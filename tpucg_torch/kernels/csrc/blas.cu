// The dense CG lap's three kernels for Hopper (sm_90a), behind a plain C ABI.
//
// K1  gemv_kernel            replaces tpucg/kernels/matvec.py:108 matvec_pallas
//                            (_matvec_kernel :82)
// K2  fused_update_kernel    replaces tpucg/kernels/blas1.py:111 fused_update_pallas
//                            (_fused_update_kernel :91)
// K3  dot_partials_kernel    replaces tpucg/kernels/blas1.py:68 dot_pallas
//                            (_dot_kernel :54)
//
// What bounds them on an H100 and what the design does about it:
//
// K1 is bound by device-memory bandwidth: it reads every byte of A once per
// call and does one FMA per element (0.5 FLOP per byte in f32). At n = 8192,
// A is 268 MB, larger than the 50 MB L2, so every call streams it from HBM.
// One warp owns one row; each lane issues 16-byte loads (4 f32 or 8 bf16,
// widened to f32 in registers), four of them in flight before their FMAs, so
// a warp keeps 2 KB of A requested at a time. Neighbouring lanes read
// neighbouring 16-byte chunks, so each warp-wide load is 512 contiguous
// bytes. x is read through the read-only cache (L1/L2), not staged in shared
// memory, so no size of x overflows a shared buffer (n = 16384 and above
// need no special case). Products and sums are plain f32 FMAs; each lane
// sums its chunks in column order and the warp reduces with a fixed shuffle
// tree, so the result depends only on the inputs.
//
// K2 and K3 read 4 and 2 vectors of n floats: at the lap's sizes (n = 8192,
// 32 KB a vector) they are bound by launch latency, not bandwidth. Their
// cross-block sums use two launches: each block writes one partial (a
// fixed-order block sum) to a scratch array whose length depends only on n,
// and one block then sums the partials in a fixed order. There are no float
// atomics, so results repeat bit for bit, which resumable solves need.
// alpha is read from device memory, so the host never waits for it.
#include "blas.cuh"

#include <cstdint>

namespace tpucg {
namespace {

__device__ __forceinline__ bool inactive(const int* active) {
  return active != nullptr && *active == 0;
}

// One 16-byte chunk of A times the matching x values, added into acc.
__device__ __forceinline__ float chunk_dot(uint4 a, const float* __restrict__ x,
                                           float acc, float) {
  const float4 xv = __ldg(reinterpret_cast<const float4*>(x));
  acc = fmaf(__uint_as_float(a.x), xv.x, acc);
  acc = fmaf(__uint_as_float(a.y), xv.y, acc);
  acc = fmaf(__uint_as_float(a.z), xv.z, acc);
  acc = fmaf(__uint_as_float(a.w), xv.w, acc);
  return acc;
}

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32 bits.
// Within each 32-bit word the lower-addressed element is the low half.
__device__ __forceinline__ float bf16_dot2(uint32_t w, float x0, float x1, float acc) {
  acc = fmaf(__uint_as_float(w << 16), x0, acc);
  acc = fmaf(__uint_as_float(w & 0xffff0000u), x1, acc);
  return acc;
}

__device__ __forceinline__ float chunk_dot(uint4 a, const float* __restrict__ x,
                                           float acc, uint16_t) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(x));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(x) + 1);
  acc = bf16_dot2(a.x, lo.x, lo.y, acc);
  acc = bf16_dot2(a.y, lo.z, lo.w, acc);
  acc = bf16_dot2(a.z, hi.x, hi.y, acc);
  acc = bf16_dot2(a.w, hi.z, hi.w, acc);
  return acc;
}

constexpr int kRowsPerBlock = kBlock / 32;
constexpr int kUnroll = 4;

// T is float (f32 A) or uint16_t (bf16 A, raw bits).
template <typename T>
__global__ void __launch_bounds__(kBlock)
gemv_kernel(const T* __restrict__ A, const float* __restrict__ x, float* __restrict__ y,
            long long rows, long long cols, const int* __restrict__ active) {
  if (inactive(active)) return;
  constexpr int kVec = 16 / sizeof(T);  // elements of A per 16-byte chunk
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave; K1 has no block barrier
  const uint4* __restrict__ arow = reinterpret_cast<const uint4*>(A + row * cols);
  const long long nchunks = cols / kVec;
  float acc = 0.f;
  long long c = lane;
  for (; c + 32 * (kUnroll - 1) < nchunks; c += 32 * kUnroll) {
    uint4 a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) a[u] = __ldg(arow + c + 32 * u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = chunk_dot(a[u], x + (c + 32 * u) * kVec, acc, T());
  }
  for (; c < nchunks; c += 32) acc = chunk_dot(__ldg(arow + c), x + c * kVec, acc, T());
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) y[row] = acc;
}

__global__ void __launch_bounds__(kBlock)
dot_partials_kernel(const float* __restrict__ u, const float* __restrict__ v, long long n,
                    float* __restrict__ partials, const int* __restrict__ active) {
  if (inactive(active)) return;  // uniform across the block: before any barrier
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  float acc = 0.f;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; i < n;
       i += stride)
    acc = fmaf(u[i], v[i], acc);
  const float s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// x and xo (r and ro) may be the same array: each element is read and then
// written by one thread, so they carry no __restrict__.
__global__ void __launch_bounds__(kBlock)
fused_update_kernel(const float* x, const float* r, const float* __restrict__ p,
                    const float* __restrict__ ap, const float* __restrict__ alpha,
                    float* xo, float* ro, long long n, float* __restrict__ partials,
                    const int* __restrict__ active) {
  if (inactive(active)) return;
  const float a = *alpha;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  float acc = 0.f;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; i < n;
       i += stride) {
    const float xn = fmaf(a, p[i], x[i]);
    const float rn = fmaf(-a, ap[i], r[i]);
    xo[i] = xn;
    ro[i] = rn;
    acc = fmaf(rn, rn, acc);
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// Stage 2 of K2/K3: one block sums the partials, thread t taking t, t+256,
// ... in order, then the fixed block tree.
__global__ void __launch_bounds__(kBlock)
sum_partials_kernel(const float* __restrict__ partials, int nparts, float* __restrict__ out,
                    const int* __restrict__ active) {
  if (inactive(active)) return;
  float acc = 0.f;
  for (int i = threadIdx.x; i < nparts; i += kBlock) acc += partials[i];
  const float s = block_sum(acc);
  if (threadIdx.x == 0) *out = s;
}

template <typename T>
cudaError_t launch_gemv(const void* A, const void* x, void* y, long long rows, long long cols,
                        const void* active, void* stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  gemv_kernel<T><<<static_cast<unsigned>(blocks), kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const float*>(x), static_cast<float*>(y), rows,
      cols, static_cast<const int*>(active));
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpucg

extern "C" cudaError_t tpucg_gemv_f32(const void* A, const void* x, void* y, long long rows,
                                      long long cols, const void* active, void* stream) {
  return tpucg::launch_gemv<float>(A, x, y, rows, cols, active, stream);
}

extern "C" cudaError_t tpucg_gemv_bf16(const void* A, const void* x, void* y, long long rows,
                                       long long cols, const void* active, void* stream) {
  return tpucg::launch_gemv<uint16_t>(A, x, y, rows, cols, active, stream);
}

extern "C" cudaError_t tpucg_dot_f32(const void* u, const void* v, void* partials, void* out,
                                     long long n, const void* active, void* stream) {
  const int nb = tpucg::reduce_blocks(n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* act = static_cast<const int*>(active);
  tpucg::dot_partials_kernel<<<nb, tpucg::kBlock, 0, s>>>(
      static_cast<const float*>(u), static_cast<const float*>(v), n,
      static_cast<float*>(partials), act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tpucg::sum_partials_kernel<<<1, tpucg::kBlock, 0, s>>>(
      static_cast<const float*>(partials), nb, static_cast<float*>(out), act);
  return cudaGetLastError();
}

extern "C" cudaError_t tpucg_fused_update_f32(const void* x, const void* r, const void* p,
                                              const void* ap, const void* alpha, void* xo,
                                              void* ro, void* partials, void* beta,
                                              long long n, const void* active, void* stream) {
  const int nb = tpucg::reduce_blocks(n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* act = static_cast<const int*>(active);
  tpucg::fused_update_kernel<<<nb, tpucg::kBlock, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(r),
      static_cast<const float*>(p), static_cast<const float*>(ap),
      static_cast<const float*>(alpha), static_cast<float*>(xo), static_cast<float*>(ro), n,
      static_cast<float*>(partials), act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tpucg::sum_partials_kernel<<<1, tpucg::kBlock, 0, s>>>(
      static_cast<const float*>(partials), nb, static_cast<float*>(beta), act);
  return cudaGetLastError();
}

extern "C" int tpucg_reduce_blocks(long long n) { return tpucg::reduce_blocks(n); }

extern "C" const char* tpucg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
