// The structured-sparse lap matvecs for Hopper (sm_90a), behind a plain C ABI.
//
// K6  dia_spmv_kernel        replaces tpucg/kernels/spmv.py:221 dia_spmv_pallas
//                            (_dia_kernel :152)
// K7  dia_spmv_halo_kernel   replaces tpucg/kernels/spmv.py:271
//                            dia_spmv_halo_pallas (_dia_kernel :152, its
//                            6-ref form)
// K8  poisson3d_kernel       replaces tpucg/kernels/stencil.py:152 poisson3d_pallas
//                            (_poisson_kernel :84, stencil_apply :44)
// K9  poisson3d_slab_kernel  replaces tpucg/kernels/stencil.py:126
//                            poisson3d_slab_pallas (_poisson_slab_kernel :94)
//
// What bounds them on an H100 and what the design does about it:
//
// All four are bound by device-memory bandwidth: a few flops per element and
// no reuse beyond neighbouring rows. K6 must read its slab once (ndiag * npad
// elements, f32 or bf16) plus x and write y: at m = 128 Poisson in DIA form
// that is 7 x 8 MiB + 16.8 MB = 75.5 MB, 22.5 us at 3.35 TB/s in f32 and
// 13.8 us in bf16. K8 reads u and writes y, 8n bytes: 16.8 MB, 5.0 us at
// m = 128. K7 and K9 are K6 and K8 on one rank's row block of a distributed
// solve, and move the block's bytes plus two halos: pad elements of x from
// each neighbour for K7, one m^2 plane of u from each for K9.
//
// The slab stays in its canonical (ndiag, npad) layout: tpucg's
// row-interleaved packing (spmv.py:62-79) served the TPU's DMA engine. A
// thread owns a row in a grid-stride loop, so for each diagonal a warp reads
// 32 neighbouring slab elements (one 128-byte line in f32) and 32
// neighbouring x elements shifted by the offset: every load coalesces. The
// offsets (at most 64, tpucg's cap) go by value in the kernel's parameters,
// which all threads read at the same address (a broadcast from the constant
// bank). bf16 is widened exactly in registers and the sums are f32.
//
// K8 reads the grid at i and its six neighbours i +- 1, i +- m, i +- m^2
// through the read-only cache: a warp's i +- 1 reads hit the lines of its
// own i, the +- m and +- m^2 planes come through L1/L2 when earlier warps
// brought them in, so DRAM traffic stays near the 8n bytes. A tiled
// shared-memory version is later work.
//
// K7 and K9 compute their rows with K6's and K8's sums, in the same order and
// rounded the same way, and read a neighbour that lies beyond the block from
// its halo (zeros at the global edges) where K6 and K8 read the global
// vector or nothing: a 0 subtracted or a product with 0 added changes no
// f32 sum. So the blocks of a vector, each with its neighbours' halos,
// concatenate to K6's and K8's output on the whole bit for bit, and one
// rank with zero halos is K6 or K8. tpucg's slab_supported (stencil.py:88)
// is a VMEM and lane rule: K9 takes any m >= 2 and mp >= 1.
//
// All read the lap's `active` flag first and return at once when it is 0.
#include "blas.cuh"
#include "sparse.cuh"

namespace tpucg {
namespace {

template <typename T>
__global__ void __launch_bounds__(kBlock)
dia_spmv_kernel(const T* __restrict__ data, const float* __restrict__ x, float* __restrict__ y,
                long long npad, const __grid_constant__ DiaOffsets offs,
                const int* __restrict__ active) {
  if (inactive(active)) return;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; i < npad;
       i += stride)
    y[i] = dia_row(data, npad, offs, i, [&](long long j) { return __ldg(x + j); });
}

// Row i < blk of the block: column j of x_ext = [lo (pad), x (blk), hi
// (pad)] at -pad <= j < blk + pad (the launcher checks pad >= every |off|).
template <typename T>
__global__ void __launch_bounds__(kBlock)
dia_spmv_halo_kernel(const T* __restrict__ data, const float* __restrict__ x,
                     const float* __restrict__ lo, const float* __restrict__ hi,
                     float* __restrict__ y, long long blk, long long pad,
                     const __grid_constant__ DiaOffsets offs, const int* __restrict__ active) {
  if (inactive(active)) return;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; i < blk;
       i += stride)
    y[i] = dia_sum(data, blk, offs, i, [&](long long j) {
      return j < 0 ? __ldg(lo + pad + j) : (j < blk ? __ldg(x + j) : __ldg(hi + (j - blk)));
    });
}

__global__ void __launch_bounds__(kBlock)
poisson3d_kernel(const float* __restrict__ u, float* __restrict__ y, int m,
                 const int* __restrict__ active) {
  if (inactive(active)) return;
  const long long n = static_cast<long long>(m) * m * m;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; i < n;
       i += stride)
    y[i] = stencil_row(m, static_cast<int>(i), __ldg(u + i),
                       [&](long long j) { return __ldg(u + j); });
}

// (A u)[i] on a slab of mp x-planes of the m^3 grid, local flat index
// i = ix*m^2 + iy*m + iz: stencil_row's sum in its order, with the
// x-neighbours beyond the slab read from the halo planes lo (ix = -1) and hi
// (ix = mp).
__global__ void __launch_bounds__(kBlock)
poisson3d_slab_kernel(const float* __restrict__ u, const float* __restrict__ lo,
                      const float* __restrict__ hi, float* __restrict__ y, int m, int mp,
                      const int* __restrict__ active) {
  if (inactive(active)) return;
  const int mm = m * m;
  const long long n = static_cast<long long>(mp) * mm;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long li = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; li < n;
       li += stride) {
    const int i = static_cast<int>(li);
    const int ix = i / mm;
    const int rem = i - ix * mm;
    const int iy = rem / m;
    const int iz = rem - iy * m;
    float acc = __fmul_rn(6.f, __ldg(u + i));
    acc = __fsub_rn(acc, ix < mp - 1 ? __ldg(u + i + mm) : __ldg(hi + rem));
    acc = __fsub_rn(acc, ix > 0 ? __ldg(u + i - mm) : __ldg(lo + rem));
    if (iy < m - 1) acc = __fsub_rn(acc, __ldg(u + i + m));
    if (iy > 0) acc = __fsub_rn(acc, __ldg(u + i - m));
    if (iz < m - 1) acc = __fsub_rn(acc, __ldg(u + i + 1));
    if (iz > 0) acc = __fsub_rn(acc, __ldg(u + i - 1));
    y[i] = acc;
  }
}

// Blocks of a grid-stride launch over n elements: one element per thread,
// at most 2^20 blocks (the loop covers the rest).
unsigned stride_blocks(long long n) {
  const long long b = (n + kBlock - 1) / kBlock;
  return static_cast<unsigned>(b < (1LL << 20) ? b : (1LL << 20));
}

// The host array of ndiag int64 offsets as the kernels' by-value struct;
// false when ndiag is out of range. `reach` gets the largest |offset|.
bool copy_offsets(const void* offsets, int ndiag, DiaOffsets* offs, long long* reach) {
  if (ndiag < 1 || ndiag > kDiaMaxDiags || offsets == nullptr) return false;
  *offs = DiaOffsets{};
  offs->ndiag = ndiag;
  *reach = 0;
  const long long* host = static_cast<const long long*>(offsets);
  for (int d = 0; d < ndiag; ++d) {
    offs->off[d] = host[d];
    const long long a = host[d] < 0 ? -host[d] : host[d];
    if (a > *reach) *reach = a;
  }
  return true;
}

template <typename T>
cudaError_t launch_dia_spmv(const void* data, const void* offsets, int ndiag, const void* x,
                            void* y, long long npad, const void* active, void* stream) {
  DiaOffsets offs;
  long long reach;
  if (!copy_offsets(offsets, ndiag, &offs, &reach) || npad <= 0) return cudaErrorInvalidValue;
  dia_spmv_kernel<T><<<stride_blocks(npad), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const float*>(x), static_cast<float*>(y), npad,
      offs, static_cast<const int*>(active));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dia_spmv_halo(const void* data, const void* offsets, int ndiag,
                                 const void* x, const void* lo, const void* hi, void* y,
                                 long long blk, long long pad, const void* active,
                                 void* stream) {
  DiaOffsets offs;
  long long reach;
  if (!copy_offsets(offsets, ndiag, &offs, &reach) || blk <= 0 || pad < reach)
    return cudaErrorInvalidValue;
  dia_spmv_halo_kernel<T><<<stride_blocks(blk), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const float*>(x), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<float*>(y), blk, pad, offs,
      static_cast<const int*>(active));
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpucg

extern "C" cudaError_t tpucg_dia_spmv_f32(const void* data, const void* offsets, int ndiag,
                                          const void* x, void* y, long long npad,
                                          const void* active, void* stream) {
  return tpucg::launch_dia_spmv<float>(data, offsets, ndiag, x, y, npad, active, stream);
}

extern "C" cudaError_t tpucg_dia_spmv_bf16(const void* data, const void* offsets, int ndiag,
                                           const void* x, void* y, long long npad,
                                           const void* active, void* stream) {
  return tpucg::launch_dia_spmv<uint16_t>(data, offsets, ndiag, x, y, npad, active, stream);
}

extern "C" cudaError_t tpucg_dia_spmv_halo_f32(const void* data, const void* offsets, int ndiag,
                                               const void* x, const void* lo, const void* hi,
                                               void* y, long long blk, long long pad,
                                               const void* active, void* stream) {
  return tpucg::launch_dia_spmv_halo<float>(data, offsets, ndiag, x, lo, hi, y, blk, pad,
                                            active, stream);
}

extern "C" cudaError_t tpucg_dia_spmv_halo_bf16(const void* data, const void* offsets, int ndiag,
                                                const void* x, const void* lo, const void* hi,
                                                void* y, long long blk, long long pad,
                                                const void* active, void* stream) {
  return tpucg::launch_dia_spmv_halo<uint16_t>(data, offsets, ndiag, x, lo, hi, y, blk, pad,
                                               active, stream);
}

extern "C" cudaError_t tpucg_poisson3d_f32(const void* u, void* y, long long m,
                                           const void* active, void* stream) {
  using namespace tpucg;
  if (m < 2 || m > kStencilMaxM) return cudaErrorInvalidValue;
  poisson3d_kernel<<<stride_blocks(m * m * m), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<float*>(y), static_cast<int>(m),
      static_cast<const int*>(active));
  return cudaGetLastError();
}

extern "C" cudaError_t tpucg_poisson3d_slab_f32(const void* u, const void* lo, const void* hi,
                                                void* y, long long m, long long mp,
                                                const void* active, void* stream) {
  using namespace tpucg;
  if (m < 2 || mp < 1 || m > kStencilMaxM || mp * m * m > kMaxIntRows)
    return cudaErrorInvalidValue;
  poisson3d_slab_kernel<<<stride_blocks(mp * m * m), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<float*>(y), static_cast<int>(m),
      static_cast<int>(mp), static_cast<const int*>(active));
  return cudaGetLastError();
}
