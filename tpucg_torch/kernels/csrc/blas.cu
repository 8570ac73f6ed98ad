// The dense CG lap's kernels for Hopper (sm_90a), behind a plain C ABI.
//
// K1  gemv_kernel            replaces tpucg/kernels/matvec.py:108 matvec_pallas
//                            (_matvec_kernel :82)
// K2  fused_update_kernel    replaces tpucg/kernels/blas1.py:111 fused_update_pallas
//                            (_fused_update_kernel :91); with p_update_kernel,
//                            the lap's p = z + beta p (tpucg's XLA where)
// K3  dot_kernel             replaces tpucg/kernels/blas1.py:68 dot_pallas
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
// 32 KB a vector) they are bound by latency, not bandwidth, so each is one
// launch that also does the lap's scalar work, and a thread issues the
// loads of its next kLoads elements before their arithmetic. Each block
// writes one partial (a fixed-order block sum) to a scratch array whose
// length depends only on n and draws an integer ticket (release and
// acquire at device scope); the block that
// draws the last one sums the partials in a fixed order (the order of the
// second launch this replaced, so the bits are unchanged) and puts the
// ticket back to 0. There are no float atomics, so results repeat bit for
// bit, which resumable solves need. That last block also finishes the lap
// where it is asked to: K3 writes alpha = rsold / p.Ap, and the lap's last
// reduction (K2's r'.r', or K3's r'.z' under a preconditioner) runs the
// scalar tail of cg.py's loop in one thread (lap_tail). p's update is one
// small kernel after it, gated by the tail's `step`, which it consumes.
// alpha, beta and the flags stay in device memory: the host never waits.
#include "blas.cuh"

#include <cstdint>

namespace tpucg {
namespace {

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

// A thread's elements of K2, K3 and p's update are e = b kBlock + t, then
// + stride, in order; kLoads of them at a time have their loads issued
// before their arithmetic, which keeps that order (so the bits are the
// single-stride loop's), so a group waits for memory once, not kLoads times.
constexpr int kLoads = 4;

// atomicAdd(ticket, 1) with release and acquire semantics at device scope:
// the partial this thread stored before it is visible to the block that
// draws the last ticket, and that block's reads come after every block's
// partial. The ticket is an int: no float atomics.
__device__ __forceinline__ int draw_ticket(int* ticket) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

// Stage 2 of K2 and K3, in the launch: the block writes its partial (valid
// in thread 0) and draws an integer ticket. The block that draws the last
// one reads the partials through L2 and sums them as the second launch
// before it did (thread t takes t, t + kBlock, ... from 0, then the block
// tree), and puts the ticket back to 0 for the next launch in stream order.
// True in that block, with the sum in thread 0's `total`.
__device__ __forceinline__ bool last_block_sum(float s, float* partials, int* ticket,
                                               float& total) {
  __shared__ int last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    last = draw_ticket(ticket) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();  // orders the block's reads after thread 0's acquire
  if (!last) return false;
  float acc = 0.f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kBlock)
    acc += __ldcg(partials + i);
  total = block_sum<1>(acc);  // block_sum<0>'s buffer may still be read
  if (threadIdx.x == 0) *ticket = 0;
  return true;
}

// The scalars the lap's tail reads, loaded by thread 0 when its kernel
// starts (a previous launch wrote them; this one writes them only in the
// tail), so their latency hides behind the reduction.
struct TailIn {
  float tol2, rsold, rr;
  int k, done;
};

template <bool WithRr>
__device__ __forceinline__ TailIn load_tail(const LapScalars& s) {
  TailIn in{};
  if (threadIdx.x == 0) {
    in.tol2 = *s.tol2;
    in.rsold = *s.rsold;
    in.k = *s.k;
    in.done = *s.done;
    if constexpr (WithRr) in.rr = *s.rr;
  }
  return in;
}

// The lap's scalar tail, cg.py's torch ops after r'.r' (lap_tail_torch), in
// the one thread that finishes the lap's last reduction. Only a running lap
// gets here (a frozen one returns before its ticket), so `active` reads 1.
// Divisions and the square root are IEEE-rounded, as torch's.
__device__ __forceinline__ void lap_tail(const LapScalars& s, const TailIn& in, float rr,
                                         float rs_new) {
  const bool stop = rr < in.tol2;
  *s.beta = __fdiv_rn(rs_new, in.rsold);
  *s.step = !stop;
  if (!stop) *s.rsold = rs_new;
  *s.rslast = rr;
  if (s.hist != nullptr && in.k + 1LL < s.hist_n) s.hist[in.k + 1] = __fsqrt_rn(rr);
  const bool done = in.done != 0 || stop;
  *s.done = done;
  *s.k = in.k + 1;
  *s.active = !done && in.k + 1LL < s.maxiter;
}

// K3's finish: kSum writes u . v; kAlpha also alpha = rsold / u.v (0 where
// u.v is 0 with safe_alpha); kTail runs the lap's tail with rs_new = u.v
// and the lap's r'.r' read from its slot.
enum class DotFinish { kSum, kAlpha, kTail };

struct AlphaArgs {
  const float* rsold;
  float* alpha;
  int safe_alpha;
};

// `active` carries no __restrict__: under kTail it is the flag the tail
// writes (after every block has read it).
template <DotFinish F>
__global__ void __launch_bounds__(kBlock)
dot_kernel(const float* __restrict__ u, const float* __restrict__ v, long long n,
           float* partials, int* ticket, float* out, const int* active, AlphaArgs al,
           LapScalars lap) {
  if (inactive(active)) return;  // uniform across the block: before any barrier
  float rsold = 0.f;
  if (F == DotFinish::kAlpha && threadIdx.x == 0) rsold = *al.rsold;
  const TailIn in = F == DotFinish::kTail ? load_tail<true>(lap) : TailIn{};
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  float acc = 0.f;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; i < n;
       i += kLoads * stride) {
    float a[kLoads], b[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const long long e = i + j * stride;
      a[j] = e < n ? u[e] : 0.f;
      b[j] = e < n ? v[e] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      if (i + j * stride < n) acc = fmaf(a[j], b[j], acc);
  }
  float total;
  if (!last_block_sum(block_sum(acc), partials, ticket, total) || threadIdx.x != 0) return;
  *out = total;
  if constexpr (F == DotFinish::kAlpha) {
    *al.alpha = (al.safe_alpha && total == 0.f) ? 0.f : __fdiv_rn(rsold, total);
  } else if constexpr (F == DotFinish::kTail) {
    lap_tail(lap, in, in.rr, total);
  }
}

// x and xo (r and ro) may be the same array: each element is read and then
// written by one thread, so they carry no __restrict__, and a group's loads
// are issued before its stores by hand. With Tail the block that finishes
// r'.r' runs the lap's tail with rs_new = r'.r'.
template <bool Tail>
__global__ void __launch_bounds__(kBlock)
fused_update_kernel(const float* x, const float* r, const float* __restrict__ p,
                    const float* __restrict__ ap, const float* __restrict__ alpha,
                    float* xo, float* ro, long long n, float* partials, int* ticket,
                    float* rr, const int* active, LapScalars lap) {
  if (inactive(active)) return;
  const TailIn in = Tail ? load_tail<false>(lap) : TailIn{};
  const float a = *alpha;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  float acc = 0.f;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; i < n;
       i += kLoads * stride) {
    float xs[kLoads] = {}, rs[kLoads] = {}, ps[kLoads] = {}, aps[kLoads] = {};
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const long long e = i + j * stride;
      if (e < n) {
        xs[j] = x[e];
        rs[j] = r[e];
        ps[j] = p[e];
        aps[j] = ap[e];
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const long long e = i + j * stride;
      if (e < n) {
        const float xn = fmaf(a, ps[j], xs[j]);
        const float rn = fmaf(-a, aps[j], rs[j]);
        xo[e] = xn;
        ro[e] = rn;
        acc = fmaf(rn, rn, acc);
      }
    }
  }
  float total;
  if (!last_block_sum(block_sum(acc), partials, ticket, total) || threadIdx.x != 0) return;
  *rr = total;
  if constexpr (Tail) lap_tail(lap, in, total, total);
}

// p = z + beta p where the lap's tail set `step` (also on the lap that
// reaches maxiter, whose tail has already cleared `active`), rounded twice
// as the torch ops before it: (rs_new / rsold) * p, then z + that. The last
// block to finish clears `step`, so the frozen laps after it write nothing.
__global__ void __launch_bounds__(kBlock)
p_update_kernel(const float* __restrict__ z, float* __restrict__ p,
                const float* __restrict__ beta, int* step, int* ticket, long long n) {
  if (*step == 0) return;  // read by every block before the last one clears it
  const float b = *beta;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; i < n;
       i += kLoads * stride) {
    float zs[kLoads] = {}, ps[kLoads] = {};
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const long long e = i + j * stride;
      if (e < n) {
        zs[j] = z[e];
        ps[j] = p[e];
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const long long e = i + j * stride;
      if (e < n) p[e] = __fadd_rn(zs[j], __fmul_rn(b, ps[j]));
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1) {
    *step = 0;
    *ticket = 0;
  }
}

// The ticket: the int after the reduce_blocks(n) partials of the scratch.
inline int* ticket_of(void* scratch, int nb) {
  return reinterpret_cast<int*>(static_cast<float*>(scratch) + nb);
}

template <DotFinish F>
cudaError_t launch_dot(const void* u, const void* v, void* scratch, void* out, long long n,
                       const int* active, AlphaArgs al, const LapScalars& lap, void* stream) {
  const int nb = reduce_blocks(n);
  dot_kernel<F><<<nb, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(v), n,
      static_cast<float*>(scratch), ticket_of(scratch, nb), static_cast<float*>(out), active,
      al, lap);
  return cudaGetLastError();
}

template <bool Tail>
cudaError_t launch_fused_update(const void* x, const void* r, const void* p, const void* ap,
                                const void* alpha, void* xo, void* ro, void* scratch, void* rr,
                                long long n, const int* active, const LapScalars& lap,
                                void* stream) {
  const int nb = reduce_blocks(n);
  fused_update_kernel<Tail><<<nb, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(r),
      static_cast<const float*>(p), static_cast<const float*>(ap),
      static_cast<const float*>(alpha), static_cast<float*>(xo), static_cast<float*>(ro), n,
      static_cast<float*>(scratch), ticket_of(scratch, nb), static_cast<float*>(rr), active,
      lap);
  return cudaGetLastError();
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

extern "C" cudaError_t tpucg_dot_f32(const void* u, const void* v, void* scratch, void* out,
                                     long long n, const void* active, void* stream) {
  return tpucg::launch_dot<tpucg::DotFinish::kSum>(
      u, v, scratch, out, n, static_cast<const int*>(active), {}, {}, stream);
}

extern "C" cudaError_t tpucg_dot_alpha_f32(const void* u, const void* v, void* scratch,
                                           void* out, const void* rsold, void* alpha,
                                           int safe_alpha, long long n, const void* active,
                                           void* stream) {
  const tpucg::AlphaArgs al{static_cast<const float*>(rsold), static_cast<float*>(alpha),
                            safe_alpha};
  return tpucg::launch_dot<tpucg::DotFinish::kAlpha>(
      u, v, scratch, out, n, static_cast<const int*>(active), al, {}, stream);
}

extern "C" cudaError_t tpucg_dot_tail_f32(const void* u, const void* v, void* scratch,
                                          void* out, const void* lap, long long n,
                                          void* stream) {
  const auto& s = *static_cast<const tpucg::LapScalars*>(lap);
  return tpucg::launch_dot<tpucg::DotFinish::kTail>(u, v, scratch, out, n, s.active, {}, s,
                                                    stream);
}

extern "C" cudaError_t tpucg_fused_update_f32(const void* x, const void* r, const void* p,
                                              const void* ap, const void* alpha, void* xo,
                                              void* ro, void* scratch, void* rr, long long n,
                                              const void* active, void* stream) {
  return tpucg::launch_fused_update<false>(x, r, p, ap, alpha, xo, ro, scratch, rr, n,
                                           static_cast<const int*>(active), {}, stream);
}

extern "C" cudaError_t tpucg_fused_update_tail_f32(const void* x, const void* r, const void* p,
                                                   const void* ap, const void* alpha, void* xo,
                                                   void* ro, void* scratch, void* rr,
                                                   const void* lap, long long n, void* stream) {
  const auto& s = *static_cast<const tpucg::LapScalars*>(lap);
  return tpucg::launch_fused_update<true>(x, r, p, ap, alpha, xo, ro, scratch, rr, n, s.active,
                                          s, stream);
}

extern "C" cudaError_t tpucg_p_update_f32(const void* z, void* p, const void* beta, void* step,
                                          void* scratch, long long n, void* stream) {
  const int nb = tpucg::reduce_blocks(n);
  tpucg::p_update_kernel<<<nb, tpucg::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<float*>(p), static_cast<const float*>(beta),
      static_cast<int*>(step), tpucg::ticket_of(scratch, nb), n);
  return cudaGetLastError();
}

extern "C" int tpucg_reduce_blocks(long long n) { return tpucg::reduce_blocks(n); }

extern "C" const char* tpucg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
