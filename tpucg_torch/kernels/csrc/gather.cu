// The irregular-sparse lap matvec for Hopper (sm_90a), behind a plain C ABI.
//
// K13 well_rows_spmv_kernel  replaces tpucg/kernels/gather_spmv.py:97
//                            well_spmv (_well_kernel :57), and under K14's
//                            name tpucg/kernels/gather_spmv.py:226
//                            well_spmv_fused_gather (_well_kernel_fused
//                            :141): both compute one function.
//
// The function is tpucg's WELL product (tpucg_torch/sparse/well.py): for
// each slot (s, l) of the packed (NS, 128) arrays, vals[s, l] * x[wrow[s /
// 8] * 128 + lidx[s, l]] goes into output row (sgb[s / BS] * BG + gidl[s]) *
// 128 + l. The TPU kernel streamed every slot, gathered 128-wide windows of
// x with a row DMA, picked lanes with a vector shuffle and routed sublanes
// to their output groups with a one-hot matrix product.
//
// What bounds it on an H100: the bytes of the function, not of the TPU
// layout. Each nonzero's value (4 or 2 bytes) and column (4 bytes) once,
// the row offsets (4 bytes a row), x read once and y written once: at
// tpucg's FEM n = 300k (5.4M nonzeros) 46.8 MB, 14.0 us at 3.35 TB/s in
// f32. x (1.2 MB) stays in the 50 MB L2, so its reads are L2 traffic.
//
// What the design does about the TPU layout. WELL stores ~5x the nonzeros
// in slots (fill ~0.19 at FEM 300k: value 0, lane index 0) and routes every
// padding sublane of a super-group to its group 0, so a kernel that walks
// the slots a group at a time reads ~5x the bytes and its longest group
// (1,499 sublanes against a mean of 96) sets its time. So the operator
// repacks once, at set-up (gather_spmv.py well_rows): the live slots
// (vals != 0) alone, as CSR rows (rowptr, cols, rvals), each row's in
// ascending sublane s, and the rows cut into tiles of whole rows that each
// hold at most `tile` slots (tptr). One block a tile, CSR-stream in the
// manner of CSR-Adaptive (Greathouse & Daga, SC14), so every block gets a
// near-equal share of the nonzeros:
//   1. the block's threads stride over the tile's slots (loads of rvals and
//      cols coalesce; kInFlight of them in flight a thread) and put each
//      product __fmul_rn(widen(v), x[col]) in shared memory;
//   2. __syncthreads();
//   3. thread t takes row r0 + t (and every kThreads-th after it), sums its
//      products from shared memory in order, from 0, with __fadd_rn, and
//      writes y once.
//   4. A row longer than a tile is a tile of its own: step 1 runs a tile of
//      its slots at a time, and thread 0 carries the row's sum across them
//      in order.
// No float atomics: y repeats bit for bit, and equals the plain version
// (which sums in the same order) bit for bit.
//
// Dropping the zero slots changes no bit while x is finite: a row's sum
// starts at +0, and under round-to-nearest +0 + (-0) and a + (-a) are +0,
// so it is never -0; adding +-0 to anything but -0 is exact. So this equals
// tpucg's well_spmv_xla, which adds every slot of a row in ascending s.
// The one intended difference is on non-finite x: tpucg's padding slots
// read x at lane 0 of their window, so a NaN or Inf there poisons rows that
// store nothing in that column; here a NaN or Inf x_j reaches exactly the
// rows whose stored entries read column j, as in a CSR product. (A CG solve
// ends the same way in both: the diagonal is stored, so a non-finite p
// makes p.Ap non-finite either way.)
//
// It reads the lap's `active` flag first and returns at once when it is 0,
// and writes rows [0, nrows) only.
#include "blas.cuh"
#include "sparse.cuh"

namespace tpucg {
namespace {

constexpr int kThreads = 256;  // threads a block (a tile)
constexpr int kInFlight = 4;   // slots whose loads a thread issues together

// Products of slots [s0, s1) into prod[0, s1 - s0): thread t takes slots
// s0 + t, s0 + t + kThreads, ...
template <typename T>
__device__ __forceinline__ void stage_products(const T* __restrict__ rvals,
                                               const int* __restrict__ cols,
                                               const float* __restrict__ x, float* prod, int s0,
                                               int s1) {
  const int n = s1 - s0;
  int i = threadIdx.x;
  for (; i + (kInFlight - 1) * kThreads < n; i += kInFlight * kThreads) {
    int c[kInFlight];
    float v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      c[u] = __ldg(cols + s0 + i + u * kThreads);
      v[u] = widen(__ldg(rvals + s0 + i + u * kThreads));
    }
    float xv[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) xv[u] = __ldg(x + c[u]);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) prod[i + u * kThreads] = __fmul_rn(v[u], xv[u]);
  }
  for (; i < n; i += kThreads)
    prod[i] = __fmul_rn(widen(__ldg(rvals + s0 + i)), __ldg(x + __ldg(cols + s0 + i)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
well_rows_spmv_kernel(const T* __restrict__ rvals, const int* __restrict__ cols,
                      const int* __restrict__ rowptr, const int* __restrict__ tptr,
                      const float* __restrict__ x, float* __restrict__ y, int nrows, int tile,
                      const int* __restrict__ active) {
  extern __shared__ float prod[];
  if (inactive(active)) return;
  const int r0 = __ldg(tptr + blockIdx.x);
  if (r0 >= nrows) return;
  const int r1 = min(__ldg(tptr + blockIdx.x + 1), nrows);
  const int s0 = __ldg(rowptr + r0);
  const int s1 = __ldg(rowptr + r1);
  const int t = threadIdx.x;
  if (s1 - s0 <= tile) {
    // Whole rows: the first row's bounds load beside the products.
    int r = r0 + t;
    int a = 0, b = 0;
    if (r < r1) {
      a = __ldg(rowptr + r) - s0;
      b = __ldg(rowptr + r + 1) - s0;
    }
    stage_products(rvals, cols, x, prod, s0, s1);
    __syncthreads();
    for (; r < r1; r += kThreads) {
      if (r != r0 + t) {
        a = __ldg(rowptr + r) - s0;
        b = __ldg(rowptr + r + 1) - s0;
      }
      float acc = 0.f;
      for (int j = a; j < b; ++j) acc = __fadd_rn(acc, prod[j]);
      y[r] = acc;
    }
    return;
  }
  // One row longer than a tile: a tile of its slots at a time.
  float acc = 0.f;
  for (int c = s0; c < s1; c += tile) {
    const int e = min(c + tile, s1);
    stage_products(rvals, cols, x, prod, c, e);
    __syncthreads();
    if (t == 0)
      for (int j = 0; j < e - c; ++j) acc = __fadd_rn(acc, prod[j]);
    __syncthreads();
  }
  if (t == 0) y[r0] = acc;
}

template <typename T>
cudaError_t launch_well_spmv(const void* rvals, const void* cols, const void* rowptr,
                             const void* tptr, const void* x, void* y, long long nrows,
                             long long ntiles, int tile, const void* active, void* stream) {
  if (nrows <= 0 || nrows > 0x7ffffffeLL || ntiles <= 0 || ntiles > 0x7fffffffLL ||
      tile < 2 || tile * sizeof(float) > 48 * 1024)
    return cudaErrorInvalidValue;
  well_rows_spmv_kernel<T><<<static_cast<unsigned>(ntiles), kThreads, tile * sizeof(float),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rvals), static_cast<const int*>(cols),
      static_cast<const int*>(rowptr), static_cast<const int*>(tptr),
      static_cast<const float*>(x), static_cast<float*>(y), static_cast<int>(nrows), tile,
      static_cast<const int*>(active));
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpucg

extern "C" cudaError_t tpucg_well_spmv_f32(const void* rvals, const void* cols, const void* rowptr,
                                           const void* tptr, const void* x, void* y,
                                           long long nrows, long long ntiles, int tile,
                                           const void* active, void* stream) {
  return tpucg::launch_well_spmv<float>(rvals, cols, rowptr, tptr, x, y, nrows, ntiles, tile,
                                        active, stream);
}

extern "C" cudaError_t tpucg_well_spmv_bf16(const void* rvals, const void* cols,
                                            const void* rowptr, const void* tptr, const void* x,
                                            void* y, long long nrows, long long ntiles, int tile,
                                            const void* active, void* stream) {
  return tpucg::launch_well_spmv<uint16_t>(rvals, cols, rowptr, tptr, x, y, nrows, ntiles,
                                           tile, active, stream);
}
