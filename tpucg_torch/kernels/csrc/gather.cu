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
// K13 x k (well_rows_spmv_multi_kernel) replaces tpucg's vmap of the same
// kernel (WellOperator.matvec_multi, the multi-RHS and block solves'
// batched matvec): Y (nrows, k) = A X over the same layout, X and Y
// row-major, so a gathered row of X is k contiguous floats. K13's design
// would stage a tile's products, tile x k floats: 64 KB for the 2,048-slot
// tile at k = 8 and 256 KB at k = 32, past the 227 KB a block can take. So a
// tile stages what the k columns share instead, each live slot's value
// (widened to f32) and column, 8 bytes a slot whatever k is (16 KB a tile;
// a tile of up to TILE_MAX slots opts in to 96 KB): the layout is read once
// for all k columns. Then each thread takes V neighbouring columns of one
// of the tile's rows (V = 4, one 16-byte gather of X's row a slot, where k
// % 4 == 0 and X and Y are 16-byte aligned, else V = 1), and every
// kThreads-th such group after it, and sums __fmul_rn of the staged value
// and X[col, j] over the row's slots in order, from 0, with __fadd_rn:
// K13's products and K13's sums. A row longer than a tile is staged a
// tile at a time, each thread carrying its columns' sums across them. So
// column j of Y is K13's y on column j of X, bit for bit, for any k and V.
//
// Both read the lap's `active` flag first and return at once when it is 0,
// and write rows [0, nrows) only.
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

// Values (widened) and columns of slots [s0, s1) into sv and sc.
template <typename T>
__device__ __forceinline__ void stage_slots(const T* __restrict__ rvals,
                                            const int* __restrict__ cols, float* sv, int* sc,
                                            int s0, int s1) {
  for (int i = threadIdx.x; i < s1 - s0; i += kThreads) {
    sv[i] = widen(__ldg(rvals + s0 + i));
    sc[i] = __ldg(cols + s0 + i);
  }
}

// Columns [c0, c0 + V) of row r over its staged slots [a, b): K13's
// products and sums, column by column.
template <int V>
__device__ __forceinline__ void row_sums(const float* sv, const int* sc, int a, int b,
                                         const float* __restrict__ xc, int k, float (&acc)[V]) {
  for (int q = a; q < b; ++q) {
    const float s = sv[q];
    const Cols<V> x = load_cols<V>(xc + static_cast<long long>(sc[q]) * k);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], __fmul_rn(s, x.v[v]));
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
well_rows_spmv_multi_kernel(const T* __restrict__ rvals, const int* __restrict__ cols,
                            const int* __restrict__ rowptr, const int* __restrict__ tptr,
                            const float* __restrict__ X, float* __restrict__ Y, int nrows,
                            int tile, int k, const int* __restrict__ active) {
  extern __shared__ float staged[];
  float* const sv = staged;
  int* const sc = reinterpret_cast<int*>(staged + tile);
  if (inactive(active)) return;
  const int r0 = __ldg(tptr + blockIdx.x);
  if (r0 >= nrows) return;
  const int r1 = min(__ldg(tptr + blockIdx.x + 1), nrows);
  const int s0 = __ldg(rowptr + r0);
  const int s1 = __ldg(rowptr + r1);
  const int groups = k / V;
  if (s1 - s0 <= tile) {
    stage_slots(rvals, cols, sv, sc, s0, s1);
    __syncthreads();
    const long long work = static_cast<long long>(r1 - r0) * groups;
    for (long long w = threadIdx.x; w < work; w += kThreads) {
      const int r = r0 + static_cast<int>(w / groups);
      const int c0 = V * static_cast<int>(w - static_cast<long long>(r - r0) * groups);
      const int a = __ldg(rowptr + r) - s0, b = __ldg(rowptr + r + 1) - s0;
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;
      row_sums<V>(sv, sc, a, b, X + c0, k, acc);
      store_cols<V>(Y + static_cast<long long>(r) * k + c0, acc);
    }
    return;
  }
  // One row longer than a tile: a tile of its slots at a time, kThreads
  // column groups at a time.
  for (int g0 = 0; g0 < groups; g0 += kThreads) {
    const int g = g0 + static_cast<int>(threadIdx.x);
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int c = s0; c < s1; c += tile) {
      const int e = min(c + tile, s1);
      stage_slots(rvals, cols, sv, sc, c, e);
      __syncthreads();
      if (g < groups) row_sums<V>(sv, sc, 0, e - c, X + V * g, k, acc);
      __syncthreads();
    }
    if (g < groups) store_cols<V>(Y + static_cast<long long>(r0) * k + V * g, acc);
  }
}

template <typename T, int V>
cudaError_t launch_well_multi_v(const void* rvals, const void* cols, const void* rowptr,
                                const void* tptr, const void* x, void* y, long long nrows,
                                long long ntiles, int tile, long long k, const void* active,
                                void* stream, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(well_rows_spmv_multi_kernel<T, V>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  well_rows_spmv_multi_kernel<T, V><<<static_cast<unsigned>(ntiles), kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rvals), static_cast<const int*>(cols),
      static_cast<const int*>(rowptr), static_cast<const int*>(tptr),
      static_cast<const float*>(x), static_cast<float*>(y), static_cast<int>(nrows), tile,
      static_cast<int>(k), static_cast<const int*>(active));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_well_spmv_multi(const void* rvals, const void* cols, const void* rowptr,
                                   const void* tptr, const void* x, void* y, long long nrows,
                                   long long ntiles, int tile, long long k, const void* active,
                                   void* stream) {
  const size_t smem = static_cast<size_t>(tile) * (sizeof(float) + sizeof(int));
  if (nrows <= 0 || nrows > 0x7ffffffeLL || ntiles <= 0 || ntiles > 0x7fffffffLL ||
      tile < 2 || smem > 227 * 1024 || k < 1 || k > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (cols_a_thread(k, x, y) == 4)
    return launch_well_multi_v<T, 4>(rvals, cols, rowptr, tptr, x, y, nrows, ntiles, tile, k,
                                     active, stream, smem);
  return launch_well_multi_v<T, 1>(rvals, cols, rowptr, tptr, x, y, nrows, ntiles, tile, k,
                                   active, stream, smem);
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

extern "C" cudaError_t tpucg_well_spmv_multi_f32(const void* rvals, const void* cols,
                                                 const void* rowptr, const void* tptr,
                                                 const void* x, void* y, long long nrows,
                                                 long long ntiles, int tile, long long k,
                                                 const void* active, void* stream) {
  return tpucg::launch_well_spmv_multi<float>(rvals, cols, rowptr, tptr, x, y, nrows, ntiles,
                                              tile, k, active, stream);
}

extern "C" cudaError_t tpucg_well_spmv_multi_bf16(const void* rvals, const void* cols,
                                                  const void* rowptr, const void* tptr,
                                                  const void* x, void* y, long long nrows,
                                                  long long ntiles, int tile, long long k,
                                                  const void* active, void* stream) {
  return tpucg::launch_well_spmv_multi<uint16_t>(rvals, cols, rowptr, tptr, x, y, nrows,
                                                 ntiles, tile, k, active, stream);
}
