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
// row-major, so a gathered row of X is k contiguous floats. Column j of Y
// is K13's y on column j of X, bit for bit: every product is
// __fmul_rn(widen(v), X[col, j]), every column's sum runs over the row's
// live slots in ascending order, from +0, with __fadd_rn.
//
// What bounds it on an H100. The function's bytes, nnz * 8 + 4 (n + 1) + 8
// n k (f32 values; 2 bytes a value in bf16): 63.6 MB at FEM 300k, k = 8,
// 19.0 us at 3.35 TB/s. Its gathers move more: a slot reads X's row of k
// floats (32 bytes at k = 8, one sector) from L2, 173 MB at k = 8 and 691
// MB at k = 32 where no read hits L1. A tile of the layout (a mean of 55
// rows and 996 slots at FEM 300k, at most 1,050; rows a mean of 18 slots,
// at most 53) reads only 13.5% distinct columns (729,543 distinct (tile,
// column) pairs of 5.4 M), so ~135 X rows a tile could serve its gathers
// from L1; but its columns span a median of 8,934 rows of X (99th
// percentile 13,445), ~286 KB at k = 8, past the 227 KB a block can hold,
// so no window of X is staged as K10 and K11 stage theirs. On the card the
// design below takes 26, 35, 44 and 78 us at k = 1, 3, 8 and 32 for the
// same 5.4 M gathers (PERF.md): the gathers set its pace, and neither more
// loads in flight nor more threads an SM moved k = 8; fewer gathers (a
// tile's distinct columns staged once) is the next step.
//
// What the first design (one block a tile: the tile's values and columns
// staged in shared memory, then one thread a (row, 4-column group)) lost:
// at FEM 300k a tile has 55 rows x 2 groups at k = 8, so 43% of the block's
// threads work (22% at k = 1), and each walks its row's ~18 gathers with
// about one in flight, after a barrier that no load overlaps. A block
// that gathers every (slot, 4-column piece) of the tile with several loads
// in flight and stages the products in shared memory (K13's design taken to
// k columns) was no faster at k = 3 and slower at k = 8 and 32 (its
// products' stores and reads in shared memory, 32 KB of them a tile at k =
// 8, and a barrier a tile; PERF.md gives the times).
//
// The design. No tiles and no shared memory for rows of at most half a
// tile (`tile` / 2 slots, every row at FEM 300k and the geometric graphs):
// a flat grid of (row, V-column group) pairs, one a thread, neighbouring threads on the V-column groups
// of one row and then on the next rows, so a warp's loads of X are whole
// rows (a 32-byte sector at k = 8) and its threads all work. V = 4 (one
// 16-byte load of X and one store of Y) where k % 4 == 0 and X and Y are
// 16-byte aligned, else 1. Each thread walks its row U slots a round: the U
// values and columns, then the U gathers of X all in flight, then the U
// products added in order; the last (b - a) % U slots one at a time (a
// guarded last round spilled at 40 registers). Occupancy sets the rest: U =
// 6 at 6 blocks an SM (40 registers) where a row has fewer than 8 column
// groups, U = 3 at 8 blocks an SM (32 registers) where it has more (k >=
// 32, or k >= 8 on scalar columns): the faster pair at FEM 300k of the
// settings tried on the card (PERF.md). With nothing staged there is no
// next tile to fetch early, so no cp.async stage. A row of more than `tile`
// / 2 slots (WellRows.long_rows: a tile of its own in K13's layout) is
// skipped there and taken by a block of its own
// (well_long_row_multi_kernel): up to 32 columns at a time, the block
// gathers a chunk of the row's slots (one (slot, V-column piece) a thread,
// kInFlight in flight) into 32 KB of products in shared memory, then
// thread j adds column j's chunk in order, its sum carried across chunks.
// The flat grid alone walks such a row with a thread a column group, its
// value and column loads before its gathers: at an arrowhead's 5,000-slot
// row 1.4x (k = 8) and 2.5x (k = 32) the first design's time, which read
// them from shared memory (PERF.md). No float atomics: Y repeats bit for
// bit and equals the plain version.
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

// Rows of at least this many column groups take the lighter thread (U = 3
// at 8 blocks an SM) in well_rows_spmv_multi_kernel.
constexpr int kManyGroups = 8;

template <typename T, int V, int U, int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks)
well_rows_spmv_multi_kernel(const T* __restrict__ rvals, const int* __restrict__ cols,
                            const int* __restrict__ rowptr, const float* __restrict__ X,
                            float* __restrict__ Y, int nrows, int k, int long_len,
                            const int* __restrict__ active) {
  if (inactive(active)) return;
  const int groups = k / V;
  const long long w = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= static_cast<long long>(nrows) * groups) return;
  const int r = static_cast<int>(w / groups);
  const int c0 = V * static_cast<int>(w - static_cast<long long>(r) * groups);
  const int a = __ldg(rowptr + r), b = __ldg(rowptr + r + 1);
  if (b - a > long_len) return;  // well_long_row_multi_kernel's
  const float* const xc = X + c0;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  int q = a;
  for (; q + U <= b; q += U) {
    // U slots: their values and columns, then their gathers, all in
    // flight, then their products added in order.
    int c[U];
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      c[u] = __ldg(cols + q + u);
      v[u] = widen(__ldg(rvals + q + u));
    }
    Cols<V> x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) x[u] = load_cols<V>(xc + static_cast<long long>(c[u]) * k);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(v[u], x[u].v[j]));
  }
  for (; q < b; ++q) {
    const Cols<V> x = load_cols<V>(xc + static_cast<long long>(__ldg(cols + q)) * k);
    const float v = widen(__ldg(rvals + q));
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(v, x.v[j]));
  }
  store_cols<V>(Y + static_cast<long long>(r) * k + c0, acc);
}

// A long row's products of slots [s0, s1) on columns [0, w) of xc (w a
// multiple of V, w <= kLongCols) into prod[(s - s0) * w + j]: thread t takes
// the (slot, V-column piece) pairs t, t + kThreads, ..., kInFlight at a time.
constexpr int kLongCols = 32;               // columns a pass of a long row
constexpr int kLongFloats = 8192;           // its products: 32 KB of shared memory

template <typename T, int V>
__device__ __forceinline__ void gather_row_products(const T* __restrict__ rvals,
                                                    const int* __restrict__ cols,
                                                    const float* __restrict__ xc, int k, int w,
                                                    float* prod, int s0, int s1) {
  const int pieces = w / V;
  const int n = (s1 - s0) * pieces;
  for (int i = threadIdx.x; i < n; i += kInFlight * kThreads) {
    int c[kInFlight], off[kInFlight];
    float v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = i + u * kThreads;
      const int s = e / pieces;
      off[u] = e < n ? V * (e - s * pieces) : 0;
      c[u] = e < n ? __ldg(cols + s0 + s) : 0;
      v[u] = e < n ? widen(__ldg(rvals + s0 + s)) : 0.f;
    }
    Cols<V> x[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (i + u * kThreads < n) x[u] = load_cols<V>(xc + static_cast<long long>(c[u]) * k + off[u]);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = i + u * kThreads;
      if (e < n) {
        float p[V];
#pragma unroll
        for (int j = 0; j < V; ++j) p[j] = __fmul_rn(v[u], x[u].v[j]);
        store_cols<V>(prod + (e / pieces) * w + off[u], p);
      }
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
well_long_row_multi_kernel(const T* __restrict__ rvals, const int* __restrict__ cols,
                           const int* __restrict__ rowptr, const int* __restrict__ long_rows,
                           const float* __restrict__ X, float* __restrict__ Y, int nrows, int k,
                           const int* __restrict__ active) {
  __shared__ float4 staged[kLongFloats / 4];
  float* const prod = reinterpret_cast<float*>(staged);
  if (inactive(active)) return;
  const int r = __ldg(long_rows + blockIdx.x);
  if (r >= nrows) return;
  const int s0 = __ldg(rowptr + r), s1 = __ldg(rowptr + r + 1);
  const int t = threadIdx.x;
  for (int c0 = 0; c0 < k; c0 += kLongCols) {
    const int w = min(kLongCols, k - c0);
    const int chunk = kLongFloats / w;
    float acc = 0.f;
    for (int c = s0; c < s1; c += chunk) {
      const int e = min(c + chunk, s1);
      gather_row_products<T, V>(rvals, cols, X + c0, k, w, prod, c, e);
      __syncthreads();
      if (t < w)
        for (int q = 0; q < e - c; ++q) acc = __fadd_rn(acc, prod[q * w + t]);
      __syncthreads();
    }
    if (t < w) Y[static_cast<long long>(r) * k + c0 + t] = acc;
  }
}

template <typename T, int V>
cudaError_t launch_well_multi_v(const void* rvals, const void* cols, const void* rowptr,
                                const void* long_rows, const void* x, void* y, long long nrows,
                                long long nlong, int tile, long long k, const void* active,
                                void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto rv = static_cast<const T*>(rvals);
  const auto cl = static_cast<const int*>(cols);
  const auto rp = static_cast<const int*>(rowptr);
  const auto X = static_cast<const float*>(x);
  const auto Y = static_cast<float*>(y);
  const auto act = static_cast<const int*>(active);
  const long long groups = k / V;
  const long long blocks = (nrows * groups + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto grid = static_cast<unsigned>(blocks);
  const int n = static_cast<int>(nrows), kk = static_cast<int>(k), long_len = tile / 2;
  if (groups < kManyGroups)
    well_rows_spmv_multi_kernel<T, V, 6, 6><<<grid, kThreads, 0, st>>>(rv, cl, rp, X, Y, n, kk,
                                                                      long_len, act);
  else
    well_rows_spmv_multi_kernel<T, V, 3, 8><<<grid, kThreads, 0, st>>>(rv, cl, rp, X, Y, n, kk,
                                                                      long_len, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nlong == 0) return err;
  well_long_row_multi_kernel<T, V><<<static_cast<unsigned>(nlong), kThreads, 0, st>>>(
      rv, cl, rp, static_cast<const int*>(long_rows), X, Y, n, kk, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_well_spmv_multi(const void* rvals, const void* cols, const void* rowptr,
                                   const void* long_rows, const void* x, void* y,
                                   long long nrows, long long nlong, int tile, long long k,
                                   const void* active, void* stream) {
  if (nrows <= 0 || nrows > 0x7ffffffeLL || nlong < 0 || nlong > 0x7fffffffLL || tile < 2 ||
      k < 1 || k > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (cols_a_thread(k, x, y) == 4)
    return launch_well_multi_v<T, 4>(rvals, cols, rowptr, long_rows, x, y, nrows, nlong, tile,
                                     k, active, stream);
  return launch_well_multi_v<T, 1>(rvals, cols, rowptr, long_rows, x, y, nrows, nlong, tile, k,
                                   active, stream);
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
                                                 const void* rowptr, const void* long_rows,
                                                 const void* x, void* y, long long nrows,
                                                 long long nlong, int tile, long long k,
                                                 const void* active, void* stream) {
  return tpucg::launch_well_spmv_multi<float>(rvals, cols, rowptr, long_rows, x, y, nrows, nlong,
                                              tile, k, active, stream);
}

extern "C" cudaError_t tpucg_well_spmv_multi_bf16(const void* rvals, const void* cols,
                                                  const void* rowptr, const void* long_rows,
                                                  const void* x, void* y, long long nrows,
                                                  long long nlong, int tile, long long k,
                                                  const void* active, void* stream) {
  return tpucg::launch_well_spmv_multi<uint16_t>(rvals, cols, rowptr, long_rows, x, y, nrows,
                                                 nlong, tile, k, active, stream);
}
