// Hand-written Hopper (sm_90a) kernels of the CG solve: the plain C ABI that
// tpucg_torch/kernels/_lib.py binds with ctypes, and the fixed-order block
// reduction that K2 (fused update) and K3 (dot) share. The dense lap (K1-K3)
// lives in blas.cu, the structured-sparse lap matvecs (K6 DIA SpMV, K8
// 7-point stencil, their row-block forms with halos K7 and K9, and the
// k-column forms K6 x k and K8 x k) in sparse.cu, the irregular one (K13
// WELL SpMV, and K13 x k) in gather.cu, the whole solves (K4, K5, K10,
// K11, K12) in fused.cu, and the gather probes P1-P7 (no solve runs them)
// in probe.cu.
//
// Every entry point takes the launch stream. The lap's kernels also take an
// optional `active` device flag (const int*, may be null). When the flag
// reads 0 they return at once, so the frozen laps a chunked CG loop runs
// after convergence cost a launch and nothing else; their outputs are then
// left as they were. Every entry point returns the launch's error, then
// cudaGetLastError().
#pragma once

#include <cuda_runtime.h>

namespace tpucg {

constexpr int kBlock = 256;          // threads per block, K1-K4
constexpr int kMaxPartials = 1024;   // cap on stage-1 blocks of a reduction
constexpr int kFusedMaxN = 4096;     // K4's largest n (tpucg's FUSED_MAX_N)
constexpr int kFusedBatchMaxN = 2048;  // K5's (tpucg's FUSED_BATCH_MAX_N)
// K12's: the largest multiple of 128 whose four f32 vectors, with the 512
// bytes of the reductions' slots, fit the 232,448 bytes of shared memory an
// H100 block may take.
constexpr int kFusedBatchDiaMaxN = 14464;

// The lap kernels' `active` flag: true when it is given and reads 0.
__device__ __forceinline__ bool inactive(const int* active) {
  return active != nullptr && *active == 0;
}

// Number of stage-1 blocks (= partial sums) of an n-element reduction. It
// depends on n alone, so the order in which a sum is taken does too: the
// same n always gives bit-identical results, with no float atomics.
__host__ __device__ inline int reduce_blocks(long long n) {
  long long b = (n + 4LL * kBlock - 1) / (4LL * kBlock);
  if (b < 1) b = 1;
  return b > kMaxPartials ? kMaxPartials : static_cast<int>(b);
}

// Sum of `v` over a kBlock-thread block in a fixed order: a shuffle tree in
// each warp, then warp 0 sums the warp results in warp order. The result is
// valid in thread 0. Each Slot has one shared buffer: a kernel calls each
// Slot at most once (K2 and K3 sum twice: slots 0 and 1).
template <int Slot = 0>
__device__ inline float block_sum(float v) {
  __shared__ float warp_sums[kBlock / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (warp == 0) {
    s = lane < kBlock / 32 ? warp_sums[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  }
  return s;
}

// The CG lap's scalars in device memory, as K2's and K3's tails read and
// write them (kernels/blas1.py LapPointers holds the same fields in this
// order): k, rsold (r.z, or r.r without a preconditioner), rslast (the last
// r.r), done (one byte), active (the lap kernels' flag), beta and step (p's
// update), tol2 (tol^2), rr (the slot K2 writes the lap's r'.r' to, which
// K3's tail reads), hist (||r|| by lap, hist_n floats; may be null) and
// maxiter.
struct LapScalars {
  int* k;
  float* rsold;
  float* rslast;
  unsigned char* done;
  int* active;
  float* beta;
  int* step;
  const float* tol2;
  const float* rr;
  float* hist;
  long long hist_n;
  long long maxiter;
};

}  // namespace tpucg

extern "C" {

// K1: y[rows] = A[rows, cols] @ x[cols], A f32 or bf16 (row-major), x and y
// f32. cols % 8 == 0; A and x 16-byte aligned.
cudaError_t tpucg_gemv_f32(const void* A, const void* x, void* y, long long rows,
                           long long cols, const void* active, void* stream);
cudaError_t tpucg_gemv_bf16(const void* A, const void* x, void* y, long long rows,
                            long long cols, const void* active, void* stream);

// K2, K3 and p's update each run as one launch. `scratch` holds
// tpucg_reduce_blocks(n) floats of partials, then the int ticket, which must
// be 0 at the first launch (each launch puts it back to 0); launches that
// share a scratch run in stream order.
//
// K3: *out = u . v over n f32.
cudaError_t tpucg_dot_f32(const void* u, const void* v, void* scratch, void* out,
                          long long n, const void* active, void* stream);
// K3, alpha mode: also *alpha = *rsold / *out. alpha_rule 0 divides as is,
// 1 gives 0 where *out is 0 (safe_alpha), 2 gives 0 unless *out > 0 (the
// guarded finish of true-residual solves).
cudaError_t tpucg_dot_alpha_f32(const void* u, const void* v, void* scratch, void* out,
                                const void* rsold, void* alpha, int alpha_rule, long long n,
                                const void* active, void* stream);
// K3, tail mode: *out = rs_new = u . v (r . z), then the lap's tail with the
// lap's r'.r' read from lap->rr; `lap` is a host LapScalars, its active the
// flag. guard != 0: the guarded tail (a step with rs_new <= 0, or NaN, takes
// beta 0 and rsold FLT_MIN).
cudaError_t tpucg_dot_tail_f32(const void* u, const void* v, void* scratch, void* out,
                               const void* lap, int guard, long long n, void* stream);

// K2: xo = x + alpha p, ro = r - alpha ap, *rr = ro . ro, with alpha read
// from device memory. xo may alias x and ro may alias r (in-place update).
cudaError_t tpucg_fused_update_f32(const void* x, const void* r, const void* p,
                                   const void* ap, const void* alpha, void* xo,
                                   void* ro, void* scratch, void* rr, long long n,
                                   const void* active, void* stream);
// K2, tail mode: the same, then the lap's tail with rs_new = rr (guarded
// where guard != 0, as K3's).
cudaError_t tpucg_fused_update_tail_f32(const void* x, const void* r, const void* p,
                                        const void* ap, const void* alpha, void* xo, void* ro,
                                        void* scratch, void* rr, const void* lap, int guard,
                                        long long n, void* stream);
// p = z + *beta p (two roundings) when *step is set, which it then clears;
// nothing when it is 0. z and p f32 (n,), p updated in place.
cudaError_t tpucg_p_update_f32(const void* z, void* p, const void* beta, void* step,
                               void* scratch, long long n, void* stream);

// Partials of an n-element reduction (the scratch holds one int more).
int tpucg_reduce_blocks(long long n);

// K4: one whole CG / PCG solve of A[n, n] x = b in one cooperative launch,
// n % 128 == 0 and n <= 4096, A f32 and 16-byte aligned. precond: 0 none,
// 1 jacobi (minv = 1/diag, n floats), 2 poly of degree `degree` (>= 1). Writes
// x[n], *k (int) and *rr (the last r.r); `scratch` holds
// tpucg_fused_cg_scratch(n) floats. A stays on chip for the whole solve:
// each block's first `slots` rows in shared memory, the rest in L2
// (fused.py dense_resident_plan). blocks_per_sm <= 0 and slots < 0 take the
// plan's; others force them, and a forced plan that does not fit is
// refused. A device without cooperative launch, or a refused launch,
// returns the CUDA error.
cudaError_t tpucg_fused_cg_f32(const void* A, const void* b, const void* x0, const void* minv,
                               void* x, void* k, void* rr, void* scratch, long long n,
                               float tol, long long maxiter, int safe_alpha, int precond,
                               int degree, int blocks_per_sm, int slots, void* stream);
// K4's plan on the current device (blocks_per_sm and slots as above): writes
// its blocks an SM, grid, resident rows a block and dynamic shared bytes to
// out (int[4]).
cudaError_t tpucg_fused_cg_plan(long long n, int blocks_per_sm, int slots, void* out);
long long tpucg_fused_cg_scratch(long long n);

// K5: `batch` independent solves of A[batch, n, n], each on a cluster of
// `cluster` blocks (1, 2, 4 or 8), n % 128 == 0 and n <= 2048; b, x0, minv
// (jacobi != 0) and x are (batch, n), k and rr (batch,). Refuses (and never
// shrinks) a cluster the card cannot hold.
cudaError_t tpucg_fused_batch_cg_f32(const void* A, const void* b, const void* x0,
                                     const void* minv, void* x, void* k, void* rr,
                                     long long batch, long long n, float tol,
                                     long long maxiter, int safe_alpha, int jacobi,
                                     int cluster, void* stream);
// K5's clusters of `cluster` blocks the current device holds at once at
// padded length n (cudaOccupancyMaxActiveClusters), or -error.
int tpucg_fused_batch_clusters(long long n, int cluster);

// K6: y[i] = sum_d data[d, i] * x[i + offsets[d]] (0 outside [0, npad)),
// data (ndiag, npad) f32 or bf16 row-major, x and y f32 (npad,). `offsets`
// is a host array of ndiag int64, 1 <= ndiag <= 64.
cudaError_t tpucg_dia_spmv_f32(const void* data, const void* offsets, int ndiag,
                               const void* x, void* y, long long npad, const void* active,
                               void* stream);
cudaError_t tpucg_dia_spmv_bf16(const void* data, const void* offsets, int ndiag,
                                const void* x, void* y, long long npad, const void* active,
                                void* stream);

// K7: K6 on a row block of blk rows whose columns reach past the block:
// y[i] = sum_d data[d, i] * x_ext[pad + i + offsets[d]] with x_ext = [lo,
// x, hi], lo and hi f32 (pad,) (the neighbours' halos, zeros at the ends of
// the chain), pad >= every |offset|; data (ndiag, blk) f32 or bf16.
cudaError_t tpucg_dia_spmv_halo_f32(const void* data, const void* offsets, int ndiag,
                                    const void* x, const void* lo, const void* hi, void* y,
                                    long long blk, long long pad, const void* active,
                                    void* stream);
cudaError_t tpucg_dia_spmv_halo_bf16(const void* data, const void* offsets, int ndiag,
                                     const void* x, const void* lo, const void* hi, void* y,
                                     long long blk, long long pad, const void* active,
                                     void* stream);

// K6 x k: Y = A X for X and Y f32 (npad, k) row-major, K6's sum for every
// column (column j of Y is K6's y on column j of X, bit for bit); k >= 1.
cudaError_t tpucg_dia_spmv_multi_f32(const void* data, const void* offsets, int ndiag,
                                     const void* x, void* y, long long npad, long long k,
                                     const void* active, void* stream);
cudaError_t tpucg_dia_spmv_multi_bf16(const void* data, const void* offsets, int ndiag,
                                      const void* x, void* y, long long npad, long long k,
                                      const void* active, void* stream);

// K8 x k: Y = A U for U and Y f32 (m^3, k) row-major, K8's sum for every
// column; 2 <= m <= 1280, k >= 1.
cudaError_t tpucg_poisson3d_multi_f32(const void* u, void* y, long long m, long long k,
                                      const void* active, void* stream);

// K8: y = A u for the 7-point Dirichlet Laplacian on an m^3 grid, flat index
// x*m^2 + y*m + z; u and y f32 (m^3,), 2 <= m <= 1280.
cudaError_t tpucg_poisson3d_f32(const void* u, void* y, long long m, const void* active,
                                void* stream);

// K9: K8 on a slab of mp x-planes, u and y f32 (mp * m^2,), the x-neighbours
// beyond the slab taken from the halo planes lo and hi, f32 (m^2,) (zeros
// at the grid's edges); m >= 2, mp >= 1, mp * m^2 < 2^31.
cudaError_t tpucg_poisson3d_slab_f32(const void* u, const void* lo, const void* hi, void* y,
                                     long long m, long long mp, const void* active,
                                     void* stream);

// K8 (lo = hi = null, mp = m) or K9 on a tile forced to tz (a multiple of 4,
// at most 128) x ty lines x nx planes a block, in place of the plan's (the
// card checks and the tile sweep, bench/k8_march.py).
cudaError_t tpucg_poisson3d_march_f32(const void* u, const void* lo, const void* hi, void* y,
                                      long long m, long long mp, int tz, int ty, int nx,
                                      const void* active, void* stream);
// K8/K9's plan for a slab of mp planes of the m^3 grid: writes its tz, ty
// and nx to out (int[3]), as kernels/stencil.py stencil_march_plan gives
// them.
cudaError_t tpucg_poisson3d_march_plan(long long m, long long mp, void* out);

// K10: one whole matrix-free Poisson CG (precond 0) or poly-PCG (2) solve on
// an m^3 grid in one cooperative launch; b, x0, x (m^3,) f32; `scratch`
// holds tpucg_fused_sparse_scratch(m^3) floats. [lo, hi] = [-hi, hi] (hi
// one of 1, m, m^2 and <= 1024, fused.py stencil_tile_plan) holds the
// neighbour offsets read from a tile's shared-memory window; the others are
// read through L2.
cudaError_t tpucg_fused_stencil_cg_f32(const void* b, const void* x0, void* x, void* k,
                                       void* rr, void* scratch, long long m, int lo, int hi,
                                       float tol, long long maxiter, int safe_alpha,
                                       int precond, int degree, void* stream);
// K10's cooperative grid for an m^3 grid on the current device, or minus the
// CUDA error.
int tpucg_fused_stencil_grid(long long m);

// K11: one whole banded CG / Jacobi (minv, npad floats) / poly-PCG solve of
// the DIA matrix (data, host `offsets`) in one cooperative launch; b, x0, x
// (npad,) f32, npad < 2^31; `scratch` holds tpucg_fused_sparse_scratch(npad)
// floats. The slab is f32 or bf16. [lo, hi] (-1024 <= lo <= 0 <= hi <= 1024,
// fused.py dia_tile_plan) holds the offsets read from a tile's shared-memory
// window; the others are read through L2.
cudaError_t tpucg_fused_dia_cg_f32(const void* data, const void* offsets, int ndiag, int lo,
                                   int hi, const void* b, const void* x0, const void* minv,
                                   void* x, void* k, void* rr, void* scratch, long long npad,
                                   float tol, long long maxiter, int safe_alpha, int precond,
                                   int degree, void* stream);
cudaError_t tpucg_fused_dia_cg_bf16(const void* data, const void* offsets, int ndiag, int lo,
                                    int hi, const void* b, const void* x0, const void* minv,
                                    void* x, void* k, void* rr, void* scratch, long long npad,
                                    float tol, long long maxiter, int safe_alpha, int precond,
                                    int degree, void* stream);
// K11's cooperative grid for a padded length npad (bf16: the bf16 slab's
// kernel) on the current device, or minus the CUDA error.
int tpucg_fused_dia_grid(long long npad, int bf16);
long long tpucg_fused_sparse_scratch(long long n);

// K12: `batch` independent banded CG (diag = -1) or Jacobi-PCG (diag = the
// slab row of offset 0) solves, each on W warps; data (batch, ndiag, npad)
// f32 or bf16 with one host `offsets` array of ndiag int64 for all, npad %
// 128 == 0 and npad <= 14464; b, x0 and x (batch, npad) f32, k and rr
// (batch,). warps <= 0 and slab < 0 take the plan's (fused.py
// batch_dia_warps_plan); others force W (1, 2, 4 or 8) and whether the slab
// is copied into shared memory, and a forced plan that cannot run is
// refused.
cudaError_t tpucg_fused_batch_dia_cg_f32(const void* data, const void* offsets, int ndiag,
                                         int diag, const void* b, const void* x0, void* x,
                                         void* k, void* rr, long long batch, long long npad,
                                         float tol, long long maxiter, int safe_alpha,
                                         int warps, int slab, void* stream);
cudaError_t tpucg_fused_batch_dia_cg_bf16(const void* data, const void* offsets, int ndiag,
                                          int diag, const void* b, const void* x0, void* x,
                                          void* k, void* rr, long long batch, long long npad,
                                          float tol, long long maxiter, int safe_alpha,
                                          int warps, int slab, void* stream);
// K12's plan on the current device for a slab of `itemsize` bytes an
// element (warps and slab as above): writes W, x/r/Ap in registers (0/1),
// systems a block, grid, threads a block, dynamic shared bytes a block,
// the vectors' padding, the slab resident (0/1) and a system's shared bytes
// to out (int[9]).
cudaError_t tpucg_fused_batch_dia_plan(long long batch, long long npad, int ndiag, int itemsize,
                                       int warps, int slab, void* out);

// K13: the WELL SpMV over its live slots repacked as rows (gather.cu). For
// each row r < nrows, y[r] is the sum, over j in [rowptr[r], rowptr[r + 1])
// in order, of rvals[j] * x[cols[j]]; rvals f32 or bf16, cols, rowptr and
// tptr int32; x and y f32. Tile t's rows are [tptr[t], tptr[t + 1]), t <
// ntiles; a tile of several rows holds at most `tile` slots, 2 <= tile <=
// 12288 (its products fill tile * 4 bytes of shared memory).
cudaError_t tpucg_well_spmv_f32(const void* rvals, const void* cols, const void* rowptr,
                                const void* tptr, const void* x, void* y, long long nrows,
                                long long ntiles, int tile, const void* active, void* stream);
cudaError_t tpucg_well_spmv_bf16(const void* rvals, const void* cols, const void* rowptr,
                                 const void* tptr, const void* x, void* y, long long nrows,
                                 long long ntiles, int tile, const void* active, void* stream);
// K13 x k: Y = A X over the same layout, X f32 (columns, k) and Y f32
// (nrows, k) row-major, K13's products and sums for every column; k >= 1.
// A row of at most tile / 2 slots is taken by a thread a column group; the
// nlong rows of long_rows (int32, ascending: every row of more than tile / 2
// slots) each by a block of their own.
cudaError_t tpucg_well_spmv_multi_f32(const void* rvals, const void* cols, const void* rowptr,
                                      const void* long_rows, const void* x, void* y,
                                      long long nrows, long long nlong, int tile, long long k,
                                      const void* active, void* stream);
cudaError_t tpucg_well_spmv_multi_bf16(const void* rvals, const void* cols, const void* rowptr,
                                       const void* long_rows, const void* x, void* y,
                                       long long nrows, long long nlong, int tile, long long k,
                                       const void* active, void* stream);

// P1-P7, the gather probes of benchmarks/probe_gather.py (probe.cu): f32
// rows of 128, int32 indices, none of them checked. P1 (and P7):
// o[i, j] = v[i, idx[i, j]], all (rows, 128) and 16-byte aligned, a row a
// warp in blocks of `warps` warps (1 <= warps <= 16). P2: o[i, j] =
// v[idx[i, j], j], v (v_rows, 128), idx and o (rows, 128), all 16-byte
// aligned; run > 0: the staged form, `run` idx rows a block (v_rows <=
// 7264), run == 0: the direct form, an element a thread; `threads` a
// block, a multiple of 32 up to 256. P3: o[i, :] = x2[ridx[i], :], ridx
// (nrows,), x2 and o 16-byte aligned. P4: o[i] = xf[eidx[i]], i < n;
// streamed != 0: 2 elements a thread, the indices and o evict-first. P5: o
// (8, 128) = sum over k < nw of x2[w[k] + r, l], in k order, 1 <= nw <= 1024,
// by bulk copies with `slots` stages of 64 windows in flight (1 <= slots <=
// 4; x2 16-byte aligned). P6: o[i, j] = x[i, (j - *shift) mod 128], shift
// one int32 in device memory, x and o 16-byte aligned, a row a warp in
// blocks of `warps` warps (1 <= warps <= 16).
cudaError_t tpucg_probe_lane_gather_f32(const void* v, const void* idx, void* o, long long rows,
                                        int warps, void* stream);
cudaError_t tpucg_probe_sub_gather_f32(const void* v, const void* idx, void* o,
                                       long long v_rows, long long rows, int run, int threads,
                                       void* stream);
cudaError_t tpucg_probe_row_gather_f32(const void* x2, const void* ridx, void* o,
                                       long long nrows, void* stream);
cudaError_t tpucg_probe_elem_gather_f32(const void* xf, const void* eidx, void* o, long long n,
                                        int streamed, void* stream);
cudaError_t tpucg_probe_dynslice_f32(const void* w, const void* x2, void* o, int nw, int slots,
                                     void* stream);
cudaError_t tpucg_probe_roll_dyn_f32(const void* shift, const void* x, void* o, long long rows,
                                     int warps, void* stream);

// cudaGetErrorString, for the wrappers' error messages.
const char* tpucg_error_string(int err);

}  // extern "C"
