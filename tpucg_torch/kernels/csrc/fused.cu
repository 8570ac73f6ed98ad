// Whole-solve CG for Hopper (sm_90a), behind a plain C ABI.
//
// K4  fused_cg_kernel          replaces tpucg/kernels/fused.py:234 fused_cg_solve_pallas
//                              (_fused_cg_kernel :177, _cg_while :78,
//                              _in_kernel_poly_precond :132)
// K5  fused_batch_cg_kernel    replaces tpucg/kernels/fused.py:610 fused_batch_cg_solve_pallas
//                              (_fused_batch_cg_kernel :560)
// K10 fused_stencil_cg_kernel  replaces tpucg/kernels/fused.py:335
//                              fused_stencil_cg_solve_pallas (_fused_stencil_cg_kernel :301)
// K11 fused_dia_cg_kernel      replaces tpucg/kernels/fused.py:493 fused_dia_cg_solve_pallas
//                              (_fused_dia_cg_kernel :452, _dia_apply_values :421)
// K12 fused_batch_dia_cg_kernel  replaces tpucg/kernels/fused.py:729
//                              fused_batch_dia_cg_solve_pallas (_fused_batch_dia_cg_kernel :694)
//
// All run tpucg's _cg_while contract: r0 = b - A x0, stop at k = 0 when
// r.r < tol^2; each lap alpha = rsold / p.Ap (0 when p.Ap = 0 with
// safe_alpha), x += alpha p, r -= alpha Ap, stop when r.r < tol^2 (p and
// rsold then stay as they were), else z = M^-1 r, p = z + (r.z / rsold) p,
// rsold = r.z; k <= maxiter. They return x, k and the last r.r.
//
// K4, K10 and K11 are one device recurrence (cg_recurrence, tpucg's shared
// _cg_while) over an operator policy: DenseOp (K4), StencilTileOp (K10) and
// DiaTileOp (K11). A policy owns the rows of the matvec and says which
// thread owns which row; the recurrence, its scalars, syncs and
// preconditioners are written once.
//
// What bounds them on an H100 and what the design does about it:
//
// The lap path (a matvec kernel, K2 and K3 enqueued from the host) is bound
// by host enqueue: tens of microseconds of device work per lap cost
// hundreds of microseconds of host time. A whole-solve kernel runs the
// solve in one cooperative launch, so the host enqueues one kernel per
// solve. Inside, a lap is bound by the matvec's bytes and by the latency of
// grid.sync(): two per lap, plus one per extra matvec of the poly
// preconditioner. The grid is sized by the occupancy calculator times the
// SM count (K4: capped at one warp per row; K10/K11: at one thread per
// element and kSparseMaxGrid): more blocks would own no row and only
// lengthen every sync.
//
// Every block must take the same branch, or the next grid.sync() hangs. So
// every scalar (p.Ap, r.r, r.z, the power method's norms) is reduced from
// per-block partials in global scratch: each block sums its threads' values
// in a fixed tree, writes one partial, grid.sync(), and then every block
// sums all partials in the same fixed order. All blocks hold the same bits
// of alpha, beta and the stopping test, and leave the loop on the same lap.
// There are no float atomics (results repeat bit for bit). A partial slot is
// read right after the grid.sync() that follows its writes, so two slots
// alternate: a fast block writing the next phase's partials never overwrites
// those a slow block is still summing.
//
// Vectors the launch writes (p, r, z, the power iterate) are read with
// __ldcg (L2, never the read-only path or L1, which other SMs' writes do not
// update); A, b, x0, the DIA slab and 1/diag are the only __ldg reads. The
// matvec of a lap forms p = z + beta p_old on the fly where it reads it
// (once per element, into shared memory), so p needs no pass (and no sync)
// of its own: the row's owner writes p to the other of two buffers
// while other blocks still read the old one; z and the power iterate are
// double-buffered the same way.
//
// K4 (dense, n <= 4096) stages that input vector (<= 16 KB) in shared
// memory, one warp owns one row (16-byte loads of A, four in flight per
// lane, a fixed shuffle tree), and lane 0 of the row's warp owns that
// element in every elementwise step. Like tpucg's K4, which holds A in VMEM
// for the whole solve, it keeps A on chip (DenseResidentOp): a block's rows
// go to its shared memory once, by bulk copies (cp.async.bulk, one mbarrier
// a row) that the first matvec waits on, and every later matvec (each lap,
// the 13 power iterations and the Neumann terms under poly) reads them
// there; the rows that do not fit are read through L2 under an evict_last
// policy and put back to the normal priority when the solve ends. The plan
// (fused.py dense_resident_plan, dense_plan below) keeps the one-warp-a-row
// grid of n / 8 blocks where all its rows fit (n <= 2048 on an H100: 72 KB
// a block at 2048), so the partials sum as before and x, k and r.r keep
// their bits; at n = 4096 (64 MiB of A) it takes two blocks an SM with 6
// of each block's ~16 rows resident (39 MiB through L2), the fastest of the
// sweep (bench/k4_resident.py; PERF.md section 6, K4).
//
// K10 and K11 keep x, r, p, Ap, z and the power iterate in global memory (8
// MiB each at m = 128: the 50 MB L2 holds the lap's five vectors, 42 MB,
// but not all of them with a slab).
//
// K10 computes the stencil from the grid coordinates, so its lap moves
// vectors only: r and p_old read, p and Ap written by the matvec, x, p, r
// and Ap read and x and r written by the update, 40 bytes a row (84 MB at
// m = 128, 25.0 us at 3.35 TB/s). K11 also streams its slab from device
// memory every lap (58.7 MB at m = 128 in f32, above L2; 17.5 us), the slab
// staying where the operator put it. Both laps are bound less by bytes than
// by chains of dependent loads: at 4 blocks an SM (the recurrence's 64
// registers) a thread walks ~16 rows (m = 128) one memory round trip after
// another in each phase. The design, the same for both:
// - tiles of kDiaTileRows rows, dealt to the blocks in turn (TileRows), so
//   the grid sweeps the rows in order; for each tile the block evaluates the
//   matvec's input g (p = z + beta p_old, the Neumann z, the power iterate,
//   x0) once per element into a shared-memory window that spans the tile
//   widened by the near offsets (|off| <= kDiaHalo: +-1, +-m of the Poisson
//   matrix up to m = 1024, +-m^2 too up to m = 32), and each row reads those
//   columns there; only the far offsets (+-m^2) read z and p_old through L2,
//   where the sweep has them;
// - a thread sums two rows at once and issues all their loads (K11: of
//   kDiaDiagsAPass diagonals) before it adds them, and the window's loads S
//   at a time; K10 selects a neighbour outside the grid as +0 instead of
//   branching around its load, and which neighbours are near is a template
//   argument of its rows' pass (chosen at run time for each load, it put a
//   branch between the loads, and each far load waited for the last: 45.7
//   against 36.2 us a lap at m = 128);
// - the update phase loads two rows' x, p, r, Ap (and 1/diag) before it
//   stores their x and r (each_loaded): the pointers may alias, so a load
//   after a store waited for it, two round trips a row (K10 36.2 -> 34.3 us
//   a lap, K11 60.9 -> 58.7; K4 runs the same code a row at a time);
// - K11's slab is read evict-first (__ldcs), so the lap's vectors keep L2;
// - __launch_bounds__(kBlock, kDiaMinBlocks) holds 4 blocks an SM (without
//   it some K11 builds took 78-80 registers and 3 blocks, 20-24% slower; K10
//   at 6 and 8 blocks an SM spilled at 40 and 32 registers and was no
//   faster, 45.8 and 47.4 against 46.3 us a lap before the template pass).
// The split and the window are planned on the host (fused.py dia_tile_plan,
// stencil_tile_plan); the window's size is fixed (12 KB), so one occupancy
// count a kernel holds for every launch. One contiguous run of n / grid rows
// a block, tried first for K11, was 19% slower at m = 160: the far columns
// left L2 between the block that read them and the block that staged them.
// K10 at m = 128 now takes ~34 us a lap, its vectors' bytes at HBM peak
// 73% of it (PERF.md, PR 10). Left for later: deferring x's update into the
// next lap's matvec, keeping Ap of a block's rows in shared memory (both
// cut bytes), a 2.5-D march over x-planes (K10's far columns from shared
// memory too), the poly Neumann step's read of r after its store of z.
//
// K5 solves B independent dense systems. tpucg's K5 keeps a system's A in
// VMEM while it iterates; here neither one SM's 227 KB (A is 4 MiB at n =
// 1024, 16 MiB at 2048) nor the 50 MB L2 (a batch of 64 x 1000 is 268 MB)
// holds it, so A is re-read from device memory by every matvec. The floor of
// this streaming is the sum over systems of (laps + 1) n^2 4 bytes at 3.35
// TB/s: 0.350 ms for the 64 x 1000 circulant batch of chip_smoke.py, 0.321
// ms for its 16 x 2048 one. One block a system left SMs idle below B = 132
// and bound the last systems to one SM's rate. So each system runs on a
// thread-block cluster of C blocks (C = 1, 2, 4 or 8; kernels/fused.py
// batch_cluster_plan) that stream its rows together:
// - the one-block design's 1,024 threads become virtual threads, block q of
//   the cluster running q T ... (q + 1) T - 1 (T = 1024 / C); row r belongs
//   to virtual warp r % 32 and element i to virtual thread i % 1024, as
//   before, so the blocks read disjoint rows of A;
// - a lane keeps U of its row's 16-byte chunks in flight: 4 at C = 1 (as
//   before), 8 at C = 2 and 4, 16 (a whole row at n = 2048) at C = 8, so an
//   SM holds 32 KB of A in flight or more at the plan's occupancy (two
//   blocks an SM for C > 1, one at C = 8 and B <= 16). The registers route,
//   no ring of bulk copies: C = 1, 4 and 8 take 64, 128 and 158 registers
//   with no spill; C = 2 spills at its 64 (two blocks of 512 an SM); U = 16
//   at C = 4 ran 26% slower at 64 x 1000 (PERF.md section 6, K5);
// - the element's owner keeps x_i and r_i in its shared memory and writes
//   z_i (r_i, or 1/diag_i r_i) into every block's copy of z; a row's owner
//   writes Ap_r into the element owner's shared memory (distributed shared
//   memory: mapa and st.shared::cluster); every block forms the whole of p =
//   z + beta p itself, the same bits in each, so no copy of p is written
//   across the cluster;
// - each scalar (p.Ap, r.r, r.z) is summed in the one-block order: each
//   warp's shuffle tree, its sum into slot q W + w of every block's 32
//   slots, the cluster barrier, then the 32 slots' shuffle tree in every
//   warp. Every block holds the same bits, the cluster leaves on the same
//   lap, and x, k and r.r are the same bits for every C (a lane sums its
//   chunks in order, whatever its loads in flight). No float atomics.
// Two cluster barriers a lap: after p.Ap's slots (Ap at its owners), after
// r.r's and r.z's (z's copies whole). The slots take two sets (p.Ap's and
// the update's): a set is rewritten only after the other set's barrier, which
// every reader of it has passed. A cluster barrier costs a GPU-scope fence
// (MEMBAR.ALL.GPU in the SASS) besides the barrier. A block that stops
// returns; no block writes another's shared memory after the last barrier it
// passes. The plan takes C = 1 once 2 B >= the SMs: a cluster of 2 was
// never faster than one block a system there (PERF.md section 6, K5).
//
// K12 solves B banded systems that share one offsets tuple, each on a few
// warps (W = 4 or 8; fused.py batch_dia_warps_plan) and never a whole
// block: at tpucg's battery (256 x 1024, 3 diagonals) a lap is ~3 us of
// latency, not bytes (its slab, 3 MB, sits in L2), and the kernel before
// this one spent it on one block of 1,024 threads a system: a slab read
// from L2 a lap and seven __syncthreads across 32 warps. Now a system's
// barrier spans its own W warps (a named barrier), three a
// lap; its slab is copied into shared memory once where it fits beside p,
// in its storage type; x, r and Ap of a row stay in the owner's registers
// (n <= 1024); r.r and r.z go through one pass. The sums keep today's
// order through virtual threads (the kernel's note), so x, k and r.r are
// the same bits as before for every W. Its cap is the card's: the n whose
// four vectors fit the 227 KB of shared memory a block may take
// (kFusedBatchDiaMaxN), where x, r and Ap go to shared memory and the slab
// streams from device memory.
#include "blas.cuh"
#include "sparse.cuh"

#include <cooperative_groups.h>

namespace tpucg {
namespace {

namespace cgrp = cooperative_groups;

constexpr int kWarps = kBlock / 32;        // K4: 8 warps a block
constexpr int kBatchBlock = 1024;          // K5, K12: 32 (virtual) warps a system
constexpr int kBatchMaxCluster = 8;        // K5: blocks a system at most (portable cluster)
constexpr int kBatchRowChunks = kFusedBatchMaxN / 128;  // K5: a row's float4s a lane at most
constexpr int kPowerIters = 12;            // tpucg's in-kernel power method
constexpr int kMaxDevices = 16;
constexpr int kSmemPerSm = 233472;         // H100: 228 KB of shared memory an SM
constexpr int kSmemPerBlock = 232448;      // and at most 227 KB a block
constexpr int kSmemReserved = 1024;        // the runtime's share of each block
constexpr int kBatchDiaBlock = 256;        // K12: threads a block at most (systems x W warps)
constexpr int kBatchDiaSlots = 128;        // K12: floats, two sets of two sums of 32 virtual warps
constexpr int kSparseMaxGrid = 4096;       // K10/K11: cap on blocks (sizes their partials)
// K10's and K11's tile (tpucg_torch/kernels/fused.py DIA_TILE_ROWS,
// DIA_TILE_HALO):
// rows a tile, a multiple of 2 kBlock; the largest |offset| read from the
// staged window, which covers +-m of the Poisson matrix up to m = 1024;
// and the window's floats, fixed so that one occupancy count holds for
// every launch (12 KB: eight blocks an SM, the thread limit, still fit).
// Tiles of 1024 and 2048 rows ran within 1% of each other at m = 128 and
// 160, 512 rows 3-5% slower.
constexpr int kDiaTileRows = 1024;
constexpr int kDiaHalo = 1024;
constexpr int kDiaWindow = kDiaTileRows + 2 * kDiaHalo;
constexpr size_t kDiaSmem = kDiaWindow * sizeof(float);
constexpr int kDiaDiagsAPass = 4;  // K11: diagonals whose loads a thread issues at once
constexpr int kDiaStageAPass = 8;  // K10/K11: window elements a thread loads at once
constexpr int kDiaMinBlocks = 4;   // K10/K11: blocks an SM must hold (64 registers a thread)

// K11's slab read: read-only for the launch and read once a lap, so it is
// marked evict-first (streaming): the lap's vectors keep their L2 lines.
__device__ __forceinline__ float dia_slab_load(const float* p) { return __ldcs(p); }
__device__ __forceinline__ uint16_t dia_slab_load(const uint16_t* p) { return __ldcs(p); }

enum Precond : int { kNone = 0, kJacobi = 1, kPoly = 2 };

// The warp's shuffle-down tree: lane 0 gets the sum of v over the warp.
__device__ __forceinline__ float warp_sum_down(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over a block of `threads` threads (whole warps), returned to
// every thread: a shuffle tree in each warp, then warp 0 sums the warp
// results in warp order. `red` is 33 floats of shared memory, free again on
// return.
template <int threads>
__device__ __forceinline__ float block_allsum(float v, float* red) {
  constexpr int warps = threads / 32;
  v = warp_sum_down(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const float s = warp_sum_down(lane < warps ? red[lane] : 0.f);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  const float out = red[32];
  __syncthreads();
  return out;
}

// One row of A (n floats, 16-byte aligned, read-only for the launch) times
// the vector staged in shared memory, summed over the warp: every lane gets
// the result. `load(c)` gives the row's 16-byte chunk c from wherever the
// row lies (device memory through the read-only path, shared memory, or L2
// under a cache policy). Lanes take neighbouring chunks, U loads in flight,
// and the row's ragged end V at a time (K4: U = 4, V = 1; K5: V = U, one
// group whose loads past the row are skipped). A lane sums its chunks c,
// c + 32, ... in that order whatever U and V are and wherever the row lies,
// so the result's bits depend on neither. row_group sums one group of U
// chunks of a lane from c on: all of them (Whole) or those below nchunks.
// The loops' unrolling is fixed: left to the compiler, K4's build took 128
// registers and spilled; pinned to 1, it ran 6-8% slower at n = 4096
// (PERF.md section 6, K4).
template <int U, bool Whole, class L>
__device__ __forceinline__ float row_group(L load, const float4* v, int c, int nchunks,
                                           float acc) {
  float4 a[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (Whole || c + 32 * u < nchunks) a[u] = load(c + 32 * u);
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (Whole || c + 32 * u < nchunks) {
      const float4 x = v[c + 32 * u];
      acc = fmaf(a[u].x, x.x, acc);
      acc = fmaf(a[u].y, x.y, acc);
      acc = fmaf(a[u].z, x.z, acc);
      acc = fmaf(a[u].w, x.w, acc);
    }
  return acc;
}
template <int U, int V, class L>
__device__ __forceinline__ float row_dot(L load, const float4* v, int nchunks, int lane) {
  float acc = 0.f;
  int c = lane;
#pragma unroll 2
  for (; c + 32 * (U - 1) < nchunks; c += 32 * U)
    acc = row_group<U, true>(load, v, c, nchunks, acc);
#pragma unroll 1
  for (; c < nchunks; c += 32 * V) acc = row_group<V, V == 1>(load, v, c, nchunks, acc);
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}
// A row of A read through the read-only path (K5).
struct LdgRow {
  const float4* __restrict__ a4;
  __device__ float4 operator()(int c) const { return __ldg(a4 + c); }
};

__device__ __forceinline__ float safe_div(float num, float den, int safe) {
  return (safe && den == 0.f) ? 0.f : num / den;
}

// The operands and outputs of one whole solve (K4, K10, K11).
struct SolveArgs {
  const float* b;     // (n,)
  const float* x0;    // (n,)
  const float* minv;  // (n,) 1/diag for jacobi, else unused
  float* x;           // (n,) out
  int* k_out;         // 0-d out
  float* rr_out;      // 0-d out
  float* scratch;     // 8 n floats, then the partials: 2 slots x 2 sums x grid
  int n;
  float tol;
  long long maxiter;
  int safe_alpha;
  int precond;
  int degree;         // poly degree: degree - 1 extra matvecs per apply
};

// Operator policies. matvec(g, f) calls f(i, v_i, (A v)_i) for every row i
// this thread owns, where v_j = g(j); each_loaded(load, store) calls
// store(i, load(i)) for the same rows (K10, K11: two rows' loads before
// their stores).
// A thread owns the same rows in every phase, so an element's owner reads
// back what it wrote itself; g may read any element. The recurrence ends
// every matvec with a block-wide sync (end_phase) before the next one.

// K4's on-chip A: bulk copies global -> shared completed on an mbarrier,
// and L2 reads under an evict_last policy (PTX, sm_90).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global `src` to shared `dst`; `bar`, initialised for one arrival, completes
// its phase 0 when they have landed.
__device__ __forceinline__ void bulk_copy_to_shared(void* dst, const void* src, unsigned bytes,
                                                    uint64_t* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1u) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(b)
      : "memory");
}
// Waits until `bar`'s phase 0 has completed (at once ever after).
__device__ __forceinline__ void wait_phase0(uint64_t* bar) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(0u)
        : "memory");
}
__device__ __forceinline__ uint64_t l2_evict_last_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}
// A row of A read through the read-only path, its lines kept in L2 under
// `policy` (evict_last), so that a row read every matvec stays there.
struct L2Row {
  const float4* a4;
  uint64_t policy;
  __device__ float4 operator()(int c) const {
    float4 v;
    asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "l"(a4 + c), "l"(policy));
    return v;
  }
};
// A row of A resident in shared memory.
struct SmemRow {
  const float4* a4;
  __device__ float4 operator()(int c) const { return a4[c]; }
};

// K4: one warp a row, rows gwarp, gwarp + nwarps, ... (the grid's warps in
// turn); g is evaluated once per element into shared memory. The warp's
// j-th row is its block's row q = j kWarps + warp: rows q < slots are
// resident in shared memory, copied there once by the launch's first
// matvec (stage(), a bulk copy a row completed on the row's mbarrier, which
// that first matvec waits on); the others are read through L2 under
// evict_last in every matvec. Whatever the row's place, row_dot sums the
// same chunks in the same order, so (A v)_row has the same bits.
struct DenseResidentOp {
  const float* __restrict__ A;
  float* vs;           // n floats of dynamic shared memory: the staged matvec input
  const float* rows;   // slots x n floats of dynamic shared memory: the resident rows
  uint64_t* bars;      // slots mbarriers: row q has landed
  int n, slots;
  int lane, warp, gwarp, nwarps;
  uint64_t policy;     // L2 evict_last, for the rows read through L2

  // The power method's seed element j, written before the launch into the
  // buffer its first step reads (power_seed_kernel).
  __device__ __forceinline__ float power_seed(long long j, const float* seed) const {
    return __ldcg(seed + j);
  }
  // Lane 0 of each warp starts the bulk copies of its resident rows.
  __device__ void stage() const {
    if (lane == 0)
      for (int row = gwarp, q = warp; row < n && q < slots; row += nwarps, q += kWarps)
        bulk_copy_to_shared(const_cast<float*>(rows) + static_cast<size_t>(q) * n,
                            A + static_cast<size_t>(row) * n, 4u * n, bars + q);
    __syncwarp();
  }
  template <class G, class F>
  __device__ __forceinline__ void matvec(G g, F f) const {
    for (int i = threadIdx.x; i < n; i += kBlock) vs[i] = g(i);
    __syncthreads();
    const float4* vs4 = reinterpret_cast<const float4*>(vs);
    for (int row = gwarp, q = warp; row < n; row += nwarps, q += kWarps) {
      float av;
      if (q < slots) {
        wait_phase0(bars + q);
        const float* arow = rows + static_cast<size_t>(q) * n;
        av = row_dot<4, 1>(SmemRow{reinterpret_cast<const float4*>(arow)}, vs4, n / 4, lane);
      } else {
        const float* arow = A + static_cast<size_t>(row) * n;
        av = row_dot<4, 1>(L2Row{reinterpret_cast<const float4*>(arow), policy}, vs4, n / 4,
                           lane);
      }
      if (lane == 0) f(row, vs[row], av);
    }
  }
  template <class L, class S>
  __device__ __forceinline__ void each_loaded(L load, S store) const {
    if (lane == 0)
      for (int row = gwarp; row < n; row += nwarps) store(row, load(row));
  }
  // Puts the lines of the rows read through L2 back to the normal eviction
  // priority, so that nothing of the launch's policy outlives it.
  __device__ void release() const {
    int q = warp;
    for (int row = gwarp; row < n; row += nwarps, q += kWarps)
      if (q >= slots)
        for (int line = lane; line < n / 32; line += 32)
          asm volatile("applypriority.global.L2::evict_normal [%0], 128;"
                       ::"l"(A + static_cast<size_t>(row) * n + 32 * line)
                       : "memory");
  }
};

// Tiles of kDiaTileRows contiguous rows (K10, K11): tile k = [k T,
// min((k + 1) T, n)) belongs to block k % grid (a block may own none), and
// thread t owns rows k T + t + kBlock j of its tiles in every phase, so the
// grid sweeps the rows in order like a grid-stride loop and a far column
// (+-m^2) is read while its neighbours are in L2.
struct TileRows {
  int n;
  int first, step;  // this block's first tile's row, the rows between its tiles
  __device__ explicit TileRows(int n_)
      : n(n_), first(static_cast<int>(blockIdx.x) * kDiaTileRows),
        step(static_cast<int>(gridDim.x) * kDiaTileRows) {}
  // The power method's seed element j, cos(0.7 j) + 0.1.
  __device__ __forceinline__ float power_seed(long long j, const float*) const {
    return cosf(static_cast<float>(j) * 0.7f) + 0.1f;
  }
  // A step that loads a row's operands (load(i) -> state) before it stores
  // (store(i, state)): two rows a pass, both rows' loads first, then the
  // stores, in row order for each thread.
  template <class L, class S>
  __device__ __forceinline__ void each_loaded(L load, S store) const {
    for (int t0 = first; t0 < n; t0 += step) {
      const int t1 = min(t0 + kDiaTileRows, n);
      for (int i0 = t0 + threadIdx.x; i0 < t1; i0 += 2 * kBlock) {
        const bool has1 = i0 + kBlock < t1;
        const auto u0 = load(i0);
        const auto u1 = load(has1 ? i0 + kBlock : i0);
        store(i0, u0);
        if (has1) store(i0 + kBlock, u1);
      }
    }
  }
};

// Stages g(base + j) into win[j] for j in [0, len), once per element, 0
// where base + j lies outside [0, n). g is called at an index clamped into
// [0, n), with no branch around it, so that every load of the S elements a
// thread takes at once is in flight before any is used.
template <class G>
__device__ __forceinline__ void stage_window(float* win, G g, int base, int len, int n) {
  constexpr int S = kDiaStageAPass;
  for (int j0 = threadIdx.x; j0 < len; j0 += S * kBlock) {
    float v[S];
#pragma unroll
    for (int u = 0; u < S; ++u) v[u] = g(min(max(base + j0 + u * kBlock, 0), n - 1));
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int j = j0 + u * kBlock;
      if (j < len) win[j] = (base + j >= 0 && base + j < n) ? v[u] : 0.f;
    }
  }
}

// K10: the 7-point stencil on an m^3 grid in tiles (TileRows). matvec
// stages g over a tile's window [t0 + lo, t1 + hi) in shared memory, once
// per element; [lo, hi] = [-hi, hi] holds the near offsets of the Poisson
// matrix's (-m^2, -m, -1, 0, 1, m, m^2) (fused.py stencil_tile_plan: +-1
// always, +-m up to m = 1024, +-m^2 up to m = 32). A row reads a near
// neighbour from the window and a far one through g (L2) at an index
// clamped into [0, n). Which offsets are near is a template argument of
// the rows' pass (chosen once a tile), so a pass is one run of code with no
// branch between its loads: a thread sums two rows at once, all their loads
// issued before the first subtraction. Each row's sum is K8's (sparse.cu),
// term by term in its order with __fmul_rn / __fsub_rn, a neighbour outside
// the grid selected as +0 rather than skipped (acc - (+0) is acc bit for
// bit, -0 included), so (A v)_i is K8's bit for bit.
struct StencilTileOp : TileRows {
  float* win;  // kDiaWindow floats of dynamic shared memory
  int m, mm, lo, hi;
  __device__ StencilTileOp(float* win_, int m_, int lo_, int hi_)
      : TileRows(m_ * m_ * m_), win(win_), m(m_), mm(m_ * m_), lo(lo_), hi(hi_) {}

  // The rows of [t0, t1) this thread owns, the window staged from `base`;
  // +-m^2 near when XNear, +-m near when YNear.
  template <bool XNear, bool YNear, class G, class F>
  __device__ __forceinline__ void rows(G g, F f, int t0, int t1, int base) const {
    for (int i0 = t0 + threadIdx.x; i0 < t1; i0 += 2 * kBlock) {
      const bool has1 = i0 + kBlock < t1;
      // A second row past the tile repeats the first's loads.
      const int row[2] = {i0, has1 ? i0 + kBlock : i0};
      float v[2][7];  // v_i, then x+1, x-1, y+1, y-1, z+1, z-1
      bool in[2][6];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = row[e];
        const int ix = i / mm;
        const int rem = i - ix * mm;
        const int iy = rem / m;
        const int iz = rem - iy * m;
        in[e][0] = ix < m - 1;
        in[e][1] = ix > 0;
        in[e][2] = iy < m - 1;
        in[e][3] = iy > 0;
        in[e][4] = iz < m - 1;
        in[e][5] = iz > 0;
        const float* w = win + (i - base);
        v[e][0] = w[0];
        v[e][1] = XNear ? w[mm] : g(min(i + mm, n - 1));
        v[e][2] = XNear ? w[-mm] : g(max(i - mm, 0));
        v[e][3] = YNear ? w[m] : g(min(i + m, n - 1));
        v[e][4] = YNear ? w[-m] : g(max(i - m, 0));
        v[e][5] = w[1];
        v[e][6] = w[-1];
      }
      float acc[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc[e] = __fmul_rn(6.f, v[e][0]);
#pragma unroll
        for (int t = 0; t < 6; ++t) acc[e] = __fsub_rn(acc[e], in[e][t] ? v[e][t + 1] : 0.f);
      }
      f(row[0], v[0][0], acc[0]);
      if (has1) f(row[1], v[1][0], acc[1]);
    }
  }

  template <class G, class F>
  __device__ __forceinline__ void matvec(G g, F f) const {
    for (int t0 = first; t0 < n; t0 += step) {
      const int t1 = min(t0 + kDiaTileRows, n);
      const int base = t0 + lo;
      if (t0 != first) __syncthreads();  // every row of the last tile is summed
      stage_window(win, g, base, t1 - t0 + hi - lo, n);
      __syncthreads();
      if (mm <= hi)
        rows<true, true>(g, f, t0, t1, base);
      else if (m <= hi)
        rows<false, true>(g, f, t0, t1, base);
      else
        rows<false, false>(g, f, t0, t1, base);
    }
  }
};

// K11: the DIA matrix (slab (ndiag, n), f32 or bf16) in tiles (TileRows).
// matvec stages g over a tile's window [t0 + lo, t1 + hi) in shared memory,
// once per element (0 outside [0, n), dia_row's rule); a row reads column
// i + off from there when lo <= off <= hi (the near offsets, all within
// kDiaHalo) and through g otherwise (the far ones). Each row's sum is
// dia_sum's, term by term in offsets order, so (A v)_i is dia_row's bit for
// bit. A thread sums two rows at once and issues the slab and column loads
// of kDiaDiagsAPass diagonals before it adds them, keeping the slab's raw
// values until the sum (a bf16 value widened where it lands made each load
// wait for the last).
template <typename T>
struct DiaTileOp : TileRows {
  const T* __restrict__ data;
  const DiaOffsets& offs;
  float* win;  // kDiaWindow floats of dynamic shared memory
  int lo, hi;
  __device__ DiaTileOp(const T* data_, const DiaOffsets& offs_, float* win_, int n_, int lo_,
                       int hi_)
      : TileRows(n_), data(data_), offs(offs_), win(win_), lo(lo_), hi(hi_) {}
  template <class G, class F>
  __device__ __forceinline__ void matvec(G g, F f) const {
    constexpr int D = kDiaDiagsAPass;
    for (int t0 = first; t0 < n; t0 += step) {
      const int t1 = min(t0 + kDiaTileRows, n);
      const int base = t0 + lo;
      if (t0 != first) __syncthreads();  // every row of the last tile is summed
      stage_window(win, g, base, t1 - t0 + hi - lo, n);
      __syncthreads();
      for (int i0 = t0 + threadIdx.x; i0 < t1; i0 += 2 * kBlock) {
        const int i1 = i0 + kBlock;
        const bool has1 = i1 < t1;
        float acc0 = 0.f, acc1 = 0.f;
        for (int d0 = 0; d0 < offs.ndiag; d0 += D) {
          T a0[D], a1[D];  // raw: widened where they are summed
          float x0[D], x1[D];
#pragma unroll
          for (int e = 0; e < D; ++e) {
            a0[e] = T(0);
            a1[e] = T(0);
            x0[e] = 0.f;
            x1[e] = 0.f;
            if (d0 + e < offs.ndiag) {
              const long long off = offs.off[d0 + e];
              const T* col = data + static_cast<long long>(d0 + e) * n;
              const long long c0 = i0 + off, c1 = i1 + off;
              a0[e] = dia_slab_load(col + i0);
              if (has1) a1[e] = dia_slab_load(col + i1);
              if (off >= lo && off <= hi) {
                x0[e] = win[c0 - base];
                if (has1) x1[e] = win[c1 - base];
              } else {
                x0[e] = (c0 >= 0 && c0 < n) ? g(c0) : 0.f;
                if (has1) x1[e] = (c1 >= 0 && c1 < n) ? g(c1) : 0.f;
              }
            }
          }
#pragma unroll
          for (int e = 0; e < D; ++e)
            if (d0 + e < offs.ndiag) {
              acc0 = __fadd_rn(acc0, __fmul_rn(widen(a0[e]), x0[e]));
              acc1 = __fadd_rn(acc1, __fmul_rn(widen(a1[e]), x1[e]));
            }
        }
        f(i0, win[i0 - base], acc0);
        if (has1) f(i1, win[i1 - base], acc1);
      }
    }
  }
};

// tpucg's _cg_while (with _in_kernel_poly_precond) over the operator `op`.
template <class Op>
__device__ void cg_recurrence(const Op& op, const SolveArgs& a) {
  cgrp::grid_group grid = cgrp::this_grid();
  __shared__ float red[33];
  const size_t n = static_cast<size_t>(a.n);
  const int nblocks = static_cast<int>(gridDim.x);
  const float tol2 = a.tol * a.tol;

  // Scratch: r | p[2] | ap | z[2] | y[2] | partials: 2 slots x 2 sums x grid.
  float* r = a.scratch;
  // Buffer i of p, z and y, by its offset: an array of pointers indexed at
  // run time lives on the stack, and a choice between two pointers keeps
  // both in registers (K4 spilled).
  auto pb = [&](int i) { return r + (1 + i) * n; };
  float* ap = r + 3 * n;
  auto zb = [&](int i) { return r + (4 + i) * n; };
  auto yb = [&](int i) { return r + (6 + i) * n; };
  float* partials = r + 8 * n;
  int slot = 0;

  // Ends a phase: the block's sums of s0 and s1 go to the current partial
  // slot, grid.sync(), and every block sums the slot in one fixed order.
  auto end_phase = [&](float s0, float s1, float& t0, float& t1) {
    float* part = partials + slot * 2 * nblocks;
    s0 = block_allsum<kBlock>(s0, red);
    s1 = block_allsum<kBlock>(s1, red);
    if (threadIdx.x == 0) {
      part[blockIdx.x] = s0;
      part[nblocks + blockIdx.x] = s1;
    }
    grid.sync();
    float u0 = 0.f, u1 = 0.f;
    for (int i = threadIdx.x; i < nblocks; i += kBlock) {
      u0 += __ldcg(part + i);
      u1 += __ldcg(part + nblocks + i);
    }
    t0 = block_allsum<kBlock>(u0, red);
    t1 = block_allsum<kBlock>(u1, red);
    slot ^= 1;
  };

  // w of the polynomial preconditioner: 12 power iterations from the fixed
  // seed cos(0.7 i) + 0.1, then lam = v.Av / (v.v + 1e-30), w = 0.95 / lam.
  float w = 0.f;
  if (a.precond == kPoly) {
    float scale = 0.f, lam = 0.f;
    for (int it = 0; it <= kPowerIters; ++it) {
      const float* yprev = yb((it + 1) & 1);
      float* ynext = yb(it & 1);
      float s0 = 0.f, s1 = 0.f;
      op.matvec(
          [&](long long j) {
            return it == 0 ? op.power_seed(j, yprev) : __ldcg(yprev + j) * scale;
          },
          [&](long long row, float v, float av) {
            if (it < kPowerIters) {
              ynext[row] = av;
              s0 += av * av;
            } else {
              s0 += v * av;
              s1 += v * v;
            }
          });
      float t0, t1;
      end_phase(s0, s1, t0, t1);
      if (it < kPowerIters)
        scale = 1.f / sqrtf(t0 + 1e-30f);
      else
        lam = t0 / (t1 + 1e-30f);
    }
    w = 0.95f / fmaxf(lam, 1e-30f);
  }

  // 1/diag of the row under jacobi (else 0), read before the row's stores.
  // Keyed on the pointer, which the launches pass for jacobi only: keyed on
  // the preconditioner, K4's build took 48 registers and spilled (5% slower
  // at n = 4096).
  auto minv_of = [&](long long row) -> float {
    return a.minv != nullptr ? __ldg(a.minv + row) : 0.f;
  };
  // z = M^-1 r for the row's owner (jacobi, mv = minv_of(row), and the first
  // Neumann term of poly, z0 = w r); returns the row's share of r.z where
  // it is final.
  auto first_z = [&](long long row, float rv, float mv) -> float {
    if (a.precond == kJacobi) {
      const float z = mv * rv;
      zb(0)[row] = z;
      return rv * z;
    }
    if (a.precond == kPoly) {
      const float z = w * rv;
      zb(0)[row] = z;
      return a.degree <= 1 ? rv * z : 0.f;
    }
    return 0.f;
  };
  // The remaining degree - 1 Neumann terms, z = z + w r - w A z, one
  // matvec and one grid.sync() each; returns r.z and the buffer holding z.
  auto neumann = [&](float rz, int& zi) -> float {
    zi = 0;
    for (int j = 1; j < a.degree; ++j) {
      const float* zsrc = zb(zi);
      float* zdst = zb(zi ^ 1);
      float s1 = 0.f;
      op.matvec([&](long long i) { return __ldcg(zsrc + i); },
                [&](long long row, float zv, float az) {
                  const float rv = r[row];
                  const float zn = zv + w * rv - w * az;
                  zdst[row] = zn;
                  s1 += rv * zn;
                });
      float t0;
      end_phase(0.f, s1, t0, rz);
      zi ^= 1;
    }
    return rz;
  };

  // r0 = b - A x0; x = x0; p_old = 0, so the first lap's p = z + 0 p = z.
  float s0 = 0.f, s1 = 0.f;
  op.matvec([&](long long j) { return __ldg(a.x0 + j); },
            [&](long long row, float xv, float av) {
              const float bv = __ldg(a.b + row), mv = minv_of(row);
              a.x[row] = xv;
              const float rv = bv - av;
              r[row] = rv;
              pb(0)[row] = 0.f;
              s0 += rv * rv;
              s1 += first_z(row, rv, mv);
            });
  float rr, rz;
  end_phase(s0, s1, rr, rz);
  int zi = 0;
  if (a.precond == kPoly && a.degree > 1) rz = neumann(rz, zi);
  if (a.precond == kNone) rz = rr;
  float rsold = rz, beta = 0.f;
  int cur = 0;  // pb(cur) holds p
  long long k = 0;
  bool done = rr < tol2;

  while (!done && k < a.maxiter) {
    // p = z + beta p_old, evaluated where the matvec reads it; the row
    // owners write it to the other buffer. Ap and p.Ap.
    const float* zsrc = a.precond == kNone ? r : zb(zi);
    const float* pold = pb(cur);
    float* pnew = pb(cur ^ 1);
    s0 = 0.f;
    op.matvec([&](long long j) { return __ldcg(zsrc + j) + beta * __ldcg(pold + j); },
              [&](long long row, float pv, float av) {
                pnew[row] = pv;
                ap[row] = av;
                s0 += pv * av;
              });
    cur ^= 1;
    float pap, unused;
    end_phase(s0, 0.f, pap, unused);
    const float alpha = safe_div(rsold, pap, a.safe_alpha);

    // x += alpha p, r -= alpha Ap, r.r and (PCG) z, r.z: row owners only.
    // Two rows' loads go out before their stores: the pointers may alias,
    // so a load issued after a store would wait for it (K10 and K11 took
    // two round trips a row).
    s0 = 0.f;
    s1 = 0.f;
    const float* p = pb(cur);
    struct RowIn {
      float x, p, r, ap, mv;
    };
    op.each_loaded(
        [&](long long row) { return RowIn{a.x[row], p[row], r[row], ap[row], minv_of(row)}; },
        [&](long long row, const RowIn& u) {
          a.x[row] = u.x + alpha * u.p;
          const float rv = u.r - alpha * u.ap;
          r[row] = rv;
          s0 += rv * rv;
          s1 += first_z(row, rv, u.mv);
        });
    end_phase(s0, s1, rr, rz);
    ++k;
    done = rr < tol2;
    if (done) break;
    if (a.precond == kPoly && a.degree > 1) rz = neumann(rz, zi);
    if (a.precond == kNone) rz = rr;
    beta = rz / rsold;
    rsold = rz;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.k_out = static_cast<int>(k);
    *a.rr_out = rr;
  }
}

// K4 under poly: the power method's seed, cos(0.7 j) + 0.1, written into
// the scratch's second y buffer (which the power method's first step reads
// and its second overwrites) by a kernel of its own before the solve's
// launch: cosf's reduction of a large argument keeps a 28-byte array on the
// stack, which would otherwise sit in K4 (0.7 j < 2868 never takes it).
__global__ void __launch_bounds__(kBlock) power_seed_kernel(float* seed, int n) {
  const int j = static_cast<int>(blockIdx.x) * kBlock + static_cast<int>(threadIdx.x);
  if (j < n) seed[j] = cosf(static_cast<float>(j) * 0.7f) + 0.1f;
}

// K4's dynamic shared memory (dense_smem): the rows' mbarriers (padded to
// 16 bytes), the staged input (n floats), the resident rows (slots x n).
// Two blocks an SM at most (the plan's): without a minimum, ptxas held the
// kernel to 64 registers and spilled.
__global__ void __launch_bounds__(kBlock, 2)
fused_cg_kernel(const __grid_constant__ SolveArgs s, const float* __restrict__ A, int slots) {
  extern __shared__ float4 dense_smem4[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(dense_smem4);
  float* vs = reinterpret_cast<float*>(dense_smem4 + (slots + 1) / 2);
  const int gwarp = static_cast<int>((blockIdx.x * kBlock + threadIdx.x) >> 5);
  const DenseResidentOp op{A, vs, vs + s.n, bars, s.n, slots,
                           static_cast<int>(threadIdx.x & 31), static_cast<int>(threadIdx.x >> 5),
                           gwarp, static_cast<int>(gridDim.x) * kWarps, l2_evict_last_policy()};
  op.stage();
  cg_recurrence(op, s);
  op.release();
}

__global__ void __launch_bounds__(kBlock, kDiaMinBlocks)
fused_stencil_cg_kernel(const __grid_constant__ SolveArgs s, int m, int lo, int hi) {
  extern __shared__ float stencil_window[];  // kDiaWindow floats
  const StencilTileOp op(stencil_window, m, lo, hi);
  cg_recurrence(op, s);
}

template <typename T>
__global__ void __launch_bounds__(kBlock, kDiaMinBlocks)
fused_dia_cg_kernel(const __grid_constant__ SolveArgs s, const T* __restrict__ data,
                    const __grid_constant__ DiaOffsets offs, int lo, int hi) {
  extern __shared__ float dia_window[];  // kDiaWindow floats
  const DiaTileOp<T> op(data, offs, dia_window, s.n, lo, hi);
  cg_recurrence(op, s);
}

struct BatchArgs {
  const float* A;     // (B, n, n), read-only
  const float* b;     // (B, n)
  const float* x0;    // (B, n)
  const float* minv;  // (B, n) 1/diag for jacobi, else unused
  float* x;           // (B, n) out
  int* k_out;         // (B,) out
  float* rr_out;      // (B,) out
  int n;
  float tol;
  long long maxiter;
  int safe_alpha;
  int jacobi;
};

// K5's cluster of C blocks, one system's (C = 1: the block alone, whose
// barrier is __syncthreads and whose shared memory is its own).
template <int C>
struct SystemCluster {
  __device__ static unsigned rank() {
    if constexpr (C == 1) return 0;
    else return cgrp::this_cluster().block_rank();
  }
  // Every thread of the C blocks arrives; shared-memory writes to any block
  // before it are seen by every block after it (release / acquire).
  __device__ static void sync() {
    if constexpr (C == 1) __syncthreads();
    else cgrp::this_cluster().sync();
  }
  // Writes v to `local`'s counterpart in block r's shared memory, through
  // its 32-bit cluster address (mapa; a generic map_shared_rank pointer
  // holds two registers).
  __device__ static void put(float* local, unsigned r, float v) {
    if constexpr (C == 1) {
      *local = v;
    } else {
      const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(local));
      unsigned remote;
      asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(a), "r"(r));
      asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote), "f"(v) : "memory");
    }
  }
};

// K5 on a cluster of C blocks of T = kBatchBlock / C threads a system (the
// design note above): thread t of block q is virtual thread v = q T + t,
// which owns elements v, v + 1024, ... (x, r, Ap in its block's shared
// memory); its virtual warp v / 32 owns rows v / 32, v / 32 + 32, ...
template <int C>
__global__ void __launch_bounds__(kBatchBlock / C, C == 1 ? 1 : 2)
fused_batch_cg_kernel(BatchArgs a) {
  using Cl = SystemCluster<C>;
  constexpr int T = kBatchBlock / C;
  constexpr int U = C == 1 ? 4 : C == kBatchMaxCluster ? kBatchRowChunks : 8;
  extern __shared__ float4 sm4[];     // x | r | p | Ap | z, n floats each (p, z whole)
  __shared__ float slots[2][2][32];   // [p.Ap | r.r, r.z][sum][virtual warp]
  const int n = a.n;
  const int nchunks = n / 4;
  float* xs = reinterpret_cast<float*>(sm4);
  float* rs = xs + n;
  float* ps = rs + n;
  float* aps = ps + n;
  float* zs = aps + n;
  const float4* ps4 = sm4 + 2 * nchunks;
  const size_t sys = blockIdx.x / C;
  const float* A = a.A + sys * n * n;
  const float* b = a.b + sys * n;
  const float* x0 = a.x0 + sys * n;
  const float* minv = a.jacobi ? a.minv + sys * n : nullptr;
  const int lane = threadIdx.x & 31;
  const int vt = static_cast<int>(Cl::rank()) * T + static_cast<int>(threadIdx.x);
  const int vw = vt >> 5;
  const float tol2 = a.tol * a.tol;

  // Ap of this block's rows for p in ps (its own copy), each Ap_r written
  // to element r's owner; lane 0 of the row's warp adds p.Ap's terms in row
  // order.
  auto matvec = [&]() -> float {
    float s = 0.f;
    for (int row = vw; row < n; row += 32) {
      const float av = row_dot<U, U>(
          LdgRow{reinterpret_cast<const float4*>(A + static_cast<size_t>(row) * n)}, ps4,
          nchunks, lane);
      if (lane == 0) {
        Cl::put(aps + row, (row & (kBatchBlock - 1)) / T, av);
        s += ps[row] * av;
      }
    }
    return s;
  };
  // z_i = M^-1 r_i (r_i without jacobi) for the owner of element i, into
  // every block's copy of z.
  auto put_z = [&](int i, float rv) -> float {
    const float z = minv ? __ldg(minv + i) * rv : rv;
#pragma unroll
    for (unsigned r = 0; r < C; ++r) Cl::put(zs + i, r, z);
    return z;
  };
  // The sums of s0 (and s1 when `two`) over the 1024 virtual threads in the
  // one-block order: each warp's shuffle tree into slot vw of slot set `set`
  // in every block, the cluster barrier, then every warp's tree over the 32
  // slots. Every block gets the same bits.
  auto allsum = [&](int set, float s0, float s1, bool two, float& t0, float& t1) {
    s0 = warp_sum_down(s0);
    if (two) s1 = warp_sum_down(s1);
    if (lane == 0) {
#pragma unroll
      for (unsigned r = 0; r < C; ++r) {
        Cl::put(&slots[set][0][vw], r, s0);
        if (two) Cl::put(&slots[set][1][vw], r, s1);
      }
    }
    Cl::sync();
    t0 = __shfl_sync(0xffffffffu, warp_sum_down(slots[set][0][lane]), 0);
    if (two) t1 = __shfl_sync(0xffffffffu, warp_sum_down(slots[set][1][lane]), 0);
  };

  for (int i = threadIdx.x; i < n; i += T) ps[i] = __ldg(x0 + i);
  for (int i = vt; i < n; i += kBatchBlock) xs[i] = __ldg(x0 + i);
  Cl::sync();  // every block of the cluster runs and holds p = x0
  matvec();
  Cl::sync();  // Ap complete at every element's owner
  float s0 = 0.f, s1 = 0.f;
  for (int i = vt; i < n; i += kBatchBlock) {
    const float rv = __ldg(b + i) - aps[i];
    rs[i] = rv;
    const float z = put_z(i, rv);
    s0 += rv * rv;
    s1 += rv * z;
  }
  float rr, rsold;
  allsum(1, s0, s1, minv != nullptr, rr, rsold);  // also: every copy of z whole
  if (!minv) rsold = rr;
  for (int i = threadIdx.x; i < n; i += T) ps[i] = zs[i];
  __syncthreads();
  long long k = 0;
  bool done = rr < tol2;
  while (!done && k < a.maxiter) {
    float pap, unused;
    allsum(0, matvec(), 0.f, false, pap, unused);  // also: Ap complete at the owners
    const float alpha = safe_div(rsold, pap, a.safe_alpha);
    s0 = 0.f;
    s1 = 0.f;
    for (int i = vt; i < n; i += kBatchBlock) {
      xs[i] = xs[i] + alpha * ps[i];
      const float rv = rs[i] - alpha * aps[i];
      rs[i] = rv;
      const float z = put_z(i, rv);
      s0 += rv * rv;
      s1 += minv ? rv * z : 0.f;
    }
    float rz;
    allsum(1, s0, s1, minv != nullptr, rr, rz);  // also: every copy of z whole
    if (!minv) rz = rr;
    ++k;
    done = rr < tol2;
    if (done) break;
    const float beta = rz / rsold;
    rsold = rz;
    // Every block forms the whole of p itself, the same bits in each.
    for (int i = threadIdx.x; i < n; i += T) ps[i] = zs[i] + beta * ps[i];
    __syncthreads();
  }
  float* x = a.x + sys * n;
  for (int i = vt; i < n; i += kBatchBlock) x[i] = xs[i];
  if (vt == 0) {
    a.k_out[sys] = static_cast<int>(k);
    a.rr_out[sys] = rr;
  }
}

struct BatchDiaArgs {
  const float* b;     // (B, n)
  const float* x0;    // (B, n)
  float* x;           // (B, n) out
  int* k_out;         // (B,) out
  float* rr_out;      // (B,) out
  int n;
  int diag;           // jacobi: the slab row of offset 0; -1 for none
  float tol;
  long long maxiter;
  int safe_alpha;
};

// K12's layout of a launch (kernels/fused.py batch_dia_warps_plan mirrors
// batch_dia_plan, below): `systems` systems a block, each on W warps; a
// vector of the system takes `len` floats of shared memory, padded by `pad`
// floats after every 32 rows so that the lanes of a warp, which own rows G
// apart (G lanes a virtual warp), fall in distinct banks; `slab` says
// whether the slab is copied into shared memory (else read from device
// memory every lap); `sys_bytes` is a system's dynamic shared memory.
struct BatchDiaLayout {
  int systems, pad, len, slab, sys_bytes;
};

// K12: B banded systems, one on each group of W warps (a block holds
// `systems` of them), with today's sums bit for bit. Today's kernel ran a
// system on one block of VT = min(n, 1024) threads: thread t summed rows t,
// t + VT, ... in order, each warp its 32 threads by the shuffle-down tree,
// warp 0 the VW = VT / 32 warps' sums by the same tree over 32 slots (zeros
// past VW). Here those are virtual threads and warps: the G = 32 W / VW
// lanes of virtual warp v take its 32 virtual lanes in turn (lane g the
// virtual lanes g, g + G, ...: V = 32 / G of them), so the tree's steps of
// offset G and more join a lane's own virtual lanes, in its registers, and
// the steps below G join the G lanes by shuffles; the virtual warps' sums
// then go through the 32-slot tree, by shared slots and the system's named
// barrier. Row i's sum, the
// arithmetic of each step and every scalar are today's, so x, k and r.r are
// today's bits for every W. The system's rows of x, r and Ap stay in their
// owner's registers (Regs: n <= 1024, at most 16 rows a lane) or in shared
// memory; p is in shared memory, where the neighbouring rows read it, as is
// the slab when it fits (read every lap, not from L2). A lap takes three
// barriers of the system's W warps: after p.Ap's slots, after r.r's and
// r.z's, after p. W = 1 and 2 (32 and 16 rows a lane) ran 2.5-6 times
// slower than W = 8 at tpucg's battery (PERF.md section 6, K12).
template <typename T, int W, bool Regs>
__global__ void __launch_bounds__(kBatchDiaBlock, 1)
fused_batch_dia_cg_kernel(const __grid_constant__ BatchDiaArgs a, long long batch,
                          const T* __restrict__ data, const __grid_constant__ DiaOffsets offs,
                          const __grid_constant__ BatchDiaLayout lay) {
  static_assert(W == 4 || W == 8, "K12 runs 4 or 8 warps a system");
  constexpr int J = 32 / W;  // virtual threads a lane at most (G = W at n >= 1024)
  constexpr int kLogJ = W == 4 ? 3 : 2;
  extern __shared__ float4 batch_dia_smem4[];
  const int n = a.n;
  const int local = static_cast<int>(threadIdx.x) / (32 * W);  // the block's system
  const long long sys = static_cast<long long>(blockIdx.x) * lay.systems + local;
  if (sys >= batch) return;  // no barrier spans systems
  const int L = static_cast<int>(threadIdx.x) % (32 * W);  // the system's lane
  const int lane = L & 31;
  const int vt = n < kBatchBlock ? n : kBatchBlock;        // VT
  const int vwarps = vt >> 5;                              // VW
  const int G = 32 * W / vwarps;                           // lanes a virtual warp
  const int V = 32 / G;                                    // virtual threads a lane
  const int vw = L / G, g = L % G;
  const int vbase = 32 * vw + g;  // virtual thread of j: vbase + G j; its rows + VT q
  const int Q = Regs ? 1 : (n + vt - 1) / vt;

  char* base = reinterpret_cast<char*>(batch_dia_smem4) + local * lay.sys_bytes;
  float* slots = reinterpret_cast<float*>(base);  // [set][sum][virtual warp]
  float* ps = slots + kBatchDiaSlots;
  float* xs = ps + lay.len;  // x, r, Ap: shared memory unless Regs
  float* rs = xs + lay.len;
  float* aps = rs + lay.len;
  T* slab_s = reinterpret_cast<T*>(Regs ? xs : aps + lay.len);
  const T* slab_g = data + sys * offs.ndiag * n;
  auto at = [&](int i) { return i + lay.pad * (i >> 5); };
  // The slab where it lies, read through one pointer (chosen here, not at
  // each load: a choice between two loads issued both): shared memory in
  // the vectors' padded layout, or device memory as it is.
  const T* sl = lay.slab ? slab_s : slab_g;
  const int slen = lay.slab ? lay.len : n;
  const int spad = lay.slab ? lay.pad : 0;
  auto slab_at = [&](int d, int i) -> float { return widen(sl[d * slen + i + spad * (i >> 5)]); };
  const float* b = a.b + sys * n;
  const float* x0 = a.x0 + sys * n;
  const bool jacobi = a.diag >= 0;
  const float tol2 = a.tol * a.tol;

  // The system's barrier: its W warps (named barrier 1 + local).
  auto sync = [&]() {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + local), "r"(32 * W) : "memory");
  };
  // f(j, row) for each row of this lane, in each virtual thread's order.
  auto each_row = [&](auto f) {
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int row = vbase + G * j + vt * q;
        if (j < V && row < n) f(j, row);
      }
  };
  // 1/diag of row i, 1 where the diagonal is 0 (tpucg's fused.py:707-711).
  auto minv = [&](int i) -> float {
    const float d = slab_at(a.diag, i);
    return d != 0.f ? 1.f / d : 1.f;
  };
  // Ap of this lane's rows of pass q into acc[j]: each row dia_row's sum,
  // term by term in offsets order, a diagonal at a time for all the rows
  // (their loads go out together). An offset beyond +-n reads no column.
  auto matvec = [&](int q, float (&acc)[J]) {
#pragma unroll
    for (int j = 0; j < J; ++j) acc[j] = 0.f;
    for (int d = 0; d < offs.ndiag; ++d) {
      const long long o = offs.off[d];
      const int off = static_cast<int>(o < -n ? -n : o > n ? n : o);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int row = vbase + G * j + vt * q;
        if (j < V && row < n) {
          const int c = row + off;
          const float xv = (c >= 0 && c < n) ? ps[at(c)] : 0.f;
          acc[j] = __fadd_rn(acc[j], __fmul_rn(slab_at(d, row), xv));
        }
      }
    }
  };
  // A virtual warp's sum of v[j] (j < V): the tree's steps of offset G and
  // more in registers, then the G lanes' shuffles; valid at g = 0.
  auto vwarp_sum = [&](float (&v)[J]) -> float {
#pragma unroll
    for (int k = 1; k <= kLogJ; ++k) {  // offsets J / 2, ..., 1
      const int off = J >> k;
      if (off < V)
#pragma unroll
        for (int j = 0; j < off; ++j) v[j] = v[j] + v[j + off];
    }
    float s = v[0];
    for (int off = G / 2; off >= 1; off >>= 1) s = s + __shfl_down_sync(0xffffffffu, s, off);
    return s;
  };
  // Today's sum over the system of v0 (and v1 when `two`), returned to every
  // lane: the virtual warps' sums into slot set `set`, then the 32-slot tree.
  auto allsum = [&](int set, float (&v0)[J], float (&v1)[J], bool two, float& t0, float& t1) {
    const float s0 = vwarp_sum(v0);
    const float s1 = two ? vwarp_sum(v1) : 0.f;
    float* sl = slots + 64 * set;
    if (g == 0) {
      sl[vw] = s0;
      if (two) sl[32 + vw] = s1;
    }
    sync();
    const float u0 = sl[lane];
    const float u1 = two ? sl[32 + lane] : 0.f;
    t0 = __shfl_sync(0xffffffffu, warp_sum_down(lane < vwarps ? u0 : 0.f), 0);
    if (two) t1 = __shfl_sync(0xffffffffu, warp_sum_down(lane < vwarps ? u1 : 0.f), 0);
  };

  // x, r and Ap of this lane's row (its j-th virtual thread's): registers
  // (Regs) or shared memory.
  float xr[Regs ? J : 1], rr_[Regs ? J : 1], apr[Regs ? J : 1];
  auto x_of = [&](int j, int row) -> float& {
    if constexpr (Regs) return xr[j];
    else return xs[at(row)];
  };
  auto r_of = [&](int j, int row) -> float& {
    if constexpr (Regs) return rr_[j];
    else return rs[at(row)];
  };
  auto ap_of = [&](int j, int row) -> float& {
    if constexpr (Regs) return apr[j];
    else return aps[at(row)];
  };

  if (lay.slab)
    for (int e = L; e < offs.ndiag * n; e += 32 * W) {
      const int d = e / n, i = e - d * n;
      slab_s[d * lay.len + at(i)] = __ldg(slab_g + e);
    }
  each_row([&](int j, int row) {
    const float v = __ldg(x0 + row);
    x_of(j, row) = v;
    ps[at(row)] = v;
  });
  sync();
  float acc[J];
  for (int q = 0; q < Q; ++q) {
    matvec(q, acc);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int row = vbase + G * j + vt * q;
      if (j < V && row < n) ap_of(j, row) = acc[j];
    }
  }
  sync();  // every read of p = x0 is done
  float s0[J], s1[J];
#pragma unroll
  for (int j = 0; j < J; ++j) s0[j] = s1[j] = 0.f;
  each_row([&](int j, int row) {
    const float rv = __ldg(b + row) - ap_of(j, row);
    r_of(j, row) = rv;
    const float z = jacobi ? minv(row) * rv : rv;
    ps[at(row)] = z;
    s0[j] = __fmaf_rn(rv, rv, s0[j]);
    s1[j] = __fmaf_rn(rv, z, s1[j]);
  });
  float rr, rsold;
  allsum(1, s0, s1, jacobi, rr, rsold);  // also: every lane's p = z is written
  if (!jacobi) rsold = rr;
  long long k = 0;
  bool done = rr < tol2;
  while (!done && k < a.maxiter) {
#pragma unroll
    for (int j = 0; j < J; ++j) s0[j] = 0.f;
    for (int q = 0; q < Q; ++q) {
      matvec(q, acc);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int row = vbase + G * j + vt * q;
        if (j < V && row < n) {
          ap_of(j, row) = acc[j];
          s0[j] = __fmaf_rn(ps[at(row)], acc[j], s0[j]);
        }
      }
    }
    float pap, unused;
    allsum(0, s0, s1, false, pap, unused);  // also: every read of p is done
    const float alpha = safe_div(rsold, pap, a.safe_alpha);
#pragma unroll
    for (int j = 0; j < J; ++j) s0[j] = s1[j] = 0.f;
    each_row([&](int j, int row) {
      x_of(j, row) = __fmaf_rn(alpha, ps[at(row)], x_of(j, row));
      const float rv = __fmaf_rn(-alpha, ap_of(j, row), r_of(j, row));
      r_of(j, row) = rv;
      s0[j] = __fmaf_rn(rv, rv, s0[j]);
      if (jacobi) s1[j] = __fadd_rn(s1[j], __fmul_rn(rv, __fmul_rn(minv(row), rv)));
    });
    float rz;
    allsum(1, s0, s1, jacobi, rr, rz);
    if (!jacobi) rz = rr;
    ++k;
    done = rr < tol2;
    if (done) break;
    const float beta = rz / rsold;
    rsold = rz;
    each_row([&](int j, int row) {
      const float rv = r_of(j, row);
      const float z = jacobi ? minv(row) * rv : rv;
      ps[at(row)] = __fmaf_rn(beta, ps[at(row)], z);
    });
    sync();  // p is whole
  }
  float* x = a.x + sys * n;
  each_row([&](int j, int row) { x[row] = x_of(j, row); });
  if (L == 0) {
    a.k_out[sys] = static_cast<int>(k);
    a.rr_out[sys] = rr;
  }
}

// The current device, its SM count and whether it takes cooperative
// launches, read once a device (the first kMaxDevices devices; others are
// asked every call).
struct DeviceInfo {
  int dev, sms, coop;
};
cudaError_t device_info(DeviceInfo* info) {
  static DeviceInfo cache[kMaxDevices];
  cudaError_t err = cudaGetDevice(&info->dev);
  if (err != cudaSuccess) return err;
  DeviceInfo* slot = info->dev < kMaxDevices ? &cache[info->dev] : nullptr;
  if (slot && slot->sms > 0) {
    *info = *slot;
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&info->coop, cudaDevAttrCooperativeLaunch, info->dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&info->sms, cudaDevAttrMultiProcessorCount, info->dev);
  if (err != cudaSuccess) return err;
  if (slot) *slot = *info;
  return cudaSuccess;
}

// K12's plan (tpucg_torch/kernels/fused.py batch_dia_warps_plan mirrors it):
// W warps a system (kBatchDiaWarps unless forced, 4 or 8, at most the VW
// virtual warps); x, r and Ap in registers when n <= 1024 (at most 8 rows
// a lane), else in shared memory; each vector padded by G floats
// every 32 rows where that fits; the slab in shared memory where it fits
// beside them (unless forced); `systems` systems a block once the batch
// would fill 32 blocks an SM (the card's limit) with one.
constexpr int kBatchDiaWarps = 8;

struct BatchDiaPlan {
  int warps, regs, systems, grid, threads, smem;
  BatchDiaLayout lay;
};
long long batch_dia_sys_bytes(long long n, int ndiag, int itemsize, int warps, bool regs, int pad,
                              bool slab) {
  const long long len = n + pad * (n / 32);
  const long long bytes = 4 * kBatchDiaSlots + 4 * len * (regs ? 1 : 4) +
                          (slab ? static_cast<long long>(itemsize) * ndiag * len : 0);
  return 16 * ((bytes + 15) / 16);
}
// warps <= 0 and slab < 0 take the plan's; others force them, and a forced
// plan that cannot run is refused.
cudaError_t batch_dia_plan(long long batch, long long n, int ndiag, int itemsize, int sms,
                           int warps, int slab, BatchDiaPlan* p) {
  const int vwarps = static_cast<int>((n < kBatchBlock ? n : kBatchBlock) / 32);
  if (warps <= 0) warps = kBatchDiaWarps < vwarps ? kBatchDiaWarps : vwarps;
  if ((warps != 4 && warps != 8) || warps > vwarps) return cudaErrorInvalidValue;
  const bool regs = n <= kBatchBlock;
  const int g = 32 * warps / vwarps;
  long long bytes = -1;
  int pad = 0, with_slab = 0;
  const int pads[2] = {g % 32, 0};  // G = 32: a warp's lanes own 32 rows in a row
  for (int s = 1; s >= 0 && bytes < 0; --s) {
    if (slab >= 0 && s != slab) continue;
    for (int k = 0; k < 2 && bytes < 0; ++k) {
      const long long b = batch_dia_sys_bytes(n, ndiag, itemsize, warps, regs, pads[k], s);
      if (b <= kSmemPerBlock) {
        bytes = b;
        pad = pads[k];
        with_slab = s;
      }
    }
  }
  if (bytes < 0) return cudaErrorInvalidValue;
  int systems = 1;
  while (2 * systems * warps * 32 <= kBatchDiaBlock && 2 * systems * bytes <= kSmemPerBlock &&
         batch > 32LL * sms * systems)
    systems *= 2;
  p->warps = warps;
  p->regs = regs;
  p->systems = systems;
  p->grid = static_cast<int>((batch + systems - 1) / systems);
  p->threads = 32 * warps * systems;
  p->smem = static_cast<int>(systems * bytes);
  p->lay = BatchDiaLayout{systems, pad, static_cast<int>(n + pad * (n / 32)), with_slab,
                          static_cast<int>(bytes)};
  return cudaSuccess;
}

// Launches one instantiation; its dynamic shared memory limit is raised to
// the card's once a device.
template <typename T, int W, bool Regs>
cudaError_t launch_batch_dia_kernel(const BatchDiaArgs& ba, long long batch, const T* data,
                                    const DiaOffsets& offs, const BatchDiaPlan& plan, int dev,
                                    cudaStream_t stream) {
  static bool granted[kMaxDevices];
  const bool cached = dev < kMaxDevices;
  if (!cached || !granted[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(fused_batch_dia_cg_kernel<T, W, Regs>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kSmemPerBlock);
    if (err != cudaSuccess) return err;
    if (cached) granted[dev] = true;
  }
  fused_batch_dia_cg_kernel<T, W, Regs><<<plan.grid, plan.threads, plan.smem, stream>>>(
      ba, batch, data, offs, plan.lay);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fused_batch_dia(const void* data, const void* offsets, int ndiag, int diag,
                                   const void* b, const void* x0, void* x, void* k, void* rr,
                                   long long batch, long long npad, float tol,
                                   long long maxiter, int safe_alpha, int warps, int slab,
                                   void* stream) {
  if (batch <= 0 || batch > 0x7fffffffLL || npad <= 0 || npad % 128 ||
      npad > kFusedBatchDiaMaxN || ndiag < 1 || ndiag > kDiaMaxDiags || offsets == nullptr ||
      diag < -1 || diag >= ndiag)
    return cudaErrorInvalidValue;
  DiaOffsets offs{};
  offs.ndiag = ndiag;
  const long long* host = static_cast<const long long*>(offsets);
  for (int d = 0; d < ndiag; ++d) offs.off[d] = host[d];
  DeviceInfo di;
  cudaError_t err = device_info(&di);
  if (err != cudaSuccess) return err;
  BatchDiaPlan plan;
  err = batch_dia_plan(batch, npad, ndiag, sizeof(T), di.sms, warps, slab, &plan);
  if (err != cudaSuccess) return err;
  const BatchDiaArgs ba{static_cast<const float*>(b), static_cast<const float*>(x0),
                        static_cast<float*>(x), static_cast<int*>(k), static_cast<float*>(rr),
                        static_cast<int>(npad), diag, tol, maxiter, safe_alpha};
  const T* d = static_cast<const T*>(data);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (plan.warps * 2 + plan.regs) {
    case 8: return launch_batch_dia_kernel<T, 4, false>(ba, batch, d, offs, plan, di.dev, s);
    case 9: return launch_batch_dia_kernel<T, 4, true>(ba, batch, d, offs, plan, di.dev, s);
    case 16: return launch_batch_dia_kernel<T, 8, false>(ba, batch, d, offs, plan, di.dev, s);
    case 17: return launch_batch_dia_kernel<T, 8, true>(ba, batch, d, offs, plan, di.dev, s);
    default: return cudaErrorInvalidValue;
  }
}

// Cooperative grid of `kernel` (kBlock threads, `smem` dynamic bytes): the
// blocks an SM holds at once (cached per device and `key`) times the SM
// count, at most `cap`. A device without cooperative launch refuses.
constexpr int kGridKeys = 3;  // K10, K11 f32, K11 bf16
constexpr int kKeyStencil = 0;
constexpr int kKeyDiaF32 = 1;
constexpr int kKeyDiaBf16 = 2;

cudaError_t coop_grid(const void* kernel, size_t smem, int key, long long cap, int* grid) {
  static int cache[kMaxDevices][kGridKeys];
  DeviceInfo di;
  cudaError_t err = device_info(&di);
  if (err != cudaSuccess) return err;
  if (!di.coop) return cudaErrorNotSupported;
  int per_sm = 0;
  int* slot = di.dev < kMaxDevices ? &cache[di.dev][key] : nullptr;
  if (slot && *slot > 0) {
    per_sm = *slot;
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, smem);
    if (err != cudaSuccess) return err;
    if (slot) *slot = per_sm;
  }
  const long long g = static_cast<long long>(per_sm) * di.sms;
  *grid = static_cast<int>(g < cap ? g : cap);
  return *grid < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}


// K10/K11: at most one thread per element and kSparseMaxGrid blocks.
long long sparse_grid_cap(long long n) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  return blocks < kSparseMaxGrid ? blocks : kSparseMaxGrid;
}

cudaError_t coop_launch(const void* kernel, int grid, size_t smem, void** args, void* stream) {
  const cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kBlock), args,
                                                      smem, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

SolveArgs solve_args(const void* b, const void* x0, const void* minv, void* x, void* k,
                     void* rr, void* scratch, long long n, float tol, long long maxiter,
                     int safe_alpha, int precond, int degree) {
  return SolveArgs{static_cast<const float*>(b), static_cast<const float*>(x0),
                   static_cast<const float*>(minv), static_cast<float*>(x),
                   static_cast<int*>(k), static_cast<float*>(rr),
                   static_cast<float*>(scratch), static_cast<int>(n), tol, maxiter,
                   safe_alpha, precond, degree};
}

// K4's plan (tpucg_torch/kernels/fused.py dense_resident_plan mirrors it):
// the grid, the resident rows a block (slots) and the dynamic shared bytes.
// The kernel before A was kept on chip ran one warp a row, n / kWarps
// blocks (its occupancy times the SMs exceeded that at every n); where that
// grid holds with each of its blocks' kWarps rows resident, the plan keeps
// it, so the partials sum as before and x, k and r.r keep their bits. Else
// kDenseBlocksPerSm blocks an SM (at most n / kWarps), each with as many of
// its rows resident as its share of the SM's shared memory holds.
constexpr int kDenseStatic = 256;      // K4's static shared memory, at most
constexpr int kDenseBlocksPerSm = 2;   // where today's grid cannot hold A
constexpr int kDenseMaxBlocksPerSm = 2048 / kBlock;
constexpr int kDenseMaxSlots = 64;     // resident rows a block, at most (the occupancy cache)

struct DensePlan {
  int blocks_per_sm, grid, slots, smem;
};
// Dynamic shared bytes a block: the mbarriers (16-byte padded), the staged
// input and the resident rows.
long long dense_smem(long long n, long long slots) {
  return 16 * ((slots + 1) / 2) + 4 * n * (1 + slots);
}
long long dense_budget(int blocks_per_sm) {
  const long long share = kSmemPerSm / blocks_per_sm - kSmemReserved;
  return (share < kSmemPerBlock ? share : kSmemPerBlock) - kDenseStatic;
}
// blocks_per_sm <= 0 and slots < 0 take the plan's; others force them (the
// sweep), and a forced plan that does not fit is refused.
cudaError_t dense_plan(long long n, int sms, int blocks_per_sm, int slots, DensePlan* p) {
  const long long today = n / kWarps;
  if (blocks_per_sm <= 0) {
    blocks_per_sm = static_cast<int>((today + sms - 1) / sms);
    if (blocks_per_sm > kDenseMaxBlocksPerSm ||
        dense_smem(n, kWarps) > dense_budget(blocks_per_sm))
      blocks_per_sm = kDenseBlocksPerSm;
  }
  if (blocks_per_sm > kDenseMaxBlocksPerSm) return cudaErrorInvalidValue;
  const long long g = static_cast<long long>(blocks_per_sm) * sms;
  p->blocks_per_sm = blocks_per_sm;
  p->grid = static_cast<int>(g < today ? g : today);
  const long long warps = static_cast<long long>(p->grid) * kWarps;
  long long most = kWarps * ((n + warps - 1) / warps);  // rows block 0 owns
  const long long budget = dense_budget(blocks_per_sm);
  long long fit = 0;
  while (fit < most && dense_smem(n, fit + 1) <= budget) ++fit;
  if (most > kDenseMaxSlots) most = kDenseMaxSlots;
  if (fit > most) fit = most;
  if (slots < 0) slots = static_cast<int>(fit);
  if (slots > fit) return cudaErrorInvalidValue;
  p->slots = slots;
  p->smem = static_cast<int>(dense_smem(n, slots));
  return cudaSuccess;
}

// K4's launch: the plan on the current device, checked against the
// occupancy calculator (cached per device, n / 128 and slots); dynamic
// shared memory above 48 KB is granted once a device.
cudaError_t launch_fused_cg(const SolveArgs& sa, const float* A, int blocks_per_sm, int slots,
                            void* stream) {
  static int occupancy[kMaxDevices][kFusedMaxN / 128 + 1][kDenseMaxSlots + 1];
  static bool granted[kMaxDevices];
  DeviceInfo di;
  cudaError_t err = device_info(&di);
  if (err != cudaSuccess) return err;
  if (!di.coop) return cudaErrorNotSupported;
  DensePlan plan;
  err = dense_plan(sa.n, di.sms, blocks_per_sm, slots, &plan);
  if (err != cudaSuccess) return err;
  const void* kernel = (const void*)fused_cg_kernel;
  const bool cached = di.dev < kMaxDevices;
  if (!cached || !granted[di.dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dense_budget(1)));
    if (err != cudaSuccess) return err;
    if (cached) granted[di.dev] = true;
  }
  int* held = cached ? &occupancy[di.dev][sa.n / 128][plan.slots] : nullptr;
  int per_sm = held ? *held : 0;
  if (per_sm <= 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, plan.smem);
    if (err != cudaSuccess) return err;
    if (held) *held = per_sm;
  }
  if (static_cast<long long>(per_sm) * di.sms < plan.grid)
    return cudaErrorCooperativeLaunchTooLarge;
  if (sa.precond == kPoly) {
    float* seed = sa.scratch + 7 * static_cast<size_t>(sa.n);
    power_seed_kernel<<<(sa.n + kBlock - 1) / kBlock, kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(seed, sa.n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  void* args[] = {const_cast<SolveArgs*>(&sa), &A, &plan.slots};
  return coop_launch(kernel, plan.grid, plan.smem, args, stream);
}

// K10's cooperative grid at the fixed window's shared memory (the same for
// the launch and for tpucg_fused_stencil_grid).
cudaError_t stencil_grid(long long m, int* grid) {
  return coop_grid((const void*)fused_stencil_cg_kernel, kDiaSmem, kKeyStencil,
                   sparse_grid_cap(m * m * m), grid);
}

// K11's cooperative grid at its fixed shared memory (the same for the
// launch and for tpucg_fused_dia_grid).
template <typename T>
cudaError_t dia_grid(long long npad, int* grid) {
  return coop_grid((const void*)fused_dia_cg_kernel<T>, kDiaSmem,
                   sizeof(T) == 2 ? kKeyDiaBf16 : kKeyDiaF32, sparse_grid_cap(npad), grid);
}

template <typename T>
cudaError_t launch_fused_dia(const void* data, const void* offsets, int ndiag, int lo, int hi,
                             const void* b, const void* x0, const void* minv, void* x, void* k,
                             void* rr, void* scratch, long long npad, float tol,
                             long long maxiter, int safe_alpha, int precond, int degree,
                             void* stream) {
  if (ndiag < 1 || ndiag > kDiaMaxDiags || npad <= 0 || npad > kMaxIntRows ||
      offsets == nullptr || lo > 0 || hi < 0 || lo < -kDiaHalo || hi > kDiaHalo ||
      precond < kNone || precond > kPoly || (precond == kJacobi && minv == nullptr) ||
      (precond == kPoly && degree < 1))
    return cudaErrorInvalidValue;
  DiaOffsets offs{};
  offs.ndiag = ndiag;
  const long long* host = static_cast<const long long*>(offsets);
  for (int d = 0; d < ndiag; ++d) offs.off[d] = host[d];
  int grid = 0;
  cudaError_t err = dia_grid<T>(npad, &grid);
  if (err != cudaSuccess) return err;
  SolveArgs sa = solve_args(b, x0, minv, x, k, rr, scratch, npad, tol, maxiter, safe_alpha,
                            precond, degree);
  const T* slab = static_cast<const T*>(data);
  void* args[] = {&sa, &slab, &offs, &lo, &hi};
  return coop_launch((const void*)fused_dia_cg_kernel<T>, grid, kDiaSmem, args, stream);
}

// K5's launch of `batch` systems on clusters of C blocks at padded length
// n (the grid: batch C blocks of kBatchBlock / C threads, 20 n bytes of
// dynamic shared memory each).
template <int C>
cudaLaunchConfig_t batch_config(long long batch, long long n, cudaLaunchAttribute* cluster,
                                cudaStream_t stream) {
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = C;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * C));
  cfg.blockDim = dim3(kBatchBlock / C);
  cfg.dynamicSmemBytes = 5 * static_cast<size_t>(n) * sizeof(float);
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of C blocks the current device holds at once at padded
// length n (cached per device, C and n / 128).
template <int C>
cudaError_t batch_clusters(long long n, int* clusters) {
  static int cache[kMaxDevices][kBatchRowChunks + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int* slot = dev < kMaxDevices ? &cache[dev][n / 128] : nullptr;
  if (slot && *slot > 0) {
    *clusters = *slot;
    return cudaSuccess;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = batch_config<C>(1, n, &attr, nullptr);
  err = cudaOccupancyMaxActiveClusters(clusters, fused_batch_cg_kernel<C>, &cfg);
  if (err != cudaSuccess) return err;
  if (slot) *slot = *clusters;
  return cudaSuccess;
}

// Launches K5 on clusters of C blocks; a cluster the card cannot hold is
// refused (cudaErrorInvalidClusterSize), never shrunk.
template <int C>
cudaError_t launch_fused_batch(const BatchArgs& ba, long long batch, void* stream) {
  int clusters = 0;
  cudaError_t err = batch_clusters<C>(ba.n, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidClusterSize;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      batch_config<C>(batch, ba.n, &attr, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, fused_batch_cg_kernel<C>, ba);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
}  // namespace tpucg

extern "C" long long tpucg_fused_cg_scratch(long long n) {
  return 8 * n + 4 * ((n + tpucg::kWarps - 1) / tpucg::kWarps);
}

extern "C" long long tpucg_fused_sparse_scratch(long long n) {
  return 8 * n + 4 * tpucg::kSparseMaxGrid;
}

extern "C" cudaError_t tpucg_fused_cg_f32(const void* A, const void* b, const void* x0,
                                          const void* minv, void* x, void* k, void* rr,
                                          void* scratch, long long n, float tol,
                                          long long maxiter, int safe_alpha, int precond,
                                          int degree, int blocks_per_sm, int slots,
                                          void* stream) {
  using namespace tpucg;
  if (n <= 0 || n % 128 || n > kFusedMaxN || (precond == kJacobi && minv == nullptr))
    return cudaErrorInvalidValue;
  const SolveArgs sa = solve_args(b, x0, minv, x, k, rr, scratch, n, tol, maxiter, safe_alpha,
                                  precond, degree);
  return launch_fused_cg(sa, static_cast<const float*>(A), blocks_per_sm, slots, stream);
}

extern "C" cudaError_t tpucg_fused_cg_plan(long long n, int blocks_per_sm, int slots, void* out) {
  using namespace tpucg;
  if (n <= 0 || n % 128 || n > kFusedMaxN || out == nullptr) return cudaErrorInvalidValue;
  DeviceInfo di;
  cudaError_t err = device_info(&di);
  if (err != cudaSuccess) return err;
  DensePlan plan;
  err = dense_plan(n, di.sms, blocks_per_sm, slots, &plan);
  if (err != cudaSuccess) return err;
  int* o = static_cast<int*>(out);
  o[0] = plan.blocks_per_sm;
  o[1] = plan.grid;
  o[2] = plan.slots;
  o[3] = plan.smem;
  return cudaSuccess;
}

extern "C" cudaError_t tpucg_fused_stencil_cg_f32(const void* b, const void* x0, void* x,
                                                  void* k, void* rr, void* scratch, long long m,
                                                  int lo, int hi, float tol, long long maxiter,
                                                  int safe_alpha, int precond, int degree,
                                                  void* stream) {
  using namespace tpucg;
  // The window [lo, hi] is symmetric and ends at one of the offsets 1, m
  // or m^2, within kDiaHalo.
  if (m < 2 || m > kStencilMaxM || lo != -hi || hi > kDiaHalo ||
      (hi != 1 && hi != m && hi != m * m) || (precond != kNone && precond != kPoly) ||
      (precond == kPoly && degree < 1))
    return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = stencil_grid(m, &grid);
  if (err != cudaSuccess) return err;
  SolveArgs sa = solve_args(b, x0, nullptr, x, k, rr, scratch, m * m * m, tol, maxiter,
                            safe_alpha, precond, degree);
  int mi = static_cast<int>(m);
  void* args[] = {&sa, &mi, &lo, &hi};
  return coop_launch((const void*)fused_stencil_cg_kernel, grid, kDiaSmem, args, stream);
}

extern "C" int tpucg_fused_stencil_grid(long long m) {
  using namespace tpucg;
  if (m < 2 || m > kStencilMaxM) return -static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  const cudaError_t err = stencil_grid(m, &grid);
  return err == cudaSuccess ? grid : -static_cast<int>(err);
}

extern "C" cudaError_t tpucg_fused_dia_cg_f32(const void* data, const void* offsets, int ndiag,
                                              int lo, int hi, const void* b, const void* x0,
                                              const void* minv, void* x, void* k, void* rr,
                                              void* scratch, long long npad, float tol,
                                              long long maxiter, int safe_alpha, int precond,
                                              int degree, void* stream) {
  return tpucg::launch_fused_dia<float>(data, offsets, ndiag, lo, hi, b, x0, minv, x, k, rr,
                                        scratch, npad, tol, maxiter, safe_alpha, precond, degree,
                                        stream);
}

extern "C" cudaError_t tpucg_fused_dia_cg_bf16(const void* data, const void* offsets, int ndiag,
                                               int lo, int hi, const void* b, const void* x0,
                                               const void* minv, void* x, void* k, void* rr,
                                               void* scratch, long long npad, float tol,
                                               long long maxiter, int safe_alpha, int precond,
                                               int degree, void* stream) {
  return tpucg::launch_fused_dia<uint16_t>(data, offsets, ndiag, lo, hi, b, x0, minv, x, k, rr,
                                           scratch, npad, tol, maxiter, safe_alpha, precond,
                                           degree, stream);
}

extern "C" int tpucg_fused_dia_grid(long long npad, int bf16) {
  using namespace tpucg;
  if (npad <= 0 || npad > kMaxIntRows) return -static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  const cudaError_t err = bf16 ? dia_grid<uint16_t>(npad, &grid) : dia_grid<float>(npad, &grid);
  return err == cudaSuccess ? grid : -static_cast<int>(err);
}

extern "C" cudaError_t tpucg_fused_batch_cg_f32(const void* A, const void* b, const void* x0,
                                                const void* minv, void* x, void* k, void* rr,
                                                long long batch, long long n, float tol,
                                                long long maxiter, int safe_alpha, int jacobi,
                                                int cluster, void* stream) {
  using namespace tpucg;
  if (batch <= 0 || batch > 0x7fffffffLL / kBatchMaxCluster || n <= 0 || n % 128 ||
      n > kFusedBatchMaxN || (jacobi && minv == nullptr))
    return cudaErrorInvalidValue;
  const BatchArgs ba{static_cast<const float*>(A), static_cast<const float*>(b),
                     static_cast<const float*>(x0), static_cast<const float*>(minv),
                     static_cast<float*>(x), static_cast<int*>(k), static_cast<float*>(rr),
                     static_cast<int>(n), tol, maxiter, safe_alpha, jacobi};
  switch (cluster) {
    case 1: return launch_fused_batch<1>(ba, batch, stream);
    case 2: return launch_fused_batch<2>(ba, batch, stream);
    case 4: return launch_fused_batch<4>(ba, batch, stream);
    case kBatchMaxCluster: return launch_fused_batch<kBatchMaxCluster>(ba, batch, stream);
    default: return cudaErrorInvalidClusterSize;
  }
}

extern "C" int tpucg_fused_batch_clusters(long long n, int cluster) {
  using namespace tpucg;
  if (n <= 0 || n % 128 || n > kFusedBatchMaxN) return -static_cast<int>(cudaErrorInvalidValue);
  int clusters = 0;
  cudaError_t err = cudaErrorInvalidClusterSize;
  switch (cluster) {
    case 1: err = batch_clusters<1>(n, &clusters); break;
    case 2: err = batch_clusters<2>(n, &clusters); break;
    case 4: err = batch_clusters<4>(n, &clusters); break;
    case kBatchMaxCluster: err = batch_clusters<kBatchMaxCluster>(n, &clusters); break;
  }
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

extern "C" cudaError_t tpucg_fused_batch_dia_cg_f32(const void* data, const void* offsets,
                                                    int ndiag, int diag, const void* b,
                                                    const void* x0, void* x, void* k, void* rr,
                                                    long long batch, long long npad, float tol,
                                                    long long maxiter, int safe_alpha, int warps,
                                                    int slab, void* stream) {
  return tpucg::launch_fused_batch_dia<float>(data, offsets, ndiag, diag, b, x0, x, k, rr, batch,
                                              npad, tol, maxiter, safe_alpha, warps, slab, stream);
}

extern "C" cudaError_t tpucg_fused_batch_dia_cg_bf16(const void* data, const void* offsets,
                                                     int ndiag, int diag, const void* b,
                                                     const void* x0, void* x, void* k, void* rr,
                                                     long long batch, long long npad, float tol,
                                                     long long maxiter, int safe_alpha, int warps,
                                                     int slab, void* stream) {
  return tpucg::launch_fused_batch_dia<uint16_t>(data, offsets, ndiag, diag, b, x0, x, k, rr,
                                                 batch, npad, tol, maxiter, safe_alpha, warps,
                                                 slab, stream);
}

extern "C" cudaError_t tpucg_fused_batch_dia_plan(long long batch, long long npad, int ndiag,
                                                  int itemsize, int warps, int slab, void* out) {
  using namespace tpucg;
  if (batch <= 0 || npad <= 0 || npad % 128 || npad > kFusedBatchDiaMaxN || ndiag < 1 ||
      ndiag > kDiaMaxDiags || (itemsize != 2 && itemsize != 4) || out == nullptr)
    return cudaErrorInvalidValue;
  DeviceInfo di;
  cudaError_t err = device_info(&di);
  if (err != cudaSuccess) return err;
  BatchDiaPlan plan;
  err = batch_dia_plan(batch, npad, ndiag, itemsize, di.sms, warps, slab, &plan);
  if (err != cudaSuccess) return err;
  int* o = static_cast<int*>(out);
  const int vals[9] = {plan.warps,   plan.regs,    plan.systems, plan.grid,        plan.threads,
                       plan.smem,    plan.lay.pad, plan.lay.slab, plan.lay.sys_bytes};
  for (int i = 0; i < 9; ++i) o[i] = vals[i];
  return cudaSuccess;
}
