// The structured-sparse lap matvecs for Hopper (sm_90a), behind a plain C ABI.
//
// K6  dia_spmv_kernel        replaces tpucg/kernels/spmv.py:221 dia_spmv_pallas
//                            (_dia_kernel :152)
// K7  dia_spmv_halo_kernel   replaces tpucg/kernels/spmv.py:271
//                            dia_spmv_halo_pallas (_dia_kernel :152, its
//                            6-ref form)
// K8  poisson3d_march_kernel<false, *>  replaces tpucg/kernels/stencil.py:152
//                            poisson3d_pallas (_poisson_kernel :84,
//                            stencil_apply :44)
// K9  poisson3d_march_kernel<true, *>   replaces tpucg/kernels/stencil.py:126
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
// K8 and K9 are one template, poisson3d_march_kernel<Halo, Vec>: a 2.5-D
// march over the x-planes. A block owns a tile of TY lines x TZ z (TZ =
// kMarchChunk CZ <= 128) in every plane of a run of NX planes (march_plan;
// kernels/stencil.py stencil_march_plan mirrors it). Each of its CZ (TY + 2)
// threads owns a chunk of kMarchChunk neighbouring z on one line: a line of
// the tile, or one of the two lines just beside it (the y halo); a thread at
// either end of a tile's line also owns the line's element just beyond the
// tile (the z halo). A thread keeps its chunk of planes x - 1, x and x + 1
// in registers, and the loads of the kMarchAhead planes after those are in
// flight while it sums plane x: no sum waits on a load issued in its own
// step. Plane x's chunks go to one of two staged tiles in shared memory, one
// barrier a plane; an element then reads y +- 1 and z +- 1 from the staged
// tile and x +- 1 from its registers, and y is written along z. So each
// element of u is loaded once for each block that stages it: the reads come
// to (TY + 2) / TY lines (less where a halo line lies outside the grid) and
// (NX + 2) / NX planes of the slab, plus the z halo where a tile is narrower
// than a line; the plan states the ratio to the slab's elements exactly.
// What it does not cut is the L2 round trip of each plane: the plan sizes
// the grid near kMarchGrid blocks (two an SM at the launch bounds), so
// every SM holds about 36 KB of loads in flight.
//
// A chunk is one 16-byte load where m % 4 == 0 and u, y and the halo
// planes are 16-byte aligned (Vec), else kMarchChunk scalar loads. A cell
// outside the grid is +0 and is not loaded: the loads are predicated, with
// no branch between them, and every coordinate comes from the thread's
// place in the tile, none from a division per element. The x-edge source
// is the template argument Halo: for K8 the planes beyond the grid are +0
// and never read; for K9 plane -1 is lo and plane mp is hi. Each element
// sums 6 u, then subtracts x+1, x-1, y+1, y-1, z+1, z-1 in that order
// (tpucg's stencil_apply, stencil.py:60-80), each rounded on its own
// (__fmul_rn / __fsub_rn), an absent neighbour as +0: acc - (+0) is acc bit
// for bit, -0 included. So y equals the plain poisson3d_torch and
// poisson3d_slab_torch bit for bit on any plan.
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
// The k-column forms, K6 x k (dia_spmv_multi_kernel) and K8 x k
// (poisson3d_multi_kernel), replace tpucg's vmap of the same Pallas kernels
// (the multi-RHS and block solves' batched matvec): Y (npad, k) = A X with
// X and Y row-major, so row i's k values lie side by side. A thread owns
// V neighbouring columns of one row of Y (V = 4, 16-byte loads and stores,
// where k % 4 == 0 and X and Y are 16-byte aligned, else V = 1); a warp's
// threads own neighbouring groups, so its loads of X and its stores of Y
// are contiguous, and each stored diagonal value is loaded once for a
// thread's V columns (the threads of row i read it at one address, one
// transaction for all k). Each column sums as its single-column kernel
// sums row i: K6 x k in dia_row's order (a column outside [0, npad) as +0),
// K8 x k 6u and then x+1, x-1, y+1, y-1, z+1, z-1, each rounded on its own,
// an absent neighbour as +0. So column j of Y is K6's (K8's) y on column j
// of X, bit for bit, for any k and V. K8 x k loads a cell's seven rows
// with no march: it saves the k - 1 launches of k K8 calls, and a 2.5-D
// march over k columns is later work.
//
// All read the lap's `active` flag first and return at once when it is 0.
#include <algorithm>

#include "blas.cuh"
#include "sparse.cuh"

namespace tpucg {
namespace {

// K8/K9's march (kernels/stencil.py mirrors these in stencil_march_plan).
constexpr int kMarchChunk = 4;       // neighbouring z a thread owns in a plane (16 bytes)
constexpr int kMarchLanes = 32;      // most threads along a tile's line: TZ <= 128
constexpr int kMarchThreads = 576;   // most threads a block: 18 lines of 32
constexpr int kMarchMinBlocks = 2;   // blocks an SM the launch bounds keep registers for
constexpr int kMarchGrid = 264;      // blocks the plan aims at: two on each of 132 SMs
constexpr int kMarchAhead = 2;       // planes in flight beyond x + 1
constexpr int kMarchPad = 4;         // floats before and after a staged line (16-byte aligned)
constexpr int kMarchMaxSmem = 48 * 1024;  // dynamic shared bytes a block takes without opt-in

// A march's tile: cz threads along z (TZ = kMarchChunk cz), ty lines, nx
// planes a block.
struct MarchTile {
  int cz, ty, nx;
};

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

// Element g of a row-major (rows, k) block over a grid-stride loop: (i, j)
// with i = g / k and j = g % k, stepped by the loop's stride without a
// division per element.
struct RowCol {
  long long i;
  long long j;
  long long di, dj;  // the stride as rows and columns
  int k;
  __device__ __forceinline__ explicit RowCol(int k_) : k(k_) {
    const long long g = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
    const long long s = static_cast<long long>(gridDim.x) * kBlock;
    i = g / k;
    j = g - i * k;
    di = s / k;
    dj = s - di * k;
  }
  __device__ __forceinline__ void next() {
    i += di;
    j += dj;
    if (j >= k) {
      j -= k;
      ++i;
    }
  }
};

// K6 x k: Y[i, j] = sum_d data[d, i] * X[i + offsets[d], j] (0 outside
// [0, npad)), dia_row's order for every column. A thread owns V columns
// of row i: each slab value is loaded once for them.
template <typename T, int V>
__global__ void __launch_bounds__(kBlock)
dia_spmv_multi_kernel(const T* __restrict__ data, const float* __restrict__ X,
                      float* __restrict__ Y, long long npad, int k,
                      const __grid_constant__ DiaOffsets offs, const int* __restrict__ active) {
  if (inactive(active)) return;
  for (RowCol e(k / V); e.i < npad; e.next()) {
    const long long c0 = e.j * V;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int d = 0; d < offs.ndiag; ++d) {
      const long long c = e.i + offs.off[d];
      const float a = widen(__ldg(data + d * npad + e.i));
      const Cols<V> x = (c >= 0 && c < npad) ? load_cols<V>(X + c * k + c0) : Cols<V>{};
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], __fmul_rn(a, x.v[v]));
    }
    store_cols<V>(Y + e.i * k + c0, acc);
  }
}

// K8 x k: Y[c, j] = (A U[:, j])[c] for the 7-point Laplacian on the m^3 grid
// (cell c = x m^2 + y m + z), in K8's order: 6u, then x+1, x-1, y+1, y-1,
// z+1, z-1, each __fsub_rn, a neighbour outside the grid +0. A thread owns
// V columns of cell c and loads its seven rows before it sums.
template <int V>
__global__ void __launch_bounds__(kBlock)
poisson3d_multi_kernel(const float* __restrict__ U, float* __restrict__ Y, int m, int k,
                       const int* __restrict__ active) {
  if (inactive(active)) return;
  const int mm = m * m;
  const long long cells = static_cast<long long>(mm) * m;
  for (RowCol e(k / V); e.i < cells; e.next()) {
    const int c = static_cast<int>(e.i);
    const int x = c / mm, y = (c - x * mm) / m, z = c - x * mm - y * m;
    const float* const u = U + e.j * V;
    auto at = [&](bool in, int cell) {
      return in ? load_cols<V>(u + static_cast<long long>(cell) * k) : Cols<V>{};
    };
    const Cols<V> uc = at(true, c), xp = at(x + 1 < m, c + mm), xm = at(x > 0, c - mm),
                  yp = at(y + 1 < m, c + m), ym = at(y > 0, c - m), zp = at(z + 1 < m, c + 1),
                  zm = at(z > 0, c - 1);
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float a = __fmul_rn(6.f, uc.v[v]);
      a = __fsub_rn(a, xp.v[v]);
      a = __fsub_rn(a, xm.v[v]);
      a = __fsub_rn(a, yp.v[v]);
      a = __fsub_rn(a, ym.v[v]);
      a = __fsub_rn(a, zp.v[v]);
      a = __fsub_rn(a, zm.v[v]);
      acc[v] = a;
    }
    store_cols<V>(Y + e.i * k + e.j * V, acc);
  }
}

// One plane's cells of a thread: its chunk, and its z halo before (l) and
// after (r) the tile (+0 where it has none).
struct MarchCells {
  float v[kMarchChunk];
  float l, r;
};

// Where a thread's cells lie in each plane, fixed for the launch.
struct MarchLane {
  int off;              // flat index in a plane of its chunk's first z
  int zin;              // z of its chunk inside the grid, 0 .. kMarchChunk
  bool own;             // a line of the tile, not of its y halo
  bool take_l, take_r;  // loads the z halo before / after the tile
};

// A thread's cells of one plane (null: no plane, all +0). A y-halo line
// is loaded only where `all` (a plane the block sums); a cell outside the
// grid is +0. The loads are predicated, none behind a branch.
template <bool Vec>
__device__ __forceinline__ MarchCells march_load(const float* __restrict__ plane,
                                                 const MarchLane& c, bool all) {
  MarchCells out{};
  if (plane == nullptr) return out;  // the same for every thread of the block
  const bool line = c.own || all;
  if (Vec) {
    const float4 q = (line && c.zin > 0)
                         ? __ldg(reinterpret_cast<const float4*>(plane + c.off))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    out.v[0] = q.x;
    out.v[1] = q.y;
    out.v[2] = q.z;
    out.v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kMarchChunk; ++k)
      out.v[k] = (line && k < c.zin) ? __ldg(plane + c.off + k) : 0.f;
  }
  out.l = c.take_l ? __ldg(plane + c.off - 1) : 0.f;
  out.r = c.take_r ? __ldg(plane + c.off + kMarchChunk) : 0.f;
  return out;
}

// K8 (Halo false) and K9 (Halo true): (A u) on a slab of mp x-planes of the
// m^3 grid, local flat index x*m^2 + y*m + z, by the 2.5-D march (source
// note). Block (run, y tile, z tile) = blockIdx (x, y, z); thread
// (ly, lz) = (threadIdx.x / t.cz, threadIdx.x % t.cz) owns line
// yt0 + ly - 1, z from zt0 + kMarchChunk lz.
template <bool Halo, bool Vec>
__global__ void __launch_bounds__(kMarchThreads, kMarchMinBlocks)
poisson3d_march_kernel(const float* __restrict__ u, const float* __restrict__ lo,
                       const float* __restrict__ hi, float* __restrict__ y, int m, int mp,
                       MarchTile t, const int* __restrict__ active) {
  if (inactive(active)) return;
  extern __shared__ float4 march_staged[];
  const int stride = kMarchChunk * t.cz + 2 * kMarchPad;  // floats a staged line
  const int tile = (t.ty + 2) * stride;                   // floats a staged plane
  const int lz = static_cast<int>(threadIdx.x) % t.cz;
  const int ly = static_cast<int>(threadIdx.x) / t.cz;
  const int zt0 = static_cast<int>(blockIdx.z) * kMarchChunk * t.cz;
  const int z0 = zt0 + kMarchChunk * lz;
  const int yy = static_cast<int>(blockIdx.y) * t.ty + ly - 1;
  const int x0 = static_cast<int>(blockIdx.x) * t.nx;
  const int x1 = x0 + min(t.nx, mp - x0);
  const int mm = m * m;
  const bool line_in = yy >= 0 && yy < m;
  MarchLane c;
  c.own = ly >= 1 && ly <= t.ty;
  c.zin = line_in ? max(0, min(kMarchChunk, m - z0)) : 0;
  c.off = line_in ? yy * m + min(z0, m - 1) : 0;
  c.take_l = c.own && line_in && lz == 0 && zt0 > 0;
  c.take_r = c.own && line_in && lz == t.cz - 1 && z0 + kMarchChunk < m;
  // Plane p's source: u in the slab, lo and hi just beyond it (K9), nothing
  // beyond the grid (K8) or past the run's last neighbour plane.
  auto plane = [&](int p) -> const float* {
    if (p > x1) return nullptr;
    if (p < 0) return Halo ? lo : nullptr;
    if (p >= mp) return Halo ? hi : nullptr;
    return u + p * mm;
  };
  MarchCells prev = march_load<Vec>(plane(x0 - 1), c, false);
  MarchCells cur = march_load<Vec>(plane(x0), c, true);
  MarchCells next = march_load<Vec>(plane(x0 + 1), c, x0 + 1 < x1);
  MarchCells ahead[kMarchAhead];
#pragma unroll
  for (int d = 0; d < kMarchAhead; ++d)
    ahead[d] = march_load<Vec>(plane(x0 + 2 + d), c, x0 + 2 + d < x1);
  float* const mine = reinterpret_cast<float*>(march_staged) + ly * stride + kMarchPad +
                      kMarchChunk * lz;
  for (int x = x0; x < x1; ++x) {
    float* const s = mine + ((x - x0) & 1) * tile;
    *reinterpret_cast<float4*>(s) = make_float4(cur.v[0], cur.v[1], cur.v[2], cur.v[3]);
    if (lz == 0) s[-1] = cur.l;
    if (lz == t.cz - 1) s[kMarchChunk] = cur.r;
    __syncthreads();  // plane x staged; the other tile's readers are done
    if (c.own && c.zin > 0) {
      const float4 up = *reinterpret_cast<const float4*>(s + stride);
      const float4 dn = *reinterpret_cast<const float4*>(s - stride);
      const float yp[kMarchChunk] = {up.x, up.y, up.z, up.w};
      const float ym[kMarchChunk] = {dn.x, dn.y, dn.z, dn.w};
      const float zl = s[-1], zr = s[kMarchChunk];
      float acc[kMarchChunk];
#pragma unroll
      for (int k = 0; k < kMarchChunk; ++k) {
        float a = __fmul_rn(6.f, cur.v[k]);
        a = __fsub_rn(a, next.v[k]);
        a = __fsub_rn(a, prev.v[k]);
        a = __fsub_rn(a, yp[k]);
        a = __fsub_rn(a, ym[k]);
        a = __fsub_rn(a, k + 1 < kMarchChunk ? cur.v[k + 1] : zr);
        a = __fsub_rn(a, k > 0 ? cur.v[k - 1] : zl);
        acc[k] = a;
      }
      float* const out = y + x * mm + c.off;
      if (Vec) {
        *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
#pragma unroll
        for (int k = 0; k < kMarchChunk; ++k)
          if (k < c.zin) out[k] = acc[k];
      }
    }
    prev = cur;
    cur = next;
    next = ahead[0];
#pragma unroll
    for (int d = 0; d + 1 < kMarchAhead; ++d) ahead[d] = ahead[d + 1];
    const int p = x + 2 + kMarchAhead;
    ahead[kMarchAhead - 1] = march_load<Vec>(plane(p), c, p < x1);
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

template <typename T>
cudaError_t launch_dia_spmv_multi(const void* data, const void* offsets, int ndiag,
                                  const void* x, void* y, long long npad, long long k,
                                  const void* active, void* stream) {
  DiaOffsets offs;
  long long reach;
  if (!copy_offsets(offsets, ndiag, &offs, &reach) || npad <= 0 || k < 1 ||
      k > 0x7fffffffLL || npad > (1LL << 62) / k)
    return cudaErrorInvalidValue;
  const int v = cols_a_thread(k, x, y);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const T*>(data);
  const auto* fx = static_cast<const float*>(x);
  auto* fy = static_cast<float*>(y);
  const auto* flag = static_cast<const int*>(active);
  const int ik = static_cast<int>(k);
  if (v == 4)
    dia_spmv_multi_kernel<T, 4><<<stride_blocks(npad * (k / 4)), kBlock, 0, st>>>(
        d, fx, fy, npad, ik, offs, flag);
  else
    dia_spmv_multi_kernel<T, 1><<<stride_blocks(npad * k), kBlock, 0, st>>>(d, fx, fy, npad,
                                                                           ik, offs, flag);
  return cudaGetLastError();
}

// A slab K8/K9 can index: 2 <= m <= kStencilMaxM, mp >= 1, mp m^2 <= kMaxIntRows.
bool march_shape(long long m, long long mp) {
  return m >= 2 && m <= kStencilMaxM && mp >= 1 && mp <= kMaxIntRows / (m * m);
}

// Dynamic shared memory of a block: two staged planes of TY + 2 lines.
long long march_smem(MarchTile t) {
  return 2LL * sizeof(float) * (t.ty + 2) * (kMarchChunk * t.cz + 2 * kMarchPad);
}

bool march_tile_fits(MarchTile t) {
  return t.cz >= 1 && t.cz <= kMarchLanes && t.ty >= 1 && t.ty <= kMarchThreads &&
         t.nx >= 1 && t.cz * (t.ty + 2) <= kMarchThreads && march_smem(t) <= kMarchMaxSmem;
}

// K8/K9's plan for a slab of mp planes of the m^3 grid (kernels/stencil.py
// stencil_march_plan mirrors it): a line's chunks in the fewest tiles of at
// most kMarchLanes, evened; as many lines a tile as kMarchThreads threads
// hold beside the two halo lines, evened over the m lines; then the planes
// in runs, as many as keep the grid at most kMarchGrid blocks (at least one
// run, at most mp).
MarchTile march_plan(long long m, long long mp) {
  const long long chunks = (m + kMarchChunk - 1) / kMarchChunk;
  const long long nz = (chunks + kMarchLanes - 1) / kMarchLanes;
  MarchTile t;
  t.cz = static_cast<int>((chunks + nz - 1) / nz);
  const long long most = std::min<long long>(m, kMarchThreads / t.cz - 2);
  const long long ny = (m + most - 1) / most;
  t.ty = static_cast<int>((m + ny - 1) / ny);
  const long long runs = std::max<long long>(1, std::min<long long>(mp, kMarchGrid / (nz * ny)));
  t.nx = static_cast<int>((mp + runs - 1) / runs);
  return t;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Launch the march on tile t: Halo takes the x-edge planes from lo and hi.
template <bool Halo>
cudaError_t launch_march(const void* u, const void* lo, const void* hi, void* y, long long m,
                         long long mp, MarchTile t, const void* active, void* stream) {
  if (!march_shape(m, mp) || !march_tile_fits(t)) return cudaErrorInvalidValue;
  const long long tz = kMarchChunk * t.cz;
  const dim3 grid(static_cast<unsigned>((mp + t.nx - 1) / t.nx),
                  static_cast<unsigned>((m + t.ty - 1) / t.ty),
                  static_cast<unsigned>((m + tz - 1) / tz));
  const unsigned threads = static_cast<unsigned>(t.cz * (t.ty + 2));
  const size_t smem = static_cast<size_t>(march_smem(t));
  const bool vec = m % kMarchChunk == 0 && aligned16(u) && aligned16(y) &&
                   (!Halo || (aligned16(lo) && aligned16(hi)));
  const auto* fu = static_cast<const float*>(u);
  const auto* flo = static_cast<const float*>(lo);
  const auto* fhi = static_cast<const float*>(hi);
  auto* fy = static_cast<float*>(y);
  const auto* flag = static_cast<const int*>(active);
  const auto st = static_cast<cudaStream_t>(stream);
  const int im = static_cast<int>(m), imp = static_cast<int>(mp);
  if (vec)
    poisson3d_march_kernel<Halo, true><<<grid, threads, smem, st>>>(fu, flo, fhi, fy, im, imp, t,
                                                                     flag);
  else
    poisson3d_march_kernel<Halo, false><<<grid, threads, smem, st>>>(fu, flo, fhi, fy, im, imp,
                                                                      t, flag);
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
  if (!march_shape(m, m)) return cudaErrorInvalidValue;
  return launch_march<false>(u, nullptr, nullptr, y, m, m, march_plan(m, m), active, stream);
}

extern "C" cudaError_t tpucg_poisson3d_slab_f32(const void* u, const void* lo, const void* hi,
                                                void* y, long long m, long long mp,
                                                const void* active, void* stream) {
  using namespace tpucg;
  if (!march_shape(m, mp)) return cudaErrorInvalidValue;
  return launch_march<true>(u, lo, hi, y, m, mp, march_plan(m, mp), active, stream);
}

extern "C" cudaError_t tpucg_poisson3d_march_f32(const void* u, const void* lo, const void* hi,
                                                 void* y, long long m, long long mp, int tz,
                                                 int ty, int nx, const void* active,
                                                 void* stream) {
  using namespace tpucg;
  if (tz < kMarchChunk || tz % kMarchChunk != 0 || (lo == nullptr) != (hi == nullptr))
    return cudaErrorInvalidValue;
  const MarchTile t{tz / kMarchChunk, ty, nx};
  if (lo == nullptr)
    return mp == m ? launch_march<false>(u, nullptr, nullptr, y, m, mp, t, active, stream)
                   : cudaErrorInvalidValue;
  return launch_march<true>(u, lo, hi, y, m, mp, t, active, stream);
}

extern "C" cudaError_t tpucg_poisson3d_march_plan(long long m, long long mp, void* out) {
  using namespace tpucg;
  if (!march_shape(m, mp) || out == nullptr) return cudaErrorInvalidValue;
  const MarchTile t = march_plan(m, mp);
  int* o = static_cast<int*>(out);
  o[0] = kMarchChunk * t.cz;
  o[1] = t.ty;
  o[2] = t.nx;
  return cudaSuccess;
}

extern "C" cudaError_t tpucg_dia_spmv_multi_f32(const void* data, const void* offsets, int ndiag,
                                                const void* x, void* y, long long npad,
                                                long long k, const void* active,
                                                void* stream) {
  return tpucg::launch_dia_spmv_multi<float>(data, offsets, ndiag, x, y, npad, k, active,
                                             stream);
}

extern "C" cudaError_t tpucg_dia_spmv_multi_bf16(const void* data, const void* offsets,
                                                 int ndiag, const void* x, void* y,
                                                 long long npad, long long k,
                                                 const void* active, void* stream) {
  return tpucg::launch_dia_spmv_multi<uint16_t>(data, offsets, ndiag, x, y, npad, k, active,
                                                stream);
}

extern "C" cudaError_t tpucg_poisson3d_multi_f32(const void* u, void* y, long long m,
                                                 long long k, const void* active,
                                                 void* stream) {
  using namespace tpucg;
  if (!march_shape(m, m) || k < 1 || k > 0x7fffffffLL || m * m * m > (1LL << 62) / k)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* fu = static_cast<const float*>(u);
  auto* fy = static_cast<float*>(y);
  const auto* flag = static_cast<const int*>(active);
  const int im = static_cast<int>(m), ik = static_cast<int>(k);
  if (cols_a_thread(k, u, y) == 4)
    poisson3d_multi_kernel<4><<<stride_blocks(m * m * m * (k / 4)), kBlock, 0, st>>>(
        fu, fy, im, ik, flag);
  else
    poisson3d_multi_kernel<1><<<stride_blocks(m * m * m * k), kBlock, 0, st>>>(fu, fy, im, ik,
                                                                              flag);
  return cudaGetLastError();
}
