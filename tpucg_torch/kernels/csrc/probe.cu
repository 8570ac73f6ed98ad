// The gather probes of benchmarks/probe_gather.py for Hopper (sm_90a),
// behind a plain C ABI.
//
// P1  lane_gather_kernel  replaces benchmarks/probe_gather.py:70 lane_gather
//                         (lane_gather_kernel :66), and under P7's name
//                         :184 lg_big (lg_big_kernel :178): one function
// P2  sub_gather_staged_kernel and sub_gather_direct_kernel (one function,
//                         two forms) replace probe_gather.py:83 sub_gather (:79)
// P3  row_gather_kernel   replaces probe_gather.py:101 row_gather (:97)
// P4  elem_gather_kernel  replaces probe_gather.py:117 elem_gather (:113)
// P5  dynslice_kernel     replaces probe_gather.py:138 dynslice (:129)
// P6  roll_dyn_kernel     replaces probe_gather.py:157 roll_dyn (:153)
//
// On the TPU these probes asked which gathers Mosaic can lower inside a
// kernel and how fast they run; their answers chose K13's layout (gather.cu).
// Here they ask where a gather should read from on an H100, so each note
// names the memory its reads come from. Every row is 128 f32 wide (one TPU
// lane row); a warp covers a quarter of it. Indices are not checked, as the
// TPU probes did not check them: an index out of range reads outside the
// table (P1: outside the block's shared row).
//
// What bounds them: each moves its indices, its output and the table
// elements it gathers (at least one 32-byte sector each, at most the table
// once) -- 0.26 to 1.3 MB at the script's shapes, well under a microsecond at
// 3.35 TB/s, so P1-P6 are bound by the launch and by the round trips to
// memory their data needs, not by bytes. P7 (P1 over 8192 rows, 12 MB) is
// the one rate probe: it streams v and idx once and writes o once.
//
// P1 lane_gather_kernel: o[i, j] = v[i, idx[i, j]], one kernel for P1 and
//   P7. A warp takes a row: each thread loads 4 elements of v and its 4
//   indices as one float4 and one int4 (16-byte loads, 512 bytes a warp,
//   coalesced), puts its float4 in the warp's 512-byte row in shared memory,
//   and after a __syncwarp gathers its 4 lanes from it and stores one float4
//   (16 bytes a thread). No block barrier: a warp's row is its own. Loads
//   and stores are evict-first (__ldcs/__stcs), as each byte is used once.
//   The parent's 4-row blocks of 4-byte loads kept ~16 KB in flight an SM
//   and a block barrier between load and store; here up to 64 warps an SM
//   each have 1 KB in flight and write as soon as their row lands, so reads
//   and writes overlap from the start. lane_gather_plan
//   (kernels/probe_gather.py) takes 8 warps a block, or 4 where 8 would
//   leave SMs without a block (P1's 256 rows: 64 blocks). Random lanes cost
//   ~3-4-way bank conflicts on the 4 scalar shared reads, as in the parent;
//   at P7 they do not show: P7 runs faster than torch.add on the same bytes
//   (bench/probe_gather.py prints both).
//   Staging each SM's run of rows by bulk copies (cp.async.bulk, every stage
//   requested at launch) was tried and was slower at P1 and P7: one thread
//   issues, the block waits on each stage in order, and a bulk copy's round
//   trip is longer than a load's.
// P2 sub_gather: o[i, j] = v[idx[i, j], j], in one of two forms that
//   sub_gather_plan (kernels/probe_gather.py) picks by the shape. The
//   parent's kernel took an element a thread and made two dependent L2
//   round trips before its store: idx, then v at an address that waits on
//   it; a warp's 32 reads fell in 32 rows.
//   sub_gather_staged_kernel: a block owns one column group of kSgCols = 8
//   columns (one 32-byte sector a row of v) over a run of idx rows, so it
//   needs only its group's slab of v (v_rows x 32 bytes), not the whole
//   table. It issues the slab's 16-byte cp.async copies into shared memory
//   and its first kSgIdx int4s of idx into registers together, before it
//   uses either, so one round trip is left; after one __syncthreads each
//   thread gathers its 4 elements from the slab and stores one float4. The
//   gather's 4 scalar shared reads fall on 8 banks a warp (the row's index
//   mod 4 and the half of the group): up to 4-way conflicts, a few cycles.
//   What bounds it is the slab: every block reads its v_rows sectors
//   through L2 and its SM's load pipe, which costs as much as the round
//   trip it saves unless the block reuses the slab over enough idx rows
//   (the time grows with blocks x v_rows, bench/p2_forms.py). So the plan
//   stages only where v_rows <= 0.75 x idx rows (at the script's 256 x 256
//   the two forms tie), on the runs that balance the slab's reads against
//   a block's share of idx (bench/p2_forms.py): at 8192 idx rows of a
//   2048-row v it is 1.5x faster than the direct form.
//   sub_gather_direct_kernel (every other shape, and any v taller than a
//   slab can hold, kSgMaxRows = 7,264 rows in 227 KB): the parent's walk,
//   an element a thread, __ldg(idx) then __ldg(v) through L2. Its two
//   dependent round trips stay. Four elements a thread (an int4 of idx, 4
//   gathers in flight, a float4 store) was tried and ran slower than this
//   walk at the script's shape and at a 16,384-row v (PERF.md, section 6): a
//   warp's 4 gathers of 32 rows each leave the load pipe one after another.
// P3 row_gather_kernel: o[i, :] = x2[ridx[i], :]. One warp a row, each lane
//   moving 16 bytes (float4): one 512-byte read and one 512-byte write a
//   warp, from L2 or device memory.
// P4 elem_gather_kernel: o = xf[eidx]. One thread an element, __ldg(xf +
//   eidx): a random element of a 1 MB vector, one 32-byte sector for 4 useful
//   bytes, from L2 once the vector is resident there (1 MB << 50 MB).
// P5 dynslice_kernel: o = sum over k of x2[w[k] : w[k] + 8, :], in k order.
//   The parent ran one block of 8 x 128 threads whose 64 window loads each
//   fed an add that waits on the one before, so only the few loads the
//   compiler hoisted were in flight: a string of L2 round trips. Now the
//   output's 8 rows go to 8 blocks of 128 threads, block r owning row r and
//   thread l its column, and every window is requested before the first
//   add: the block reads w into shared memory, then its threads start one
//   512-byte cp.async.bulk of row w[k] + r a window, kDsStageWindows windows
//   a stage on the stage's own mbarrier (32 KB), up to kDsMaxSlots stages in
//   flight (dynslice_plan, kernels/probe_gather.py); nw = 64 is one stage,
//   all issued at once, and nw up to kMaxWindows walks the ring. Once a
//   stage lands each thread loads its column's kDsStageWindows values into
//   registers, then adds them: thread (r, l) sums its column over k = 0 ..
//   nw - 1 from 0, each add rounded on its own (__fadd_rn), today's adds in
//   today's order, so the sum equals the plain version and the Pallas body
//   bit for bit. What is left is two dependent round trips (w, then the
//   windows) and the 64-add chain. Loading each column into registers, 32
//   windows at a time, was tried and was slower: 8,192 4-byte loads a block
//   against 64 bulk copies.
// P6 roll_dyn_kernel: o[i, j] = x[i, (j - s) mod 128], pltpu.roll's (and
//   jnp.roll's) direction. The shift s is read from device memory (one
//   broadcast load): the probe exists to test a shift known only at run
//   time, so it is never a host argument. The parent's threads each read s
//   and then their element of x at an address that waited on it: two
//   dependent round trips. A roll moves elements only within their row, so
//   the row is known before s arrives: a warp takes a row, as P1 does, and
//   each lane issues its 16-byte load of x (__ldcs) and the load of s
//   together. The row is then rotated in registers: lane l's elements 4l ...
//   4l + 3 come from x's elements d ... d + 3, d = (4l - s) mod 128, that is
//   from lanes d / 4 and d / 4 + 1 (mod 32) at an offset d mod 4 that is the
//   same for the whole warp: 8 __shfl_sync and a select, no shared memory
//   and so no bank conflict, and one 16-byte store (__stcs). s mod 128 is
//   taken as ((s % 128) + 128) % 128, which holds for every int32. Its plan
//   is lane_gather_plan's: 8 warps a block, 4 for small inputs.
#include "blas.cuh"

#include <cstdint>

namespace tpucg {
namespace {

constexpr int kLane = 128;        // elements in a row
constexpr int kRowBytes = 4 * kLane;
constexpr int kWindow = 8;        // rows of a P5 window
constexpr int kMaxWindows = 1024; // P5 windows a launch (shared offsets)
constexpr int kThreads = 256;     // threads of a P3 and P4 block (P3: a warp a row)
constexpr int kMaxDevices = 16;   // devices whose shared memory limit is raised once
constexpr int kMaxSmem = 232448;  // shared memory a block may take (227 KB)

constexpr int kLgMaxWarps = 16;                    // P1/P7: warps of a block, a row each
// P5: a block an output row, a thread a column.
constexpr int kDsStageWindows = 64;                // windows a stage (32 KB), <= kLane
constexpr int kDsMaxSlots = 4;                     // stages in flight a block
constexpr int kDsBarBytes = 8 * kDsMaxSlots;
// P2: a staged block owns kSgCols columns of v; a block takes up to
// kSgMaxThreads threads, and a staged thread kSgIdx int4s of idx at once.
constexpr int kSgCols = 8;
constexpr int kSgGroups = kLane / kSgCols;
constexpr int kSgMaxRows = kMaxSmem / (4 * kSgCols);  // rows of v a slab may hold (7,264)
constexpr int kSgMaxThreads = 256;
constexpr int kSgIdx = 8;

// Bulk copies global -> shared completed on mbarriers (PTX, sm_90).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// Initialises `bar` for one arrival and orders it before the bulk copies;
// the block's other threads see it after a __syncthreads.
__device__ __forceinline__ void init_bar(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(1u)
               : "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// The arrival of `bar`'s current phase, which then also waits for `bytes`
// of bulk copies. Copies may land before it: the phase completes only once
// it has arrived and every expected byte has landed.
__device__ __forceinline__ void arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global `src` to shared `dst`, counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// Copies 16 bytes from global `src` to shared `dst` (both 16-byte
// aligned), through L2 only (cp.async.cg, sm_80 and later).
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// Waits for every cp.async this thread issued.
__device__ __forceinline__ void copies_done() { asm volatile("cp.async.wait_all;" ::: "memory"); }
// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void wait_parity(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// P1/P7. Warp w of block b takes row b * warps + w. Dynamic shared
// memory: a 512-byte row a warp.
__global__ void __launch_bounds__(kLgMaxWarps * 32)
lane_gather_kernel(const float4* __restrict__ v, const int4* __restrict__ idx,
                   float4* __restrict__ o, long long rows) {
  extern __shared__ float4 lg_rows[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (row >= rows) return;
  const long long at = row * (kLane / 4) + lane;
  const float4 x = __ldcs(v + at);
  const int4 l = __ldcs(idx + at);
  float4* mine = lg_rows + warp * (kLane / 4);
  mine[lane] = x;
  __syncwarp();
  const float* r = reinterpret_cast<const float*>(mine);
  __stcs(o + at, make_float4(r[l.x], r[l.y], r[l.z], r[l.w]));
}

// P2, staged. Block b takes column group g = b % kSgGroups (columns 8g ...
// 8g + 7) over `run` idx rows from (b / kSgGroups) * run. Dynamic shared
// memory: the group's slab of v, row r's 8 columns at 8r. Item it of the
// block is o's float4 at its row it / 2, columns 8g + 4 (it % 2) ... + 3.
__global__ void __launch_bounds__(kSgMaxThreads)
sub_gather_staged_kernel(const float4* __restrict__ v, const int4* __restrict__ idx,
                         float4* __restrict__ o, int v_rows, long long rows, int run) {
  extern __shared__ float4 sg_slab[];
  const int g = blockIdx.x % kSgGroups, t = threadIdx.x, threads = blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x / kSgGroups) * run;
  const int items = 2 * static_cast<int>(min(static_cast<long long>(run), rows - first));
  const auto at = [&](int it) { return (first + (it >> 1)) * (kLane / 4) + 2 * g + (it & 1); };
  for (int k = t; k < 2 * v_rows; k += threads)
    copy16(sg_slab + k, v + static_cast<long long>(k >> 1) * (kLane / 4) + 2 * g + (k & 1));
  const float* slab = reinterpret_cast<const float*>(sg_slab);
  for (int base = 0; base < items; base += kSgIdx * threads) {  // items > 0: every thread enters
    int4 l[kSgIdx];
#pragma unroll
    for (int j = 0; j < kSgIdx; ++j) {
      const int it = base + t + j * threads;
      if (it < items) l[j] = __ldg(idx + at(it));
    }
    if (base == 0) {  // the slab and the first indices were in flight together
      copies_done();
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kSgIdx; ++j) {
      const int it = base + t + j * threads;
      if (it < items) {
        const float* s = slab + 4 * (it & 1);
        o[at(it)] = make_float4(s[8 * l[j].x], s[8 * l[j].y + 1], s[8 * l[j].z + 2],
                                s[8 * l[j].w + 3]);
      }
    }
  }
}

// P2, direct. Thread `at` takes o's element `at`.
__global__ void __launch_bounds__(kSgMaxThreads)
sub_gather_direct_kernel(const float* __restrict__ v, const int* __restrict__ idx,
                         float* __restrict__ o, long long n) {
  const long long at = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (at >= n) return;
  o[at] = __ldg(v + static_cast<long long>(__ldg(idx + at)) * kLane + (at & (kLane - 1)));
}

__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float* __restrict__ x2, const int* __restrict__ ridx,
                  float* __restrict__ o, long long nrows) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= nrows) return;
  const int lane = threadIdx.x & 31;
  const long long src = static_cast<long long>(__ldg(ridx + row));
  const float4 val = __ldg(reinterpret_cast<const float4*>(x2 + src * kLane) + lane);
  reinterpret_cast<float4*>(o + row * kLane)[lane] = val;
}

__global__ void __launch_bounds__(kThreads)
elem_gather_kernel(const float* __restrict__ xf, const int* __restrict__ eidx,
                   float* __restrict__ o, long long n) {
  const long long at = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (at >= n) return;
  o[at] = __ldg(xf + __ldg(eidx + at));
}

// P5. Dynamic shared memory: each slot's kDsStageWindows rows, the window
// offsets (kMaxWindows ints), then the stages' mbarriers. The rows come
// first so that every bulk copy lands on a 128-byte boundary. Stage c is
// windows [c kDsStageWindows, (c + 1) kDsStageWindows) of row r.
struct WindowRing {
  const float* x2;
  const int* start;  // the offsets, in shared memory
  float* slot0;      // slot s: kDsStageWindows rows from slot0 + s kDsStageWindows kLane
  uint64_t* bars;
  int nw, r;

  __device__ int windows(int c) const { return min(kDsStageWindows, nw - c * kDsStageWindows); }
  // One thread: stage c's arrival on slot s's mbarrier, expecting its bytes.
  __device__ void expect(int c, int s) const {
    arrive_expect(bars + s, static_cast<unsigned>(windows(c)) * kRowBytes);
  }
  // Every thread: stage c into slot s (a refill), thread j copying window j
  // of the stage (kDsStageWindows <= kLane).
  __device__ void issue(int c, int s) const {
    const int j = threadIdx.x;
    if (j < windows(c))
      bulk_copy(slot0 + (static_cast<size_t>(s) * kDsStageWindows + j) * kLane,
                x2 + static_cast<long long>(start[c * kDsStageWindows + j] + r) * kLane,
                kRowBytes, bars + s);
  }
};

// acc plus the first n (<= kDsStageWindows) values of a staged column, in
// order, all loaded before the first add; Full: n == kDsStageWindows.
template <bool Full>
__device__ __forceinline__ float add_column(float acc, const float* col, int n) {
  float x[kDsStageWindows];
#pragma unroll
  for (int j = 0; j < kDsStageWindows; ++j) x[j] = Full || j < n ? col[j * kLane] : 0.f;
#pragma unroll
  for (int j = 0; j < kDsStageWindows; ++j)
    if (Full || j < n) acc = __fadd_rn(acc, x[j]);
  return acc;
}

__global__ void __launch_bounds__(kLane)
dynslice_kernel(const int* __restrict__ w, const float* __restrict__ x2, float* __restrict__ o,
                int nw, int slots) {
  extern __shared__ __align__(128) float4 ds_smem4[];
  float* slot0 = reinterpret_cast<float*>(ds_smem4);
  int* start = reinterpret_cast<int*>(slot0 + static_cast<size_t>(slots) * kDsStageWindows * kLane);
  const WindowRing ring{x2, start, slot0, reinterpret_cast<uint64_t*>(start + kMaxWindows), nw,
                        static_cast<int>(blockIdx.x)};
  const int l = threadIdx.x;
  const int stages = (nw + kDsStageWindows - 1) / kDsStageWindows, first = min(stages, slots);
#pragma unroll 1
  for (int k = l; k < nw; k += kLane) start[k] = __ldg(w + k);
  if (l < slots) {  // thread s: slot s's mbarrier, and the first fill's arrival on it
    init_bar(ring.bars + l);
    if (l < first) ring.expect(l, l);
  }
  __syncthreads();
  // The first fill: stage c in slot c, thread l copying windows l, l + kLane.
  for (int k = l; k < min(nw, first * kDsStageWindows); k += kLane)
    bulk_copy(slot0 + static_cast<size_t>(k) * kLane,
              x2 + static_cast<long long>(start[k] + ring.r) * kLane, kRowBytes,
              ring.bars + k / kDsStageWindows);
  float acc = 0.f;
  unsigned phase = 0;
  for (int c = 0, s = 0; c < stages; ++c) {
    wait_parity(ring.bars + s, phase);
    const float* col = slot0 + static_cast<size_t>(s) * kDsStageWindows * kLane + l;
    const int n = ring.windows(c);
    acc = n == kDsStageWindows ? add_column<true>(acc, col, n) : add_column<false>(acc, col, n);
    if (c + slots < stages) {  // refill the slot once every thread has read it
      __syncthreads();
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      if (l == 0) ring.expect(c + slots, s);
      ring.issue(c + slots, s);
    }
    if (++s == slots) s = 0, phase ^= 1u;
  }
  o[blockIdx.x * kLane + l] = acc;
}

// P6. Warp w of block b takes row b * warps + w, lane l its float4 l.
__global__ void __launch_bounds__(kLgMaxWarps * 32)
roll_dyn_kernel(const int* __restrict__ shift, const float4* __restrict__ x,
                float4* __restrict__ o, long long rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // the whole warp: its shuffles below have every lane
  const long long at = row * (kLane / 4) + lane;
  const int s = __ldg(shift);
  const float4 mine = __ldcs(x + at);
  const int r = ((s % kLane) + kLane) % kLane;
  const int d = (4 * lane - r) & (kLane - 1);  // the source of element 4 lane
  const int a = d >> 2, b = d & 3;             // b: the same for every lane
  const int a1 = (a + 1) & 31;
  const float4 lo = make_float4(__shfl_sync(~0u, mine.x, a), __shfl_sync(~0u, mine.y, a),
                                __shfl_sync(~0u, mine.z, a), __shfl_sync(~0u, mine.w, a));
  const float4 hi = make_float4(__shfl_sync(~0u, mine.x, a1), __shfl_sync(~0u, mine.y, a1),
                                __shfl_sync(~0u, mine.z, a1), __shfl_sync(~0u, mine.w, a1));
  const float4 out = b == 0   ? lo
                     : b == 1 ? make_float4(lo.y, lo.z, lo.w, hi.x)
                     : b == 2 ? make_float4(lo.z, lo.w, hi.x, hi.y)
                              : make_float4(lo.w, hi.x, hi.y, hi.z);
  __stcs(o + at, out);
}

// Blocks of `per` work items covering n, or 0 when n is out of range.
unsigned blocks_for(long long n, long long per) {
  if (n <= 0 || n > 0x7fffffffLL) return 0;
  return static_cast<unsigned>((n + per - 1) / per);
}

// Raises `kernel`'s dynamic shared memory limit to `bytes`, once a device.
cudaError_t grant_smem(const void* kernel, int bytes, bool* granted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < kMaxDevices;
  if (cached && granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && cached) granted[dev] = true;
  return err;
}

}  // namespace
}  // namespace tpucg

using tpucg::kLane;

extern "C" cudaError_t tpucg_probe_lane_gather_f32(const void* v, const void* idx, void* o,
                                                   long long rows, int warps, void* stream) {
  using namespace tpucg;
  if (warps < 1 || warps > kLgMaxWarps) return cudaErrorInvalidValue;
  const unsigned grid = blocks_for(rows, warps);
  if (grid == 0) return cudaErrorInvalidValue;
  lane_gather_kernel<<<grid, warps * 32, warps * kRowBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(v), static_cast<const int4*>(idx), static_cast<float4*>(o), rows);
  return cudaGetLastError();
}

extern "C" cudaError_t tpucg_probe_sub_gather_f32(const void* v, const void* idx, void* o,
                                                  long long v_rows, long long rows, int run,
                                                  int threads, void* stream) {
  using namespace tpucg;
  static bool granted[kMaxDevices];
  if (v_rows < 1 || run < 0 || threads < 32 || threads > kSgMaxThreads || threads % 32)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (run == 0) {
    const unsigned grid = blocks_for(rows * kLane, threads);
    if (grid == 0) return cudaErrorInvalidValue;
    sub_gather_direct_kernel<<<grid, threads, 0, s>>>(
        static_cast<const float*>(v), static_cast<const int*>(idx), static_cast<float*>(o),
        rows * kLane);
    return cudaGetLastError();
  }
  const unsigned runs = blocks_for(rows, run);
  if (v_rows > kSgMaxRows || runs == 0 || runs > 0x7fffffffu / kSgGroups)
    return cudaErrorInvalidValue;
  const cudaError_t err =
      grant_smem((const void*)sub_gather_staged_kernel, kSgMaxRows * 4 * kSgCols, granted);
  if (err != cudaSuccess) return err;
  sub_gather_staged_kernel<<<runs * kSgGroups, threads, static_cast<int>(v_rows) * 4 * kSgCols,
                             s>>>(static_cast<const float4*>(v), static_cast<const int4*>(idx),
                                  static_cast<float4*>(o), static_cast<int>(v_rows), rows, run);
  return cudaGetLastError();
}

extern "C" cudaError_t tpucg_probe_row_gather_f32(const void* x2, const void* ridx, void* o,
                                                  long long nrows, void* stream) {
  const unsigned grid = tpucg::blocks_for(nrows * kLane, tpucg::kThreads / 32 * kLane);
  if (grid == 0) return cudaErrorInvalidValue;
  tpucg::row_gather_kernel<<<grid, tpucg::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x2), static_cast<const int*>(ridx), static_cast<float*>(o),
      nrows);
  return cudaGetLastError();
}

extern "C" cudaError_t tpucg_probe_elem_gather_f32(const void* xf, const void* eidx, void* o,
                                                   long long n, void* stream) {
  const unsigned grid = tpucg::blocks_for(n, tpucg::kThreads);
  if (grid == 0) return cudaErrorInvalidValue;
  tpucg::elem_gather_kernel<<<grid, tpucg::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xf), static_cast<const int*>(eidx), static_cast<float*>(o), n);
  return cudaGetLastError();
}

extern "C" cudaError_t tpucg_probe_dynslice_f32(const void* w, const void* x2, void* o, int nw,
                                                int slots, void* stream) {
  using namespace tpucg;
  static bool granted[kMaxDevices];
  if (nw < 1 || nw > kMaxWindows || slots < 1 || slots > kDsMaxSlots) return cudaErrorInvalidValue;
  const int fixed = kDsBarBytes + 4 * kMaxWindows, stage = kDsStageWindows * kRowBytes;
  const cudaError_t err =
      grant_smem((const void*)dynslice_kernel, fixed + kDsMaxSlots * stage, granted);
  if (err != cudaSuccess) return err;
  dynslice_kernel<<<kWindow, kLane, fixed + slots * stage, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(w), static_cast<const float*>(x2), static_cast<float*>(o), nw, slots);
  return cudaGetLastError();
}

extern "C" cudaError_t tpucg_probe_roll_dyn_f32(const void* shift, const void* x, void* o,
                                                long long rows, int warps, void* stream) {
  using namespace tpucg;
  if (warps < 1 || warps > kLgMaxWarps) return cudaErrorInvalidValue;
  const unsigned grid = blocks_for(rows, warps);
  if (grid == 0) return cudaErrorInvalidValue;
  roll_dyn_kernel<<<grid, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(shift), static_cast<const float4*>(x), static_cast<float4*>(o), rows);
  return cudaGetLastError();
}
