// The gather probes of benchmarks/probe_gather.py for Hopper (sm_90a),
// behind a plain C ABI.
//
// P1  lane_gather_kernel  replaces benchmarks/probe_gather.py:70 lane_gather
//                         (lane_gather_kernel :66), and under P7's name
//                         :184 lg_big (lg_big_kernel :178): one function
// P2  sub_gather_kernel   replaces probe_gather.py:83 sub_gather (:79)
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
// 3.35 TB/s, so P1-P6 are bound by the launch, not by bytes. P7 (P1 over
// 8192 rows, 12 MB) is the one rate probe: it streams v and idx once and
// writes o once.
//
// P1 lane_gather_kernel: o[i, j] = v[i, idx[i, j]]. A block of 4 x 128
//   threads stages its 4 rows of v in shared memory (coalesced 512-byte row
//   loads), syncs, and each thread reads its lane from shared memory: the
//   counterpart of the TPU's in-VMEM lane shuffle. Lanes of a warp that pick
//   the same bank but other words wait on each other (random indices: ~4-way
//   conflicts). The TPU's 512-row BlockSpec of P7 is tiling and not carried
//   over: the kernel takes a row count.
// P2 sub_gather_kernel: o[i, j] = v[idx[i, j], j]. Each thread reads its
//   element of v through the read-only path (__ldg: L1, then L2), never
//   staged in shared memory: the whole 128 KB tile would have to be copied
//   into every block (above 48 KB only as opt-in dynamic shared memory) to
//   serve 1 KB of reads a block. Each lane reads its own column, so a warp's
//   32 reads fall in 32 other rows: 32 sectors a warp.
// P3 row_gather_kernel: o[i, :] = x2[ridx[i], :]. One warp a row, each lane
//   moving 16 bytes (float4): one 512-byte read and one 512-byte write a
//   warp, from L2 or device memory.
// P4 elem_gather_kernel: o = xf[eidx]. One thread an element, __ldg(xf +
//   eidx): a random element of a 1 MB vector, one 32-byte sector for 4 useful
//   bytes, from L2 once the vector is resident there (1 MB << 50 MB).
// P5 dynslice_kernel: o = sum over k of x2[w[k] : w[k] + 8, :], in k order.
//   One block of 8 x 128 threads. It loads the window offsets into shared
//   memory itself (the TPU prefetched them into SMEM as scalars); thread
//   (r, l) then sums x2[(w[k] + r) * 128 + l] for k = 0 .. nw - 1 from 0,
//   each add rounded on its own (__fadd_rn), so the sum equals the plain
//   version and the Pallas body bit for bit. Each window is 8 whole rows
//   (4 KB, coalesced) read through __ldg.
// P6 roll_dyn_kernel: o[i, j] = x[i, (j - s) mod 128], pltpu.roll's (and
//   jnp.roll's) direction. The shift s is read from device memory by every
//   thread (one broadcast load): the probe exists to test a shift known only
//   at run time, so it is never a host argument. Reads of x are coalesced
//   up to one rotation within the row.
#include "blas.cuh"

namespace tpucg {
namespace {

constexpr int kLane = 128;        // elements in a row
constexpr int kLaneRows = 4;      // rows of a P1 block
constexpr int kWindow = 8;        // rows of a P5 window
constexpr int kMaxWindows = 1024; // P5 windows a launch (shared offsets)
constexpr int kThreads = 256;     // threads of a P2, P4 and P6 block

__global__ void __launch_bounds__(kLaneRows * kLane)
lane_gather_kernel(const float* __restrict__ v, const int* __restrict__ idx,
                   float* __restrict__ o, long long rows) {
  __shared__ float tile[kLaneRows][kLane];
  const int r = threadIdx.y;
  const long long row = static_cast<long long>(blockIdx.x) * kLaneRows + r;
  const bool live = row < rows;
  const long long at = row * kLane + threadIdx.x;
  int lane = 0;
  if (live) {
    tile[r][threadIdx.x] = __ldg(v + at);
    lane = __ldg(idx + at);
  }
  __syncthreads();
  if (live) o[at] = tile[r][lane];
}

__global__ void __launch_bounds__(kThreads)
sub_gather_kernel(const float* __restrict__ v, const int* __restrict__ idx,
                  float* __restrict__ o, long long n) {
  const long long at = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (at >= n) return;
  const long long col = at % kLane;
  o[at] = __ldg(v + static_cast<long long>(__ldg(idx + at)) * kLane + col);
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

__global__ void __launch_bounds__(kWindow * kLane)
dynslice_kernel(const int* __restrict__ w, const float* __restrict__ x2, float* __restrict__ o,
                int nw) {
  __shared__ int start[kMaxWindows];
  const int t = threadIdx.y * kLane + threadIdx.x;
  for (int k = t; k < nw; k += kWindow * kLane) start[k] = __ldg(w + k);
  __syncthreads();
  const int r = threadIdx.y;
  const int l = threadIdx.x;
  float acc = 0.f;
  for (int k = 0; k < nw; ++k) {
    acc = __fadd_rn(acc, __ldg(x2 + static_cast<long long>(start[k] + r) * kLane + l));
  }
  o[r * kLane + l] = acc;
}

__global__ void __launch_bounds__(kThreads)
roll_dyn_kernel(const int* __restrict__ shift, const float* __restrict__ x,
                float* __restrict__ o, long long n) {
  const long long at = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (at >= n) return;
  const long long s = __ldg(shift);
  const long long j = at % kLane;
  const long long src = ((j - s) % kLane + kLane) % kLane;
  o[at] = __ldg(x + (at - j) + src);
}

// Blocks of `per` work items covering n, or 0 when n is out of range.
unsigned blocks_for(long long n, long long per) {
  if (n <= 0 || n > 0x7fffffffLL) return 0;
  return static_cast<unsigned>((n + per - 1) / per);
}

}  // namespace
}  // namespace tpucg

using tpucg::kLane;

extern "C" cudaError_t tpucg_probe_lane_gather_f32(const void* v, const void* idx, void* o,
                                                   long long rows, void* stream) {
  const unsigned grid = tpucg::blocks_for(rows * kLane, tpucg::kLaneRows * kLane);
  if (grid == 0) return cudaErrorInvalidValue;
  tpucg::lane_gather_kernel<<<grid, dim3(kLane, tpucg::kLaneRows), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const int*>(idx), static_cast<float*>(o), rows);
  return cudaGetLastError();
}

extern "C" cudaError_t tpucg_probe_sub_gather_f32(const void* v, const void* idx, void* o,
                                                  long long rows, void* stream) {
  const unsigned grid = tpucg::blocks_for(rows * kLane, tpucg::kThreads);
  if (grid == 0) return cudaErrorInvalidValue;
  tpucg::sub_gather_kernel<<<grid, tpucg::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const int*>(idx), static_cast<float*>(o),
      rows * kLane);
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
                                                void* stream) {
  if (nw < 1 || nw > tpucg::kMaxWindows) return cudaErrorInvalidValue;
  tpucg::dynslice_kernel<<<1, dim3(kLane, tpucg::kWindow), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(w), static_cast<const float*>(x2), static_cast<float*>(o), nw);
  return cudaGetLastError();
}

extern "C" cudaError_t tpucg_probe_roll_dyn_f32(const void* shift, const void* x, void* o,
                                                long long rows, void* stream) {
  const unsigned grid = tpucg::blocks_for(rows * kLane, tpucg::kThreads);
  if (grid == 0) return cudaErrorInvalidValue;
  tpucg::roll_dyn_kernel<<<grid, tpucg::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(shift), static_cast<const float*>(x), static_cast<float*>(o),
      rows * kLane);
  return cudaGetLastError();
}
