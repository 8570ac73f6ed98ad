// Hand-written Hopper (sm_90a) kernels of the dense CG lap: the plain C ABI
// that tpucg_torch/kernels/_lib.py binds with ctypes, and the fixed-order
// block reduction that K2 (fused update) and K3 (dot) share.
//
// Every entry point takes the launch stream and an optional `active` device
// flag (const int*, may be null). When the flag reads 0 the kernels return
// at once, so the frozen laps a chunked CG loop runs after convergence cost a
// launch and nothing else; their outputs are then left as they were. Every
// entry point returns cudaGetLastError() after its launches.
#pragma once

#include <cuda_runtime.h>

namespace tpucg {

constexpr int kBlock = 256;          // threads per block, every kernel
constexpr int kMaxPartials = 1024;   // cap on stage-1 blocks of a reduction

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
// valid in thread 0. Called at most once per kernel (one shared buffer).
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

}  // namespace tpucg

extern "C" {

// K1: y[rows] = A[rows, cols] @ x[cols], A f32 or bf16 (row-major), x and y
// f32. cols % 8 == 0; A and x 16-byte aligned.
cudaError_t tpucg_gemv_f32(const void* A, const void* x, void* y, long long rows,
                           long long cols, const void* active, void* stream);
cudaError_t tpucg_gemv_bf16(const void* A, const void* x, void* y, long long rows,
                            long long cols, const void* active, void* stream);

// K3: *out = u . v over n f32; `partials` holds tpucg_reduce_blocks(n) floats.
cudaError_t tpucg_dot_f32(const void* u, const void* v, void* partials, void* out,
                          long long n, const void* active, void* stream);

// K2: xo = x + alpha p, ro = r - alpha ap, *beta = ro . ro, with alpha read
// from device memory. xo may alias x and ro may alias r (in-place update).
cudaError_t tpucg_fused_update_f32(const void* x, const void* r, const void* p,
                                   const void* ap, const void* alpha, void* xo,
                                   void* ro, void* partials, void* beta, long long n,
                                   const void* active, void* stream);

// Length of the `partials` scratch for an n-element reduction.
int tpucg_reduce_blocks(long long n);

// cudaGetErrorString, for the wrappers' error messages.
const char* tpucg_error_string(int err);

}  // extern "C"
