// The structured-sparse lap matvecs for Hopper (sm_90a), behind a plain C ABI.
//
// K6  dia_spmv_kernel    replaces tpucg/kernels/spmv.py:221 dia_spmv_pallas
//                        (_dia_kernel :152)
// K8  poisson3d_kernel   replaces tpucg/kernels/stencil.py:152 poisson3d_pallas
//                        (_poisson_kernel :84, stencil_apply :44)
//
// What bounds them on an H100 and what the design does about it:
//
// Both are bound by device-memory bandwidth: a few flops per element and no
// reuse beyond neighbouring rows. K6 must read its slab once (ndiag * npad
// elements, f32 or bf16) plus x and write y: at m = 128 Poisson in DIA form
// that is 7 x 8 MiB + 16.8 MB = 75.5 MB, 22.5 us at 3.35 TB/s in f32 and
// 13.8 us in bf16. K8 reads u and writes y, 8n bytes: 16.8 MB, 5.0 us at
// m = 128.
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
// K8 reads the grid at i and its six neighbours i +- 1, i +- m, i +- m^2
// through the read-only cache: a warp's i +- 1 reads hit the lines of its
// own i, the +- m and +- m^2 planes come through L1/L2 when earlier warps
// brought them in, so DRAM traffic stays near the 8n bytes. A tiled
// shared-memory version is later work.
//
// Both read the lap's `active` flag first and return at once when it is 0.
#include "blas.cuh"
#include "sparse.cuh"

namespace tpucg {
namespace {

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

__global__ void __launch_bounds__(kBlock)
poisson3d_kernel(const float* __restrict__ u, float* __restrict__ y, int m,
                 const int* __restrict__ active) {
  if (inactive(active)) return;
  const long long n = static_cast<long long>(m) * m * m;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; i < n;
       i += stride)
    y[i] = stencil_row(m, static_cast<int>(i), __ldg(u + i),
                       [&](long long j) { return __ldg(u + j); });
}

// Blocks of a grid-stride launch over n elements: one element per thread,
// at most 2^20 blocks (the loop covers the rest).
unsigned stride_blocks(long long n) {
  const long long b = (n + kBlock - 1) / kBlock;
  return static_cast<unsigned>(b < (1LL << 20) ? b : (1LL << 20));
}

template <typename T>
cudaError_t launch_dia_spmv(const void* data, const void* offsets, int ndiag, const void* x,
                            void* y, long long npad, const void* active, void* stream) {
  if (ndiag < 1 || ndiag > kDiaMaxDiags || npad <= 0 || offsets == nullptr)
    return cudaErrorInvalidValue;
  DiaOffsets offs{};
  offs.ndiag = ndiag;
  const long long* host = static_cast<const long long*>(offsets);
  for (int d = 0; d < ndiag; ++d) offs.off[d] = host[d];
  dia_spmv_kernel<T><<<stride_blocks(npad), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const float*>(x), static_cast<float*>(y), npad,
      offs, static_cast<const int*>(active));
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

extern "C" cudaError_t tpucg_poisson3d_f32(const void* u, void* y, long long m,
                                           const void* active, void* stream) {
  using namespace tpucg;
  if (m < 2 || m > kStencilMaxM) return cudaErrorInvalidValue;
  poisson3d_kernel<<<stride_blocks(m * m * m), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<float*>(y), static_cast<int>(m),
      static_cast<const int*>(active));
  return cudaGetLastError();
}
