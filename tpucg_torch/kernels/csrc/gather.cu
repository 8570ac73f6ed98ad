// The irregular-sparse lap matvec for Hopper (sm_90a), behind a plain C ABI.
//
// K13 well_spmv_kernel  replaces tpucg/kernels/gather_spmv.py:97 well_spmv
//                       (_well_kernel :57), and under K14's name
//                       tpucg/kernels/gather_spmv.py:226 well_spmv_fused_gather
//                       (_well_kernel_fused :141): both compute one function.
//
// It reads tpucg's WELL arrays as they are (tpucg_torch/sparse/well.py): for
// each slot (s, l) the product vals[s, l] * x[wrow[s / 8] * 128 + lidx[s, l]]
// goes into output row (sgb[s / BS] * BG + gidl[s]) * 128 + l. The TPU kernel
// gathered the 128-wide windows of x with a row DMA, picked lanes with a
// vector shuffle and routed sublanes to their output groups with a one-hot
// matrix product. None of that is needed here: a thread can read any x.
//
// What bounds it on an H100 and what the design does about it:
//
// It must read every stored slot once (NS * 128 * (itemsize + 1) bytes of
// values and lane indices), the window ids, x and write y. At tpucg's FEM
// n = 300k (fill ~0.19, NS * 128 ~ 29M slots) that is ~145 MB, 43 us at
// 3.35 TB/s in f32: device-memory bandwidth bounds it, and the fill (a TPU
// layout choice) makes it stream ~3x the bytes of a CSR product.
//
// One block of 128 threads per output group g, thread l owning output row
// g * 128 + l. A group index built with the operator (`gptr`, `gsub`: the
// sublanes sorted by group, ascending within a group) lists the group's
// sublanes; thread l sums their lane-l products in that order, each product
// and each sum rounded on its own (__fmul_rn / __fadd_rn), from 0. So there
// are no float atomics, y repeats bit for bit, and the plain version (which
// sums in the same order) equals it bit for bit. The warp's loads of a
// sublane's values and lane indices are coalesced (512 + 128 bytes); its x
// reads fall in one 512-byte window; the sublane and window ids are
// broadcast reads. Eight sublanes are loaded before their products are
// added, so a thread keeps several loads in flight. Groups own unequal
// numbers of sublanes (group 0 of each super-group also owns the
// super-group's padding sublanes, which add 0 * x as tpucg's kernel does),
// so blocks end at different times; balancing them is later work.
//
// It reads the lap's `active` flag first and returns at once when it is 0.
#include "blas.cuh"
#include "sparse.cuh"

namespace tpucg {
namespace {

constexpr int kLane = 128;  // threads a block: one per row of a group
constexpr int kUnroll = 8;  // sublanes whose loads are in flight together

template <typename T>
__global__ void __launch_bounds__(kLane)
well_spmv_kernel(const T* __restrict__ vals, const signed char* __restrict__ lidx,
                 const int* __restrict__ wrow, const int* __restrict__ gptr,
                 const int* __restrict__ gsub, const float* __restrict__ x,
                 float* __restrict__ y, const int* __restrict__ active) {
  if (inactive(active)) return;
  const int g = blockIdx.x;
  const int l = threadIdx.x;
  const int j1 = __ldg(gptr + g + 1);
  int j = __ldg(gptr + g);
  float acc = 0.f;
  for (; j + kUnroll <= j1; j += kUnroll) {
    float v[kUnroll];
    long long xi[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long s = __ldg(gsub + j + u);
      const long long slot = s * kLane + l;
      v[u] = widen(__ldg(vals + slot));
      xi[u] = static_cast<long long>(__ldg(wrow + (s >> 3))) * kLane + __ldg(lidx + slot);
    }
    float xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) xv[u] = __ldg(x + xi[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = __fadd_rn(acc, __fmul_rn(v[u], xv[u]));
  }
  for (; j < j1; ++j) {
    const long long s = __ldg(gsub + j);
    const long long slot = s * kLane + l;
    const float xv =
        __ldg(x + static_cast<long long>(__ldg(wrow + (s >> 3))) * kLane + __ldg(lidx + slot));
    acc = __fadd_rn(acc, __fmul_rn(widen(__ldg(vals + slot)), xv));
  }
  y[static_cast<long long>(g) * kLane + l] = acc;
}

template <typename T>
cudaError_t launch_well_spmv(const void* vals, const void* lidx, const void* wrow,
                             const void* gptr, const void* gsub, const void* x, void* y,
                             long long ngroups, const void* active, void* stream) {
  if (ngroups <= 0 || ngroups > 0x7fffffffLL / kLane) return cudaErrorInvalidValue;
  well_spmv_kernel<T><<<static_cast<unsigned>(ngroups), kLane, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const signed char*>(lidx),
      static_cast<const int*>(wrow), static_cast<const int*>(gptr),
      static_cast<const int*>(gsub), static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const int*>(active));
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpucg

extern "C" cudaError_t tpucg_well_spmv_f32(const void* vals, const void* lidx, const void* wrow,
                                           const void* gptr, const void* gsub, const void* x,
                                           void* y, long long ngroups, const void* active,
                                           void* stream) {
  return tpucg::launch_well_spmv<float>(vals, lidx, wrow, gptr, gsub, x, y, ngroups, active,
                                        stream);
}

extern "C" cudaError_t tpucg_well_spmv_bf16(const void* vals, const void* lidx, const void* wrow,
                                            const void* gptr, const void* gsub, const void* x,
                                            void* y, long long ngroups, const void* active,
                                            void* stream) {
  return tpucg::launch_well_spmv<uint16_t>(vals, lidx, wrow, gptr, gsub, x, y, ngroups, active,
                                           stream);
}
