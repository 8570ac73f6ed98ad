// Row functions of the DIA operators, used by the lap kernels (sparse.cu:
// K6 DIA SpMV, K7 its row-block form with halos); the whole solves K11 and
// K12 (fused.cu) sum each row term by term in these functions' order, so a
// lap and a whole solve compute one operator the same way, and K8/K9
// (sparse.cu) and K10 (fused.cu) sum the 7-point stencil in one order,
// tpucg's x+1, x-1, y+1, y-1, z+1, z-1 (stencil.py:60-80).
//
// Both take the input vector as a functor v(j) (j a flat index inside the
// vector; the row functions never call it outside [0, n)): the lap kernels
// pass a read through the read-only cache.
//
// The sums are taken in the plain version's order, each product and each
// sum rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn keep nvcc from
// contracting them into FMAs), so a kernel's y equals its plain PyTorch
// version's bit for bit.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tpucg {

constexpr int kDiaMaxDiags = 64;  // tpucg's cap on the diagonals of its DIA kernel

// A DIA matrix's offsets, passed by value to the kernels (520 bytes).
struct DiaOffsets {
  int ndiag;
  long long off[kDiaMaxDiags];
};

// One slab element widened to f32: a float as it is, a bf16 (raw bits)
// exactly (its bits are the high half of the f32's).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// Row i of the DIA slab `data` (ndiag, npad), row-major and read-only for
// the launch, against a vector given column by column: sum over d, in
// offsets order from 0, of data[d, i] * xat(i + off_d). `xat` takes every
// column the offsets reach, inside [0, npad) or not.
template <typename T, class X>
__device__ __forceinline__ float dia_sum(const T* __restrict__ data, long long npad,
                                         const DiaOffsets& offs, long long i, X xat) {
  float acc = 0.f;
  for (int d = 0; d < offs.ndiag; ++d)
    acc = __fadd_rn(acc, __fmul_rn(widen(__ldg(data + d * npad + i)), xat(i + offs.off[d])));
  return acc;
}

// (A v)[i] for the DIA matrix with slab `data`: dia_sum with a column
// outside [0, npad) giving 0.
template <typename T, class V>
__device__ __forceinline__ float dia_row(const T* __restrict__ data, long long npad,
                                         const DiaOffsets& offs, long long i, V v) {
  return dia_sum(data, npad, offs, i,
                 [&](long long j) { return (j >= 0 && j < npad) ? v(j) : 0.f; });
}

// V neighbouring columns of one row of a row-major (rows, k) block, the
// k-column kernels' unit of work (sparse.cu, gather.cu): V = 4 is one
// 16-byte load or store (k % 4 == 0 and the block 16-byte aligned), V = 1
// a float. Cols<V>{} is V zeros (+0), a row outside the block.
template <int V>
struct Cols {
  float v[V];
};

template <int V>
__device__ __forceinline__ Cols<V> load_cols(const float* __restrict__ p) {
  Cols<V> c;
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    c.v[0] = q.x;
    c.v[1] = q.y;
    c.v[2] = q.z;
    c.v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) c.v[j] = __ldg(p + j);
  }
  return c;
}

template <int V>
__device__ __forceinline__ void store_cols(float* p, const float (&a)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = a[j];
  }
}

// The columns a thread of a k-column kernel takes: 4 where k % 4 == 0 and
// the input and output blocks are 16-byte aligned, else 1.
inline int cols_a_thread(long long k, const void* x, const void* y) {
  const bool a16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  return k % 4 == 0 && a16 ? 4 : 1;
}

// Sizes the kernels index with int: a grid-stride loop's i + stride must
// stay below 2^31 for up to 2^22 threads (K8/K9 keep the same cap).
constexpr long long kMaxIntRows = 0x7fffffffLL - (1LL << 22);
constexpr long long kStencilMaxM = 1280;  // 1280^3 <= kMaxIntRows

}  // namespace tpucg
