// Shared by the whole-unfold kernels (fused_unfold.cu, fused_unfold_rm.cu):
// the tile width, the transition's activation (selu spelled with
// expf(x) - 1 as the JAX kernels spell it: their TPU lowering has no expm1),
// 16-byte loads and stores of a row, the nonzero bits of bf16 entries and
// the walk of a 128-bit nonzero mask.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async_ring.cuh"

namespace {

constexpr int TILE = 128;
constexpr float SELU_SCALE = 1.0507009873554805f;
constexpr float SELU_ALPHA = 1.6732632423543772f;

// The activation of code ``act`` (the order of
// gnnkeras_tpu_torch.ops.fused._ACT_CODES) on every element of x; the
// switch stands outside the loop, so that the elements' exponentials
// overlap.
template <int N>
__device__ __forceinline__ void activate(float (&x)[N], int act) {
  switch (act) {
    case 0:
#pragma unroll
      for (int k = 0; k < N; ++k) {
        // both sides evaluated, then selected: no branch per element
        const float neg = SELU_ALPHA * (expf(x[k]) - 1.f);
        x[k] = SELU_SCALE * (x[k] > 0.f ? x[k] : neg);
      }
      break;
    case 1:
#pragma unroll
      for (int k = 0; k < N; ++k) x[k] = fmaxf(x[k], 0.f);
      break;
    case 2:
#pragma unroll
      for (int k = 0; k < N; ++k) x[k] = tanhf(x[k]);
      break;
    case 3:
#pragma unroll
      for (int k = 0; k < N; ++k) x[k] = 1.f / (1.f + expf(-x[k]));
      break;
    default:
      break;
  }
}

// A row of F floats (F a multiple of 4) at p, 16-byte aligned, as 16-byte
// loads and stores
template <int F>
__device__ __forceinline__ void load_vec(float (&v)[F], const float* p) {
  static_assert(F % 4 == 0, "rows are whole 16-byte chunks");
#pragma unroll
  for (int k = 0; k < F; k += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + k);
    v[k] = x.x, v[k + 1] = x.y, v[k + 2] = x.z, v[k + 3] = x.w;
  }
}

template <int F>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[F]) {
  static_assert(F % 4 == 0, "rows are whole 16-byte chunks");
#pragma unroll
  for (int k = 0; k < F; k += 4) *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
}

// Bit e set where bf16 entry e of a 16-byte chunk is nonzero (a zero of
// either sign is not)
__device__ __forceinline__ uint32_t bf16_nonzero_bits(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    bits |= static_cast<uint32_t>((w[k] & 0x7fffu) != 0) << (2 * k) |
            static_cast<uint32_t>((w[k] & 0x7fff0000u) != 0) << (2 * k + 1);
  return bits;
}

// fn(k) for every set bit k of the 128-bit mask, k ascending: one bit a
// step, so that the lanes of a warp take as many steps as the most set bits
template <typename F>
__device__ __forceinline__ void for_each_bit(const uint32_t (&mask)[4], F&& fn) {
  uint64_t lo = (static_cast<uint64_t>(mask[1]) << 32) | mask[0];
  uint64_t hi = (static_cast<uint64_t>(mask[3]) << 32) | mask[2];
  while (lo | hi) {
    int k;
    if (lo) {
      k = __ffsll(static_cast<long long>(lo)) - 1;
      lo &= lo - 1;
    } else {
      k = 63 + __ffsll(static_cast<long long>(hi));
      hi &= hi - 1;
    }
    fn(k);
  }
}

}  // namespace
