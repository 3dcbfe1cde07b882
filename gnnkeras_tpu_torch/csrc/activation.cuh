// Shared by the whole-unfold kernels (fused_unfold.cu, fused_unfold_rm.cu):
// the tile width and the transition's activation, selu spelled with
// expf(x) - 1 as the JAX kernels spell it (their TPU lowering has no expm1).

#pragma once

namespace {

constexpr int TILE = 128;
constexpr float SELU_SCALE = 1.0507009873554805f;
constexpr float SELU_ALPHA = 1.6732632423543772f;

// activation codes, in the order of gnnkeras_tpu_torch.ops.fused._ACT_CODES
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 0:
      return SELU_SCALE * (x > 0.f ? x : SELU_ALPHA * (expf(x) - 1.f));
    case 1:
      return fmaxf(x, 0.f);
    case 2:
      return tanhf(x);
    case 3:
      return 1.f / (1.f + expf(-x));
    default:
      return x;
  }
}

}  // namespace
