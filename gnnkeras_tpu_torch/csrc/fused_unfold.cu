// Whole-unfold kernel on feature-major state: per 128-node tile, n_iter times
//
//   agg = s . A_t                      (A_t: 128x128 bf16, src rows x dst cols)
//   s   = act(Ws^T . s + Wa^T . agg + c)
//
// with s, c of shape (D, 128) per tile and D = d_pad.
//
// Replaces: gnnkeras_tpu/ops/fused.py, _unfold_kernel_t launched by
// fused_unfold_t (the serving route of Predictor).
//
// What bounds it on an H100: bytes.  Per tile it reads the bf16 block
// (32 KiB), the state and the constant (2 x D x 128 f32) and writes D x 128
// f32 once for all n_iter iterations.  The arithmetic is 2 * D * nnz per
// iteration for the aggregation plus 4 * D * D * 128 for the transition,
// which the f32 cores finish in less time than the bytes take.
//
// Design: one block per tile, one thread per node column.  The block, the two
// D x D weights and the state live in shared memory for every iteration, as
// the TPU kernel keeps them in VMEM: the state never returns to device memory
// between iterations.  The aggregation needs every column of the state, the
// transition only the thread's own column, so a thread keeps its own state,
// constant and aggregate columns in registers and the block synchronises
// twice per iteration: after every thread has read the old state, and after
// every thread has written the new one.  selu is spelled with expf(x) - 1,
// as the JAX kernel spells it.  No tensor cores in this version.
//
// Entry: gnn_fused_unfold_t, a plain C function bound with ctypes.  It
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <int D>
constexpr size_t smem_bytes() {
  return TILE * TILE * sizeof(__nv_bfloat16) + (D * TILE + 2 * D * D) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(TILE) fused_unfold_t_kernel(
    const float* __restrict__ s0, const float* __restrict__ c,
    const float* __restrict__ ws, const float* __restrict__ wa,
    const __nv_bfloat16* __restrict__ blocks, float* __restrict__ out, long n,
    int n_iter, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_s = reinterpret_cast<float*>(smem + TILE * TILE * sizeof(__nv_bfloat16));
  float* ws_s = s_s + D * TILE;
  float* wa_s = ws_s + D * D;

  const int t = blockIdx.x;
  const int j = threadIdx.x;
  const long col = static_cast<long>(t) * TILE + j;

  // stage the 32 KiB block with 16-byte loads (8 bf16 each)
  const uint4* a_src = reinterpret_cast<const uint4*>(blocks + static_cast<long>(t) * TILE * TILE);
  uint4* a_dst = reinterpret_cast<uint4*>(a_s);
  for (int k = j; k < TILE * TILE / 8; k += TILE) a_dst[k] = a_src[k];
  for (int k = j; k < D * D; k += TILE) {
    ws_s[k] = ws[k];
    wa_s[k] = wa[k];
  }
  float s[D], cc[D];
#pragma unroll
  for (int f = 0; f < D; ++f) {
    s[f] = s0[f * n + col];
    cc[f] = c[f * n + col];
    s_s[f * TILE + j] = s[f];
  }
  __syncthreads();

  for (int it = 0; it < n_iter; ++it) {
    float agg[D];
#pragma unroll
    for (int f = 0; f < D; ++f) agg[f] = 0.f;
#pragma unroll 4
    for (int i = 0; i < TILE; ++i) {
      const float a = __bfloat162float(a_s[i * TILE + j]);
#pragma unroll
      for (int f = 0; f < D; ++f) agg[f] = fmaf(s_s[f * TILE + i], a, agg[f]);
    }
    __syncthreads();  // every thread has read the old state

    float nxt[D];
#pragma unroll
    for (int g = 0; g < D; ++g) {
      float zs = 0.f, za = 0.f;
#pragma unroll
      for (int f = 0; f < D; ++f) {
        zs = fmaf(ws_s[g * D + f], s[f], zs);
        za = fmaf(wa_s[g * D + f], agg[f], za);
      }
      nxt[g] = activate(zs + za + cc[g], act);
    }
#pragma unroll
    for (int g = 0; g < D; ++g) {
      s[g] = nxt[g];
      s_s[g * TILE + j] = nxt[g];
    }
    __syncthreads();  // the new state is complete
  }

#pragma unroll
  for (int f = 0; f < D; ++f) out[f * n + col] = s[f];
}

template <int D>
cudaError_t launch(const void* s0, const void* c, const void* ws, const void* wa,
                   const void* blocks, void* out, int n_tiles, int n_iter, int act,
                   cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  // Above 48 KiB (D = 24 and 32) the dynamic shared memory limit must be
  // raised, once per device, so later launches on that device, including
  // ones captured into a CUDA graph, make no non-stream API call.
  if (bytes > 48 * 1024) {
    constexpr int kMaxDevices = 64;
    static bool smem_set[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!smem_set[dev]) {
      err = cudaFuncSetAttribute(fused_unfold_t_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
      smem_set[dev] = true;
    }
  }
  fused_unfold_t_kernel<D><<<n_tiles, TILE, bytes, stream>>>(
      static_cast<const float*>(s0), static_cast<const float*>(c),
      static_cast<const float*>(ws), static_cast<const float*>(wa),
      static_cast<const __nv_bfloat16*>(blocks), static_cast<float*>(out),
      static_cast<long>(n_tiles) * TILE, n_iter, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gnn_fused_unfold_t(const void* s0, const void* c, const void* ws,
                                  const void* wa, const void* blocks, void* out, int d,
                                  int n_tiles, int n_iter, int act, void* stream) {
  if (n_tiles < 0 || n_iter < 0 || act < 0 || act > 4) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 8:
      err = launch<8>(s0, c, ws, wa, blocks, out, n_tiles, n_iter, act, s);
      break;
    case 16:
      err = launch<16>(s0, c, ws, wa, blocks, out, n_tiles, n_iter, act, s);
      break;
    case 24:
      err = launch<24>(s0, c, ws, wa, blocks, out, n_tiles, n_iter, act, s);
      break;
    case 32:
      err = launch<32>(s0, c, ws, wa, blocks, out, n_tiles, n_iter, act, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
