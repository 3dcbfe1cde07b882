// Compact-strip aggregation at slot = 128, forward direction (scale on the
// output columns), on feature-major state:
//
//   out[f, 128t + j] = scale[t, j] * sum_i x[f, 128t + i] * M[t, i, j]
//
// Replaces: gnnkeras_tpu/ops/strip.py, _strip_kernel launched by
// _strip_matmul (scale_in=False), the aggregation of strip_aggregate_t.
//
// What bounds it on an H100: bytes.  Per tile it reads the 128x128 operator
// (16 KiB as an int8 0/1 mask, 512 B of f32 scale) and d x 128 f32 of state,
// and writes d x 128 f32.  The useful arithmetic is 2 * d * nnz FLOP (a few
// arcs per node), far below what the f32 cores do in the time the operator
// takes to stream from HBM.
//
// Design: one block per (tile, chunk of DC feature rows), one thread per
// output column j.  The state chunk (DC x 128 f32, 8 KiB at DC = 16) is staged
// in shared memory once; each thread walks the 128 rows of its mask column,
// so each row read is one coalesced 128-byte line across the block, and every
// mask byte is read from HBM exactly once per launch (DC = d_pad up to 16).
// The mask is upcast to f32 in registers, the DC accumulators stay in
// registers, and the per-column scale is applied once in the epilogue, as
// the TPU kernel does.  No tensor cores: a later change can move the product
// onto mma with the mask upcast to bf16 in shared memory.
//
// Entry: gnn_strip_matmul, a plain C function bound with ctypes.  It
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;

__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int DC, typename MaskT, bool SCALED>
__global__ void __launch_bounds__(TILE) strip_matmul_kernel(
    const float* __restrict__ x, const MaskT* __restrict__ m,
    const float* __restrict__ scale, float* __restrict__ out, long n) {
  __shared__ float xs[DC][TILE];
  const int t = blockIdx.x;
  const int f0 = blockIdx.y * DC;
  const int j = threadIdx.x;
  const long col = static_cast<long>(t) * TILE + j;

#pragma unroll
  for (int f = 0; f < DC; ++f) xs[f][j] = x[(f0 + f) * n + col];
  __syncthreads();

  float acc[DC];
#pragma unroll
  for (int f = 0; f < DC; ++f) acc[f] = 0.f;

  const MaskT* mcol = m + static_cast<long>(t) * TILE * TILE + j;
#pragma unroll 4
  for (int i = 0; i < TILE; ++i) {
    const float a = to_f32(mcol[i * TILE]);
#pragma unroll
    for (int f = 0; f < DC; ++f) acc[f] = fmaf(xs[f][i], a, acc[f]);
  }

  const float s = SCALED ? scale[col] : 1.f;
#pragma unroll
  for (int f = 0; f < DC; ++f) out[(f0 + f) * n + col] = SCALED ? acc[f] * s : acc[f];
}

template <int DC>
cudaError_t launch(const void* x, const void* m, int mask_kind, const void* scale,
                   void* out, int d, int n_tiles, cudaStream_t stream) {
  const dim3 grid(n_tiles, d / DC);
  const long n = static_cast<long>(n_tiles) * TILE;
  const float* xf = static_cast<const float*>(x);
  const float* sf = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out);
  switch (mask_kind) {
    case 0:  // int8 0/1 mask with per-column f32 scale
      strip_matmul_kernel<DC, int8_t, true>
          <<<grid, TILE, 0, stream>>>(xf, static_cast<const int8_t*>(m), sf, of, n);
      break;
    case 1:  // f32 weights, no scale
      strip_matmul_kernel<DC, float, false>
          <<<grid, TILE, 0, stream>>>(xf, static_cast<const float*>(m), sf, of, n);
      break;
    case 2:  // bf16 weights, no scale
      strip_matmul_kernel<DC, __nv_bfloat16, false>
          <<<grid, TILE, 0, stream>>>(xf, static_cast<const __nv_bfloat16*>(m), sf, of, n);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int gnn_strip_matmul(const void* x, const void* m, int mask_kind,
                                const void* scale, void* out, int d, int n_tiles,
                                void* stream) {
  if (d <= 0 || d % 8 != 0 || n_tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = (d % 16 == 0) ? launch<16>(x, m, mask_kind, scale, out, d, n_tiles, s)
                                  : launch<8>(x, m, mask_kind, scale, out, d, n_tiles, s);
  return static_cast<int>(err);
}
