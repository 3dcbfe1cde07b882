// Compact-strip aggregation at slot = 128 on feature-major state, both
// directions of the diagonal-block product:
//
//   forward  (scale on the output columns):
//     out[f, 128t + j]    = scale[t, j] * sum_i x[f, 128t + i] * M[t, i, j]
//   backward (scale on the contraction axis, the block read transposed):
//     dstate[f, 128t + i] = sum_j M[t, i, j] * scale[t, j] * ct[f, 128t + j]
//
// Replaces: gnnkeras_tpu/ops/strip.py, _strip_kernel launched by
// _strip_matmul: with scale_in=False on strip (gnn_strip_matmul, the
// aggregation of strip_aggregate_t) and with scale_in=True on strip_t, the
// blocks' transpose (gnn_strip_matmul_t, the VJP _strip_t_bwd).
//
// What bounds both on an H100: bytes.  Per tile a launch reads the 128x128
// operator (16 KiB as an int8 0/1 mask, 512 B of f32 scale) and d x 128 f32
// of state or cotangent, and writes d x 128 f32.  The useful arithmetic is
// 2 * d * nnz FLOP (a few arcs per node), far below what the f32 cores do in
// the time the operator takes to stream from HBM.
//
// Forward design: one block per (tile, chunk of DC feature rows), one thread
// per output column j.  The state chunk (DC x 128 f32, 8 KiB at DC = 16) is
// staged in shared memory once; each thread walks the 128 rows of its mask
// column, so each row read is one coalesced 128-byte line across the block,
// and every mask byte is read from HBM exactly once per launch (DC = d_pad up
// to 16).  The mask is upcast to f32 in registers, the DC accumulators stay
// in registers, and the per-column scale is applied once in the epilogue, as
// the TPU kernel does.
//
// Backward design: the same grid, one thread per output row i, which must sum
// along row i of M.  A thread walking a row straight from HBM would make each
// warp read 32 rows 128 elements apart, so the block first stages the whole
// tile from HBM into shared memory with coalesced 4-byte row loads, each row
// padded by one 4-byte word: thread i then reads word w of row i at bank
// (i + w) mod 32, free of bank conflicts.  The scaled cotangent chunk
// ct[f, 128t + j] * scale[t, j] is staged beside it (the scale multiplies
// the input in the prologue, as scale_in does).  No second, transposed
// operator is stored.  Shared memory per block: 16.5 KiB (int8), 32.5 KiB
// (bf16) or 64.5 KiB (f32) for the tile plus 8 KiB for the chunk at DC = 16;
// above 48 KiB (f32) the limit is raised once per device.
//
// No tensor cores in either: a later change can move the products onto mma.
//
// Entries: gnn_strip_matmul and gnn_strip_matmul_t, plain C functions bound
// with ctypes.  Each launches on the caller's stream and returns
// cudaGetLastError().

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

// One 4-byte shared-memory word of a staged tile holds 4 int8, 2 bf16 or 1
// f32 operator entries, lowest address first.
template <typename MaskT>
struct Word;

template <>
struct Word<int8_t> {
  static constexpr int kValues = 4;
  __device__ __forceinline__ static float at(uint32_t w, int e) {
    return static_cast<float>(static_cast<int8_t>((w >> (8 * e)) & 0xffu));
  }
};

template <>
struct Word<__nv_bfloat16> {
  static constexpr int kValues = 2;
  __device__ __forceinline__ static float at(uint32_t w, int e) {
    return __uint_as_float(((w >> (16 * e)) & 0xffffu) << 16);
  }
};

template <>
struct Word<float> {
  static constexpr int kValues = 1;
  __device__ __forceinline__ static float at(uint32_t w, int) { return __uint_as_float(w); }
};

template <typename MaskT>
__host__ __device__ constexpr int row_words() {
  return TILE * static_cast<int>(sizeof(MaskT)) / 4;
}

template <int DC, typename MaskT>
constexpr size_t smem_bytes_t() {
  return (static_cast<size_t>(TILE) * (row_words<MaskT>() + 1) + DC * TILE) * 4;
}

template <int DC, typename MaskT, bool SCALED>
__global__ void __launch_bounds__(TILE) strip_matmul_t_kernel(
    const float* __restrict__ ct, const MaskT* __restrict__ m,
    const float* __restrict__ scale, float* __restrict__ out, long n) {
  constexpr int RW = row_words<MaskT>();
  constexpr int STRIDE = RW + 1;  // one pad word per row: conflict-free row walks
  constexpr int VPW = Word<MaskT>::kValues;
  extern __shared__ __align__(16) uint32_t smem_t[];
  uint32_t* ms = smem_t;                                // TILE rows of STRIDE words
  float* cs = reinterpret_cast<float*>(smem_t + TILE * STRIDE);  // DC x TILE

  const int t = blockIdx.x;
  const int f0 = blockIdx.y * DC;
  const int tid = threadIdx.x;
  const long col = static_cast<long>(t) * TILE + tid;

  // stage the tile: consecutive threads take consecutive words of a row
  const uint32_t* msrc = reinterpret_cast<const uint32_t*>(m + static_cast<long>(t) * TILE * TILE);
  for (int k = tid; k < TILE * RW; k += TILE) {
    const int r = k / RW, w = k - r * RW;
    ms[r * STRIDE + w] = msrc[k];
  }
  // stage the cotangent chunk, scaled along the contraction axis
  const float s = SCALED ? scale[col] : 1.f;
#pragma unroll
  for (int f = 0; f < DC; ++f) {
    const float v = ct[(f0 + f) * n + col];
    cs[f * TILE + tid] = SCALED ? v * s : v;
  }
  __syncthreads();

  float acc[DC];
#pragma unroll
  for (int f = 0; f < DC; ++f) acc[f] = 0.f;

  const uint32_t* mrow = ms + tid * STRIDE;
#pragma unroll 2
  for (int w = 0; w < RW; ++w) {
    const uint32_t word = mrow[w];
#pragma unroll
    for (int e = 0; e < VPW; ++e) {
      const float a = Word<MaskT>::at(word, e);
      const int j = w * VPW + e;
#pragma unroll
      for (int f = 0; f < DC; ++f) acc[f] = fmaf(cs[f * TILE + j], a, acc[f]);
    }
  }

#pragma unroll
  for (int f = 0; f < DC; ++f) out[(f0 + f) * n + col] = acc[f];
}

template <int DC, typename MaskT, bool SCALED>
cudaError_t launch_t(const float* ct, const MaskT* m, const float* scale, float* out,
                     int d, int n_tiles, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes_t<DC, MaskT>();
  // Above 48 KiB (f32 blocks) the dynamic shared memory limit must be raised,
  // once per device, so later launches on that device, including ones
  // captured into a CUDA graph, make no non-stream API call.
  if (bytes > 48 * 1024) {
    constexpr int kMaxDevices = 64;
    static bool smem_set[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!smem_set[dev]) {
      err = cudaFuncSetAttribute(strip_matmul_t_kernel<DC, MaskT, SCALED>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
      smem_set[dev] = true;
    }
  }
  const dim3 grid(n_tiles, d / DC);
  strip_matmul_t_kernel<DC, MaskT, SCALED><<<grid, TILE, bytes, stream>>>(
      ct, m, scale, out, static_cast<long>(n_tiles) * TILE);
  return cudaGetLastError();
}

template <int DC>
cudaError_t launch(const void* x, const void* m, int mask_kind, const void* scale,
                   void* out, int d, int n_tiles, bool transposed, cudaStream_t stream) {
  const float* xf = static_cast<const float*>(x);
  const float* sf = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out);
  if (transposed) {
    switch (mask_kind) {
      case 0:
        return launch_t<DC, int8_t, true>(xf, static_cast<const int8_t*>(m), sf, of, d, n_tiles, stream);
      case 1:
        return launch_t<DC, float, false>(xf, static_cast<const float*>(m), sf, of, d, n_tiles, stream);
      case 2:
        return launch_t<DC, __nv_bfloat16, false>(xf, static_cast<const __nv_bfloat16*>(m), sf, of, d,
                                                  n_tiles, stream);
      default:
        return cudaErrorInvalidValue;
    }
  }
  const dim3 grid(n_tiles, d / DC);
  const long n = static_cast<long>(n_tiles) * TILE;
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

int dispatch(const void* x, const void* m, int mask_kind, const void* scale, void* out, int d,
             int n_tiles, bool transposed, void* stream) {
  if (d <= 0 || d % 8 != 0 || n_tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = (d % 16 == 0) ? launch<16>(x, m, mask_kind, scale, out, d, n_tiles, transposed, s)
                                  : launch<8>(x, m, mask_kind, scale, out, d, n_tiles, transposed, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int gnn_strip_matmul(const void* x, const void* m, int mask_kind,
                                const void* scale, void* out, int d, int n_tiles,
                                void* stream) {
  return dispatch(x, m, mask_kind, scale, out, d, n_tiles, false, stream);
}

extern "C" int gnn_strip_matmul_t(const void* ct, const void* m, int mask_kind,
                                  const void* scale, void* out, int d, int n_tiles,
                                  void* stream) {
  return dispatch(ct, m, mask_kind, scale, out, d, n_tiles, true, stream);
}
