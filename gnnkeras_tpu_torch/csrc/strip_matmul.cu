// Compact-strip aggregation on feature-major state, both directions of the
// diagonal-block product, for slot 128 (dense diagonal blocks), compact
// slot-32/64 strips and the mixed format (compact strips on tiles [0, Ts),
// full diagonal blocks on tiles [Ts, T)):
//
//   forward  (scale on the output columns):
//     out[f, 128t + j]    = scale[t, j] * sum_i x[f, 128t + i] * M[t, i, j]
//   backward (scale on the contraction axis, the block read transposed):
//     dstate[f, 128t + i] = sum_j M[t, i, j] * scale[t, j] * ct[f, 128t + j]
//
// where M[t] is, on a strip tile (t < Ts), the (slot, 128) strip expanded to
// its 128x128 block diagonal: M[t, i, j] = strip[t, i % slot, j] when
// i / slot == j / slot, else 0; and on a block tile the full block
// blocks[t - Ts].  At slot 128 the strip is the dense block.
//
// Replaces: gnnkeras_tpu/ops/strip.py, _strip_kernel launched by
// _strip_matmul (slot-pure strips) and _mixed_kernel launched by
// _strip_matmul_mixed (both regions in one launch): with scale_in=False on
// strip / blocks (gnn_strip_matmul, the aggregation of strip_aggregate_t)
// and with scale_in=True on strip_t / blocks_t, their transposes
// (gnn_strip_matmul_t, the VJP _strip_t_bwd).
//
// What bounds both on an H100: bytes.  Per tile a launch reads the operator
// (slot x 128 entries: 4 KiB at slot 32 as an int8 0/1 mask, 16 KiB for a
// full block, plus 512 B of f32 scale) and d x 128 f32 of state or
// cotangent, and writes d x 128 f32.  The useful arithmetic is
// 2 * d * nnz FLOP (a few arcs per node), far below what the f32 cores do
// in the time the operator takes to stream from HBM.
//
// Forward design: one block per (tile, chunk of DC feature rows), one thread
// per output column j.  The state chunk (DC x 128 f32, 8 KiB at DC = 16) is
// staged in shared memory once; each thread walks its operator column: the
// 128 rows of a full block, or the slot rows of a compact strip, which
// multiply the state rows of j's slot group (slot * (j / slot) + i).  Each
// row read is one coalesced 128-byte line across the block, and every
// operator byte is read from HBM exactly once per launch (DC = d_pad up to
// 16).  The compact strip is never expanded in memory: its zeros are the
// rows a thread skips.  The operator is upcast to f32 in registers, the DC
// accumulators stay in registers, and the per-column scale is applied once
// in the epilogue, as the TPU kernel does.
//
// Backward design: the same grid, one thread per output row i, which must
// sum along row i of M.  A thread walking a row straight from HBM would make
// each warp read 32 rows 128 elements apart, so the block first stages the
// tile's operator rows (slot rows of a strip, 128 of a full block) from HBM
// into shared memory with coalesced 4-byte row loads, each row padded by one
// 4-byte word: thread i reads word w of row i % slot at bank
// (i % slot + w) mod 32, free of bank conflicts, over the words of its slot
// group's columns.  The scaled cotangent chunk ct[f, 128t + j] * scale[t, j]
// is staged beside it (the scale multiplies the input in the prologue, as
// scale_in does).  No second, transposed operator is stored.  Shared memory
// per block: 16.5 KiB (int8), 32.5 KiB (bf16) or 64.5 KiB (f32) for the
// operator plus 8 KiB for the chunk at DC = 16; above 48 KiB (f32) the limit
// is raised once per device.
//
// No tensor cores in either: a later change can move the products onto mma.
//
// bf16-state variant (mask_kind 3, operator type Bf16State): bf16 weights
// whose product first rounds the state (forward) or the cotangent (backward)
// to bf16 (__float2bfloat16_rn) as it is staged, then multiplies in f32.
// That is what the experiment scripts' compact-strip kernels compute
// (scripts/bench_pallas_compact.py _strip_kernel, scripts/bench_strip_blocked.py
// _blocked_kernel, scripts/bench_strip64.py _kernel and _packed_kernel:
// x.astype(bf16) @ strip), where the model's path lifts the operator to f32
// and keeps the state.  It is a separate operator type, so the int8, f32 and
// bf16 instantiations the model runs are compiled exactly as before; it is
// built for slot-pure operators only (the scripts have no block region).
//
// Entries: gnn_strip_matmul and gnn_strip_matmul_t, plain C functions bound
// with ctypes.  Each launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 128;

__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// bf16 weights of the bf16-state variant: the same two bytes as
// __nv_bfloat16, a type of its own so that it instantiates kernels of its own
struct Bf16State {
  __nv_bfloat16 w;
};
__device__ __forceinline__ float to_f32(Bf16State v) { return __bfloat162float(v.w); }

// The state (forward) or cotangent (backward) value as a tile stages it:
// unchanged, or rounded to bf16 for the bf16-state variant.
template <typename MaskT>
__device__ __forceinline__ float staged(float v) {
  return v;
}
template <>
__device__ __forceinline__ float staged<Bf16State>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One tile of the forward: ROWS operator rows (the slot of a compact strip,
// or 128 for a full block) from ``rows``, each multiplying the state row of
// thread j's slot group.  ROWS is a compile-time constant, so the walk's
// trip count and offsets are too.
template <int DC, int ROWS, typename MaskT, bool SCALED>
__device__ __forceinline__ void forward_tile(const float* xs, const MaskT* __restrict__ rows,
                                             const float* __restrict__ scale, float* __restrict__ out, long n,
                                             int f0, long col, int j) {
  float acc[DC];
#pragma unroll
  for (int f = 0; f < DC; ++f) acc[f] = 0.f;
  const float* x0 = xs + (ROWS == TILE ? 0 : (j / ROWS) * ROWS);  // row 0 of j's slot group
  const MaskT* mcol = rows + j;
#pragma unroll 4
  for (int i = 0; i < ROWS; ++i) {
    const float a = to_f32(mcol[i * TILE]);
#pragma unroll
    for (int f = 0; f < DC; ++f) acc[f] = fmaf(x0[f * TILE + i], a, acc[f]);
  }
  const float s = SCALED ? scale[j] : 1.f;
#pragma unroll
  for (int f = 0; f < DC; ++f) out[(f0 + f) * n + col] = SCALED ? acc[f] * s : acc[f];
}

// Tiles [0, ts) hold (SLOT, 128) strips, tiles [ts, T) full blocks; the
// branch is uniform over a thread block.  MIXED is false for a slot-pure
// operator (ts == T): that instantiation has no block region and no branch.
template <int DC, int SLOT, typename MaskT, bool SCALED, bool MIXED>
__global__ void __launch_bounds__(TILE) strip_matmul_kernel(
    const float* __restrict__ x, const MaskT* __restrict__ strip, const float* __restrict__ scale, int ts,
    const MaskT* __restrict__ blocks, const float* __restrict__ blocks_scale, float* __restrict__ out, long n) {
  __shared__ float xs[DC * TILE];
  const int t = blockIdx.x;
  const int f0 = blockIdx.y * DC;
  const int j = threadIdx.x;
  const long col = static_cast<long>(t) * TILE + j;

#pragma unroll
  for (int f = 0; f < DC; ++f) xs[f * TILE + j] = staged<MaskT>(x[(f0 + f) * n + col]);
  __syncthreads();

  if (!MIXED || t < ts) {
    forward_tile<DC, SLOT, MaskT, SCALED>(xs, strip + static_cast<long>(t) * SLOT * TILE,
                                          SCALED ? scale + static_cast<long>(t) * TILE : nullptr, out, n, f0, col, j);
  } else {
    const long tb = t - ts;
    forward_tile<DC, TILE, MaskT, SCALED>(xs, blocks + tb * TILE * TILE, SCALED ? blocks_scale + tb * TILE : nullptr,
                                          out, n, f0, col, j);
  }
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
struct Word<Bf16State> : Word<__nv_bfloat16> {};

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

// One tile of the backward: stage its ROWS operator rows, and the cotangent
// chunk scaled along the contraction axis, then thread tid sums row tid of
// the expanded block: strip row tid % ROWS over the columns of tid's slot
// group (all 128 at ROWS = 128).
template <int DC, int ROWS, typename MaskT, bool SCALED>
__device__ __forceinline__ void backward_tile(uint32_t* ms, float* cs, const float* __restrict__ ct,
                                              const MaskT* __restrict__ rows, const float* __restrict__ scale,
                                              float* __restrict__ out, long n, int f0, long col, int tid) {
  constexpr int RW = row_words<MaskT>();
  constexpr int STRIDE = RW + 1;  // one pad word per row: conflict-free row walks
  constexpr int VPW = Word<MaskT>::kValues;
  // stage the operator rows: consecutive threads take consecutive words of a row
  const uint32_t* msrc = reinterpret_cast<const uint32_t*>(rows);
  for (int k = tid; k < ROWS * RW; k += TILE) {
    const int r = k / RW, w = k - r * RW;
    ms[r * STRIDE + w] = msrc[k];
  }
  const float s = SCALED ? scale[tid] : 1.f;
#pragma unroll
  for (int f = 0; f < DC; ++f) {
    const float v = ct[(f0 + f) * n + col];
    cs[f * TILE + tid] = staged<MaskT>(SCALED ? v * s : v);
  }
  __syncthreads();

  float acc[DC];
#pragma unroll
  for (int f = 0; f < DC; ++f) acc[f] = 0.f;
  const int group = ROWS == TILE ? 0 : (tid / ROWS) * ROWS;  // first column of tid's slot group
  const uint32_t* mrow = ms + (ROWS == TILE ? tid : tid % ROWS) * STRIDE + group / VPW;
  const float* c0 = cs + group;
#pragma unroll 2
  for (int w = 0; w < ROWS / VPW; ++w) {
    const uint32_t word = mrow[w];
#pragma unroll
    for (int e = 0; e < VPW; ++e) {
      const float a = Word<MaskT>::at(word, e);
#pragma unroll
      for (int f = 0; f < DC; ++f) acc[f] = fmaf(c0[f * TILE + w * VPW + e], a, acc[f]);
    }
  }
#pragma unroll
  for (int f = 0; f < DC; ++f) out[(f0 + f) * n + col] = acc[f];
}

template <int DC, int SLOT, typename MaskT, bool SCALED, bool MIXED>
__global__ void __launch_bounds__(TILE) strip_matmul_t_kernel(
    const float* __restrict__ ct, const MaskT* __restrict__ strip, const float* __restrict__ scale, int ts,
    const MaskT* __restrict__ blocks, const float* __restrict__ blocks_scale, float* __restrict__ out, long n) {
  extern __shared__ __align__(16) uint32_t smem_t[];
  uint32_t* ms = smem_t;                                                             // up to TILE rows
  float* cs = reinterpret_cast<float*>(smem_t + TILE * (row_words<MaskT>() + 1));  // DC x TILE
  const int t = blockIdx.x;
  const int f0 = blockIdx.y * DC;
  const int tid = threadIdx.x;
  const long col = static_cast<long>(t) * TILE + tid;
  if (!MIXED || t < ts) {
    backward_tile<DC, SLOT, MaskT, SCALED>(ms, cs, ct, strip + static_cast<long>(t) * SLOT * TILE,
                                           SCALED ? scale + static_cast<long>(t) * TILE : nullptr, out, n, f0, col,
                                           tid);
  } else {
    const long tb = t - ts;
    backward_tile<DC, TILE, MaskT, SCALED>(ms, cs, ct, blocks + tb * TILE * TILE,
                                           SCALED ? blocks_scale + tb * TILE : nullptr, out, n, f0, col, tid);
  }
}

template <int DC, int SLOT, typename MaskT, bool SCALED, bool MIXED>
cudaError_t launch_kernel(const float* x, const void* strip, const float* scale, int ts, const void* blocks,
                         const float* blocks_scale, float* out, int d, int n_tiles, bool transposed,
                         cudaStream_t stream) {
  const MaskT* sm = static_cast<const MaskT*>(strip);
  const MaskT* bm = static_cast<const MaskT*>(blocks);
  const dim3 grid(n_tiles, d / DC);
  const long n = static_cast<long>(n_tiles) * TILE;
  if (!transposed) {
    strip_matmul_kernel<DC, SLOT, MaskT, SCALED, MIXED><<<grid, TILE, 0, stream>>>(x, sm, scale, ts, bm, blocks_scale,
                                                                                   out, n);
    return cudaGetLastError();
  }
  constexpr size_t bytes = smem_bytes_t<DC, MaskT>();
  // Above 48 KiB (f32 operators) the dynamic shared memory limit must be
  // raised, once per device, so later launches on that device, including ones
  // captured into a CUDA graph, make no non-stream API call.
  if (bytes > 48 * 1024) {
    constexpr int kMaxDevices = 64;
    static bool smem_set[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!smem_set[dev]) {
      err = cudaFuncSetAttribute(strip_matmul_t_kernel<DC, SLOT, MaskT, SCALED, MIXED>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
      smem_set[dev] = true;
    }
  }
  strip_matmul_t_kernel<DC, SLOT, MaskT, SCALED, MIXED><<<grid, TILE, bytes, stream>>>(x, sm, scale, ts, bm,
                                                                                       blocks_scale, out, n);
  return cudaGetLastError();
}

template <int DC, int SLOT, typename MaskT, bool SCALED>
cudaError_t launch_typed(const float* x, const void* strip, const float* scale, int ts, const void* blocks,
                         const float* blocks_scale, float* out, int d, int n_tiles, bool transposed,
                         cudaStream_t stream) {
  if constexpr (std::is_same<MaskT, Bf16State>::value) {
    if (ts < n_tiles) return cudaErrorInvalidValue;  // built for slot-pure operators only
  } else {
    if (ts < n_tiles)
      return launch_kernel<DC, SLOT, MaskT, SCALED, true>(x, strip, scale, ts, blocks, blocks_scale, out, d, n_tiles,
                                                          transposed, stream);
  }
  return launch_kernel<DC, SLOT, MaskT, SCALED, false>(x, strip, scale, ts, blocks, blocks_scale, out, d, n_tiles,
                                                       transposed, stream);
}

template <int DC, int SLOT>
cudaError_t launch(const void* x, const void* strip, const void* scale, int ts, const void* blocks,
                   const void* blocks_scale, int mask_kind, void* out, int d, int n_tiles, bool transposed,
                   cudaStream_t stream) {
  const float* xf = static_cast<const float*>(x);
  const float* sf = static_cast<const float*>(scale);
  const float* bsf = static_cast<const float*>(blocks_scale);
  float* of = static_cast<float*>(out);
  switch (mask_kind) {
    case 0:  // int8 0/1 mask with per-column f32 scale
      return launch_typed<DC, SLOT, int8_t, true>(xf, strip, sf, ts, blocks, bsf, of, d, n_tiles, transposed, stream);
    case 1:  // f32 weights, no scale
      return launch_typed<DC, SLOT, float, false>(xf, strip, sf, ts, blocks, bsf, of, d, n_tiles, transposed, stream);
    case 2:  // bf16 weights, no scale
      return launch_typed<DC, SLOT, __nv_bfloat16, false>(xf, strip, sf, ts, blocks, bsf, of, d, n_tiles, transposed,
                                                          stream);
    case 3:  // bf16 weights, state rounded to bf16 (the experiment scripts' product)
      return launch_typed<DC, SLOT, Bf16State, false>(xf, strip, sf, ts, blocks, bsf, of, d, n_tiles, transposed,
                                                      stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int DC>
cudaError_t launch_slot(const void* x, const void* strip, const void* scale, int ts, int slot, const void* blocks,
                        const void* blocks_scale, int mask_kind, void* out, int d, int n_tiles, bool transposed,
                        cudaStream_t stream) {
  switch (slot) {
    case 32:
      return launch<DC, 32>(x, strip, scale, ts, blocks, blocks_scale, mask_kind, out, d, n_tiles, transposed, stream);
    case 64:
      return launch<DC, 64>(x, strip, scale, ts, blocks, blocks_scale, mask_kind, out, d, n_tiles, transposed, stream);
    case TILE:
      return launch<DC, TILE>(x, strip, scale, ts, blocks, blocks_scale, mask_kind, out, d, n_tiles, transposed,
                              stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(const void* x, const void* strip, const void* scale, int ts, int slot, const void* blocks,
             const void* blocks_scale, int mask_kind, void* out, int d, int n_tiles, bool transposed,
             void* stream) {
  if (d <= 0 || d % 8 != 0 || n_tiles < 0 || ts < 0 || ts > n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  if (ts < n_tiles && blocks == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = (d % 16 == 0)
                        ? launch_slot<16>(x, strip, scale, ts, slot, blocks, blocks_scale, mask_kind, out, d, n_tiles,
                                          transposed, s)
                        : launch_slot<8>(x, strip, scale, ts, slot, blocks, blocks_scale, mask_kind, out, d, n_tiles,
                                         transposed, s);
  return static_cast<int>(err);
}

}  // namespace

// strip (ts, slot, 128) with scale (ts, 128) covers tiles [0, ts); blocks
// (n_tiles - ts, 128, 128) with blocks_scale cover the rest (null when
// ts == n_tiles).  Scales are null for float operators.
extern "C" int gnn_strip_matmul(const void* x, const void* strip, const void* scale, int ts, int slot,
                                const void* blocks, const void* blocks_scale, int mask_kind, void* out, int d,
                                int n_tiles, void* stream) {
  return dispatch(x, strip, scale, ts, slot, blocks, blocks_scale, mask_kind, out, d, n_tiles, false, stream);
}

extern "C" int gnn_strip_matmul_t(const void* ct, const void* strip, const void* scale, int ts, int slot,
                                  const void* blocks, const void* blocks_scale, int mask_kind, void* out, int d,
                                  int n_tiles, void* stream) {
  return dispatch(ct, strip, scale, ts, slot, blocks, blocks_scale, mask_kind, out, d, n_tiles, true, stream);
}
