// Quantised block-sparse aggregation on feature-major state, both
// directions, gather and segment sum included:
//
//   forward  (scale on the output columns; blocks b of destination tile j):
//     out[f, 128j + c] = sum_b scale[b, c] * sum_r x[f, 128 src[b] + r] * M[b, r, c]
//   backward (scale on the input columns; blocks b of source tile i):
//     out[f, 128i + r] = sum_b sum_c M[b, r, c] * scale[b, c] * ct[f, 128 dst[b] + c]
//
// M is an int8 0/1 mask with one f32 scale per (block, destination column),
// or bf16 weights with no scale.
//
// Replaces: gnnkeras_tpu/ops/bcsr.py, _qblock_kernel launched by _qbcsr_impl
// (the per-block products; XLA's tile gather before it and segment_sum
// after it are folded in here): with scale_in=False on the forward blocks
// (gnn_qbcsr_matmul, qbcsr_aggregate_t) and with scale_in=True on the
// precomputed transposed blocks (gnn_qbcsr_matmul_t, the VJP _qbcsr_bwd).
// No transposed copy of the operator is stored: the backward reads the
// forward blocks transposed, walking them in source-tile order through a
// host-built permutation.
//
// What bounds both on an H100: bytes.  A launch must read every block once
// (16 KiB int8 + 512 B scale, or 32 KiB bf16), the state tiles it gathers
// and write the output once; the useful arithmetic, 2 * d * nnz FLOP, is far
// below what the f32 cores do in the time the blocks take to stream.
//
// Design: one thread block per (output tile, chunk of DC feature rows), one
// thread per output column, f32 accumulators in registers, the output tile
// written once.  A tile's blocks are walked in a fixed order (row_ptr /
// src_row_ptr runs), so there are no atomics and the sum's order does not
// change from run to run, and no (d, B, 128) intermediate exists.  Per
// block the gathered input tile is staged in shared memory feature-minor
// ([128][DC]), so the inner loop reads DC/4 float4 broadcasts per operator
// entry.
// - Forward: thread c walks column c of the block straight from HBM; each
//   row read is one coalesced line across the thread block.
// - Backward: thread r must walk row r.  The block is first staged into
//   shared memory with coalesced 4-byte loads, each row padded by one word,
//   so thread r's reads of word w land on bank (r + w) mod 32, conflict free.
//   Shared memory: 16.5 KiB (int8) or 32.5 KiB (bf16) for the block plus
//   DC x 512 B for the cotangent chunk; above 48 KiB (bf16 at DC >= 32) the
//   limit is raised once per device.
// DC is the largest of 40, 32, 24, 16, 8 that divides d: one pass over the
// operator for every d_pad up to 40.  Padding blocks (all-zero) add nothing.
// No tensor cores: a later change can move the products onto mma.
//
// Entries: gnn_qbcsr_matmul and gnn_qbcsr_matmul_t, plain C functions bound
// with ctypes.  Each launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;

__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One 4-byte shared-memory word of a staged block holds 4 int8 or 2 bf16
// entries, lowest address first.
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

template <typename MaskT>
__host__ __device__ constexpr int row_words() {
  return TILE * static_cast<int>(sizeof(MaskT)) / 4;
}

template <int DC>
__device__ __forceinline__ void fma_row(float (&acc)[DC], const float* row, float a) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < DC / 4; ++q) {
    const float4 v = r4[q];
    acc[4 * q + 0] = fmaf(v.x, a, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(v.y, a, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(v.z, a, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(v.w, a, acc[4 * q + 3]);
  }
}

template <int DC, typename MaskT, bool SCALED>
__global__ void __launch_bounds__(TILE) qbcsr_kernel(
    const float* __restrict__ x, const MaskT* __restrict__ m, const float* __restrict__ scale,
    const int* __restrict__ src_tile, const int* __restrict__ row_ptr, float* __restrict__ out,
    long n_in, long n_out) {
  __shared__ __align__(16) float xs[TILE * DC];  // [row r][feature f]
  const int j = blockIdx.x;
  const int f0 = blockIdx.y * DC;
  const int tid = threadIdx.x;

  float acc[DC];
#pragma unroll
  for (int f = 0; f < DC; ++f) acc[f] = 0.f;

  const int end = row_ptr[j + 1];
  for (int b = row_ptr[j]; b < end; ++b) {
    const long src_col = static_cast<long>(src_tile[b]) * TILE + tid;
    __syncthreads();  // every thread is done reading the previous block's tile
#pragma unroll
    for (int f = 0; f < DC; ++f) xs[tid * DC + f] = x[(f0 + f) * n_in + src_col];
    __syncthreads();

    float part[DC];
#pragma unroll
    for (int f = 0; f < DC; ++f) part[f] = 0.f;
    const MaskT* mcol = m + static_cast<long>(b) * TILE * TILE + tid;
#pragma unroll 4
    for (int r = 0; r < TILE; ++r) fma_row<DC>(part, xs + r * DC, to_f32(mcol[r * TILE]));

    const float s = SCALED ? scale[static_cast<long>(b) * TILE + tid] : 1.f;
#pragma unroll
    for (int f = 0; f < DC; ++f) acc[f] = SCALED ? fmaf(part[f], s, acc[f]) : acc[f] + part[f];
  }

  const long col = static_cast<long>(j) * TILE + tid;
#pragma unroll
  for (int f = 0; f < DC; ++f) out[(f0 + f) * n_out + col] = acc[f];
}

template <int DC, typename MaskT>
constexpr size_t smem_bytes_t() {
  return (static_cast<size_t>(TILE) * (row_words<MaskT>() + 1) + DC * TILE) * 4;
}

template <int DC, typename MaskT, bool SCALED>
__global__ void __launch_bounds__(TILE) qbcsr_t_kernel(
    const float* __restrict__ ct, const MaskT* __restrict__ m, const float* __restrict__ scale,
    const int* __restrict__ dst_tile, const int* __restrict__ src_order, const int* __restrict__ src_row_ptr,
    float* __restrict__ out, long n_in, long n_out) {
  constexpr int RW = row_words<MaskT>();
  constexpr int STRIDE = RW + 1;  // one pad word per row: conflict-free row walks
  constexpr int VPW = Word<MaskT>::kValues;
  extern __shared__ __align__(16) uint32_t smem_t[];
  uint32_t* ms = smem_t;                                         // TILE rows of STRIDE words
  float* cs = reinterpret_cast<float*>(smem_t + TILE * STRIDE);  // [column c][feature f]

  const int i = blockIdx.x;
  const int f0 = blockIdx.y * DC;
  const int tid = threadIdx.x;

  float acc[DC];
#pragma unroll
  for (int f = 0; f < DC; ++f) acc[f] = 0.f;

  const int end = src_row_ptr[i + 1];
  for (int k = src_row_ptr[i]; k < end; ++k) {
    const int b = src_order[k];
    const long in_col = static_cast<long>(dst_tile[b]) * TILE + tid;
    __syncthreads();  // every thread is done reading the previous block
    // stage the block: consecutive threads take consecutive words of a row
    const uint32_t* msrc = reinterpret_cast<const uint32_t*>(m + static_cast<long>(b) * TILE * TILE);
    for (int w = tid; w < TILE * RW; w += TILE) {
      const int r = w / RW, c = w - r * RW;
      ms[r * STRIDE + c] = msrc[w];
    }
    // stage the cotangent chunk, scaled along the contraction axis
    const float s = SCALED ? scale[static_cast<long>(b) * TILE + tid] : 1.f;
#pragma unroll
    for (int f = 0; f < DC; ++f) {
      const float v = ct[(f0 + f) * n_in + in_col];
      cs[tid * DC + f] = SCALED ? v * s : v;
    }
    __syncthreads();

    const uint32_t* mrow = ms + tid * STRIDE;
#pragma unroll 2
    for (int w = 0; w < RW; ++w) {
      const uint32_t word = mrow[w];
#pragma unroll
      for (int e = 0; e < VPW; ++e) fma_row<DC>(acc, cs + (w * VPW + e) * DC, Word<MaskT>::at(word, e));
    }
  }

  const long col = static_cast<long>(i) * TILE + tid;
#pragma unroll
  for (int f = 0; f < DC; ++f) out[(f0 + f) * n_out + col] = acc[f];
}

// Raise a kernel's dynamic shared memory limit above 48 KiB, once per device,
// so later launches on that device, including ones captured into a CUDA
// graph, make no non-stream API call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool (&done)[64]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int DC, typename MaskT, bool SCALED>
cudaError_t launch(const void* x, const void* m, const void* scale, const int* tile_ids, const int* order,
                   const int* ptr, void* out, int d, int n_in_tiles, int n_out_tiles, bool transposed,
                   cudaStream_t stream) {
  const float* xf = static_cast<const float*>(x);
  const MaskT* mm = static_cast<const MaskT*>(m);
  const float* sf = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out);
  const long n_in = static_cast<long>(n_in_tiles) * TILE, n_out = static_cast<long>(n_out_tiles) * TILE;
  const dim3 grid(n_out_tiles, d / DC);
  if (transposed) {
    constexpr size_t bytes = smem_bytes_t<DC, MaskT>();
    static bool smem_set[64] = {};
    cudaError_t err = allow_smem(qbcsr_t_kernel<DC, MaskT, SCALED>, bytes, smem_set);
    if (err != cudaSuccess) return err;
    qbcsr_t_kernel<DC, MaskT, SCALED><<<grid, TILE, bytes, stream>>>(xf, mm, sf, tile_ids, order, ptr, of, n_in,
                                                                     n_out);
  } else {
    qbcsr_kernel<DC, MaskT, SCALED><<<grid, TILE, 0, stream>>>(xf, mm, sf, tile_ids, ptr, of, n_in, n_out);
  }
  return cudaGetLastError();
}

template <int DC>
cudaError_t launch_kind(const void* x, const void* m, int mask_kind, const void* scale, const int* tile_ids,
                        const int* order, const int* ptr, void* out, int d, int n_in_tiles, int n_out_tiles,
                        bool transposed, cudaStream_t stream) {
  switch (mask_kind) {
    case 0:  // int8 0/1 mask with per-column f32 scale
      return launch<DC, int8_t, true>(x, m, scale, tile_ids, order, ptr, out, d, n_in_tiles, n_out_tiles,
                                      transposed, stream);
    case 2:  // bf16 weights, no scale
      return launch<DC, __nv_bfloat16, false>(x, m, scale, tile_ids, order, ptr, out, d, n_in_tiles,
                                              n_out_tiles, transposed, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(const void* x, const void* m, int mask_kind, const void* scale, const void* tile_ids,
             const void* order, const void* ptr, void* out, int d, int n_in_tiles, int n_out_tiles,
             bool transposed, void* stream) {
  if (d <= 0 || d % 8 != 0 || n_in_tiles < 0 || n_out_tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_out_tiles == 0) return 0;
  if (transposed && order == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ti = static_cast<const int*>(tile_ids);
  const int* od = static_cast<const int*>(order);
  const int* pt = static_cast<const int*>(ptr);
  cudaError_t err;
  if (d % 40 == 0)
    err = launch_kind<40>(x, m, mask_kind, scale, ti, od, pt, out, d, n_in_tiles, n_out_tiles, transposed, s);
  else if (d % 32 == 0)
    err = launch_kind<32>(x, m, mask_kind, scale, ti, od, pt, out, d, n_in_tiles, n_out_tiles, transposed, s);
  else if (d % 24 == 0)
    err = launch_kind<24>(x, m, mask_kind, scale, ti, od, pt, out, d, n_in_tiles, n_out_tiles, transposed, s);
  else if (d % 16 == 0)
    err = launch_kind<16>(x, m, mask_kind, scale, ti, od, pt, out, d, n_in_tiles, n_out_tiles, transposed, s);
  else
    err = launch_kind<8>(x, m, mask_kind, scale, ti, od, pt, out, d, n_in_tiles, n_out_tiles, transposed, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int gnn_qbcsr_matmul(const void* x, const void* m, int mask_kind, const void* scale,
                                const void* src_tile, const void* order, const void* row_ptr, void* out, int d,
                                int n_src_tiles, int n_dst_tiles, void* stream) {
  return dispatch(x, m, mask_kind, scale, src_tile, order, row_ptr, out, d, n_src_tiles, n_dst_tiles, false,
                  stream);
}

extern "C" int gnn_qbcsr_matmul_t(const void* ct, const void* m, int mask_kind, const void* scale,
                                  const void* dst_tile, const void* src_order, const void* src_row_ptr, void* out,
                                  int d, int n_dst_tiles, int n_src_tiles, void* stream) {
  return dispatch(ct, m, mask_kind, scale, dst_tile, src_order, src_row_ptr, out, d, n_dst_tiles, n_src_tiles,
                  true, stream);
}
