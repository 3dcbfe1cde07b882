// Quantised block-sparse aggregation on feature-major state, both
// directions, gather and segment sum included:
//
//   forward  (scale on the output columns; blocks b of destination tile j):
//     out[f, 128j + c] = sum_b scale[b, c] * sum_r x[f, 128 src[b] + r] * M[b, r, c]
//   backward (scale on the input columns; blocks b of source tile i):
//     out[f, 128i + r] = sum_b sum_c M[b, r, c] * scale[b, c] * ct[f, 128 dst[b] + c]
//
// M is an int8 0/1 mask with one f32 scale per (block, destination column),
// or bf16 weights with no scale.  Neither kernel reads M: each reads the
// block's nonzero entries from a list built on the host.  Block b's entries
// are nz_start[b] .. nz_start[b+1]; the forward's list groups them by
// destination column (col_start: 129 block-local i16 offsets, col_rows: u8
// source rows, ascending within a column), the backward's by source row
// (row_start, row_cols: u8 destination columns, ascending within a row).
// The bf16 storage carries each entry's weight in the same order (u16
// bits); the int8 mask's entries are 1.
//
// Replaces: gnnkeras_tpu/ops/bcsr.py, _qblock_kernel launched by _qbcsr_impl
// (the per-block products; XLA's tile gather before it and segment_sum
// after it are folded in here): with scale_in=False on the forward blocks
// (gnn_qbcsr_matmul, qbcsr_aggregate_t) and with scale_in=True on the
// precomputed transposed blocks (gnn_qbcsr_matmul_t, the VJP _qbcsr_bwd).
// No transposed copy of the operator is stored: the backward walks the
// forward blocks in source-tile order through a host-built permutation and
// reads their row lists.
//
// What bounds both on an H100: bytes.  A launch must read the lists (the
// offsets, one byte of id per nonzero, and two bytes of weight for bf16),
// the scale, the tile index and the input state once, and write the output
// once.  The blocks are ~1% full on a banded graph (147 nonzeros of 16,384
// at a band of 384), so a dense block walk would stream ~100x the bytes it
// uses; the useful arithmetic, 2 * d * nnz FLOP, is far below what the f32
// cores do in the time the lists take to stream.
//
// Design: one thread block per (output tile, chunk of DC feature rows), one
// thread per output column (forward) or row (backward), f32 accumulators in
// registers, the output tile written once.  A tile's blocks are walked in a
// fixed order (row_ptr / src_row_ptr runs), so there are no atomics and the
// sum's order does not change from run to run, and no (d, B, 128)
// intermediate exists.  Thread c (r) walks only its column's (row's)
// entries: ~1 a block at a band of 384, not 128.
//
// The input slice a block reads, 128 columns x DC features of one state
// tile, is staged in shared memory feature-minor ([128][DC]), G blocks at a
// time behind one pair of barriers; each entry then reads its DC features as
// DC/4 float4 broadcasts.  The other choice, gathering only the rows a
// block's lists name straight from the state, costs DC separate 32-byte
// sectors per entry: the state is feature-major, so one node's features lie
// n_in floats apart.  At ~147 entries a block that is ~9x the staged
// slice's 4 KiB (d = 8); the staged slices (~112 MB a forward at a band of
// 384, each state tile read once for each of its ~7 blocks) come mostly
// from L2.  The backward stages its cotangent slice scaled, as the dense
// kernel did.
//
// Sum order: in the forward, a column's entries add in ascending row order
// into a per-block partial, which joins the accumulator as
// fmaf(partial, scale, acc) (or acc + partial for bf16), blocks in row_ptr
// order; in the backward, a row's entries add in ascending column order,
// blocks in src_order.  A 0/1 entry of 1 adds x exactly as fmaf(x, 1, p)
// does, and an entry of 0 leaves fmaf(x, 0, p) = p for finite x, so for
// finite inputs the results equal, bit for bit, those of a walk over the
// dense blocks in the same order.  A non-finite input differs: the dense
// walk turned inf * 0 into NaN, and the list walk never touches the zeros.
//
// DC is the largest of 40, 32, 24, 16, 8 that divides d: one pass over the
// lists for every d_pad up to 40.  G = 64 / DC blocks (at least 1) are
// staged at once: at most 32 KiB of static shared memory.  Padding blocks
// (no entries) are not staged and add nothing.  No tensor cores: ~1 entry a
// thread a block gives a matrix unit nothing to fill.
//
// Entries: gnn_qbcsr_matmul and gnn_qbcsr_matmul_t, plain C functions bound
// with ctypes.  Each launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;

template <int DC>
__host__ __device__ constexpr int group() {
  return 64 / DC > 0 ? 64 / DC : 1;
}

__device__ __forceinline__ float bf16_bits_to_f32(uint16_t w) { return __uint_as_float(static_cast<uint32_t>(w) << 16); }

// acc[f] = fmaf(row[f], a, acc[f]), or acc[f] + row[f] when the entry is an
// int8 1 (WEIGHTED = false): the same bits as fmaf(row[f], 1.f, acc[f]).
template <int DC, bool WEIGHTED>
__device__ __forceinline__ void add_row(float (&acc)[DC], const float* row, float a) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < DC / 4; ++q) {
    const float4 v = r4[q];
    if (WEIGHTED) {
      acc[4 * q + 0] = fmaf(v.x, a, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(v.y, a, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v.z, a, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v.w, a, acc[4 * q + 3]);
    } else {
      acc[4 * q + 0] += v.x;
      acc[4 * q + 1] += v.y;
      acc[4 * q + 2] += v.z;
      acc[4 * q + 3] += v.w;
    }
  }
}

// Thread tid stages column tid of a 128 x DC input slice, feature-minor,
// with float4 stores; SCALED multiplies it by s.
template <int DC, bool SCALED>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, long n_in, long col, float s,
                                      int tid) {
  float v[DC];
#pragma unroll
  for (int f = 0; f < DC; ++f) {
    const float a = __ldg(src + f * n_in + col);
    v[f] = SCALED ? a * s : a;
  }
  float4* d4 = reinterpret_cast<float4*>(dst + tid * DC);
#pragma unroll
  for (int q = 0; q < DC / 4; ++q) d4[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// Forward: thread block (j, chunk), thread c = destination column c of tile j.
template <int DC, bool WEIGHTED, bool SCALED>
__global__ void __launch_bounds__(TILE) qbcsr_list_kernel(
    const float* __restrict__ x, const float* __restrict__ scale, const uint16_t* __restrict__ weights,
    const int* __restrict__ src_tile, const int* __restrict__ row_ptr, const int* __restrict__ nz_start,
    const int16_t* __restrict__ col_start, const uint8_t* __restrict__ col_rows, float* __restrict__ out,
    long n_in, long n_out) {
  constexpr int G = group<DC>();
  __shared__ __align__(16) float xs[G][TILE * DC];  // [block][row r][feature f]
  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  const float* xf = x + static_cast<long>(blockIdx.y) * DC * n_in;

  float acc[DC];
#pragma unroll
  for (int f = 0; f < DC; ++f) acc[f] = 0.f;

  const int end = row_ptr[j + 1];
  for (int b0 = row_ptr[j]; b0 < end; b0 += G) {
    const int nb = min(G, end - b0);
    __syncthreads();  // every thread is done reading the previous group's slices
    for (int g = 0; g < nb; ++g) {
      const int b = b0 + g;
      if (__ldg(nz_start + b + 1) > __ldg(nz_start + b))
        stage<DC, false>(xs[g], xf, n_in, static_cast<long>(__ldg(src_tile + b)) * TILE + tid, 1.f, tid);
    }
    __syncthreads();
    for (int g = 0; g < nb; ++g) {
      const int b = b0 + g;
      const long base = __ldg(nz_start + b);
      const int16_t* starts = col_start + static_cast<long>(b) * (TILE + 1) + tid;
      const int lo = __ldg(starts), hi = __ldg(starts + 1);
      float part[DC];
#pragma unroll
      for (int f = 0; f < DC; ++f) part[f] = 0.f;
      for (int k = lo; k < hi; ++k) {
        const int r = __ldg(col_rows + base + k);
        const float w = WEIGHTED ? bf16_bits_to_f32(__ldg(weights + base + k)) : 1.f;
        add_row<DC, WEIGHTED>(part, xs[g] + r * DC, w);
      }
      const float s = SCALED ? __ldg(scale + static_cast<long>(b) * TILE + tid) : 1.f;
#pragma unroll
      for (int f = 0; f < DC; ++f) acc[f] = SCALED ? fmaf(part[f], s, acc[f]) : acc[f] + part[f];
    }
  }

  float* of = out + static_cast<long>(blockIdx.y) * DC * n_out + static_cast<long>(j) * TILE + tid;
#pragma unroll
  for (int f = 0; f < DC; ++f) of[f * n_out] = acc[f];
}

// Backward: thread block (i, chunk), thread r = source row r of tile i.
template <int DC, bool WEIGHTED, bool SCALED>
__global__ void __launch_bounds__(TILE) qbcsr_list_t_kernel(
    const float* __restrict__ ct, const float* __restrict__ scale, const uint16_t* __restrict__ weights,
    const int* __restrict__ dst_tile, const int* __restrict__ src_order, const int* __restrict__ src_row_ptr,
    const int* __restrict__ nz_start, const int16_t* __restrict__ row_start, const uint8_t* __restrict__ row_cols,
    float* __restrict__ out, long n_in, long n_out) {
  constexpr int G = group<DC>();
  __shared__ __align__(16) float cs[G][TILE * DC];  // [block][column c][feature f], scaled
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const float* cf = ct + static_cast<long>(blockIdx.y) * DC * n_in;

  float acc[DC];
#pragma unroll
  for (int f = 0; f < DC; ++f) acc[f] = 0.f;

  const int end = src_row_ptr[i + 1];
  for (int k0 = src_row_ptr[i]; k0 < end; k0 += G) {
    const int nb = min(G, end - k0);
    __syncthreads();  // every thread is done reading the previous group's slices
    for (int g = 0; g < nb; ++g) {
      const int b = __ldg(src_order + k0 + g);
      if (__ldg(nz_start + b + 1) > __ldg(nz_start + b)) {
        const float s = SCALED ? __ldg(scale + static_cast<long>(b) * TILE + tid) : 1.f;
        stage<DC, SCALED>(cs[g], cf, n_in, static_cast<long>(__ldg(dst_tile + b)) * TILE + tid, s, tid);
      }
    }
    __syncthreads();
    for (int g = 0; g < nb; ++g) {
      const int b = __ldg(src_order + k0 + g);
      const long base = __ldg(nz_start + b);
      const int16_t* starts = row_start + static_cast<long>(b) * (TILE + 1) + tid;
      const int lo = __ldg(starts), hi = __ldg(starts + 1);
      for (int k = lo; k < hi; ++k) {
        const int c = __ldg(row_cols + base + k);
        const float w = WEIGHTED ? bf16_bits_to_f32(__ldg(weights + base + k)) : 1.f;
        add_row<DC, WEIGHTED>(acc, cs[g] + c * DC, w);
      }
    }
  }

  float* of = out + static_cast<long>(blockIdx.y) * DC * n_out + static_cast<long>(i) * TILE + tid;
#pragma unroll
  for (int f = 0; f < DC; ++f) of[f * n_out] = acc[f];
}

struct Args {
  const float* x;
  const float* scale;
  const uint16_t* weights;
  const int* tile_ids;
  const int* order;
  const int* ptr;
  const int* nz_start;
  const int16_t* starts;
  const uint8_t* ids;
  float* out;
  long n_in, n_out;
};

template <int DC, bool WEIGHTED, bool SCALED>
void launch(const Args& a, dim3 grid, bool transposed, cudaStream_t stream) {
  if (transposed)
    qbcsr_list_t_kernel<DC, WEIGHTED, SCALED><<<grid, TILE, 0, stream>>>(
        a.x, a.scale, a.weights, a.tile_ids, a.order, a.ptr, a.nz_start, a.starts, a.ids, a.out, a.n_in, a.n_out);
  else
    qbcsr_list_kernel<DC, WEIGHTED, SCALED><<<grid, TILE, 0, stream>>>(
        a.x, a.scale, a.weights, a.tile_ids, a.ptr, a.nz_start, a.starts, a.ids, a.out, a.n_in, a.n_out);
}

template <int DC>
void launch_kind(const Args& a, dim3 grid, bool transposed, cudaStream_t stream) {
  if (a.weights != nullptr)
    launch<DC, true, false>(a, grid, transposed, stream);  // bf16 weights, no scale
  else
    launch<DC, false, true>(a, grid, transposed, stream);  // int8 0/1 entries with per-column f32 scale
}

int dispatch(const void* x, const void* scale, const void* weights, const void* tile_ids, const void* order,
             const void* ptr, const void* nz_start, const void* starts, const void* ids, void* out, int d,
             int n_in_tiles, int n_out_tiles, bool transposed, void* stream) {
  if (d <= 0 || d % 8 != 0 || n_in_tiles < 0 || n_out_tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((scale == nullptr) == (weights == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (transposed && order == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n_out_tiles == 0) return 0;
  const Args a{static_cast<const float*>(x), static_cast<const float*>(scale),
               static_cast<const uint16_t*>(weights), static_cast<const int*>(tile_ids),
               static_cast<const int*>(order), static_cast<const int*>(ptr), static_cast<const int*>(nz_start),
               static_cast<const int16_t*>(starts), static_cast<const uint8_t*>(ids), static_cast<float*>(out),
               static_cast<long>(n_in_tiles) * TILE, static_cast<long>(n_out_tiles) * TILE};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 40 == 0)
    launch_kind<40>(a, dim3(n_out_tiles, d / 40), transposed, s);
  else if (d % 32 == 0)
    launch_kind<32>(a, dim3(n_out_tiles, d / 32), transposed, s);
  else if (d % 24 == 0)
    launch_kind<24>(a, dim3(n_out_tiles, d / 24), transposed, s);
  else if (d % 16 == 0)
    launch_kind<16>(a, dim3(n_out_tiles, d / 16), transposed, s);
  else
    launch_kind<8>(a, dim3(n_out_tiles, d / 8), transposed, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gnn_qbcsr_matmul(const void* x, const void* scale, const void* col_weights, const void* src_tile,
                                const void* order, const void* row_ptr, const void* nz_start, const void* col_start,
                                const void* col_rows, void* out, int d, int n_src_tiles, int n_dst_tiles,
                                void* stream) {
  return dispatch(x, scale, col_weights, src_tile, order, row_ptr, nz_start, col_start, col_rows, out, d,
                  n_src_tiles, n_dst_tiles, false, stream);
}

extern "C" int gnn_qbcsr_matmul_t(const void* ct, const void* scale, const void* row_weights, const void* dst_tile,
                                  const void* src_order, const void* src_row_ptr, const void* nz_start,
                                  const void* row_start, const void* row_cols, void* out, int d, int n_dst_tiles,
                                  int n_src_tiles, void* stream) {
  return dispatch(ct, scale, row_weights, dst_tile, src_order, src_row_ptr, nz_start, row_start, row_cols, out, d,
                  n_dst_tiles, n_src_tiles, true, stream);
}
