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
// (gnn_strip_matmul_t, the VJP _strip_t_bwd).  The experiment scripts'
// compact-strip kernels (scripts/bench_pallas_compact.py _strip_kernel,
// scripts/bench_strip_blocked.py _blocked_kernel, scripts/bench_strip64.py
// _kernel and _packed_kernel) run on the bf16-state operator type below.
//
// What bounds both on an H100: bytes at 3.35 TB/s.  Per tile a launch reads
// the operator once (slot x 128 entries: 4 KiB at slot 32 as an int8 0/1
// mask, 32 KiB for a bf16 block, plus 512 B of f32 scale) and d x 128 f32 of
// state or cotangent, and writes d x 128 f32.  The f32 fused multiply-adds
// come close behind: at bench scale (1,085 slot-128 tiles, d 16) 284 M of
// them, ~8.5 us of the CUDA cores' peak against 15.9 us of bytes (bf16).
//
// Numbers: every output is an f32 fused multiply-add chain from 0 over its
// contraction, in order (r forward, k backward), with the int8 scale on the
// output columns forward and on the cotangent (one f32 product, as
// scale_in does) before the chain backward.  That is how the plain version's
// f32 product sums on the CPU, so the card's forwards and train steps meet
// the CPU's.  Tensor cores sum a k-step's products in an order of their own,
// and an answer that is more exact is no nearer: the card-against-CPU checks
// sit at the f32 noise floor of the 5-iteration forward, where only the
// CPU's order meets them.  Zero entries leave a chain unchanged, so a
// compact strip's contraction is its slot group's slot rows only: the block
// diagonal is never expanded.  No atomics: two launches give the same bits.
//
// Design, one routine for both directions (tile_fma).  Thread (warp w, lane
// l) owns two output positions p, p + 1 (p = 64 (w & 1) + 2l: columns j
// forward, rows i backward) and d / 2 feature rows (half the block's d
// each), so 2 x d/2 sums in registers.  Per 4 contraction steps it takes 8
// operator entries from shared memory (forward: 2 entries of each of 4 rows;
// backward: 16-byte chunks of its 2 rows, 4 to 16 entries each, read along
// the contraction, so no transposed operator is stored) and one float4 of
// state per feature row, broadcast over the lanes of a slot group: 8 fused
// multiply-adds per float4.  int8 entries become f32 exactly by a byte
// permute and one add.  Operator rows keep their 16-byte chunks
// XOR-swizzled by row, and the state rows' 32-column groups are 16 B apart,
// so the loads are free of bank conflicts.
//
// Tile stream.  Persistent blocks (as many as fit on the card, at most one a
// tile) walk the tiles t = blockIdx.x, + gridDim.x, ...  Each tile's operator
// (contiguous in HBM), state chunk (d rows of 512 B, strided by n) and scale
// arrive by 16-byte cp.async into a ring of 2-3 stages (whichever keeps more
// tiles in flight on an SM), so the copies of the next tiles run while this
// one multiplies.  All of d up to 48 is one chunk of 8, 16, 32 or 48 feature
// rows (rows past d copied as zeros and not stored): the operator is read
// once (larger d: chunks of 48, one grid row each).
//
// bf16-state variant (mask kind 3, operator type Bf16State): bf16 weights
// whose product first rounds the state (forward) or the cotangent (backward)
// to bf16 (round to nearest even).  That is what the experiment scripts'
// compact-strip kernels compute (x.astype(bf16) @ strip), where the model's
// path keeps the state; its products are exact in bf16, so it runs on
// tensor cores (tile_mma): mma.sync.m16n8k16 with f32 accumulators, the
// operator by ldmatrix.trans forward and ldmatrix backward, the rounded state
// as one bf16 plane.  It is built for slot-pure operators only (the scripts
// have no block region).
//
// Entries: gnn_strip_matmul and gnn_strip_matmul_t, plain C functions bound
// with ctypes.  Every operand must start on a 16-byte boundary.  Each
// launches on the caller's stream and returns cudaGetLastError().  The
// kernels themselves are templates (strip_matmul.cuh), instantiated in eight
// translation units, one per mask kind and direction (strip_matmul_unit.cu).
#include "strip_matmul.cuh"

namespace {

int dispatch(const void* x, const void* strip, const void* scale, int ts, int slot, const void* blocks,
             const void* blocks_scale, int mask_kind, void* out, int d, int n_tiles, bool transposed,
             void* stream) {
  if (d <= 0 || d % 8 != 0 || n_tiles < 0 || ts < 0 || ts > n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  if (ts < n_tiles && blocks == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  const gnn_strip::Call c{static_cast<const float*>(x), strip, static_cast<const float*>(scale), ts, slot, blocks,
                          static_cast<const float*>(blocks_scale), static_cast<float*>(out), d, n_tiles,
                          static_cast<cudaStream_t>(stream)};
  switch (mask_kind) {
    case 0:
      return static_cast<int>(transposed ? gnn_strip::launch_kind<0, true>(c) : gnn_strip::launch_kind<0, false>(c));
    case 1:
      return static_cast<int>(transposed ? gnn_strip::launch_kind<1, true>(c) : gnn_strip::launch_kind<1, false>(c));
    case 2:
      return static_cast<int>(transposed ? gnn_strip::launch_kind<2, true>(c) : gnn_strip::launch_kind<2, false>(c));
    case 3:
      return static_cast<int>(transposed ? gnn_strip::launch_kind<3, true>(c) : gnn_strip::launch_kind<3, false>(c));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
