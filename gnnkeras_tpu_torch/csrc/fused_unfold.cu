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
// f32 once for all n_iter iterations.  The arithmetic the data needs is
// 2 * D * nnz per iteration for the aggregation (a molecule block holds
// about 1.5% nonzeros) plus 4 * D * D * 128 for the transition, which the
// f32 cores finish in less time than the bytes take.  The one-block-per-tile
// kernel this replaced stayed at 9-11x that bound: it multiplied every entry
// of the block, each multiply-add fed by a scalar shared-memory load.  What
// holds this one above it, by the code's count (PERF.md), is shared
// memory's issue rate (the transition's weights reach every thread as
// 16-byte broadcasts: 2 D D / 4 loads a node and iteration, four
// multiply-adds each), the serial chain of a walk step (a neighbour's row
// arrives before its multiply-adds), and the per-tile work of finding the
// nonzeros.
//
// Design: persistent blocks, as many as fit on the card (fewer when there
// are fewer tiles), each walking tiles t = blockIdx.x, + gridDim.x, ...  A
// ring of two or three stages (block | state | constant) is filled by
// cp.async, so the next tiles' bytes arrive while the current tile
// iterates; the block's rows keep their 16-byte chunks XOR-swizzled by the
// row's low three bits, so that eight threads reading eight rows' chunk k
// hit distinct banks.  One thread per destination column j.  On a tile's
// arrival thread r turns row r into one byte per 8 columns (bit set where
// the entry is nonzero; a zero of either sign is not), and thread j then
// gathers bit j % 8 of every row's byte into a 128-bit mask of its column's
// nonzero rows, held in four registers.  Every iteration walks only those
// bits, one step a bit (__ffsll), reading the weight from the staged block,
// so a dense column costs its 128 entries and a molecule column about two.
// The state lives in shared memory node-major, rows of D + 4 floats (the pad
// spreads consecutive rows over the banks), so a neighbour's features arrive
// as 16-byte loads; each thread transposes its own column on the way in
// (from the staged feature-major chunk) and writes it out feature-major from
// registers, so the global layouts stay as they were.  The transition keeps
// its two accumulators per output feature in registers and reads the
// weights, staged once per block from the row-major (d, d) Dense weights,
// transposed and zero-padded, in the order the chains consume them.  The
// activation's switch stands outside its loop, and selu evaluates both
// sides and selects, so that no element branches.  Two barriers per
// iteration: after every thread has read the old state, and after every
// thread has written its new row.
//
// The sums are those of the one-block-per-tile kernel this replaced: each
// aggregate an fmaf chain from +0 over the source rows ascending (a skipped
// zero entry leaves the chain as it was, and the chain never holds -0), each
// transition output two fmaf chains over f ascending, then (zs + za) + c
// and the activation.  No tensor cores.
//
// Entry: gnn_fused_unfold_t, a plain C function bound with ctypes.  It
// launches on the caller's stream and returns cudaGetLastError().  The
// state, the constant and the blocks start on 16-byte boundaries (the
// wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_unfold.cuh"

namespace {

// Shared memory of one block: STAGES ring stages, then the node-major
// state, the two weights and the block's nonzero bytes.
template <int D>
struct Layout {
  static constexpr int ROW = TILE * 2;          // bytes per bf16 block row
  static constexpr int BLOCK = TILE * ROW;      // src rows x dst cols
  static constexpr int FM = D * TILE * 4;       // a feature-major (D, 128) f32 chunk
  static constexpr int STAGE = BLOCK + 2 * FM;  // block | state | constant
  static constexpr int SP = D + 4;              // floats per node-major state row
  static constexpr int FIXED = TILE * SP * 4 + 2 * D * D * 4 + 16 * TILE;
  static constexpr int STAGES = ring_stages(STAGE, FIXED);
  static constexpr int BYTES = STAGES * STAGE + FIXED;
};

// Byte offset of 16-byte chunk c of row r of a staged block
__device__ __forceinline__ int chunk_at(int r, int c) { return r * (TILE * 2) + ((c ^ (r & 7)) << 4); }

template <int D>
__global__ void __launch_bounds__(TILE) fused_unfold_t_kernel(
    const float* __restrict__ s0, const float* __restrict__ c,
    const float* __restrict__ ws, const float* __restrict__ wa,
    const __nv_bfloat16* __restrict__ blocks, float* __restrict__ out, int d, int n_tiles,
    int n_iter, int act) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_nm = reinterpret_cast<float*>(smem + L::STAGES * L::STAGE);  // (TILE, SP)
  float* ws_s = s_nm + TILE * L::SP;  // (D, D): [f][g], zero past d
  float* wa_s = ws_s + D * D;
  // (16, TILE): bit e of byte [cb][r] set where entry (r, 8 cb + e) is nonzero
  uint8_t* col_bytes = reinterpret_cast<uint8_t*>(wa_s + D * D);

  const int j = threadIdx.x;  // the thread's column (node)
  const long n = static_cast<long>(n_tiles) * TILE;
  const uint32_t smem_s = smem_addr(smem);

  auto issue = [&](int t, int stage) {
    const uint32_t st = smem_s + stage * L::STAGE;
    const long col0 = static_cast<long>(t) * TILE;
    const char* a = reinterpret_cast<const char*>(blocks + col0 * TILE);
#pragma unroll 4
    for (int k = j; k < L::BLOCK / 16; k += TILE) cp_async16(st + chunk_at(k >> 4, k & 15), a + k * 16);
#pragma unroll 4
    for (int k = j; k < D * 32; k += TILE) {
      const int f = k >> 5, x = (k & 31) * 4;
      cp_async16(st + L::BLOCK + (f * TILE + x) * 4, s0 + f * n + col0 + x);
      cp_async16(st + L::BLOCK + L::FM + (f * TILE + x) * 4, c + f * n + col0 + x);
    }
  };

  // the row-major (d, d) Dense weights, zero-padded to (D, D): visible to
  // every thread after the first tile's barrier
  for (int k = j; k < D * D; k += TILE) {
    const int f = k / D, g = k % D;
    const bool real = f < d && g < d;
    ws_s[k] = real ? ws[f * d + g] : 0.f;
    wa_s[k] = real ? wa[f * d + g] : 0.f;
  }

  int t_next = blockIdx.x;
#pragma unroll 1
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (t_next < n_tiles) issue(t_next, s);
    cp_async_commit();
    t_next += gridDim.x;
  }
  int stage = 0;
#pragma unroll 1
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    // the previous tile's stage is free again: fetch a later tile into it
    if (t_next < n_tiles) issue(t_next, stage == 0 ? L::STAGES - 1 : stage - 1);
    cp_async_commit();
    t_next += gridDim.x;
    cp_async_wait<L::STAGES - 1>();  // this thread's copies of tile t have landed
    __syncthreads();                  // and every thread's

    const unsigned char* st = smem + stage * L::STAGE;
    const float* s_fm = reinterpret_cast<const float*>(st + L::BLOCK);
    const float* c_fm = s_fm + D * TILE;

    // the nonzeros of row j, a byte per 8 columns
#pragma unroll 4
    for (int cb = 0; cb < 16; ++cb)
      col_bytes[cb * TILE + j] =
          static_cast<uint8_t>(bf16_nonzero_bits(*reinterpret_cast<const uint4*>(st + chunk_at(j, cb))));
    float s[D];  // the thread's state column
#pragma unroll
    for (int f = 0; f < D; ++f) s[f] = s_fm[f * TILE + j];
    store_vec<D>(s_nm + j * L::SP, s);
    __syncthreads();  // every byte and row is in place

    // column j's nonzero rows: bit j % 8 of each row's byte
    uint32_t mask[4] = {0u, 0u, 0u, 0u};
    {
      const uint4* bytes = reinterpret_cast<const uint4*>(col_bytes + (j >> 3) * TILE);
#pragma unroll
      for (int p = 0; p < 8; ++p) {  // rows [16p, 16p + 16)
        const uint4 v = bytes[p];
        const uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)  // bit j % 8 of 4 row bytes, gathered into a nibble
          mask[p / 2] |= ((((x[e] >> (j & 7)) & 0x01010101u) * 0x01020408u) >> 24) << (16 * (p % 2) + 4 * e);
      }
    }

    const int a_col = ((j >> 3) << 4) | ((j & 7) << 1);  // column j within a row, before the swizzle
#pragma unroll 1
    for (int it = 0; it < n_iter; ++it) {
      float agg[D];
#pragma unroll
      for (int f = 0; f < D; ++f) agg[f] = 0.f;
      for_each_bit(mask, [&](int i) {
        const uint16_t bits = *reinterpret_cast<const uint16_t*>(st + i * L::ROW + (a_col ^ ((i & 7) << 4)));
        const float a = __uint_as_float(static_cast<uint32_t>(bits) << 16);
        float x[D];
        load_vec<D>(x, s_nm + i * L::SP);
#pragma unroll
        for (int f = 0; f < D; ++f) agg[f] = fmaf(x[f], a, agg[f]);
      });
      __syncthreads();  // every thread has read the old state

      float zs[D], za[D];
#pragma unroll
      for (int g = 0; g < D; ++g) zs[g] = za[g] = 0.f;
#pragma unroll
      for (int f = 0; f < D; ++f) {
        float u[D], v[D];  // 16-byte loads, the same address across the block
        load_vec<D>(u, ws_s + f * D);
        load_vec<D>(v, wa_s + f * D);
#pragma unroll
        for (int g = 0; g < D; ++g) {
          zs[g] = fmaf(u[g], s[f], zs[g]);
          za[g] = fmaf(v[g], agg[f], za[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < D; ++g) s[g] = zs[g] + za[g] + c_fm[g * TILE + j];
      activate(s, act);
      store_vec<D>(s_nm + j * L::SP, s);
      __syncthreads();  // the new state is complete
    }

    const long col = static_cast<long>(t) * TILE + j;
#pragma unroll
    for (int f = 0; f < D; ++f) out[f * n + col] = s[f];
    __syncthreads();  // every thread is done with the stage
    stage = stage + 1 == L::STAGES ? 0 : stage + 1;
  }
  cp_async_wait<0>();
}

template <int D>
cudaError_t launch(const void* s0, const void* c, const void* ws, const void* wa,
                   const void* blocks, void* out, int d, int n_tiles, int n_iter, int act,
                   cudaStream_t stream) {
  using L = Layout<D>;
  static_assert(L::BYTES <= 227 * 1024, "a block's shared memory exceeds the SM's");
  const auto kernel = fused_unfold_t_kernel<D>;
  static int resident[kMaxDevices] = {};
  int blocks_on_card = 0;
  const cudaError_t err = resident_blocks(kernel, TILE, L::BYTES, resident, &blocks_on_card);
  if (err != cudaSuccess) return err;
  const int grid = n_tiles < blocks_on_card ? n_tiles : blocks_on_card;
  kernel<<<grid, TILE, L::BYTES, stream>>>(
      static_cast<const float*>(s0), static_cast<const float*>(c),
      static_cast<const float*>(ws), static_cast<const float*>(wa),
      static_cast<const __nv_bfloat16*>(blocks), static_cast<float*>(out), d, n_tiles, n_iter, act);
  return cudaGetLastError();
}

}  // namespace

// ws, wa: the row-major (d, d) Dense weights; d_pad (8, 16, 24 or 32) rows
// of state, d <= d_pad of them real
extern "C" int gnn_fused_unfold_t(const void* s0, const void* c, const void* ws,
                                  const void* wa, const void* blocks, void* out, int d_pad, int d,
                                  int n_tiles, int n_iter, int act, void* stream) {
  if (n_tiles < 0 || n_iter < 0 || act < 0 || act > 4 || d < 1 || d > d_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d_pad) {
    case 8:
      err = launch<8>(s0, c, ws, wa, blocks, out, d, n_tiles, n_iter, act, s);
      break;
    case 16:
      err = launch<16>(s0, c, ws, wa, blocks, out, d, n_tiles, n_iter, act, s);
      break;
    case 24:
      err = launch<24>(s0, c, ws, wa, blocks, out, d, n_tiles, n_iter, act, s);
      break;
    case 32:
      err = launch<32>(s0, c, ws, wa, blocks, out, d, n_tiles, n_iter, act, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
