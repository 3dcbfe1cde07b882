// Row-major whole-unfold kernel: per 128-node tile, n_iter times, with cd the
// blocks' storage type (bf16 or f32) and round_cd rounding to it
//
//   sc  = round_cd(s)                                   (128, d)
//   agg = A_t . sc                   (A_t: dst rows x src cols, f32 sums)
//   s   = act(sc . Ws + round_cd(agg) . Wa + c)          (f32 sums)
//
// with s, c of shape (128, d) per tile, d unpadded (14 on the flagship), and
// Ws, Wa (d, d) rounded to cd as they are staged.  round_cd is
// __float2bfloat16_rn (to nearest even, as XLA rounds) for bf16 blocks and
// the identity for f32 blocks; a product of two bf16 values is exact in f32,
// so only the order of the f32 sums differs from the plain version.
//
// Replaces: gnnkeras_tpu/ops/fused.py, _unfold_kernel launched by
// fused_unfold (GNNnodeBased.forward_fused).
//
// What bounds it on an H100: bytes.  Per tile it reads the block (32 KiB
// bf16, 64 KiB f32), the state and the constant (2 x 128 x d f32) and writes
// 128 x d f32 once for all n_iter iterations; the arithmetic the data needs
// (2 * d * nnz per iteration for the aggregation, 4 * d * d * 128 for the
// transition) takes the f32 cores less time than the bytes take.  The
// one-block-per-tile kernel this replaced stayed at 9-11x that bound: it
// multiplied every entry of the block (a molecule block holds about 1.5%
// nonzeros), and with f32 blocks only two tiles fit on an SM.  What holds
// this one above it, by the code's count (PERF.md), is shared memory's
// issue rate (the transition's weights reach every thread as 16-byte
// broadcasts: 2 DP DP / 4 loads a row and iteration, four multiply-adds
// each), the serial chain of a walk step, and the per-tile work of finding
// the nonzeros.
//
// Design: persistent blocks, as many as fit on the card (fewer when there
// are fewer tiles), each walking tiles t = blockIdx.x, + gridDim.x, ...  A
// ring of two or three stages (block | state rows | constant rows) is
// filled by cp.async, so the next tiles' bytes arrive while the current
// tile iterates; a tile's state and constant rows are one contiguous run of
// 128 x d floats (16-byte aligned at any d), copied as they lie.  The
// block's rows keep their 16-byte chunks XOR-swizzled by the row's low three
// bits, so that eight threads reading their rows' chunk k hit distinct
// banks.  One thread per destination row i.  On a tile's arrival each
// thread reads its row once, as 16-byte loads, into a 128-bit mask of its
// nonzero columns (a zero of either sign is not one) held in four
// registers; every iteration walks only those bits, one step a bit
// (__ffsll), reading the weight from the staged block, so a dense row costs
// its 128 entries and a molecule row about two.  The rounded state lives in
// shared memory node-major, rows of DP + 4 floats (DP = d padded to 16 or
// 32, pad features zero), so a neighbour's features arrive as 16-byte
// loads; each thread keeps its own f32 state row in registers.  The
// transition keeps its two accumulators per output feature in registers and
// reads the rounded weights in the order the chains consume them.  The
// activation's switch stands outside its loop, and selu evaluates both
// sides and selects, so that no element branches.  Two barriers per
// iteration: after every thread has read the old rows, and after every
// thread has written its new one.  The final state leaves through the
// tile's staged state rows, as 16-byte stores.
//
// The sums are those of the one-block-per-tile kernel this replaced: each
// aggregate an fmaf chain from +0 over the source columns ascending (a
// skipped zero entry leaves the chain as it was, and the chain never holds
// -0), each transition output two fmaf chains over f ascending, then
// (zs + za) + c and the activation; bf16 blocks round the state, the
// weights and the aggregate at the same three points.  No tensor cores.
//
// Entry: gnn_fused_unfold, a plain C function bound with ctypes.  It launches
// on the caller's stream and returns cudaGetLastError().  The state, the
// constant and the blocks start on 16-byte boundaries (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_unfold.cuh"

namespace {

template <typename TB>
__device__ __forceinline__ float round_cd(float x);
template <>
__device__ __forceinline__ float round_cd<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_cd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Bit e set where entry e of a 16-byte chunk of block entries is nonzero (a
// zero of either sign is not)
__device__ __forceinline__ uint32_t nonzero_bits(uint4 v, const float*) {
  return static_cast<uint32_t>((v.x & 0x7fffffffu) != 0) | static_cast<uint32_t>((v.y & 0x7fffffffu) != 0) << 1 |
         static_cast<uint32_t>((v.z & 0x7fffffffu) != 0) << 2 | static_cast<uint32_t>((v.w & 0x7fffffffu) != 0) << 3;
}
__device__ __forceinline__ uint32_t nonzero_bits(uint4 v, const __nv_bfloat16*) { return bf16_nonzero_bits(v); }

// Shared memory of one block: STAGES ring stages, then the node-major
// rounded state and the two rounded weights.
template <int DP, typename TB>
struct Layout {
  static constexpr int EPC = 16 / static_cast<int>(sizeof(TB));    // block entries per 16-byte chunk
  static constexpr int ROW = TILE * static_cast<int>(sizeof(TB));  // bytes per block row
  static constexpr int BLOCK = TILE * ROW;
  static constexpr int ROWS = TILE * DP * 4;      // room for a tile's (128, d) f32 rows, d <= DP
  static constexpr int STAGE = BLOCK + 2 * ROWS;  // block | state rows | constant rows
  static constexpr int SP = DP + 4;               // floats per node-major state row
  static constexpr int FIXED = TILE * SP * 4 + 2 * DP * DP * 4;
  static constexpr int STAGES = ring_stages(STAGE, FIXED);
  static constexpr int BYTES = STAGES * STAGE + FIXED;
};

// Byte offset of 16-byte chunk k of row r in a staged block
template <class L>
__device__ __forceinline__ int chunk_at(int r, int k) {
  return r * L::ROW + ((k ^ (r & 7)) << 4);
}

// Entry (i, j) of a staged block, as f32 (exact)
template <class L>
__device__ __forceinline__ float entry(const unsigned char* blk, int i, int j, const float*) {
  return *reinterpret_cast<const float*>(blk + chunk_at<L>(i, j / L::EPC) + (j % L::EPC) * 4);
}
template <class L>
__device__ __forceinline__ float entry(const unsigned char* blk, int i, int j, const __nv_bfloat16*) {
  const uint16_t bits = *reinterpret_cast<const uint16_t*>(blk + chunk_at<L>(i, j / L::EPC) + (j % L::EPC) * 2);
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

template <int DP, typename TB>
__device__ __forceinline__ void store_rounded(float* row, const float (&s)[DP]) {
  float r[DP];
#pragma unroll
  for (int f = 0; f < DP; ++f) r[f] = round_cd<TB>(s[f]);
  store_vec<DP>(row, r);
}

template <int DP, typename TB>
__global__ void __launch_bounds__(TILE) fused_unfold_kernel(
    const float* __restrict__ s0, const float* __restrict__ c,
    const float* __restrict__ ws, const float* __restrict__ wa,
    const TB* __restrict__ blocks, float* __restrict__ out, int d, int n_tiles, int n_iter,
    int act) {
  using L = Layout<DP, TB>;
  constexpr int CPR = L::ROW / 16;  // chunks per block row
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_nm = reinterpret_cast<float*>(smem + L::STAGES * L::STAGE);  // (TILE, SP), rounded
  float* ws_s = s_nm + TILE * L::SP;                                   // (DP, DP): [f][g]
  float* wa_s = ws_s + DP * DP;

  const int i = threadIdx.x;  // the thread's row
  const uint32_t smem_s = smem_addr(smem);
  const int row_chunks = 32 * d;  // 16-byte chunks of a tile's 128 x d floats
  const TB* tb = nullptr;         // selects the storage's overloads

  auto issue = [&](int t, int stage) {
    const uint32_t st = smem_s + stage * L::STAGE;
    const char* a = reinterpret_cast<const char*>(blocks + static_cast<long>(t) * TILE * TILE);
#pragma unroll 4
    for (int k = i; k < TILE * CPR; k += TILE) cp_async16(st + chunk_at<L>(k / CPR, k % CPR), a + k * 16);
    const long base = static_cast<long>(t) * TILE * d;
    for (int k = i; k < row_chunks; k += TILE) {
      cp_async16(st + L::BLOCK + k * 16, s0 + base + 4 * k);
      cp_async16(st + L::BLOCK + L::ROWS + k * 16, c + base + 4 * k);
    }
  };

  // visible to every thread after the first tile's barrier
  for (int k = i; k < DP * DP; k += TILE) {
    const int f = k / DP, g = k % DP;
    const bool real = f < d && g < d;
    ws_s[k] = real ? round_cd<TB>(ws[f * d + g]) : 0.f;
    wa_s[k] = real ? round_cd<TB>(wa[f * d + g]) : 0.f;
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

    unsigned char* st = smem + stage * L::STAGE;
    float* s_in = reinterpret_cast<float*>(st + L::BLOCK);  // (128, d), packed
    const float* c_in = s_in + TILE * DP;                  // (128, d), packed

    // row i's nonzero columns, 16-byte chunks of entries at a time
    uint32_t mask[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < CPR; ++k)
      mask[k * L::EPC / 32] |= nonzero_bits(*reinterpret_cast<const uint4*>(st + chunk_at<L>(i, k)), tb)
                               << (k * L::EPC % 32);
    float s[DP];  // the thread's f32 state row
#pragma unroll
    for (int f = 0; f < DP; ++f) s[f] = f < d ? s_in[i * d + f] : 0.f;
    store_rounded<DP, TB>(s_nm + i * L::SP, s);
    __syncthreads();  // every row is in place

#pragma unroll 1
    for (int it = 0; it < n_iter; ++it) {
      float agg[DP];
#pragma unroll
      for (int f = 0; f < DP; ++f) agg[f] = 0.f;
      for_each_bit(mask, [&](int j) {
        const float a = entry<L>(st, i, j, tb);
        float x[DP];
        load_vec<DP>(x, s_nm + j * L::SP);
#pragma unroll
        for (int f = 0; f < DP; ++f) agg[f] = fmaf(a, x[f], agg[f]);
      });
      __syncthreads();  // every thread has read the old rows

      float zs[DP], za[DP];
#pragma unroll
      for (int g = 0; g < DP; ++g) zs[g] = za[g] = 0.f;
#pragma unroll
      for (int f = 0; f < DP; ++f) {
        const float sc = round_cd<TB>(s[f]), ac = round_cd<TB>(agg[f]);
        float u[DP], v[DP];  // 16-byte loads, the same address across the block
        load_vec<DP>(u, ws_s + f * DP);
        load_vec<DP>(v, wa_s + f * DP);
#pragma unroll
        for (int g = 0; g < DP; ++g) {
          zs[g] = fmaf(sc, u[g], zs[g]);
          za[g] = fmaf(ac, v[g], za[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < DP; ++g) s[g] = zs[g] + za[g] + (g < d ? c_in[i * d + g] : 0.f);
      activate(s, act);
#pragma unroll
      for (int g = 0; g < DP; ++g)
        if (g >= d) s[g] = 0.f;
      store_rounded<DP, TB>(s_nm + i * L::SP, s);
      __syncthreads();  // the new rows are complete
    }

    // the f32 state out through the tile's staged state rows (read only
    // before the first iteration, each thread its own row)
#pragma unroll
    for (int f = 0; f < DP; ++f)
      if (f < d) s_in[i * d + f] = s[f];
    __syncthreads();
    float4* o = reinterpret_cast<float4*>(out + static_cast<long>(t) * TILE * d);
    for (int k = i; k < row_chunks; k += TILE) o[k] = reinterpret_cast<const float4*>(s_in)[k];
    __syncthreads();  // every thread is done with the stage
    stage = stage + 1 == L::STAGES ? 0 : stage + 1;
  }
  cp_async_wait<0>();
}

template <int DP, typename TB>
cudaError_t launch_rm(const void* s0, const void* c, const void* ws, const void* wa,
                      const void* blocks, void* out, int d, int n_tiles, int n_iter, int act,
                      cudaStream_t stream) {
  using L = Layout<DP, TB>;
  static_assert(L::BYTES <= 227 * 1024, "a block's shared memory exceeds the SM's");
  const auto kernel = fused_unfold_kernel<DP, TB>;
  static int resident[kMaxDevices] = {};
  int blocks_on_card = 0;
  const cudaError_t err = resident_blocks(kernel, TILE, L::BYTES, resident, &blocks_on_card);
  if (err != cudaSuccess) return err;
  const int grid = n_tiles < blocks_on_card ? n_tiles : blocks_on_card;
  kernel<<<grid, TILE, L::BYTES, stream>>>(
      static_cast<const float*>(s0), static_cast<const float*>(c),
      static_cast<const float*>(ws), static_cast<const float*>(wa),
      static_cast<const TB*>(blocks), static_cast<float*>(out), d, n_tiles, n_iter, act);
  return cudaGetLastError();
}

template <typename TB>
cudaError_t dispatch_rm(const void* s0, const void* c, const void* ws, const void* wa,
                        const void* blocks, void* out, int d, int n_tiles, int n_iter, int act,
                        cudaStream_t stream) {
  if (d <= 16) return launch_rm<16, TB>(s0, c, ws, wa, blocks, out, d, n_tiles, n_iter, act, stream);
  return launch_rm<32, TB>(s0, c, ws, wa, blocks, out, d, n_tiles, n_iter, act, stream);
}

}  // namespace

// block_kind: 0 bf16 blocks, 1 f32 blocks
extern "C" int gnn_fused_unfold(const void* s0, const void* c, const void* ws, const void* wa,
                                const void* blocks, int block_kind, void* out, int d, int n_tiles,
                                int n_iter, int act, void* stream) {
  if (n_tiles < 0 || n_iter < 0 || act < 0 || act > 4 || d < 1 || d > 32 ||
      (block_kind != 0 && block_kind != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = block_kind == 0
                        ? dispatch_rm<__nv_bfloat16>(s0, c, ws, wa, blocks, out, d, n_tiles, n_iter, act, st)
                        : dispatch_rm<float>(s0, c, ws, wa, blocks, out, d, n_tiles, n_iter, act, st);
  return static_cast<int>(err);
}
