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
// transition) takes the f32 cores less time than the bytes take.  This
// version multiplies the whole 128 x 128 block, about five times the
// nonzeros' arithmetic, so the rate at which the SMs dispatch instructions
// bounds it instead.
//
// Design: one block per tile, one thread per destination row, as the
// feature-major kernel.  The block lives in shared memory for every
// iteration, its rows padded from 128 to 130 entries: thread i reads entries
// (i, j) and (i, j + 1) in one 4-byte (bf16) or 8-byte (f32) load, and at a
// pitch of 65 words (bf16), or 130 words read 8 bytes at a time (f32), the
// threads of a warp hit distinct banks.  The rounded state rows (128 x DP
// floats, DP = d padded to 16 or 32, pad features zero) sit in shared
// memory too and are read as float4 broadcasts; each thread keeps its own f32 state row, constant row
// and aggregate in registers.  Two barriers per iteration: after every
// thread has read the old rows, and after every thread has written its new
// one.  State and constant come in, and the state goes out, through shared
// memory, so that the 128 x d floats of a tile move as contiguous runs
// (a row of 14 floats is not 16-byte aligned).  No tensor cores here.
//
// Entry: gnn_fused_unfold, a plain C function bound with ctypes.  It launches
// on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "activation.cuh"

namespace {

constexpr int PITCH = TILE + 2;  // entries per staged block row

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

// entries k and k + 1 of a staged row (k even), as floats
__device__ __forceinline__ float2 entry_pair(const float* a, int k) {
  return *reinterpret_cast<const float2*>(a + k);
}
__device__ __forceinline__ float2 entry_pair(const __nv_bfloat16* a, int k) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + k));
}

template <typename TB>
__host__ __device__ constexpr size_t rm_block_bytes() {
  return TILE * PITCH * sizeof(TB);  // a multiple of 16
}

template <int DP, typename TB>
constexpr size_t rm_smem_bytes() {
  return rm_block_bytes<TB>() + (TILE * DP + 2 * DP * DP) * sizeof(float);
}

template <int DP, typename TB>
__global__ void __launch_bounds__(TILE) fused_unfold_kernel(
    const float* __restrict__ s0, const float* __restrict__ c,
    const float* __restrict__ ws, const float* __restrict__ wa,
    const TB* __restrict__ blocks, float* __restrict__ out, int d, int n_iter,
    int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  TB* a_s = reinterpret_cast<TB*>(smem);
  float* s_s = reinterpret_cast<float*>(smem + rm_block_bytes<TB>());  // (TILE, DP)
  float* ws_s = s_s + TILE * DP;                                      // (DP, DP)
  float* wa_s = ws_s + DP * DP;

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const long base = static_cast<long>(t) * TILE * d;  // the tile's rows in s0, c, out

  // stage the block with 16-byte loads, rows padded to PITCH entries
  constexpr int PER_LOAD = 16 / sizeof(TB);
  const uint4* a_src = reinterpret_cast<const uint4*>(blocks + static_cast<long>(t) * TILE * TILE);
  for (int k = i; k < TILE * TILE / PER_LOAD; k += TILE) {
    const uint4 v = a_src[k];
    const int e = k * PER_LOAD;
    uint32_t* dst = reinterpret_cast<uint32_t*>(a_s + (e / TILE) * PITCH + e % TILE);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  for (int k = i; k < DP * DP; k += TILE) {
    const int f = k / DP, g = k % DP;
    const bool real = f < d && g < d;
    ws_s[k] = real ? round_cd<TB>(ws[f * d + g]) : 0.f;
    wa_s[k] = real ? round_cd<TB>(wa[f * d + g]) : 0.f;
  }
  // the constant, then the state, staged through shared memory
  for (int k = i; k < TILE * d; k += TILE) s_s[(k / d) * DP + k % d] = c[base + k];
  __syncthreads();
  float cc[DP];
#pragma unroll
  for (int g = 0; g < DP; ++g) cc[g] = g < d ? s_s[i * DP + g] : 0.f;
  __syncthreads();
  for (int k = i; k < TILE * d; k += TILE) s_s[(k / d) * DP + k % d] = s0[base + k];
  __syncthreads();
  float s[DP];
#pragma unroll
  for (int f = 0; f < DP; ++f) s[f] = f < d ? s_s[i * DP + f] : 0.f;
  // the thread's own row only: no other thread touches it until the barrier
#pragma unroll
  for (int f = 0; f < DP; ++f) s_s[i * DP + f] = round_cd<TB>(s[f]);
  __syncthreads();

  const TB* a_row = a_s + i * PITCH;
  for (int it = 0; it < n_iter; ++it) {
    float agg[DP];
#pragma unroll
    for (int f = 0; f < DP; ++f) agg[f] = 0.f;
#pragma unroll 2
    for (int j = 0; j < TILE; j += 2) {
      const float2 a = entry_pair(a_row, j);
      const float4* x0 = reinterpret_cast<const float4*>(s_s + j * DP);
      const float4* x1 = reinterpret_cast<const float4*>(s_s + (j + 1) * DP);
#pragma unroll
      for (int q = 0; q < DP / 4; ++q) {
        const float4 u = x0[q];
        agg[4 * q + 0] = fmaf(a.x, u.x, agg[4 * q + 0]);
        agg[4 * q + 1] = fmaf(a.x, u.y, agg[4 * q + 1]);
        agg[4 * q + 2] = fmaf(a.x, u.z, agg[4 * q + 2]);
        agg[4 * q + 3] = fmaf(a.x, u.w, agg[4 * q + 3]);
      }
#pragma unroll
      for (int q = 0; q < DP / 4; ++q) {
        const float4 v = x1[q];
        agg[4 * q + 0] = fmaf(a.y, v.x, agg[4 * q + 0]);
        agg[4 * q + 1] = fmaf(a.y, v.y, agg[4 * q + 1]);
        agg[4 * q + 2] = fmaf(a.y, v.z, agg[4 * q + 2]);
        agg[4 * q + 3] = fmaf(a.y, v.w, agg[4 * q + 3]);
      }
    }
    __syncthreads();  // every thread has read the old rows

    float sc[DP], ac[DP];
#pragma unroll
    for (int f = 0; f < DP; ++f) {
      sc[f] = round_cd<TB>(s[f]);
      ac[f] = round_cd<TB>(agg[f]);
    }
#pragma unroll
    for (int g = 0; g < DP; ++g) {
      float zs = 0.f, za = 0.f;
#pragma unroll
      for (int f = 0; f < DP; ++f) {
        zs = fmaf(sc[f], ws_s[f * DP + g], zs);
        za = fmaf(ac[f], wa_s[f * DP + g], za);
      }
      s[g] = g < d ? activate(zs + za + cc[g], act) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < DP; ++g) s_s[i * DP + g] = round_cd<TB>(s[g]);
    __syncthreads();  // the new rows are complete
  }

  // the f32 state out through shared memory (own row, then every row)
#pragma unroll
  for (int f = 0; f < DP; ++f) s_s[i * DP + f] = s[f];
  __syncthreads();
  for (int k = i; k < TILE * d; k += TILE) out[base + k] = s_s[(k / d) * DP + k % d];
}

template <int DP, typename TB>
cudaError_t launch_rm(const void* s0, const void* c, const void* ws, const void* wa,
                      const void* blocks, void* out, int d, int n_tiles, int n_iter, int act,
                      cudaStream_t stream) {
  constexpr size_t bytes = rm_smem_bytes<DP, TB>();
  // Above 48 KiB the dynamic shared memory limit must be raised, once per
  // device, so later launches on that device, including ones captured into a
  // CUDA graph, make no non-stream API call.
  if (bytes > 48 * 1024) {
    constexpr int kMaxDevices = 64;
    static bool smem_set[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!smem_set[dev]) {
      err = cudaFuncSetAttribute(fused_unfold_kernel<DP, TB>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
      smem_set[dev] = true;
    }
  }
  fused_unfold_kernel<DP, TB><<<n_tiles, TILE, bytes, stream>>>(
      static_cast<const float*>(s0), static_cast<const float*>(c),
      static_cast<const float*>(ws), static_cast<const float*>(wa),
      static_cast<const TB*>(blocks), static_cast<float*>(out), d, n_iter, act);
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
