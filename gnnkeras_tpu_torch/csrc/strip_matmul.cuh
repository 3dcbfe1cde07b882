// The strip kernels' templates (csrc/strip_matmul.cu holds the design note
// and the C entries, which dispatch to launch_kind).  Each mask kind and
// direction instantiates its kernels in a translation unit of its own
// (strip_matmul_unit.cu, compiled eight times), so that nvcc builds them in
// parallel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async_ring.cuh"

namespace gnn_strip {

constexpr int TILE = 128;
constexpr int THREADS = 128;  // 4 warps

// bf16 weights of the bf16-state variant: the same two bytes as
// __nv_bfloat16, a type of its own so that it instantiates kernels of its own
struct Bf16State {
  __nv_bfloat16 w;
};

// Shared memory of one block: STAGES ring stages of [operator tile | state
// chunk | scale], then (bf16-state, the tensor-core route) the state's bf16
// plane.  A state row is 4 groups of 32 f32, each group 16 B past the last,
// so that lanes reading the same column of different slot groups hit
// different banks.
template <int D_, int SLOT, typename T_, bool SCALED_, bool MIXED>
struct Layout {
  using T = T_;
  static constexpr int D = D_;
  static constexpr bool SCALED = SCALED_;
  static constexpr bool MMA = std::is_same<T, Bf16State>::value;
  static constexpr int ROWS = MIXED ? TILE : SLOT;  // operator rows a stage holds
  static constexpr int ROW_BYTES = TILE * static_cast<int>(sizeof(T));
  static constexpr int OP = ROWS * ROW_BYTES;
  static constexpr int XROW = TILE * 4 + 4 * 16;
  static constexpr int STATE = D * XROW;
  static constexpr int STAGE = OP + STATE + (SCALED ? TILE * 4 : 0);
  static constexpr int PLANE = MMA ? D * TILE * 2 : 0;
  static constexpr int STAGES = ring_stages(STAGE, PLANE);
  static constexpr int BYTES = STAGES * STAGE + PLANE;
  // Operator rows keep their 16-byte chunks XOR-swizzled by row bits
  // [SHIFT, SHIFT + 3): ldmatrix reads rows r .. r + 7 (shift 0), the
  // CUDA-core backward rows 2l and 2l + 1 in lane l (shift 1).
  static constexpr int SHIFT = MMA ? 0 : 1;
};

// Byte offset of 16-byte chunk c of row r, rows of RB bytes, the chunk index
// XOR-swizzled by the row's bits [SHIFT, SHIFT + 3).
template <int RB, int SHIFT>
__device__ __forceinline__ int swz(int r, int c) {
  return r * RB + ((c ^ ((r >> SHIFT) & 7)) << 4);
}

// Byte offset of state element (f, col) in a stage's state chunk
template <class L>
__device__ __forceinline__ int xoff(int f, int col) {
  return L::OP + f * L::XROW + col * 4 + (col >> 5) * 16;
}

// Start the copies of one tile into the stage at shared address ``st``:
// ROWS operator rows from ``op``, the D state rows of columns [col0, col0 +
// 128) from x (row stride n) starting at row f0 (rows from d on are zero),
// and the scale.
template <class L, int ROWS>
__device__ __forceinline__ void issue_tile(uint32_t st, const typename L::T* op, const float* x,
                                           const float* scale, long n, int f0, int d, long col0, int tid) {
  constexpr int CPR = L::ROW_BYTES / 16;  // 16-byte chunks per operator row
  const char* src = reinterpret_cast<const char*>(op);
#pragma unroll 4
  for (int c = tid; c < ROWS * CPR; c += THREADS)
    cp_async16(st + swz<L::ROW_BYTES, L::SHIFT>(c / CPR, c % CPR), src + c * 16);
#pragma unroll 4
  for (int c = tid; c < L::D * 32; c += THREADS) {
    const int f = f0 + (c >> 5), col = (c & 31) * 4;
    cp_async16(st + xoff<L>(c >> 5, col), f < d ? x + f * n + col0 + col : x, f < d ? 16 : 0);
  }
  if (L::SCALED && tid < 32) cp_async16(st + L::OP + L::STATE + tid * 16, scale + tid * 4);
}

// ---------------------------------------------------------------------------
// CUDA cores (int8, f32 and bf16 operators): every output summed in f32 by
// fmaf in contraction order, as the plain version's f32 product sums.

// byte k of w (a signed int8) as f32, exactly: byte v ^ 0x80 placed in the
// mantissa of 1.5 * 2^23 gives 12582912 + 128 + v
__device__ __forceinline__ float i8_at(uint32_t w, int k) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B400000u, 0x7650 | k)) - 12583040.f;
}

// Entry e of one 16-byte chunk of operator entries, as f32 (exact)
template <typename T>
__device__ __forceinline__ float chunk_at(const uint4& w, int e) {
  const uint32_t word = (&w.x)[e * static_cast<int>(sizeof(T)) / 4];
  if constexpr (std::is_same<T, int8_t>::value) {
    return i8_at(word, e & 3);
  } else if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(word);
  } else {
    return __uint_as_float(e & 1 ? word & 0xffff0000u : word << 16);
  }
}

// Entries (r, c) and (r, c + 1) of the staged operator, c even, as f32
template <class L>
__device__ __forceinline__ void pair_at(const unsigned char* st, int r, int c, float& a0, float& a1) {
  using T = typename L::T;
  constexpr int S = static_cast<int>(sizeof(T));
  const unsigned char* p = st + swz<L::ROW_BYTES, L::SHIFT>(r, c * S / 16) + (c * S) % 16;
  if constexpr (std::is_same<T, int8_t>::value) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(p);
    a0 = i8_at(w, 0);
    a1 = i8_at(w, 1);
  } else if constexpr (std::is_same<T, float>::value) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    a0 = w.x;
    a1 = w.y;
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    a0 = __uint_as_float(w << 16);
    a1 = __uint_as_float(w & 0xffff0000u);
  }
}

// The backward scales the staged cotangent along the contraction axis by the
// int8 scale, in place, as the plain version does before its product.
template <class L>
__device__ __forceinline__ void scale_state(unsigned char* st, int tid) {
  const float4* sc = reinterpret_cast<const float4*>(st + L::OP + L::STATE);
#pragma unroll 4
  for (int c = tid; c < L::D * 32; c += THREADS) {
    float4* p = reinterpret_cast<float4*>(st + xoff<L>(c >> 5, (c & 31) * 4));
    const float4 v = *p, s = sc[c & 31];
    *p = make_float4(__fmul_rn(v.x, s.x), __fmul_rn(v.y, s.y), __fmul_rn(v.z, s.z), __fmul_rn(v.w, s.w));
  }
}

// One tile on CUDA cores.  Thread (warp w, lane l) owns output positions p,
// p + 1 (p = 64 (w & 1) + 2l: columns forward, rows backward) and the D / 2
// feature rows from fl = (D / 2)(w >> 1); its contraction is its slot
// group's ROWS entries from g0.  Forward out[f][p] = sum_r S[r][p] x[f][g0 +
// r]; backward out[f][p] = sum_k S[p - g0][g0 + k] c[f][g0 + k], each an
// fmaf chain from 0 in r (k) order.
template <class L, int ROWS, bool BWD>
__device__ __forceinline__ void tile_fma(const unsigned char* st, float* __restrict__ out, long n, int f0, int d,
                                         long col0, int warp, int lane) {
  using T = typename L::T;
  constexpr int F = L::D / 2;
  constexpr int V = BWD ? 16 / static_cast<int>(sizeof(T)) : 4;  // contraction entries a step loads
  const int p = 64 * (warp & 1) + 2 * lane;
  const int fl = F * (warp >> 1);
  const int g0 = ROWS == TILE ? 0 : (p / ROWS) * ROWS;
  const int r0 = p - g0;  // the backward's strip row of position p

  float acc[2][F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[0][f] = acc[1][f] = 0.f;

  // each unrolled body covers 32 contraction entries (16 past 16 feature
  // rows, where more would spill registers)
  constexpr int UNROLL = (L::D <= 16 ? 32 : 16) / V;
#pragma unroll UNROLL
  for (int k0 = 0; k0 < ROWS; k0 += V) {
    uint4 w0, w1;
    if constexpr (BWD) {  // V entries of strip rows r0 and r0 + 1 from column g0 + k0
      const int c = (g0 + k0) * static_cast<int>(sizeof(T)) / 16;
      w0 = *reinterpret_cast<const uint4*>(st + swz<L::ROW_BYTES, L::SHIFT>(r0, c));
      w1 = *reinterpret_cast<const uint4*>(st + swz<L::ROW_BYTES, L::SHIFT>(r0 + 1, c));
    }
#pragma unroll
    for (int kk = 0; kk < V; kk += 4) {
      float a[4][2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (BWD) {
          a[e][0] = chunk_at<T>(w0, kk + e);
          a[e][1] = chunk_at<T>(w1, kk + e);
        } else {
          pair_at<L>(st, k0 + kk + e, p, a[e][0], a[e][1]);
        }
      }
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float4 x = *reinterpret_cast<const float4*>(st + xoff<L>(fl + f, g0 + k0 + kk));
        acc[0][f] = fmaf(x.x, a[0][0], acc[0][f]);
        acc[1][f] = fmaf(x.x, a[0][1], acc[1][f]);
        acc[0][f] = fmaf(x.y, a[1][0], acc[0][f]);
        acc[1][f] = fmaf(x.y, a[1][1], acc[1][f]);
        acc[0][f] = fmaf(x.z, a[2][0], acc[0][f]);
        acc[1][f] = fmaf(x.z, a[2][1], acc[1][f]);
        acc[0][f] = fmaf(x.w, a[3][0], acc[0][f]);
        acc[1][f] = fmaf(x.w, a[3][1], acc[1][f]);
      }
    }
  }

  float s0 = 1.f, s1 = 1.f;
  if constexpr (!BWD && L::SCALED) {  // the forward's scale on the output columns
    const float* sc = reinterpret_cast<const float*>(st + L::OP + L::STATE);
    s0 = sc[p];
    s1 = sc[p + 1];
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int row = f0 + fl + f;
    if (row < d) {
      const float2 v = !BWD && L::SCALED ? make_float2(acc[0][f] * s0, acc[1][f] * s1)
                                         : make_float2(acc[0][f], acc[1][f]);
      *reinterpret_cast<float2*>(out + row * n + col0 + p) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor cores (the bf16-state variant): bf16 weights times the state
// rounded to bf16, products exact, on mma.sync.m16n8k16 with f32
// accumulators.

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

// c += a * b on one m16n8k16 tile: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_rn(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// After the stage has landed: the state chunk rounded to its bf16 plane
// (rows of 256 B, swizzled for ldmatrix).
template <class L>
__device__ __forceinline__ void prepare_plane(const unsigned char* st, unsigned char* plane, int tid) {
#pragma unroll 4
  for (int c = tid; c < L::D * 32; c += THREADS) {
    const int f = c >> 5, cc = c & 31;  // 4 values of row f, columns 4cc .. 4cc + 3
    const float4 v = *reinterpret_cast<const float4*>(st + xoff<L>(f, 4 * cc));
    *reinterpret_cast<uint2*>(plane + swz<256, 0>(f, cc >> 1) + ((cc & 1) << 3)) =
        make_uint2(pack_rn(v.x, v.y), pack_rn(v.z, v.w));
  }
}

// The tile product of warp ``warp`` (output rows [32 warp, 32 warp + 32)):
// A is the operator tile (M = output rows, K = the slot group's rows), read
// by ldmatrix.trans forward and ldmatrix backward; B the state plane.
template <class L, int ROWS, bool BWD>
__device__ __forceinline__ void tile_mma(const unsigned char* op, const unsigned char* plane,
                                         float* __restrict__ out, long n, int f0, int d, long col0, int warp,
                                         int lane) {
  constexpr int NT = L::D / 8;  // n8 tiles
  const int row0 = warp * 32;
  const int g0 = ROWS == TILE ? 0 : (row0 / ROWS) * ROWS;  // first column of the warp's slot group
  const int q = lane >> 3, r8 = lane & 7;
  const uint32_t op_s = smem_addr(op), plane_s = smem_addr(plane);

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll 2
  for (int k0 = 0; k0 < ROWS; k0 += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m0 = row0 + 16 * mt;
      if constexpr (!BWD) {
        // A[j][k] = S[k][j]: the 8x8 matrices of rows k, columns j, transposed
        const int r = k0 + (q >> 1) * 8 + r8, c = m0 + (q & 1) * 8;
        ldsm_x4_trans(op_s + swz<256, 0>(r, c >> 3), a[mt]);
      } else {
        // A[i][k] = S[i - g0][g0 + k]
        const int r = m0 - g0 + (q & 1) * 8 + r8, c = g0 + k0 + (q >> 1) * 8;
        ldsm_x4(op_s + swz<256, 0>(r, c >> 3), a[mt]);
      }
    }
    // B[k][f] = plane[f][g0 + k]: b[nt] = {k0 .. k0 + 7, k0 + 8 .. k0 + 15}
    uint32_t b[NT][2];
    const int bc = (g0 + k0 + (q & 1) * 8) >> 3;
#pragma unroll
    for (int nt = 0; nt + 1 < NT; nt += 2) {
      uint32_t r[4];
      ldsm_x4(plane_s + swz<256, 0>(8 * nt + (q >> 1) * 8 + r8, bc), r);
      b[nt][0] = r[0];
      b[nt][1] = r[1];
      b[nt + 1][0] = r[2];
      b[nt + 1][1] = r[3];
    }
    if constexpr (NT % 2) ldsm_x2(plane_s + swz<256, 0>(8 * (NT - 1) + r8, bc), b[NT - 1][0], b[NT - 1][1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }

  // c[e]: output row m0 + g (+8 for e >= 2), feature row 8nt + 2tig (+1 for odd e)
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 16 * mt + g + (e >> 1) * 8;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int f = f0 + 8 * nt + 2 * tig + (e & 1);
        if (f < d) out[f * n + col0 + row] = acc[mt][nt][e];
      }
    }
}

// ---------------------------------------------------------------------------

// Tiles [0, ts) hold (SLOT, 128) strips, tiles [ts, T) full blocks.  MIXED is
// false for a slot-pure operator (ts == T), and at slot 128, where both
// regions take the same routine from their own pointers.
template <int D, int SLOT, typename T, bool SCALED, bool MIXED, bool BWD>
__global__ void __launch_bounds__(THREADS) strip_kernel(const float* __restrict__ x, const T* __restrict__ strip,
                                                        const float* __restrict__ scale, int ts,
                                                        const T* __restrict__ blocks,
                                                        const float* __restrict__ blocks_scale,
                                                        float* __restrict__ out, int n_tiles, int d) {
  using L = Layout<D, SLOT, T, SCALED, MIXED>;
  constexpr bool BLOCKS = MIXED || SLOT == TILE;  // a block region can exist
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* plane = smem + L::STAGES * L::STAGE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long n = static_cast<long>(n_tiles) * TILE;
  const int f0 = blockIdx.y * D;
  const uint32_t smem_s = smem_addr(smem);

  auto issue = [&](int t, int stage) {
    const uint32_t st = smem_s + stage * L::STAGE;
    const long col0 = static_cast<long>(t) * TILE;
    if (!BLOCKS || t < ts) {
      issue_tile<L, SLOT>(st, strip + static_cast<long>(t) * SLOT * TILE, x, SCALED ? scale + col0 : nullptr, n,
                          f0, d, col0, tid);
    } else if constexpr (BLOCKS) {
      const long tb = t - ts;
      issue_tile<L, TILE>(st, blocks + tb * TILE * TILE, x, SCALED ? blocks_scale + tb * TILE : nullptr, n, f0, d,
                          col0, tid);
    }
  };

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
    // the stage of the previous tile is free again: fetch a later tile into it
    if (t_next < n_tiles) issue(t_next, stage == 0 ? L::STAGES - 1 : stage - 1);
    cp_async_commit();
    t_next += gridDim.x;
    cp_async_wait<L::STAGES - 1>();  // this thread's copies of tile t have landed
    __syncthreads();                  // and every thread's
    unsigned char* st = smem + stage * L::STAGE;
    const long col0 = static_cast<long>(t) * TILE;
    if constexpr (L::MMA) {
      prepare_plane<L>(st, plane, tid);
      __syncthreads();
      tile_mma<L, SLOT, BWD>(st, plane, out, n, f0, d, col0, warp, lane);
    } else {
      if constexpr (BWD && SCALED) {
        scale_state<L>(st, tid);
        __syncthreads();
      }
      if (MIXED && t >= ts) {
        if constexpr (MIXED) tile_fma<L, TILE, BWD>(st, out, n, f0, d, col0, warp, lane);
      } else {
        tile_fma<L, SLOT, BWD>(st, out, n, f0, d, col0, warp, lane);
      }
    }
    __syncthreads();  // every warp is done with the stage
    stage = stage + 1 == L::STAGES ? 0 : stage + 1;
  }
  cp_async_wait<0>();
}

// One call as the entries take it.
struct Call {
  const float* x;
  const void* strip;
  const float* scale;
  int ts;
  int slot;
  const void* blocks;
  const float* blocks_scale;
  float* out;
  int d;
  int n_tiles;
  cudaStream_t stream;
};

template <int D, int SLOT, typename T, bool SCALED, bool MIXED, bool BWD>
cudaError_t launch_kernel(const Call& c) {
  using L = Layout<D, SLOT, T, SCALED, MIXED>;
  static_assert(L::BYTES <= 227 * 1024, "a block's shared memory exceeds the SM's");
  const auto kernel = strip_kernel<D, SLOT, T, SCALED, MIXED, BWD>;
  static int resident[kMaxDevices] = {};
  int blocks_on_card = 0;
  const cudaError_t err = resident_blocks(kernel, THREADS, L::BYTES, resident, &blocks_on_card);
  if (err != cudaSuccess) return err;
  const int chunks = (c.d + D - 1) / D;
  int grid = blocks_on_card / chunks;
  grid = grid < 1 ? 1 : (grid > c.n_tiles ? c.n_tiles : grid);
  strip_kernel<D, SLOT, T, SCALED, MIXED, BWD><<<dim3(grid, chunks), THREADS, L::BYTES, c.stream>>>(
      c.x, static_cast<const T*>(c.strip), c.scale, c.ts, static_cast<const T*>(c.blocks), c.blocks_scale, c.out,
      c.n_tiles, c.d);
  return cudaGetLastError();
}

template <int D, int SLOT, typename T, bool SCALED, bool BWD>
cudaError_t launch_typed(const Call& c) {
  if (c.ts < c.n_tiles) {
    if constexpr (std::is_same<T, Bf16State>::value) {
      return cudaErrorInvalidValue;  // built for slot-pure operators only
    } else if constexpr (SLOT != TILE) {
      return launch_kernel<D, SLOT, T, SCALED, true, BWD>(c);
    }
  }
  return launch_kernel<D, SLOT, T, SCALED, false, BWD>(c);
}

template <int D, typename T, bool SCALED, bool BWD>
cudaError_t launch_slot(const Call& c) {
  switch (c.slot) {
    case 32:
      return launch_typed<D, 32, T, SCALED, BWD>(c);
    case 64:
      return launch_typed<D, 64, T, SCALED, BWD>(c);
    case TILE:
      return launch_typed<D, TILE, T, SCALED, BWD>(c);
    default:
      return cudaErrorInvalidValue;
  }
}

// The operator type and scale of each mask kind.
template <int KIND>
struct MaskKind;
template <>
struct MaskKind<0> {  // int8 0/1 mask, per-column f32 scale
  using T = int8_t;
  static constexpr bool SCALED = true;
};
template <>
struct MaskKind<1> {  // f32 weights
  using T = float;
  static constexpr bool SCALED = false;
};
template <>
struct MaskKind<2> {  // bf16 weights
  using T = __nv_bfloat16;
  static constexpr bool SCALED = false;
};
template <>
struct MaskKind<3> {  // bf16 weights, state rounded to bf16 (the experiment scripts' product)
  using T = Bf16State;
  static constexpr bool SCALED = false;
};

// Every kernel of one mask kind and direction: the narrowest width of 8, 16,
// 32 and 48 feature rows that holds d (so the operator is read once at any d
// up to 48; rows past d are zero and not stored), above 48 chunks of 48, one
// grid row each; then the slot.
template <int KIND, bool BWD>
cudaError_t launch_widths(const Call& c) {
  using K = MaskKind<KIND>;
  if (c.d <= 8) return launch_slot<8, typename K::T, K::SCALED, BWD>(c);
  if (c.d <= 16) return launch_slot<16, typename K::T, K::SCALED, BWD>(c);
  if (c.d <= 32) return launch_slot<32, typename K::T, K::SCALED, BWD>(c);
  return launch_slot<48, typename K::T, K::SCALED, BWD>(c);
}

// launch_widths<KIND, BWD>, instantiated in strip_matmul_unit.cu, which is
// compiled once per mask kind and direction so that nvcc builds the eight
// in parallel.
template <int KIND, bool BWD>
cudaError_t launch_kind(const Call& c);
template <>
cudaError_t launch_kind<0, false>(const Call& c);
template <>
cudaError_t launch_kind<0, true>(const Call& c);
template <>
cudaError_t launch_kind<1, false>(const Call& c);
template <>
cudaError_t launch_kind<1, true>(const Call& c);
template <>
cudaError_t launch_kind<2, false>(const Call& c);
template <>
cudaError_t launch_kind<2, true>(const Call& c);
template <>
cudaError_t launch_kind<3, false>(const Call& c);
template <>
cudaError_t launch_kind<3, true>(const Call& c);

}  // namespace gnn_strip
