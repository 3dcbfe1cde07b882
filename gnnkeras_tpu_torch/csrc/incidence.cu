// Arc-row select and its transpose through the union incidence pairs, the
// arc-focused readout and its gradient:
//
//   select  (forward):  y_src[128 at + r] = state[128 nt + cols_src[p, r]]
//                       y_dst[128 at + r] = state[128 nt + cols_dst[p, r]]
//                       for every pair p = (at, nt) and row r with cols >= 0;
//                       rows no pair touches are zero;
//   scatter (backward): out[128 nt + c] = sum over pairs p = (at, nt), rows r
//                       of [cols_src[p, r] == c] ct_src[128 at + r]
//                                       + [cols_dst[p, r] == c] ct_dst[128 at + r].
//
// Replaces: gnnkeras_tpu/ops/incidence.py, both directions of each of its
// pair kernels: _fwd_kernel (launched by incidence_select_xla, above the
// 10,240-pair VMEM budget) and _fused_kernel with bwd=False (launched by
// _fused_call from incidence_select_fused) become gnn_incidence_select;
// _bwd_kernel (incidence_scatter_xla) and _fused_kernel with bwd=True
// (incidence_scatter_fused) become gnn_incidence_scatter.  The TPU rebuilt a
// 0/1 one-hot from the cols and ran it through the matrix unit; here the
// select is a copy and the scatter a segmented sum, one kernel for any pair
// count (there is no VMEM pair budget to fall back from).
//
// What bounds both on an H100: bytes.  The select reads the (N, d) state and
// the (B, 128) i32 cols of both endpoints and writes two (A_pad, d) f32
// arrays; the scatter moves the same bytes the other way.  There is no
// arithmetic to speak of (the scatter adds each cotangent row once).
//
// Select design: one block per arc tile walks its run of pairs
// f_start[j] .. f_start[j+1].  Per pair it stages the two cols rows in shared
// memory, then its threads copy node rows into the tile's 2 x 128 output
// rows, VEC floats (16 bytes where d allows) per load: consecutive threads
// take consecutive words of one row, then the next row, so the writes are
// one contiguous run per tile.  A copy is exact, bit for bit, -0.0 and
// subnormals included.  A per-row flag in shared memory records which rows a
// pair wrote; the rest are zeroed at the end, so the output needs no memset.
//
// Scatter design: one block per (node tile, chunk of DC features).  Thread c
// owns node column c and keeps its DC sums in registers.  Per pair the block
// stages the two cols rows and the arc tile's two 128 x DC cotangent chunks
// in shared memory (coalesced; rows past the arc count read as zero), and
// each thread walks the 128 cols entries, adding the rows that name its
// column.  Pairs in run order, rows in order, source before destination:
// the sum's order is fixed, so the result is the same from run to run, and
// there are no global atomics.  The sums go back through shared memory so
// the (N, d) output is written in contiguous runs.
//
// Pairs from n_live on are inert padding (all cols -1) and are not walked.
// n_live is read on the device, from the one-element array the pairs carry:
// a program saved by torch.export takes it from each batch it is called
// with, never from the batch it was traced on.
//
// Entries: gnn_incidence_select and gnn_incidence_scatter, plain C functions
// bound with ctypes.  Each launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;
constexpr int SELECT_THREADS = 256;

template <int VEC> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

template <int VEC>
__global__ void __launch_bounds__(SELECT_THREADS) incidence_select_kernel(
    const float* __restrict__ state, const int* __restrict__ f_start, const int* __restrict__ f_node_tile,
    const int* __restrict__ f_cols_src, const int* __restrict__ f_cols_dst, float* __restrict__ y_src,
    float* __restrict__ y_dst, int d, const int* __restrict__ n_live) {
  using V = typename Vec<VEC>::T;
  __shared__ int cols[2][TILE];
  __shared__ int hit[2][TILE];
  const int j = blockIdx.x;
  const int nv = d / VEC;  // vectors per row
  const int items = 2 * TILE * nv;
  const long row0 = static_cast<long>(j) * TILE;
  const V* src = reinterpret_cast<const V*>(state);
  V* out[2] = {reinterpret_cast<V*>(y_src), reinterpret_cast<V*>(y_dst)};

  for (int i = threadIdx.x; i < 2 * TILE; i += SELECT_THREADS) hit[i / TILE][i % TILE] = 0;
  const int p_end = min(f_start[j + 1], *n_live);
  for (int p = f_start[j]; p < p_end; ++p) {
    __syncthreads();  // the previous pair's cols are read out
    for (int i = threadIdx.x; i < 2 * TILE; i += SELECT_THREADS) {
      const int e = i / TILE, r = i % TILE;
      const int c = (e == 0 ? f_cols_src : f_cols_dst)[static_cast<long>(p) * TILE + r];
      cols[e][r] = c;
      if (c >= 0) hit[e][r] = 1;
    }
    __syncthreads();
    const long node0 = static_cast<long>(f_node_tile[p]) * TILE;
    for (int i = threadIdx.x; i < items; i += SELECT_THREADS) {
      const int e = i / (TILE * nv);
      const int rem = i - e * TILE * nv;
      const int r = rem / nv, v = rem - r * nv;
      const int c = cols[e][r];
      if (c >= 0) out[e][(row0 + r) * nv + v] = src[(node0 + c) * nv + v];
    }
  }
  __syncthreads();
  V zero;
  float* zf = reinterpret_cast<float*>(&zero);
#pragma unroll
  for (int k = 0; k < VEC; ++k) zf[k] = 0.f;
  for (int i = threadIdx.x; i < items; i += SELECT_THREADS) {
    const int e = i / (TILE * nv);
    const int rem = i - e * TILE * nv;
    const int r = rem / nv, v = rem - r * nv;
    if (!hit[e][r]) out[e][(row0 + r) * nv + v] = zero;
  }
}

template <int DC>
__global__ void __launch_bounds__(TILE) incidence_scatter_kernel(
    const float* __restrict__ ct_src, const float* __restrict__ ct_dst, int n_rows,
    const int* __restrict__ b_start, const int* __restrict__ b_arc_tile, const int* __restrict__ b_cols_src,
    const int* __restrict__ b_cols_dst, float* __restrict__ out, int d, const int* __restrict__ n_live) {
  constexpr int DCP = DC + 1;  // padded rows: thread c reads row r at bank (r * DCP + f) mod 32
  __shared__ float cts[2][TILE * DCP];
  __shared__ int cols[2][TILE];
  const int j = blockIdx.x;
  const int f0 = blockIdx.y * DC;
  const int dc = min(DC, d - f0);
  const int c = threadIdx.x;

  float acc[DC];
#pragma unroll
  for (int f = 0; f < DC; ++f) acc[f] = 0.f;

  const int p_end = min(b_start[j + 1], *n_live);
  for (int p = b_start[j]; p < p_end; ++p) {
    __syncthreads();  // the previous pair's stage is read out
    const long arc0 = static_cast<long>(b_arc_tile[p]) * TILE;
    cols[0][c] = b_cols_src[static_cast<long>(p) * TILE + c];
    cols[1][c] = b_cols_dst[static_cast<long>(p) * TILE + c];
    for (int i = c; i < TILE * dc; i += TILE) {
      const int r = i / dc, f = i - r * dc;
      const long row = arc0 + r;
      const bool in = row < n_rows;
      cts[0][r * DCP + f] = in ? ct_src[row * d + f0 + f] : 0.f;
      cts[1][r * DCP + f] = in ? ct_dst[row * d + f0 + f] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < TILE; ++r) {
      if (cols[0][r] == c) {
#pragma unroll
        for (int f = 0; f < DC; ++f)
          if (f < dc) acc[f] += cts[0][r * DCP + f];
      }
      if (cols[1][r] == c) {
#pragma unroll
        for (int f = 0; f < DC; ++f)
          if (f < dc) acc[f] += cts[1][r * DCP + f];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < DC; ++f)
    if (f < dc) cts[0][c * DCP + f] = acc[f];
  __syncthreads();
  const long node0 = static_cast<long>(j) * TILE;
  for (int i = c; i < TILE * dc; i += TILE) {
    const int r = i / dc, f = i - r * dc;
    out[(node0 + r) * d + f0 + f] = cts[0][r * DCP + f];
  }
}

}  // namespace

extern "C" {

int gnn_incidence_select(const void* state, const void* f_start, const void* f_node_tile, const void* f_cols_src,
                         const void* f_cols_dst, void* y_src, void* y_dst, int d, int n_arc_tiles,
                         const void* n_live, int vec, void* stream) {
  if (d < 1 || n_arc_tiles < 1 || d % vec) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_arc_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, SELECT_THREADS, 0, s>>>(
        static_cast<const float*>(state), static_cast<const int*>(f_start), static_cast<const int*>(f_node_tile),
        static_cast<const int*>(f_cols_src), static_cast<const int*>(f_cols_dst), static_cast<float*>(y_src),
        static_cast<float*>(y_dst), d, static_cast<const int*>(n_live));
  };
  switch (vec) {
    case 4: args(incidence_select_kernel<4>); break;
    case 2: args(incidence_select_kernel<2>); break;
    case 1: args(incidence_select_kernel<1>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int gnn_incidence_scatter(const void* ct_src, const void* ct_dst, int n_rows, const void* b_start,
                          const void* b_arc_tile, const void* b_cols_src, const void* b_cols_dst, void* out, int d,
                          int n_node_tiles, const void* n_live, void* stream) {
  if (d < 1 || n_node_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel, int dc) {
    const dim3 grid(n_node_tiles, (d + dc - 1) / dc);
    kernel<<<grid, TILE, 0, s>>>(
        static_cast<const float*>(ct_src), static_cast<const float*>(ct_dst), n_rows,
        static_cast<const int*>(b_start), static_cast<const int*>(b_arc_tile), static_cast<const int*>(b_cols_src),
        static_cast<const int*>(b_cols_dst), static_cast<float*>(out), d, static_cast<const int*>(n_live));
  };
  if (d <= 8) {
    launch(incidence_scatter_kernel<8>, 8);
  } else if (d <= 16) {
    launch(incidence_scatter_kernel<16>, 16);
  } else {
    launch(incidence_scatter_kernel<32>, 32);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
