// Arc-row select and its transpose through the union incidence pairs, the
// arc-focused readout and its gradient:
//
//   select  (forward):  y_src[128 at + r] = state[128 nt + cols_src[p, r]]
//                       y_dst[128 at + r] = state[128 nt + cols_dst[p, r]]
//                       for every pair p = (at, nt) and row r with cols >= 0;
//                       rows no pair touches are zero;
//   scatter (backward): out[n] = sum over arc rows a < n_rows of
//                       [arc_src[a] == n] ct_src[a] + [arc_dst[a] == n] ct_dst[a],
//                       the terms in the order of the node-major index:
//                       out[n] = sum over k in node_start[n] .. node_start[n+1]
//                       of ct_{e & 1}[e >> 1],  e = node_entry[k].
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
// arrays.  The scatter reads the two (A, d) cotangents and the node index
// (N + 1 offsets, 2 A entries) and writes the (N, d) output.  There is no
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
// Scatter design: the node-major index (node_start, node_entry, built on the
// host with the pairs) lists each node row's incident entries e = 2 a + s,
// ascending.  A group of nv = d / VEC consecutive threads owns one node row,
// thread v its VEC features: it walks the row's entries (the group reads the
// same entry, one broadcast), adds vector v of cotangent row e >> 1 of
// ct_src or ct_dst (VEC floats per load, 16 bytes where d allows) into
// registers, and writes its vector once, zero for a node without arcs, so the
// output needs no memset and consecutive threads write one contiguous run.
// Four entries are loaded ahead of their rows to keep loads in flight; they
// are added in the index's order.  The work is one read per (entry, feature):
// it grows with the arcs, not with the pairs, and there are no shared-memory
// stages, no block barriers and no global atomics.  The sum's order is fixed
// (arc rows ascending, source before destination), so the result is the same
// from run to run.  Entries of arc rows >= n_rows (the cotangents' row
// count) add nothing.
//
// The select walks no pair from n_live on: those are inert padding (all cols
// -1).  n_live is read on the device, from the one-element array the pairs carry:
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
constexpr int SCATTER_THREADS = 256;

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

template <int VEC>
__global__ void __launch_bounds__(SCATTER_THREADS) incidence_scatter_kernel(
    const float* __restrict__ ct_src, const float* __restrict__ ct_dst, int n_rows,
    const int* __restrict__ node_start, const int* __restrict__ node_entry, float* __restrict__ out, int nv,
    long n_items) {
  using V = typename Vec<VEC>::T;
  const long t = static_cast<long>(blockIdx.x) * SCATTER_THREADS + threadIdx.x;
  if (t >= n_items) return;
  const long node = t / nv;
  const int v = static_cast<int>(t - node * nv);
  const V* src = reinterpret_cast<const V*>(ct_src);
  const V* dst = reinterpret_cast<const V*>(ct_dst);
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  // cotangent vector v of entry e, zero for an arc row past n_rows
  auto row = [&](int e) {
    V x;
    const int a = e >> 1;
    if (a < n_rows) {
      x = __ldg(((e & 1) ? dst : src) + static_cast<long>(a) * nv + v);
    } else {
      float* xf = reinterpret_cast<float*>(&x);
#pragma unroll
      for (int j = 0; j < VEC; ++j) xf[j] = 0.f;
    }
    return x;
  };
  auto add = [&](const V& x) {
    const float* xf = reinterpret_cast<const float*>(&x);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += xf[j];
  };
  const int hi = __ldg(node_start + node + 1);
  int k = __ldg(node_start + node);
  for (; k + 4 <= hi; k += 4) {  // four rows in flight, added in order
    const V x0 = row(__ldg(node_entry + k)), x1 = row(__ldg(node_entry + k + 1));
    const V x2 = row(__ldg(node_entry + k + 2)), x3 = row(__ldg(node_entry + k + 3));
    add(x0);
    add(x1);
    add(x2);
    add(x3);
  }
  for (; k < hi; ++k) add(row(__ldg(node_entry + k)));
  V r;
  float* rf = reinterpret_cast<float*>(&r);
#pragma unroll
  for (int j = 0; j < VEC; ++j) rf[j] = acc[j];
  reinterpret_cast<V*>(out)[t] = r;
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

int gnn_incidence_scatter(const void* ct_src, const void* ct_dst, int n_rows, const void* node_start,
                          const void* node_entry, void* out, int d, int n_nodes, int vec, void* stream) {
  if (d < 1 || n_nodes < 1 || d % vec) return static_cast<int>(cudaErrorInvalidValue);
  const int nv = d / vec;
  const long n_items = static_cast<long>(n_nodes) * nv;
  const dim3 grid(static_cast<unsigned>((n_items + SCATTER_THREADS - 1) / SCATTER_THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, SCATTER_THREADS, 0, s>>>(static_cast<const float*>(ct_src), static_cast<const float*>(ct_dst),
                                            n_rows, static_cast<const int*>(node_start),
                                            static_cast<const int*>(node_entry), static_cast<float*>(out), nv,
                                            n_items);
  };
  switch (vec) {
    case 4: args(incidence_scatter_kernel<4>); break;
    case 2: args(incidence_scatter_kernel<2>); break;
    case 1: args(incidence_scatter_kernel<1>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
