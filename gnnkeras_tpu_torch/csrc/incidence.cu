// Arc-row select and its transpose, the arc-focused readout and its
// gradient:
//
//   select  (forward):  y_src[a] = state[arc_ends[a, 0]],
//                       y_dst[a] = state[arc_ends[a, 1]]   for a < n_arcs,
//                       rows n_arcs .. a_pad zero;
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
// 0/1 one-hot from the (arc tile, node tile) pairs' cols and ran it through
// the matrix unit; here the select is a row copy through an arc-major index
// and the scatter a segmented sum through a node-major one, one kernel for
// any pair count (there is no VMEM pair budget to fall back from).  Neither
// reads the pairs.
//
// What bounds both on an H100: bytes.  The select reads the (N, d) state
// (each node row at least once, more often from L2) and the (n_arcs, 2) i32
// index, and writes two (a_pad, d) f32 arrays.  The scatter reads the two
// (A, d) cotangents and the node index (N + 1 offsets, 2 A entries) and
// writes the (N, d) output.  There is no arithmetic to speak of (the
// scatter adds each cotangent row once).
//
// Select design: one thread per (output, arc row, vector) of both outputs,
// VEC floats (16 bytes where d allows) per load: a group of nv = d / VEC
// consecutive threads owns one output row; they read the row's node from
// the index (one broadcast), then vector v of that node's state row.
// Consecutive threads write consecutive words, so each output is one
// contiguous run; rows past n_arcs are written as zero, so the outputs
// need no memset.  The work is 2 * a_pad * nv vectors, whatever the pair
// count; no shared memory, no barriers.  A copy is exact, bit for bit,
// -0.0 and subnormals included.  (The pair walk this replaced gave a block
// to each arc tile, staged each of its pairs' cols behind two barriers and
// skipped the -1 entries of 256 * nv items per pair: pairs * 256 * nv work,
// ~6x the copy at the bench's pair count, and the cols weighed half the
// output.)
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
// Both indices are inputs of every call: a program saved by torch.export
// takes them from each batch it is called with.
//
// Entries: gnn_incidence_select and gnn_incidence_scatter, plain C functions
// bound with ctypes.  Each launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SELECT_THREADS = 256;
constexpr int SCATTER_THREADS = 256;

template <int VEC> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

template <int VEC>
__global__ void __launch_bounds__(SELECT_THREADS) incidence_select_kernel(
    const float* __restrict__ state, const int* __restrict__ arc_ends, float* __restrict__ y_src,
    float* __restrict__ y_dst, int nv, int n_arcs, long n_items) {
  using V = typename Vec<VEC>::T;
  const long t = static_cast<long>(blockIdx.x) * SELECT_THREADS + threadIdx.x;
  if (t >= 2 * n_items) return;
  const int e = t >= n_items;  // 0: source output, 1: destination output
  const long i = t - e * n_items;
  const long row = i / nv;
  const int v = static_cast<int>(i - row * nv);
  V x;
  if (row < n_arcs) {
    const long node = __ldg(arc_ends + 2 * row + e);
    x = __ldg(reinterpret_cast<const V*>(state) + node * nv + v);
  } else {
    float* xf = reinterpret_cast<float*>(&x);
#pragma unroll
    for (int j = 0; j < VEC; ++j) xf[j] = 0.f;
  }
  reinterpret_cast<V*>(e ? y_dst : y_src)[i] = x;
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

int gnn_incidence_select(const void* state, const void* arc_ends, void* y_src, void* y_dst, int d, int n_arcs,
                         int a_pad, int vec, void* stream) {
  if (d < 1 || n_arcs < 0 || a_pad < 1 || n_arcs > a_pad || d % vec) return static_cast<int>(cudaErrorInvalidValue);
  const int nv = d / vec;
  const long n_items = static_cast<long>(a_pad) * nv;
  const dim3 grid(static_cast<unsigned>((2 * n_items + SELECT_THREADS - 1) / SELECT_THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, SELECT_THREADS, 0, s>>>(static_cast<const float*>(state), static_cast<const int*>(arc_ends),
                                           static_cast<float*>(y_src), static_cast<float*>(y_dst), nv, n_arcs,
                                           n_items);
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
