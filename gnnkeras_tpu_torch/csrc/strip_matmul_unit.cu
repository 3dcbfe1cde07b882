// The strip kernels of one mask kind and direction (strip_matmul.cuh): built
// with -DGNN_STRIP_KIND=<0..3> -DGNN_STRIP_BWD=<0|1>, once for each pair, by
// gnnkeras_tpu_torch/kernels.

#include "strip_matmul.cuh"

namespace gnn_strip {

template <>
cudaError_t launch_kind<GNN_STRIP_KIND, (GNN_STRIP_BWD != 0)>(const Call& c) {
  return launch_widths<GNN_STRIP_KIND, (GNN_STRIP_BWD != 0)>(c);
}

}  // namespace gnn_strip
