// SHB23's row kernels (fused_rows.cuh) for groups of 2 rows, in an nvcc
// process of their own; fused_two_matrix.cu's sm_fused_fwd_rows and
// sm_fused_bwd_rows call them.
#include "fused_rows.cuh"

namespace smo {
SMO_ROWS_DEFINE(2)
}  // namespace smo
