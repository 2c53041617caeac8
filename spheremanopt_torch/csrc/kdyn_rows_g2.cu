// The row launches of the KDyn sweeps whose stage tasks step 2 rows
// (sm_kdyn_fwd_rows, sm_kdyn_fwd_traj_rows, sm_kdyn_bwd_rows choose the
// group size by the row count): the instances of the kernel templates in
// kdyn_step.cu for that size, compiled in a translation unit of their own
// so that the build's nvcc processes, one a source started together,
// compile them beside the one-row instances and the other sizes'.
#define SMO_KDYN_ROWS_G 2
#include "kdyn_step.cu"
