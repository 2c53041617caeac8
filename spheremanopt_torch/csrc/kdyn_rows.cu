// The row launches of the KDyn sweeps (sm_kdyn_fwd_rows,
// sm_kdyn_fwd_traj_rows, sm_kdyn_bwd_rows): the kRows instances of the
// kernel templates in kdyn_step.cu, compiled in a translation unit of
// their own so that the build's nvcc processes, one a source started
// together, compile them beside the one-row instances.
#define SMO_KDYN_ROWS
#include "kdyn_step.cu"
