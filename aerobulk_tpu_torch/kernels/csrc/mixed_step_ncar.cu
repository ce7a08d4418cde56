// The mixed ocean+ice cell with NCAR leads, any ice algorithm: one library
// of mixed_step.cuh's kernels.
#include "mixed_step.cuh"

ABT_MIXED_ENTRIES(abt_mixed_step_ncar, abt::kNcar)
