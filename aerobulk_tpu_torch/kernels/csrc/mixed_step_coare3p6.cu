// The mixed ocean+ice cell with COARE 3.6 leads, any ice algorithm: one library
// of mixed_step.cuh's kernels.
#include "mixed_step.cuh"

ABT_MIXED_ENTRIES(abt_mixed_step_coare3p6, abt::kCoare3p6)
