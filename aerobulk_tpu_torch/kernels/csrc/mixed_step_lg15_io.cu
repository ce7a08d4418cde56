// The simultaneous LG15_IO solve of both surfaces of a mixed ocean+ice cell:
// one library of mixed_step.cuh's kernels.
#include "mixed_step.cuh"

ABT_MIXED_ENTRIES(abt_mixed_step_lg15_io, abt::kSimultaneous)
