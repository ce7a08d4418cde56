// One stateful ECMWF + cool-skin + warm-layer flux step per grid point, as one
// CUDA kernel for Hopper (sm_90a): fused_step.cu with the ECMWF skin solve.
//
// Replaces the TPU kernel aerobulk_tpu/kernels/fused.py::_kernel for
// cfg.algo == "ecmwf", use_skin=True (BASELINE config 4; the Pallas body
// calls api.flux_step, so it runs any skin config).  The plain version it is
// held to is aerobulk_tpu_torch/kernels/fused.py::fused_flux_step_plain.
//
// The body is algos/ecmwf.turb_ecmwf with use_cs = use_wl = True
// (algos_point.cuh, EcmwfSkin): the Ri-bulk fixed point with the ECMWF cool
// skin (no Saunders term) and the prognostic warm layer, whose 10-pass
// semi-implicit solve runs inside each of the niter iterations and commits
// dT_wl every time.  Hz_wl (3 m), Qnt_ac and Tau_ac pass through.  Per point
// it reads 13 fields and writes 10, as the COARE step, against ~6.5k
// operations (the census of the JAX graph), so it is bound by operations.
//
// Its own source, so that its nvcc runs beside the others'.  Its fp32 launch
// shape is four blocks per SM (fused_step.cu's StepShape).  The numerics
// and the plain C interface (abt_fused_step_ecmwf_f32 / _f64, the arguments
// of abt_fused_step_*; the COARE constants and isecday_utc are not read)
// are fused_step.cu's.

#include "algos_point.cuh"

#define ABT_STEP_SOLVE abt::EcmwfSkin
#define ABT_STEP_ENTRY(dtype) abt_fused_step_ecmwf_##dtype
#define ABT_STEP_F32_MIN_BLOCKS 4

#include "fused_step.cu"
