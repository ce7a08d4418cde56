// The gradient of one stateful ECMWF + cool-skin + warm-layer flux step per
// grid point (its vector-Jacobian product), as one CUDA kernel for Hopper
// (sm_90a): fused_grad.cu on the ECMWF skin solve.
//
// Replaces the TPU kernel aerobulk_tpu/kernels/fused.py::_grad_kernel for
// cfg.algo == "ecmwf", use_skin=True.  The plain version it is held to is
// aerobulk_tpu_torch/kernels/fused.py::fused_flux_step_vjp_plain.
//
// The reverse sweep of adjoint.cuh on the ECMWF solve (EcmwfSkinVjp; the
// loop also carries Fm, Fh, z0 and the z0q terms).  Two places where the
// step is not differentiable matter here: a fresh state has dT_wl = 0, so
// wl_ecmwf's MAX(dT_wl / tcorr, 0) and the MAX(., 0) of its 10-pass loop
// sit on a tie (the warm-layer stage's adjoint splits it 0.5/0.5 by
// dual.cuh's maxp_w, as jnp.maximum splits the gradient), and phi_takaya's
// |zeta| at zeta = 0 (derivative 1).  The gradient in lon is 0 everywhere (the ECMWF warm
// layer has no solar clock); in Hz_wl it is not (the depth correction and
// the absorption depend on it).
//
// Its own source, so that its nvcc (the longest of the package, with the
// COARE gradient's) runs beside the others'.  Plain C interface
// abt_fused_grad_ecmwf_f32 / _f64, with the arguments of abt_fused_grad_*.

#include "algos_point.cuh"

#define ABT_GRAD_SOLVE abt::EcmwfSkin
#define ABT_GRAD_ENTRY(dtype) abt_fused_grad_ecmwf_##dtype

#include "fused_grad.cu"
