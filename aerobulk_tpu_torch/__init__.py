"""aerobulk_tpu_torch — the PyTorch/CUDA port of aerobulk_tpu.

Air-sea turbulent fluxes from bulk formulae on tensors, with the five
ocean algorithms, the cool-skin / warm-layer schemes and their stateful
time series, the sea-ice algorithms and mixed ocean+ice cells,
differentiable with torch autograd.
``run_series(backend="fused")`` runs each record through one hand-written
CUDA kernel (``kernels/csrc/fused_step.cu``) and each record's backward
pass through another (``kernels/csrc/fused_grad.cu``).  The package
imports torch and numpy, never jax; ``aerobulk_tpu`` is its reference.
"""

from .api import (AeroBulkConfig, FluxOutput, flux, flux_step,
                  flux_step_ice, flux_step_mixed, init, init_skin_state,
                  run_series)
from .skin import SkinState

__all__ = ["AeroBulkConfig", "FluxOutput", "SkinState", "flux", "flux_step",
           "flux_step_ice", "flux_step_mixed", "init", "init_skin_state",
           "run_series"]
