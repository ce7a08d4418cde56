"""aerobulk_tpu_torch — the PyTorch/CUDA port of aerobulk_tpu.

Air-sea turbulent fluxes from bulk formulae on tensors, with the five
ocean algorithms, the cool-skin / warm-layer schemes and their stateful
time series, the sea-ice algorithms and mixed ocean+ice cells,
differentiable with torch autograd and ``torch.func``, with per-point
linearizations and the reference's ``AEROBULK_MODEL`` entry point.
``run_series(backend="fused")`` runs each record through one hand-written
CUDA kernel (``kernels/csrc/fused_step.cu``) and each record's backward
pass through another (``kernels/csrc/fused_grad.cu``).  The package
imports torch and numpy, never jax; ``aerobulk_tpu`` is its reference.

Quick start::

    from aerobulk_tpu_torch import flux
    out = flux("coare3p6", zt=2., zu=10., sst=sst, t_zt=t2m, hum_zt=q2m,
               U_zu=u10, V_zu=v10, slp=slp, rad_sw=ssrd, rad_lw=strd,
               use_skin=True, isecday_utc=43200)
"""

from . import closures, constants, skin, stability, thermo
from .algos import (FluxResult, OCEAN_ALGOS, turb_andreas, turb_coare3p0,
                    turb_coare3p6, turb_ecmwf, turb_ncar)
from .algos.neutral_10m import turb_neutral_10m
from .api import (AeroBulkConfig, FluxOutput, aerobulk_model,
                  check_flux_sanity, flux, flux_sanity_count, flux_step,
                  flux_step_ice, flux_step_ice_linearized,
                  flux_step_linearized, flux_step_mixed, init,
                  init_skin_state, run_series)
from .skin import SkinState

__version__ = "0.1.0"

__all__ = [
    "AeroBulkConfig", "FluxOutput", "FluxResult", "OCEAN_ALGOS", "SkinState",
    "aerobulk_model", "check_flux_sanity",
    "closures", "constants", "flux", "flux_sanity_count", "flux_step",
    "flux_step_ice", "flux_step_ice_linearized", "flux_step_linearized",
    "flux_step_mixed", "init", "init_skin_state", "run_series",
    "skin", "stability", "thermo", "turb_andreas", "turb_coare3p0",
    "turb_coare3p6", "turb_ecmwf", "turb_ncar", "turb_neutral_10m",
]
