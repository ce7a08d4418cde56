"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

The CUDA sources under ``csrc/`` are built with nvcc at first launch
(``_build.py``); importing this package needs no nvcc.
"""

from .fused import (fused_bulk_step, fused_bulk_step_plain, fused_flux_step,
                    fused_flux_step_plain, fused_ice_step,
                    fused_ice_step_plain, fused_mixed_step,
                    fused_mixed_step_plain)

__all__ = ["fused_bulk_step", "fused_bulk_step_plain", "fused_flux_step",
           "fused_flux_step_plain", "fused_ice_step", "fused_ice_step_plain",
           "fused_mixed_step", "fused_mixed_step_plain"]
