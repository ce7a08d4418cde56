"""Common result structure for the bulk algorithms."""

from __future__ import annotations

from typing import NamedTuple

import torch


class FluxResult(NamedTuple):
    """Outputs of a bulk-transfer algorithm, all the shape of the inputs."""
    # primary outputs (the mandatory TURB_* outputs in the reference)
    Cd: torch.Tensor       # drag coefficient
    Ch: torch.Tensor       # sensible-heat coefficient
    Ce: torch.Tensor       # evaporation coefficient
    t_zu: torch.Tensor     # potential air temperature adjusted to zu [K]
    q_zu: torch.Tensor     # specific humidity adjusted to zu [kg/kg]
    Ubzu: torch.Tensor     # bulk wind speed at zu (incl. gustiness) [m/s]
    # surface state (updated if a skin scheme ran, else the inputs)
    T_s: torch.Tensor      # surface (skin or bulk) temperature [K]
    q_s: torch.Tensor      # saturation specific humidity at T_s [kg/kg]
    # diagnostics (the optional outputs in the reference)
    CdN: torch.Tensor      # neutral-stability drag coefficient
    ChN: torch.Tensor      # neutral-stability heat coefficient
    CeN: torch.Tensor      # neutral-stability evaporation coefficient
    z0: torch.Tensor       # aerodynamic roughness length [m]
    u_star: torch.Tensor   # friction velocity [m/s]
    L: torch.Tensor        # Obukhov length [m]
    UN10: torch.Tensor     # neutral wind speed at 10 m [m/s]
    # skin diagnostics (zeros when no skin scheme)
    dT_cs: torch.Tensor    # cool-skin temperature increment [K]
    dT_wl: torch.Tensor    # warm-layer temperature increment [K]
    Hz_wl: torch.Tensor    # warm-layer depth [m]
