"""Adjoint sensitivity maps: d(net turbulent heat flux)/d(SST) and
d/d(wind) over a global grid, from one reverse-mode sweep.

The sensitivity of Q = QL + QH to every input field at every grid point
comes from one ``torch.func.grad`` evaluation of the summed flux (the solve
is pointwise, so the gradient of the sum is the per-point derivative), not
from 2N finite-difference solves.  dQ/dSST is the local air-sea feedback
strength (W/m^2/K, negative: a warmer ocean loses more heat), strongest
over warm, windy regions.  The counterpart of the JAX package's
``examples/sensitivity_map.py``; the eager COARE 3.6 + skin step in fp64
on the card (the JAX example runs fp64 on its CPU path too).

Usage:
    python3 -m aerobulk_tpu_torch.sensitivity_map [OUT.png]
        [--device cuda|cpu]

Without OUT.png it prints the maps' statistics only; with it, it also
draws them (matplotlib, imported only then).  Runs on the CUDA device
unless given ``--device cpu``; without a GPU it raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .api import AeroBulkConfig, flux_step
from .skin import default_device

NY, NX = 90, 180    # 2-degree demo grid; the adjoint scales like the primal


def synthetic_climatology():
    """Smooth, geographically structured fields (zonal SST gradient,
    mid-latitude westerlies) as numpy arrays: (sst, t_zt, q_zt, U, lat,
    lon)."""
    lat = np.linspace(-89, 89, NY)[:, None] * np.ones((1, NX))
    lon = np.ones((NY, 1)) * np.linspace(0, 358, NX)[None, :]
    sst = 302.0 - 27.0 * (np.abs(lat) / 90.0) ** 1.7 \
        + 1.5 * np.sin(np.radians(3 * lon))
    t_zt = sst - 1.0 + 0.5 * np.cos(np.radians(2 * lat))
    U = 4.0 + 8.0 * np.sin(np.radians(2 * np.abs(lat))) ** 2
    q_zt = 0.8 * 0.012 * np.exp((sst - 302.0) / 18.0)
    return sst, t_zt, q_zt, U, lat[:, 0], lon[0]


def sensitivities(device=None, dtype=torch.float64):
    """``(dQ/dSST, dQ/dU)`` on the demo grid as numpy arrays, with Q =
    QL + QH of one COARE 3.6 + skin step at local noon UTC."""
    device = default_device(device)
    sst, t_zt, q_zt, U, _, _ = (torch.as_tensor(x, dtype=dtype, device=device)
                                for x in synthetic_climatology())
    slp, rsw, rlw = (torch.full((NY, NX), x, dtype=dtype, device=device)
                     for x in (101000.0, 250.0, 370.0))
    cfg = AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)

    def qnet(sst, U):
        out, _ = flux_step(cfg, sst, t_zt, q_zt, U, torch.zeros_like(U), slp,
                           rad_sw=rsw, rad_lw=rlw, isecday_utc=43200)
        return torch.sum(out.QL + out.QH)

    dq_dsst, dq_du = torch.func.grad(qnet, argnums=(0, 1))(sst, U)
    return dq_dsst.cpu().numpy(), dq_du.cpu().numpy()


def main(out_png=None, device=None):
    """Compute the maps, print their statistics and check they are finite;
    draw them into ``out_png`` when given.  Returns the two maps."""
    dq_dsst, dq_du = sensitivities(device)
    print(f"dQ/dSST [W/m^2/K]: min {dq_dsst.min():+.1f}  median "
          f"{np.median(dq_dsst):+.1f}  max {dq_dsst.max():+.1f}")
    print(f"dQ/dU [W/m^2 per m/s]: min {dq_du.min():+.1f}  median "
          f"{np.median(dq_du):+.1f}  max {dq_du.max():+.1f}")
    assert np.isfinite(dq_dsst).all() and np.isfinite(dq_du).all()
    if out_png:
        _plot(out_png, dq_dsst, dq_du)
    return dq_dsst, dq_du


def _plot(out_png, dq_dsst, dq_du):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    *_, lat, lon = synthetic_climatology()
    fig, axes = plt.subplots(2, 1, figsize=(9, 8), constrained_layout=True)
    for ax, field, title, unit in (
            (axes[0], dq_dsst, "dQ/dSST (air-sea feedback strength)",
             "W m$^{-2}$ K$^{-1}$"),
            (axes[1], dq_du, "dQ/dU$_{10}$", "W m$^{-2}$ (m/s)$^{-1}$")):
        lim = np.percentile(np.abs(field), 99)
        im = ax.pcolormesh(lon, lat, field, cmap="RdBu_r",
                           vmin=-lim, vmax=lim, shading="auto")
        ax.set_title(title)
        ax.set_xlabel("lon")
        ax.set_ylabel("lat")
        fig.colorbar(im, ax=ax, label=unit)
    fig.suptitle("Adjoint sensitivities of net turbulent heat flux "
                 "(COARE 3.6 + skin, one reverse sweep)")
    fig.savefig(out_png, dpi=110)
    print(f"wrote {out_png}")


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_png", nargs="?", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    main(args.out_png, args.device)


if __name__ == "__main__":
    _cli()
