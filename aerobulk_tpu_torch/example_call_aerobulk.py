"""Python mirror of the reference's example_call_aerobulk.f90: the 2-point
(unstable + stable) case through every ocean algorithm, printing the table
whose golden values live in the reference's doc/ex_ab.dat.  The
counterpart of examples/example_call_aerobulk.py; ``cpp_torch/example``
runs the same cases through the C++ binding.

    python3 -m aerobulk_tpu_torch.example_call_aerobulk [--device cpu]

Runs in float64 on the CUDA device unless given ``--device cpu``; without a
GPU it raises unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch

from .api import AeroBulkConfig, flux_step
from .skin import default_device

NITER = 50   # doc/ex_ab.dat was generated fully converged

#: (algorithm, skin schemes on) in the order of the reference's example
CASES = (("coare3p0", True), ("coare3p6", True), ("ecmwf", True),
         ("ncar", False), ("andreas", False))


def main(device=None):
    """Print the table; returns ``{algo: FluxOutput}`` on ``device`` (the
    CUDA device unless the caller names another)."""
    dev = default_device(device)

    def T(*values):
        return torch.tensor(values, dtype=torch.float64, device=dev)

    sst = T(295.15, 295.15)       # 22 degC
    t_zt = T(293.15, 298.15)      # 20 degC (unstable) / 25 degC (stable)
    q_zt = T(0.012, 0.012)
    U, V = T(5.0, 5.0), T(0.0, 0.0)
    slp = T(101000.0, 101000.0)
    rad_sw = T(0.0, 0.0)          # night
    rad_lw = T(350.0, 350.0)

    outs = {}
    for algo, skin in CASES:
        cfg = AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=NITER,
                             use_skin=skin)
        # isecday_utc=12 replicates the reference's hardcoded library clock
        # (mod_aerobulk_compute.f90:136) — ex_ab.dat was generated with it
        kw = dict(rad_sw=rad_sw, rad_lw=rad_lw, isecday_utc=12) if skin \
            else {}
        out, _ = flux_step(cfg, sst, t_zt, q_zt, U, V, slp, **kw)
        outs[algo] = out
        QH, QL, E, Ts, Tx = (x.cpu().tolist() for x in (
            out.QH, out.QL, out.Evap * 86400.0, out.T_s - 273.15,
            out.Tau_x))

        print(f"\n *********** {algo.upper()} *****************")
        print(f"  QH    = {QH[0]:12.5f} {QH[1]:12.5f} W/m^2")
        print(f"  QL    = {QL[0]:12.5f} {QL[1]:12.5f} W/m^2")
        print(f"  Evap  = {E[0]:12.6f} {E[1]:12.6f} mm/day")
        if skin:
            print(f"  T_s   = {Ts[0]:12.5f} {Ts[1]:12.5f} deg.C")
        print(f"  Tau_x = {Tx[0]:13.7e} {Tx[1]:13.7e} N/m^2")
    return outs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where to compute (default: the CUDA device)")
    main(ap.parse_args().device)
