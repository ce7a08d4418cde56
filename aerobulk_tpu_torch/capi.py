"""Flat-array entry point for the C/C++ binding (``cpp_torch/``).

The reference exposes its compute core to C++ GCMs (e.g. neXtSIM) through
``BIND(c)`` shims that flatten 2-D fields to 1-D (mod_aerobulk_cxx.f90:29-95).
Here the equivalent is :func:`model_buffers`: it takes Python buffer objects
(memoryviews handed over by the C++ layer, zero-copy), runs the eager flux
step on a torch device, and writes results into caller-provided output
buffers.  The counterpart of ``aerobulk_tpu.capi``.

The semantics mirror ``AEROBULK_MODEL`` (mod_aerobulk.f90:176-268): at
``jt == 1`` the ``AEROBULK_INIT`` path runs — shape agreement, unit
consistency checks, and ``type_of_humidity`` auto-detection
(mod_aerobulk.f90:126-153) — and the detected humidity kind plus the
warm-layer state persist in a process-local registry until ``jt == Nt``.
The reference C++ API has no humidity-kind argument, so detection is the
only way a C++ caller handing over RH [%] or dew-point [K] gets correct
fluxes.

The binding's contract is float64 end to end (the reference core is
compiled with -fdefault-real-8), and the H100 computes float64 natively:
the step runs on the CUDA device unless the environment variable
``AEROBULK_CAPI_DEVICE`` names another (``AEROBULK_CAPI_DEVICE=cpu``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple

import numpy as np
import torch

from .api import AeroBulkConfig, flux_step, init, init_skin_state

#: the environment variable that names the device of :func:`model_buffers`
DEVICE_ENV = "AEROBULK_CAPI_DEVICE"

# key -> (SkinState, detected humidity kind); one entry per running series
_STATE: Dict[Tuple, tuple] = {}


def capi_device() -> torch.device:
    """The device of the binding: ``$AEROBULK_CAPI_DEVICE`` when set, else
    the current CUDA device; without a GPU and without the variable this
    raises."""
    name = os.environ.get(DEVICE_ENV)
    if name:
        return torch.device(name)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "aerobulk_tpu_torch.capi computes on the CUDA device unless told "
            f"otherwise, and no CUDA device is available: set {DEVICE_ENV}=cpu "
            "to compute on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def model_buffers(jt, Nt, calgo, zt, zu, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                  QL, QH, Tau_x, Tau_y, Evap, niter=5, use_skin=False,
                  rad_sw=None, rad_lw=None, T_s=None, series_id=0):
    """Run one time record over flat buffers.

    All array arguments are 1-D buffers of float64 with the same length;
    output buffers (QL..Evap, optionally T_s) are written in place.

    ``series_id`` disambiguates interleaved series that share the same
    algorithm and grid size: like the reference's module-global state, the
    registry would otherwise silently share the warm-layer state between
    them (the C++ ``aerobulk::model`` API passes it as its last argument).
    """
    device = capi_device()

    def np_arr(b):
        return None if b is None else np.frombuffer(b, dtype=np.float64)

    sst_np = np_arr(sst)
    n = sst_np.shape[0]

    key = (calgo, n, series_id)
    if int(jt) == 1 or key not in _STATE:
        # AEROBULK_INIT semantics at the first record
        # (mod_aerobulk.f90:87-153, reached from C++ via the cxx shim):
        # shape/unit validation + type_of_humidity auto-detection, once.
        # (The reference bug of feeding rad_lw as prsw at :248 is not
        # replicated — rad_sw is validated as shortwave.)
        probe = AeroBulkConfig(algo=calgo, zt=float(zt), zu=float(zu),
                               niter=int(niter), use_skin=bool(use_skin),
                               humidity="auto")
        _, htype = init(probe, sst_np, np_arr(t_zt), np_arr(hum_zt),
                        np_arr(U_zu), np_arr(V_zu), np_arr(slp),
                        rad_sw=np_arr(rad_sw), rad_lw=np_arr(rad_lw))
        cfg0 = dataclasses.replace(probe, humidity=htype)
        _STATE[key] = (init_skin_state(cfg0, (n,), torch.float64, device),
                       htype)
    state, htype = _STATE[key]
    cfg = AeroBulkConfig(algo=calgo, zt=float(zt), zu=float(zu),
                         niter=int(niter), use_skin=bool(use_skin),
                         humidity=htype)

    def in_arr(b):
        # a copy on the device (the caller's buffer may be read-only)
        return torch.tensor(np_arr(b), device=device)

    kw = {}
    if use_skin:
        # the reference C++ API has no time argument — its library path
        # hardcodes isecday_utc=12 (mod_aerobulk_compute.f90:136, a known
        # bug replicated here for drop-in parity; the native Python API
        # requires an explicit clock instead)
        kw = dict(rad_sw=in_arr(rad_sw), rad_lw=in_arr(rad_lw),
                  isecday_utc=12)
    out, new_state = flux_step(cfg, in_arr(sst), in_arr(t_zt),
                               in_arr(hum_zt), in_arr(U_zu), in_arr(V_zu),
                               in_arr(slp), skin_state=state, **kw)

    if int(jt) >= int(Nt):
        _STATE.pop(key, None)
    else:
        _STATE[key] = (new_state, htype)

    def out_arr(b, x):
        np.frombuffer(b, dtype=np.float64)[:] = x.detach().cpu().numpy()

    out_arr(QL, out.QL)
    out_arr(QH, out.QH)
    out_arr(Tau_x, out.Tau_x)
    out_arr(Tau_y, out.Tau_y)
    out_arr(Evap, out.Evap)
    if T_s is not None:
        out_arr(T_s, out.T_s)
    return 0
