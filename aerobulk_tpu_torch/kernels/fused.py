"""The fused flux step: one CUDA kernel per record for Hopper, and its plain
PyTorch version.

:func:`fused_flux_step` is the counterpart of
``aerobulk_tpu.kernels.fused.fused_flux_step`` (the Pallas kernel
``_kernel``).  On CUDA tensors it launches ``csrc/fused_step.cu``, which
runs the whole stateful COARE 3.0/3.6 + cool-skin + warm-layer step in
registers, one thread per point.  On CPU tensors it runs
:func:`fused_flux_step_plain`, the eager :func:`api.flux_step` reduced to
the same outputs.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..algos.coare import _VERSIONS
from ..api import AeroBulkConfig, flux_step, init_skin_state
from ..closures import charn_coare3p0, charn_coare3p6
from ..skin import SkinState
from ._build import load_library

#: number of launches of the fused-step kernel in this process
LAUNCHES = 0

_HUMIDITY = {"sh": 0, "rh": 1, "dp": 2}
_CHARN_LAW = {charn_coare3p0: 0, charn_coare3p6: 1}


def _check_config(cfg: AeroBulkConfig):
    if not cfg.use_skin:
        raise NotImplementedError(
            "fused_flux_step runs the skin (use_skin=True) step; the "
            "stateless fused kernel is still to port (ROADMAP.md section 2, "
            "kernel 3)")
    if cfg.algo not in _VERSIONS:
        raise NotImplementedError(
            f"fused_flux_step takes coare3p0/coare3p6; {cfg.algo!r} with "
            "skin waits for its algorithm's port (ROADMAP.md section 1, "
            "item 8)")
    if cfg.humidity not in _HUMIDITY:
        raise ValueError("fused_flux_step: resolve humidity='auto' via "
                         "init() and rebuild the config with the detected "
                         "type")


def fused_flux_step_plain(cfg: AeroBulkConfig, sst, t_zt, hum_zt, U_zu,
                          V_zu, slp, rad_sw, rad_lw, lon=None,
                          isecday_utc=43200,
                          skin_state: Optional[SkinState] = None):
    """The plain PyTorch version of the kernel: :func:`api.flux_step` with
    the kernel's outputs.  Returns ``((QL, QH, Tau_x, Tau_y, Evap, T_s),
    SkinState)``."""
    out, state = flux_step(cfg, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                           rad_sw=rad_sw, rad_lw=rad_lw,
                           isecday_utc=isecday_utc, lon=lon,
                           skin_state=skin_state)
    return (out.QL, out.QH, out.Tau_x, out.Tau_y, out.Evap, out.T_s), state


def fused_flux_step(cfg: AeroBulkConfig, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                    rad_sw, rad_lw, lon=None, isecday_utc=43200,
                    skin_state: Optional[SkinState] = None):
    """One stateful flux step (COARE 3.0/3.6 with cool skin and warm layer).

    All fields are tensors of one shape, dtype (fp32 or fp64) and device;
    on CUDA they must be contiguous.  ``isecday_utc`` is a Python number
    (UTC seconds since 00h) and reaches the kernel as a scalar argument.
    Returns ``((QL, QH, Tau_x, Tau_y, Evap, T_s), SkinState)``."""
    _check_config(cfg)
    if lon is None:
        lon = torch.zeros_like(sst)
    if skin_state is None:
        skin_state = init_skin_state(cfg, sst.shape, sst.dtype, sst.device)
    args = (sst, t_zt, hum_zt, U_zu, V_zu, slp, rad_sw, rad_lw, lon)
    if sst.device.type == "cpu":
        return fused_flux_step_plain(cfg, *args[:8], lon=lon,
                                     isecday_utc=isecday_utc,
                                     skin_state=skin_state)
    if sst.device.type != "cuda":
        raise ValueError(f"fused_flux_step: no kernel for device {sst.device}")
    return _launch(cfg, (*args, *skin_state), float(isecday_utc))


def _launch(cfg: AeroBulkConfig, ins, isecday_utc: float):
    global LAUNCHES
    names = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "rad_sw",
             "rad_lw", "lon", "dT_wl", "Hz_wl", "Qnt_ac", "Tau_ac")
    ref = ins[0]
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_flux_step: dtype {ref.dtype} is not "
                        "float32 or float64")
    for name, x in zip(names, ins):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"fused_flux_step: {name} is not a tensor")
        if x.device != ref.device or x.dtype != ref.dtype \
                or x.shape != ref.shape:
            raise ValueError(
                f"fused_flux_step: {name} is {x.dtype} {tuple(x.shape)} on "
                f"{x.device}; expected {ref.dtype} {tuple(ref.shape)} on "
                f"{ref.device}")
        if not x.is_contiguous():
            raise ValueError(f"fused_flux_step: {name} is not contiguous")

    lib = load_library()
    fn = (lib.abt_fused_step_f32 if ref.dtype == torch.float32
          else lib.abt_fused_step_f64)
    outs = [torch.empty_like(ref) for _ in range(10)]
    ptrs = (ctypes.c_void_p * 23)(*(x.data_ptr() for x in (*ins, *outs)))
    ver = _VERSIONS[cfg.algo]
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = fn(ptrs, ref.numel(), cfg.niter, _CHARN_LAW[ver.charn],
                 int(ver.visc_at_tzu), _HUMIDITY[cfg.humidity],
                 ver.z0t_max, ver.z0t_coef, ver.z0t_pow, ver.beta0,
                 cfg.zt, cfg.zu, cfg.rdt, cfg.gdept, isecday_utc, stream)
    if err != 0:
        raise RuntimeError(f"fused_flux_step: kernel launch failed with "
                           f"CUDA error {err}")
    LAUNCHES += 1
    return tuple(outs[:6]), SkinState(*outs[6:])
