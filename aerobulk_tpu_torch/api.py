"""User-facing API on tensors: config, validation, single-step flux, time
series.  The counterpart of ``aerobulk_tpu.api`` for the ocean path:

  * :class:`AeroBulkConfig` — a frozen dataclass of the static settings;
  * :func:`init` — host-side validation, masking and humidity detection
    (the ``AEROBULK_INIT`` semantics, mod_aerobulk.f90:24-170), in numpy;
  * :func:`flux_step` — one time record, explicit :class:`SkinState` in
    and out; :func:`flux_step_linearized` adds every output's derivative
    with respect to one input field (one ``torch.func.jvp``);
  * :func:`run_series` — a Python loop over the records that carries the
    warm-layer state, eagerly or through the fused CUDA kernel, or, for a
    stateless config, one call on the whole series
    (``batch_records=True``), eager or through the stateless kernel;
  * :func:`flux` — one-shot convenience wrapper;
  * :func:`aerobulk_model` — the drop-in analogue of the reference's
    ``AEROBULK_MODEL``, its warm-layer state in a process-local registry;
  * :func:`flux_step_ice` — fluxes over sea ice with one of the ice
    algorithms (``ice.ICE_ALGOS``), and :func:`flux_step_ice_linearized`;
  * :func:`flux_step_mixed` — a mixed ocean+ice cell: ice fluxes over the
    ice fraction, ocean fluxes over the leads, area-weighted, or the
    LG15_IO solve of both surfaces in one pass (``simultaneous=True``).

As in ``aerobulk_tpu``, the warm layer's solar clock ``isecday_utc`` is a
required input whenever the configuration runs it (the reference hardcodes
12 seconds past midnight, mod_aerobulk_compute.f90:136).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import constants as c
from . import thermo
from .algos import OCEAN_ALGOS, FluxResult
from .profiling import call_id, span
from .skin import (SkinState, default_device, init_skin_state_coare,
                   init_skin_state_ecmwf)


@dataclasses.dataclass(frozen=True)
class AeroBulkConfig:
    """Static configuration of a flux computation."""
    algo: str = "coare3p6"     # one of OCEAN_ALGOS
    zt: float = 2.0            # height of t/q measurements [m]
    zu: float = 10.0           # height of wind measurement [m]
    niter: int = 5             # bulk iterations (reference default nb_iter=5)
    use_skin: bool = False     # cool-skin + warm-layer (COARE*/ECMWF only)
    humidity: str = "sh"       # 'sh' [kg/kg] | 'rh' [%] | 'dp' [K]
    rdt: float = 3600.0        # warm-layer accumulation timestep [s]
    gdept: float = 1.0         # depth of bulk-SST measurement [m]
    #: a mixed ocean + ice cell: this ice algorithm (one of ice.ICE_ALGOS)
    #: over the ice fraction, ``algo`` without skin over the leads
    ice_algo: Optional[str] = None

    def __post_init__(self):
        if self.algo not in OCEAN_ALGOS:
            raise ValueError(
                f"unknown algorithm {self.algo!r}; available: "
                f"{sorted(OCEAN_ALGOS)}")
        if self.humidity not in ("sh", "rh", "dp", "auto"):
            raise ValueError(f"unknown humidity type {self.humidity!r}")
        if self.use_skin and not OCEAN_ALGOS[self.algo][1]:
            raise ValueError(
                f"algorithm {self.algo!r} does not support skin schemes "
                "(only coare3p0/coare3p6/ecmwf do)")
        if self.ice_algo is not None:
            from .ice import ICE_ALGOS
            if self.ice_algo not in ICE_ALGOS:
                raise ValueError(
                    f"unknown ice algorithm {self.ice_algo!r}; available: "
                    f"{sorted(ICE_ALGOS)}")
            if self.use_skin:
                raise ValueError(
                    "a mixed ocean + ice config (ice_algo set) runs its "
                    "leads without skin: use_skin must be False")
            if self.humidity == "auto":
                raise ValueError(
                    "a mixed ocean + ice config takes humidity 'sh', 'rh' "
                    "or 'dp': resolve 'auto' via init() first")


class FluxOutput(NamedTuple):
    """Fluxes + full diagnostics for one time record."""
    QL: torch.Tensor      # latent heat flux [W/m^2]
    QH: torch.Tensor      # sensible heat flux [W/m^2]
    Tau: torch.Tensor     # wind stress module [N/m^2]
    Tau_x: torch.Tensor   # zonal wind stress [N/m^2]
    Tau_y: torch.Tensor   # meridional wind stress [N/m^2]
    Evap: torch.Tensor    # evaporation [kg/m^2/s] (<0: ocean loses water)
    T_s: torch.Tensor     # surface (skin if enabled, else bulk) temp [K]
    rho_a: torch.Tensor   # air density at zu [kg/m^3]
    diag: FluxResult      # full per-algorithm diagnostics


def init_skin_state(cfg: AeroBulkConfig, shape, dtype=torch.float64,
                    device=None) -> SkinState:
    """Fresh warm-layer state appropriate to the configured algorithm, on
    ``device``: the CUDA device unless the caller names another (pass
    ``device="cpu"`` to build on the CPU); raises without a GPU."""
    if cfg.algo == "ecmwf":
        return init_skin_state_ecmwf(shape, dtype, device)
    return init_skin_state_coare(shape, dtype, device)


# ---------------------------------------------------------------------------
# host-side validation (AEROBULK_INIT semantics) — numpy
# ---------------------------------------------------------------------------

def _host(x, dtype=np.float64):
    """A numpy copy of an array, a tensor on any device, or a scalar."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def detect_humidity_type(hum, mask=None) -> str:
    """Guess humidity kind ('sh'/'dp'/'rh') from value ranges
    (mod_phymbl.f90:1957-2007)."""
    h = _host(hum)
    mask = np.ones_like(h, dtype=bool) if mask is None else _host(mask, bool)
    vals = h[mask]
    mean, vmin, vmax = vals.mean(), vals.min(), vals.max()

    def in_range(lo, hi, hi_inc=False):
        top_ok = (mean <= hi and vmax <= hi) if hi_inc else (mean < hi and vmax < hi)
        return lo <= mean and lo <= vmin and top_ok

    if in_range(c.ref_sha_min, c.ref_sha_max):
        return "sh"
    if in_range(c.ref_dpt_min, c.ref_dpt_max):
        return "dp"
    if in_range(c.ref_rlh_min, c.ref_rlh_max, hi_inc=True):
        return "rh"
    raise ValueError(
        f"cannot identify humidity type: mean={mean:.4g} min={vmin:.4g} "
        f"max={vmax:.4g}")


_UNIT_RANGES = {
    "sst": (c.ref_sst_min, c.ref_sst_max, "K"),
    "t_air": (c.ref_taa_min, c.ref_taa_max, "K"),
    "q_air": (c.ref_sha_min, c.ref_sha_max, "kg/kg"),
    "rh_air": (c.ref_rlh_min, c.ref_rlh_max, "%"),
    "dp_air": (c.ref_dpt_min, c.ref_dpt_max, "K"),
    "slp": (c.ref_slp_min, c.ref_slp_max, "Pa"),
    "u10": (-c.ref_wnd_max, c.ref_wnd_max, "m/s"),
    "v10": (-c.ref_wnd_max, c.ref_wnd_max, "m/s"),
    "wnd": (c.ref_wnd_min, c.ref_wnd_max, "m/s"),
    "rad_sw": (c.ref_rsw_min, c.ref_rsw_max, "W/m^2"),
    "rad_lw": (c.ref_rlw_min, c.ref_rlw_max, "W/m^2"),
}


def check_unit_consistency(field: str, x, mask=None):
    """Abort if a field is outside its physical range — wrong units
    (mod_phymbl.f90:1851-1954)."""
    lo, hi, unit = _UNIT_RANGES[field]
    x = _host(x)
    m = np.ones_like(x, dtype=bool) if mask is None else _host(mask, bool)
    vals = x[m]
    if vals.max() > hi or vals.min() < lo or not (lo <= vals.mean() <= hi):
        raise ValueError(
            f"field {field!r} does not seem to be in [{unit}]: "
            f"min={vals.min():.4g} max={vals.max():.4g} mean={vals.mean():.4g}")


def init(cfg: AeroBulkConfig, sst, t_zt, hum_zt, U_zu, V_zu, slp,
         rad_sw=None, rad_lw=None):
    """Validate inputs, build the in-range mask, detect humidity type
    (``AEROBULK_INIT``, mod_aerobulk.f90:24-170).  Returns
    ``(mask, humidity_type)`` with ``mask`` a numpy bool array; raises
    ``ValueError`` on unit inconsistencies or if every point is masked."""
    sst, t_zt, hum_zt, U_zu, V_zu, slp = (
        _host(x) for x in (sst, t_zt, hum_zt, U_zu, V_zu, slp))
    shapes = {np.shape(a) for a in (sst, t_zt, hum_zt, U_zu, V_zu, slp)}
    if len(shapes) != 1:
        raise ValueError(f"input shapes disagree: {shapes}")

    mask = ((sst >= c.ref_sst_min) & (sst <= c.ref_sst_max)
            & (t_zt >= c.ref_taa_min) & (t_zt <= c.ref_taa_max)
            & (slp >= c.ref_slp_min) & (slp <= c.ref_slp_max))
    wnd = np.sqrt(U_zu ** 2 + V_zu ** 2)
    mask &= (wnd >= c.ref_wnd_min) & (wnd <= c.ref_wnd_max)
    if not mask.any():
        raise ValueError("aerobulk_tpu_torch.init: all points masked — "
                         "check units")

    htype = detect_humidity_type(hum_zt, mask) if cfg.humidity == "auto" \
        else cfg.humidity

    check_unit_consistency("sst", sst, mask)
    check_unit_consistency("t_air", t_zt, mask)
    hum_field = {"sh": "q_air", "rh": "rh_air", "dp": "dp_air"}[htype]
    check_unit_consistency(hum_field, hum_zt, mask)
    check_unit_consistency("slp", slp, mask)
    check_unit_consistency("wnd", wnd, mask)
    if rad_sw is not None:
        check_unit_consistency("rad_sw", rad_sw, mask)
    if rad_lw is not None:
        check_unit_consistency("rad_lw", rad_lw, mask)
    return mask, htype


# ---------------------------------------------------------------------------
# the compute step (aerobulk_compute semantics)
# ---------------------------------------------------------------------------

def _q_air(humidity, hum_zt, t_zt, slp):
    """The humidity input as specific humidity (slp floored at 50000 Pa as
    the reference does)."""
    if humidity == "sh":
        return hum_zt
    if humidity == "dp":
        return thermo.q_air_dp(hum_zt, thermo.maxc(slp, 50000.0))
    return thermo.q_air_rh(hum_zt, t_zt, thermo.maxc(slp, 50000.0))


def _flux_outputs_from_result(zu, res, wnd, U_zu, V_zu, slp, l_ice):
    """BULK_FORMULA + stress decomposition (with the |U| > 1e-3 guard) for
    one surface's FluxResult."""
    Tau, QH, QL, Evap, rho_a = thermo.bulk_formula(
        zu, res.T_s, res.q_s, res.t_zu, res.q_zu,
        res.Cd, res.Ch, res.Ce, wnd, res.Ubzu, slp, l_ice=l_ice)
    safe = wnd > 1.0e-3
    inv_w = torch.where(safe, 1.0 / thermo.maxc(wnd, 1.0e-3), 0.0)
    return FluxOutput(QL=QL, QH=QH, Tau=Tau, Tau_x=Tau * inv_w * U_zu,
                      Tau_y=Tau * inv_w * V_zu, Evap=Evap, T_s=res.T_s,
                      rho_a=rho_a, diag=res)


def flux_step(cfg: AeroBulkConfig, sst, t_zt, hum_zt, U_zu, V_zu, slp,
              rad_sw=None, rad_lw=None, isecday_utc=None, lon=None,
              skin_state: Optional[SkinState] = None):
    """Compute fluxes for one time record (mod_aerobulk_compute.f90:22-213).

    ``t_zt`` is ABSOLUTE air temperature at zt [K]; ``hum_zt`` is read per
    ``cfg.humidity``.  ``isecday_utc`` (UTC seconds since 00h, a Python
    number) is required by coare3p0/coare3p6 with ``use_skin=True``.
    Returns ``(FluxOutput, SkinState)``."""
    fn, supports_skin, needs_time = OCEAN_ALGOS[cfg.algo]

    # humidity conversion (slp floored at 50000 Pa as the reference does)
    if cfg.humidity == "auto":
        raise ValueError("flux_step: resolve humidity='auto' via init() "
                         "and rebuild the config with the detected type")
    q_zt = _q_air(cfg.humidity, hum_zt, t_zt, slp)
    wnd = torch.sqrt(U_zu * U_zu + V_zu * V_zu)
    ssq = c.rdct_qsat_salt * thermo.q_sat(sst, slp)
    theta_zt = thermo.theta_from_z_p0_t_q(cfg.zt, slp, t_zt, q_zt)

    if lon is None:
        lon = torch.zeros_like(sst)

    if cfg.use_skin:
        if rad_sw is None or rad_lw is None:
            raise ValueError("flux_step: rad_sw & rad_lw required with skin")
        Qsw = (1.0 - c.roce_alb0) * rad_sw
        kw = dict(niter=cfg.niter, use_cs=True, use_wl=True, Qsw=Qsw,
                  rad_lw=rad_lw, slp=slp, skin_state=skin_state,
                  rdt=cfg.rdt, gdept=cfg.gdept)
        if needs_time:
            if isecday_utc is None:
                raise ValueError(
                    f"flux_step: algo {cfg.algo!r} with use_skin=True "
                    "needs isecday_utc (UTC seconds since 00h) for the "
                    "warm layer's solar clock.  Pass the record's true "
                    "seconds-of-day, 43200 for solar noon, or 12 "
                    "explicitly to replicate the reference's hardcoded "
                    "value (mod_aerobulk_compute.f90:136)")
            kw.update(isecday_utc=isecday_utc, lon=lon)
        res, state = fn(cfg.zt, cfg.zu, sst, theta_zt, ssq, q_zt, wnd, **kw)
    elif supports_skin:
        res, state = fn(cfg.zt, cfg.zu, sst, theta_zt, ssq, q_zt, wnd,
                        niter=cfg.niter, skin_state=skin_state)
    else:
        res = fn(cfg.zt, cfg.zu, sst, theta_zt, ssq, q_zt, wnd,
                 niter=cfg.niter)
        state = skin_state if skin_state is not None else \
            init_skin_state(cfg, sst.shape, sst.dtype, sst.device)

    return _flux_outputs_from_result(cfg.zu, res, wnd, U_zu, V_zu, slp,
                                     False), state


_LINEARIZABLE = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp",
                 "rad_sw", "rad_lw")


def _linearize(who, allowed, fields, wrt, step):
    """``torch.func.jvp`` of ``step(fields)`` with a ones tangent on the
    field ``wrt`` (one of ``allowed``) and none on the others: ``(primal,
    tangent)``."""
    if wrt not in allowed:
        raise ValueError(f"{who}: wrt={wrt!r} not one of {allowed}")
    if fields[wrt] is None:
        raise ValueError(f"{who}: wrt={wrt!r} but that input was not "
                         "provided")
    x = torch.as_tensor(fields[wrt])
    return torch.func.jvp(lambda v: step(dict(fields, **{wrt: v})), (x,),
                          (torch.ones_like(x),))


def flux_step_linearized(cfg: AeroBulkConfig, sst, t_zt, hum_zt, U_zu,
                         V_zu, slp, rad_sw=None, rad_lw=None,
                         isecday_utc=None, lon=None,
                         skin_state: Optional[SkinState] = None,
                         wrt: str = "sst"):
    """Fluxes plus the per-point derivative of every output with respect
    to one input field ``wrt`` (one of ``_LINEARIZABLE``), in one
    forward-mode pass.

    The solve is pointwise, so each output's Jacobian with respect to a
    field is diagonal, and one ``torch.func.jvp`` with a ones tangent on
    that field gives the whole diagonal.  Returns ``(out, d_out, state)``:
    ``d_out`` is a :class:`FluxOutput` of derivatives (``d_out.QL[i]`` is
    dQL/d<wrt> at point i; ``d_out.diag`` holds every diagnostic's), and
    ``state`` the primal next state (its tangent is dropped).  This is what
    implicit air-sea coupling consumes: ``dQ/dT = d_out.QL + d_out.QH``
    with ``wrt="sst"`` (``aerobulk_tpu_torch.implicit_coupling``)."""
    fields = dict(sst=sst, t_zt=t_zt, hum_zt=hum_zt, U_zu=U_zu,
                  V_zu=V_zu, slp=slp, rad_sw=rad_sw, rad_lw=rad_lw)
    (out, state), (d_out, _) = _linearize(
        "flux_step_linearized", _LINEARIZABLE, fields, wrt,
        lambda f: flux_step(cfg, f["sst"], f["t_zt"], f["hum_zt"],
                            f["U_zu"], f["V_zu"], f["slp"],
                            rad_sw=f["rad_sw"], rad_lw=f["rad_lw"],
                            isecday_utc=isecday_utc, lon=lon,
                            skin_state=skin_state))
    return out, d_out, state


# ---------------------------------------------------------------------------
# flux sanity (BULK_FORMULA_VCTR's tau abort)
# ---------------------------------------------------------------------------

def flux_sanity_count(out: FluxOutput):
    """The number of points with |tau| above ``ref_tau_max`` or a
    non-finite flux, as a 0-d int64 tensor on the outputs' device — 0 means
    healthy (the reference aborts instead, mod_phymbl.f90:1249-1253).
    Works on the reduced output set of ``run_series(backend='fused')``,
    where ``Tau`` is None: the module is rebuilt from its components."""
    tau = out.Tau if out.Tau is not None else torch.hypot(out.Tau_x, out.Tau_y)
    bad = ((torch.abs(tau) > c.ref_tau_max)
           | ~torch.isfinite(tau) | ~torch.isfinite(out.QL)
           | ~torch.isfinite(out.QH))
    return bad.sum()


def check_flux_sanity(out: FluxOutput):
    """Host-side equivalent of the reference's ``ctl_stop`` on
    ``tau > ref_tau_max`` (mod_phymbl.f90:1249-1253): raises ValueError
    naming the worst offender, else returns ``out``."""
    n = int(flux_sanity_count(out))
    if n:
        tau = out.Tau if out.Tau is not None else torch.hypot(out.Tau_x,
                                                              out.Tau_y)
        worst = float(np.nanmax(np.abs(_host(tau))))
        raise ValueError(
            f"flux sanity check failed at {n} point(s): wind stress too "
            f"strong or non-finite flux (max |tau| = {worst:.3f} N/m^2, "
            f"limit {c.ref_tau_max}) — check input units/ranges")
    return out


# ---------------------------------------------------------------------------
# time series
# ---------------------------------------------------------------------------

def _stack(records):
    """Stack a list of per-record outputs (tensors, None, or tuples of
    them) along a new leading time axis."""
    first = records[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(_stack([r[i] for r in records])
                             for i in range(len(first))))
    return torch.stack(records)


def run_series(cfg: AeroBulkConfig, forcing: dict,
               skin_state: Optional[SkinState] = None,
               isecday_utc=None, lon=None, backend: str = "eager",
               remat: bool = False, fused_grad_backend: str = "kernel",
               batch_records: bool = False):
    """Run :func:`flux_step` over a time axis, carrying the warm-layer
    state from record to record as the reference's time loop does.

    ``forcing`` maps input names (sst, t_zt, hum_zt, U_zu, V_zu, slp,
    [rad_sw, rad_lw]) to tensors of shape ``(nt, ...)``.  ``isecday_utc``
    holds the ``nt`` UTC seconds-of-day on the host (a list, a numpy array
    or a CPU tensor): it is required whenever the config runs the COARE
    warm layer.  Returns ``(FluxOutput stacked over nt, final SkinState)``.

    ``backend``:
      * ``"eager"`` — :func:`flux_step` on tensors (the counterpart of
        ``aerobulk_tpu``'s ``"jit"``).
      * ``"fused"`` — one launch of the fused CUDA kernel per record
        (:func:`aerobulk_tpu_torch.kernels.fused.fused_flux_step`); needs a
        COARE or ECMWF config with ``use_skin=True`` and rad_sw/rad_lw.
        Returns the reduced output set: ``Tau``, ``rho_a`` and ``diag`` are
        None.
        Differentiable: ``fused_grad_backend`` (``"kernel"`` or
        ``"eager"``) picks each record's backward pass, as
        ``fused_flux_step``'s ``grad_backend``.

    Gradients with respect to the forcing and the initial state come from
    torch autograd.  ``remat=True`` (eager backend) recomputes each
    record's step in the backward pass instead of keeping its
    intermediates (``torch.utils.checkpoint``, the counterpart of
    ``jax.checkpoint``), so the memory for a gradient holds one record's
    graph at a time.  The fused backend keeps only each record's 13 inputs
    anyway: there ``remat`` has no effect.

    A mixed ocean + ice config (``cfg.ice_algo`` set) steps mixed cells:
    ``forcing`` also holds the ice surface temperature ``Ts_i`` and the ice
    concentration ``frice``; ``rad_sw``, ``rad_lw``, ``lon`` and
    ``isecday_utc`` are not read.  Each record is
    :func:`flux_step_mixed` (``cfg.ice_algo`` over the ice, ``cfg.algo``
    over the leads) with ``backend="eager"``, returning the net
    :class:`FluxOutput`; with ``backend="fused"`` one launch of the mixed
    kernel (:func:`aerobulk_tpu_torch.kernels.fused.fused_mixed_step`),
    returning the net ``QL``, ``QH``, ``Tau``, ``Evap`` and ``T_s``
    (``Tau_x``, ``Tau_y``, ``rho_a`` and ``diag`` None).  Neither has
    state: the returned state is the initial one, untouched.

    ``batch_records=True`` (stateless configs, ``use_skin=False``, only)
    computes every record in one call instead of looping: the records of a
    stateless config are independent.  With ``backend="eager"`` it is one
    :func:`flux_step` on the whole ``(nt, ...)`` tensors; with
    ``backend="fused"`` one launch of the stateless CUDA kernel
    (:func:`aerobulk_tpu_torch.kernels.fused.fused_bulk_step`), with the
    reduced output set, for all five algorithms.  A mixed config's batch
    is one :func:`flux_step_mixed`, or one launch of the mixed kernel.
    The fused kernels have no backward pass: take gradients through
    ``backend="eager"``.  The returned state is the initial one,
    untouched.

    In a ``torch.profiler`` trace the call is the span
    ``aerobulk.run_series`` (args: backend, nt, call, and a mixed
    config's ice_algo), with
    ``.init_state`` (a fresh state; a batch's after its launch), one
    ``.record`` a record (args: call, k) and ``.stack`` inside it.
    """
    call = call_id()
    args = {"backend": backend, "nt": int(forcing["sst"].shape[0]),
            "call": call}
    if cfg.ice_algo is not None:        # a trace keeps no None arg
        args["ice_algo"] = cfg.ice_algo
    with span("aerobulk.run_series", args):
        return _series(cfg, forcing, skin_state, isecday_utc, lon, backend,
                       remat, fused_grad_backend, batch_records, call)


def _series(cfg, forcing, skin_state, isecday_utc, lon, backend, remat,
            fused_grad_backend, batch_records, call):
    """The body of :func:`run_series`, ``call`` its spans' id."""
    names = ["sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp"]
    opt = [n for n in ("rad_sw", "rad_lw") if n in forcing]
    sst = forcing["sst"]
    nt = sst.shape[0]

    def initial_state():
        if skin_state is not None:
            return skin_state
        with span("aerobulk.run_series.init_state"):
            return init_skin_state(cfg, sst.shape[1:], sst.dtype, sst.device)

    if batch_records:
        # the records are independent: the batch is queued first, and the
        # state it returns untouched is made while the device works on it
        out = (_run_batch(cfg, forcing, names, opt, lon, backend)
               if cfg.ice_algo is None else
               _mixed_series(cfg, forcing, backend, True, call))
        return out, initial_state()
    skin_state = initial_state()
    if cfg.ice_algo is not None:
        return _mixed_series(cfg, forcing, backend, False, call), skin_state

    if isecday_utc is None:
        if cfg.use_skin and OCEAN_ALGOS[cfg.algo][2]:
            raise ValueError(
                f"run_series: algo {cfg.algo!r} with use_skin=True needs "
                "isecday_utc — the nt UTC seconds since 00h of the "
                "records — to anchor the warm layer's solar clock.  Pass "
                "[12] * nt explicitly to replicate the reference's "
                "hardcoded library value (mod_aerobulk_compute.f90:136)")
        isecday_utc = [0] * nt      # unused by the config
    if isinstance(isecday_utc, torch.Tensor):
        isecday_utc = isecday_utc.cpu()
    isd = np.asarray(isecday_utc).tolist()
    if len(isd) != nt:
        raise ValueError(f"run_series: {len(isd)} isecday_utc values for "
                         f"{nt} records")

    if backend == "fused":
        from .kernels.fused import fused_flux_step
        if not cfg.use_skin or "rad_sw" not in forcing \
                or "rad_lw" not in forcing:
            raise ValueError("run_series(backend='fused') needs a skin "
                             "config and rad_sw/rad_lw forcing")

        def step(k, state):
            (QL, QH, Tau_x, Tau_y, Evap, T_s), state = fused_flux_step(
                cfg, *(forcing[n][k] for n in names), forcing["rad_sw"][k],
                forcing["rad_lw"][k], lon=lon, isecday_utc=isd[k],
                skin_state=state, grad_backend=fused_grad_backend)
            return FluxOutput(QL=QL, QH=QH, Tau=None, Tau_x=Tau_x,
                              Tau_y=Tau_y, Evap=Evap, T_s=T_s, rho_a=None,
                              diag=None), state
    elif backend == "eager":
        def step(k, state):
            return flux_step(cfg, *(forcing[n][k] for n in names),
                             **{n: forcing[n][k] for n in opt},
                             isecday_utc=isd[k], lon=lon, skin_state=state)

        if remat:
            from torch.utils.checkpoint import checkpoint
            plain_step = step

            def step(k, state):
                return checkpoint(plain_step, k, state, use_reentrant=False)
    else:
        raise ValueError(f"run_series: unknown backend {backend!r}")

    state = skin_state
    outs = []
    for k in range(nt):
        with span("aerobulk.run_series.record", {"call": call, "k": k}):
            out, state = step(k, state)
        outs.append(out)
    with span("aerobulk.run_series.stack"):
        return _stack(outs), state


#: the fields of a mixed ocean + ice record, in the order of
#: :func:`flux_step_mixed`
_MIXED_FIELDS = ("Ts_i", "sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp",
                 "frice")


def _mixed_series(cfg: AeroBulkConfig, forcing, backend, batch_records,
                  call):
    """``run_series`` of a mixed ocean + ice config: the net fluxes of
    every record, one step a record or one over the whole series."""
    missing = [n for n in ("Ts_i", "frice") if n not in forcing]
    if missing:
        raise ValueError(f"run_series: a mixed config (ice_algo="
                         f"{cfg.ice_algo!r}) needs {missing} in the forcing")
    kw = dict(ice_algo=cfg.ice_algo, ocean_algo=cfg.algo, niter=cfg.niter,
              humidity=cfg.humidity)
    if backend == "fused":
        from .kernels.fused import fused_mixed_step

        def step(fields):
            QL, QH, Tau, Evap, T_s = fused_mixed_step(cfg.zt, cfg.zu,
                                                      *fields, **kw)
            return FluxOutput(QL=QL, QH=QH, Tau=Tau, Tau_x=None, Tau_y=None,
                              Evap=Evap, T_s=T_s, rho_a=None, diag=None)
    elif backend == "eager":
        def step(fields):
            return flux_step_mixed(cfg.zt, cfg.zu, *fields, **kw)[0]
    else:
        raise ValueError(f"run_series: unknown backend {backend!r}")

    if batch_records:
        return step([forcing[n] for n in _MIXED_FIELDS])
    outs = []
    for k in range(forcing["sst"].shape[0]):
        with span("aerobulk.run_series.record", {"call": call, "k": k}):
            outs.append(step([forcing[n][k] for n in _MIXED_FIELDS]))
    with span("aerobulk.run_series.stack"):
        return _stack(outs)


def _run_batch(cfg: AeroBulkConfig, forcing, names, opt, lon, backend):
    """``run_series(batch_records=True)``: the whole series in one call."""
    if cfg.use_skin:
        raise ValueError("run_series(batch_records=True) requires a "
                         "stateless (use_skin=False) config — skin state "
                         "couples consecutive records")
    if backend == "fused":
        if opt or lon is not None:
            # the eager batch forwards rad_sw/rad_lw/lon to flux_step, which
            # ignores them for stateless configs; the kernel does not take
            # them at all: warn so the asymmetry never hides a caller error
            ignored = opt + (["lon"] if lon is not None else [])
            warnings.warn(
                "run_series(batch_records=True, backend='fused'): ignoring "
                f"{ignored} — stateless configs use neither (radiation/lon "
                "only drive the skin schemes)", stacklevel=4)
        from .kernels.fused import fused_bulk_step
        QL, QH, Tau_x, Tau_y, Evap, T_s = fused_bulk_step(
            cfg, *(forcing[n] for n in names))
        return FluxOutput(QL=QL, QH=QH, Tau=None, Tau_x=Tau_x, Tau_y=Tau_y,
                          Evap=Evap, T_s=T_s, rho_a=None, diag=None)
    if backend != "eager":
        raise ValueError(f"run_series: unknown backend {backend!r}")
    out, _ = flux_step(cfg, *(forcing[n] for n in names),
                       **{n: forcing[n] for n in opt}, lon=lon)
    return out


#: the warm-layer state and humidity kind of each open aerobulk_model
#: series, by (algorithm, shape, series_id)
_MODEL_STATE: dict = {}


def aerobulk_model(jt, Nt, calgo, zt, zu, sst, t_zt, hum_zt, U_zu, V_zu,
                   slp, Niter=5, l_use_skin=False, rad_sw=None, rad_lw=None,
                   isecday_utc=12, lon=None, series_id=0, device=None):
    """Drop-in analogue of the reference's ``AEROBULK_MODEL``
    (mod_aerobulk.f90:176-268) for migrating users.

    Call with ``jt`` from 1 to ``Nt``.  The fields may be numpy arrays,
    scalars or tensors: they are put on ``device``, the CUDA device unless
    the caller names another (``device="cpu"``); without a GPU and without
    ``device`` this raises.  Validation and humidity-type detection run at
    ``jt == 1`` (AEROBULK_INIT, mod_aerobulk.f90:126-153); the warm-layer
    state and the detected humidity kind are carried between calls in a
    process-local registry keyed by ``(calgo, shape, series_id)``,
    created at ``jt == 1`` and dropped after ``jt == Nt``.  ``series_id``
    keeps interleaved series of one algorithm and shape apart.  Each call
    runs the eager :func:`flux_step` and then :func:`check_flux_sanity`
    (the reference aborts on tau > ref_tau_max, mod_phymbl.f90:1249-1253).

    Returns ``(QL, QH, Tau_x, Tau_y, Evap, T_s)`` as tensors on ``device``.
    Prefer :func:`flux_step` / :func:`run_series` in new code.

    NB: the default ``isecday_utc=12`` replicates the reference's
    library-level warm-layer bug (mod_aerobulk_compute.f90:136 anchors the
    solar clock 12 *seconds* past midnight).  Pass the real seconds-of-day
    for physically meaningful warm-layer timing."""
    device = default_device(device)

    def on_device(x):
        return None if x is None else torch.as_tensor(x, device=device)

    sst, t_zt, hum_zt, U_zu, V_zu, slp, rad_sw, rad_lw, lon = (
        on_device(x) for x in (sst, t_zt, hum_zt, U_zu, V_zu, slp, rad_sw,
                               rad_lw, lon))
    cfg = AeroBulkConfig(algo=calgo, zt=float(zt), zu=float(zu),
                         niter=int(Niter), use_skin=bool(l_use_skin),
                         humidity="auto")
    key = (calgo, tuple(sst.shape), series_id)
    if int(jt) == 1 or key not in _MODEL_STATE:
        _, htype = init(cfg, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                        rad_sw=rad_sw, rad_lw=rad_lw)
        cfg = dataclasses.replace(cfg, humidity=htype)
        _MODEL_STATE[key] = (init_skin_state(cfg, sst.shape, sst.dtype,
                                             device), htype)
    skin_state, htype = _MODEL_STATE[key]
    cfg = dataclasses.replace(cfg, humidity=htype)
    out, state = flux_step(cfg, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                           rad_sw=rad_sw, rad_lw=rad_lw,
                           isecday_utc=isecday_utc, lon=lon,
                           skin_state=skin_state)
    check_flux_sanity(out)
    if int(jt) >= int(Nt):
        _MODEL_STATE.pop(key, None)
    else:
        _MODEL_STATE[key] = (state, htype)
    return out.QL, out.QH, out.Tau_x, out.Tau_y, out.Evap, out.T_s


def flux(algo, zt, zu, sst, t_zt, hum_zt, U_zu, V_zu, slp,
         rad_sw=None, rad_lw=None, niter=5, use_skin=False, humidity="sh",
         **kw):
    """One-shot convenience wrapper (the ``aerobulk::model`` analogue)."""
    cfg = AeroBulkConfig(algo=algo, zt=zt, zu=zu, niter=niter,
                         use_skin=use_skin, humidity=humidity)
    out, _ = flux_step(cfg, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                       rad_sw=rad_sw, rad_lw=rad_lw, **kw)
    return out


# ---------------------------------------------------------------------------
# sea ice and mixed ocean+ice cells
# ---------------------------------------------------------------------------

def flux_step_ice(ice_algo: str, zt, zu, Ts_i, t_zt, hum_zt, U_zu, V_zu,
                  slp, frice=None, niter=5, humidity="sh", **algo_kw):
    """Fluxes over sea ice with one of the ice algorithm family
    (``ice.ICE_ALGOS``).  ``Ts_i`` is the ice surface temperature;
    saturation humidity at the surface uses the over-ice Goff formula and
    the bulk formula the sublimation branch (``l_ice`` semantics of
    mod_phymbl.f90:1193-1196).  ``frice`` (ice concentration) is required
    by the algorithms with ``needs_frice``; ``algo_kw`` are the scalar
    settings of an algorithm (``ice_easy``'s ``CdN``, ``ChN``, ``CeN``).

    Returns ``(FluxOutput, FluxResult)``."""
    from .ice import ICE_ALGOS

    fn, needs_frice = ICE_ALGOS[ice_algo]
    q_zt = _q_air(humidity, hum_zt, t_zt, slp)
    wnd = torch.sqrt(U_zu * U_zu + V_zu * V_zu)
    qs_i = thermo.q_sat(Ts_i, slp, l_ice=True)
    theta_zt = thermo.theta_from_z_p0_t_q(zt, slp, t_zt, q_zt)

    args = (zt, zu, Ts_i, theta_zt, qs_i, q_zt, wnd)
    if needs_frice:
        if frice is None:
            raise ValueError(f"{ice_algo} requires the ice concentration "
                             "`frice`")
        args = args + (frice,)
    res = fn(*args, niter=niter, **algo_kw)
    return _flux_outputs_from_result(zu, res, wnd, U_zu, V_zu, slp,
                                     True), res


_ICE_LINEARIZABLE = ("Ts_i", "t_zt", "hum_zt", "U_zu", "V_zu", "slp")


def flux_step_ice_linearized(ice_algo: str, zt, zu, Ts_i, t_zt, hum_zt,
                             U_zu, V_zu, slp, frice=None, niter=5,
                             humidity="sh", wrt: str = "Ts_i", **algo_kw):
    """Ice fluxes plus the per-point derivative of every output with
    respect to one input field ``wrt`` (one of ``_ICE_LINEARIZABLE``), in
    one forward-mode pass, as :func:`flux_step_linearized`.  ``wrt="Ts_i"``
    gives what the surface energy-balance Newton iteration of SI3/CICE-class
    ice models needs, exact through the chosen scheme.  Returns ``(out,
    d_out, res)``: the primal :class:`FluxOutput`, its derivative
    (``d_out.diag`` holds the diagnostics'), and the primal
    :class:`FluxResult`."""
    fields = dict(Ts_i=Ts_i, t_zt=t_zt, hum_zt=hum_zt, U_zu=U_zu,
                  V_zu=V_zu, slp=slp)
    (out, res), (d_out, _) = _linearize(
        "flux_step_ice_linearized", _ICE_LINEARIZABLE, fields, wrt,
        lambda f: flux_step_ice(ice_algo, zt, zu, f["Ts_i"], f["t_zt"],
                                f["hum_zt"], f["U_zu"], f["V_zu"], f["slp"],
                                frice=frice, niter=niter, humidity=humidity,
                                **algo_kw))
    return out, d_out, res


def _blend(frice, out_i: FluxOutput, out_w: FluxOutput):
    """Area-weighted net of the ice and ocean fluxes, ``frice * ice +
    (1 - frice) * ocean``; the diagnostics are the ocean side's."""
    def blend(i, w):
        return frice * i + (1.0 - frice) * w

    return FluxOutput(
        QL=blend(out_i.QL, out_w.QL), QH=blend(out_i.QH, out_w.QH),
        Tau=blend(out_i.Tau, out_w.Tau),
        Tau_x=blend(out_i.Tau_x, out_w.Tau_x),
        Tau_y=blend(out_i.Tau_y, out_w.Tau_y),
        Evap=blend(out_i.Evap, out_w.Evap),
        T_s=blend(out_i.T_s, out_w.T_s),
        rho_a=blend(out_i.rho_a, out_w.rho_a), diag=out_w.diag)


def flux_step_mixed(zt, zu, Ts_i, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                    frice, ice_algo="ice_lg15", ocean_algo="ecmwf",
                    niter=5, humidity="sh", simultaneous=False):
    """Mixed ocean+ice grid cell: ice fluxes over the ice fraction, ocean
    fluxes (``ocean_algo`` without skin) over the leads, area-weighted net
    (the ``test_aerobulk_oce+ice.f90`` workload, BASELINE config 5).

    ``simultaneous=True`` selects the reference's LG15_IO path
    (mod_blk_ice_lg15_io.f90:55-404): ice and open-water transfer
    coefficients are solved in one pass by the same Louis-stability
    scheme (``turb_ice_lg15_io``); ``ice_algo``/``ocean_algo`` are then
    ignored.

    Returns ``(net FluxOutput, ice FluxOutput, ocean FluxOutput)`` where
    the net fluxes are ``frice * ice + (1 - frice) * ocean``."""
    if simultaneous:
        return _flux_step_mixed_lg15_io(zt, zu, Ts_i, sst, t_zt, hum_zt,
                                        U_zu, V_zu, slp, frice,
                                        niter=niter, humidity=humidity)
    out_i, _ = flux_step_ice(ice_algo, zt, zu, Ts_i, t_zt, hum_zt,
                             U_zu, V_zu, slp, frice=frice, niter=niter,
                             humidity=humidity)
    cfg_w = AeroBulkConfig(algo=ocean_algo, zt=zt, zu=zu, niter=niter,
                           humidity=humidity)
    out_w, _ = flux_step(cfg_w, sst, t_zt, hum_zt, U_zu, V_zu, slp)
    return _blend(frice, out_i, out_w), out_i, out_w


def _flux_step_mixed_lg15_io(zt, zu, Ts_i, sst, t_zt, hum_zt, U_zu, V_zu,
                             slp, frice, niter=5, humidity="sh"):
    """LG15_IO mixed-cell step: one simultaneous ice+water coefficient
    solve (mod_blk_ice_lg15_io.f90:55-404), then per-surface BULK_FORMULA
    (ice branch over ice, ocean branch over leads) and area blending."""
    from .ice import turb_ice_lg15_io

    q_zt = _q_air(humidity, hum_zt, t_zt, slp)
    wnd = torch.sqrt(U_zu * U_zu + V_zu * V_zu)
    qs_i = thermo.q_sat(Ts_i, slp, l_ice=True)
    ssq_w = c.rdct_qsat_salt * thermo.q_sat(sst, slp)
    theta_zt = thermo.theta_from_z_p0_t_q(zt, slp, t_zt, q_zt)

    res_i, res_w = turb_ice_lg15_io(zt, zu, Ts_i, theta_zt, qs_i, q_zt,
                                    wnd, frice, Ts_w=sst, qs_w=ssq_w,
                                    niter=niter)
    out_i = _flux_outputs_from_result(zu, res_i, wnd, U_zu, V_zu, slp, True)
    out_w = _flux_outputs_from_result(zu, res_w, wnd, U_zu, V_zu, slp, False)
    return _blend(frice, out_i, out_w), out_i, out_w
