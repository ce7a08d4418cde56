"""The fused flux step and its gradient: one CUDA kernel per record for
Hopper each way; the stateless batched step, one CUDA kernel over any
shape; and the plain PyTorch versions of all three.

:func:`fused_flux_step` is the counterpart of
``aerobulk_tpu.kernels.fused.fused_flux_step`` (the Pallas kernel
``_kernel``).  On CUDA tensors it launches ``csrc/fused_step.cu``, which
runs the whole stateful COARE 3.0/3.6 + cool-skin + warm-layer step in
registers, one thread per point, or for ECMWF + skin its twin
``csrc/fused_step_ecmwf.cu``.  It is differentiable (``_FusedStep``,
the counterpart of ``_fused_step_ad``): with ``grad_backend="kernel"`` the
backward pass launches ``csrc/fused_grad.cu`` (``fused_grad_ecmwf.cu``
for ECMWF; the counterpart of the Pallas ``_grad_kernel``), with
``"eager"`` it is autograd of the eager step recomputed from the saved
inputs.  On CPU tensors the step is
:func:`fused_flux_step_plain`, the eager :func:`api.flux_step` reduced to
the same outputs, and autograd runs through it.  There is no fallback
from one to the other.

:func:`fused_bulk_step` is the counterpart of
``aerobulk_tpu.kernels.fused.fused_bulk_step`` (the Pallas kernel
``_bulk_kernel``): the stateless step (``use_skin=False``) of any of the
five ocean algorithms on inputs of any shape, through
``csrc/bulk_step.cu`` on CUDA tensors and :func:`fused_bulk_step_plain`
on CPU tensors.  Like the Pallas kernel it has no backward pass.

:func:`fused_ice_step` and :func:`fused_mixed_step` are the counterparts of
``aerobulk_tpu.kernels.fused.fused_ice_step`` and ``fused_mixed_step`` (the
Pallas kernels ``_ice_kernel`` and ``_mixed_kernel``): the ice-only step of
the seven sea-ice algorithms through ``csrc/ice_step.cu``, and the mixed
ocean+ice cell through ``csrc/mixed_step.cuh`` (one library per ocean
algorithm), on CUDA tensors;
:func:`fused_ice_step_plain` and :func:`fused_mixed_step_plain` on CPU
tensors.  Neither has a backward pass.

On CUDA tensors each wrapper is a span in a ``torch.profiler`` trace
(``profiling.span``): ``aerobulk.kernel<N>.wrapper`` for kernel N, and for
kernels 1, 2, 3 and 5 its ``.check`` (the arguments' and fields' checks),
``.alloc`` (the outputs) and ``.launch`` (the library's entry and the
ctypes call) inside it; kernel 1's backward pass is
``aerobulk.kernel1.backward``.

Every launch takes its entry from ``_build.entry`` and runs through
``_build.launch``: the pointers of the kernel's fields in the order of its
names here (``_INPUTS`` and ``_OUTPUTS``, ``_BULK_INPUTS``, ``_ICE_INPUTS``,
``_MIXED_INPUTS``), then the outputs, then the scalar arguments of
``_skin_args``, ``_bulk_args``, ``_ice_args`` or ``_mixed_args``.
"""

from __future__ import annotations

import ctypes
import functools
import inspect
import math
from typing import Optional

import torch

from ..algos.coare import _VERSIONS
from ..api import (AeroBulkConfig, flux_step, flux_step_ice, flux_step_mixed,
                   init_skin_state)
from ..closures import charn_coare3p0, charn_coare3p6
from ..ice import ICE_ALGOS, turb_ice_easy
from ..profiling import open_args, span
from ..skin import SkinState
from . import _build

#: number of launches of the fused-step kernel (COARE or ECMWF) in this
#: process
LAUNCHES = 0
#: number of launches of the fused-gradient kernel (COARE or ECMWF) in this
#: process
GRAD_LAUNCHES = 0
#: number of launches of the stateless (bulk) kernel in this process
BULK_LAUNCHES = 0
#: number of launches of the ice-only kernel in this process
ICE_LAUNCHES = 0
#: number of launches of the mixed ocean+ice kernel in this process
MIXED_LAUNCHES = 0

GRAD_BACKENDS = ("kernel", "eager")
#: the most outer iterations (cfg.niter) the gradient kernel takes: its
#: reverse sweep keeps one checkpoint per iteration (csrc/adjoint.cuh,
#: kMaxIter)
GRAD_MAX_NITER = 20

_HUMIDITY = {"sh": 0, "rh": 1, "dp": 2}
#: the algorithm index of bulk_step.cu's host switch
_BULK_ALGOS = {"coare3p0": 0, "coare3p6": 1, "ecmwf": 2, "ncar": 3,
               "andreas": 4}
_CHARN_LAW = {charn_coare3p0: 0, charn_coare3p6: 1}
_INPUTS = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "rad_sw",
           "rad_lw", "lon", "dT_wl", "Hz_wl", "Qnt_ac", "Tau_ac")
_OUTPUTS = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s", "dT_wl", "Hz_wl",
            "Qnt_ac", "Tau_ac")


def _check_config(cfg: AeroBulkConfig):
    if not cfg.use_skin:
        raise NotImplementedError(
            "fused_flux_step runs the skin (use_skin=True) step; stateless "
            "configs go through fused_bulk_step (run_series(batch_records="
            "True, backend='fused'))")
    if cfg.humidity not in _HUMIDITY:
        raise ValueError("fused_flux_step: resolve humidity='auto' via "
                         "init() and rebuild the config with the detected "
                         "type")


def _check_grad_backend(grad_backend):
    if grad_backend == "remat":
        raise ValueError(
            "fused_flux_step: grad_backend='remat' is not ported: it is a "
            "measured negative in aerobulk_tpu (kernels/fused.py, "
            "_fused_step_bwd); use 'kernel' or 'eager'")
    if grad_backend not in GRAD_BACKENDS:
        raise ValueError(f"fused_flux_step: unknown grad_backend "
                         f"{grad_backend!r}; expected one of {GRAD_BACKENDS}")


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


def fused_flux_step_vjp_plain(cfg: AeroBulkConfig, inputs, state: SkinState,
                              cotangents, isecday_utc=43200):
    """The plain PyTorch version of the gradient kernel (the counterpart of
    ``aerobulk_tpu``'s ``jax.vjp`` of ``_jit_equiv``): autograd of
    :func:`fused_flux_step_plain` at ``inputs`` (sst, t_zt, hum_zt, U_zu,
    V_zu, slp, rad_sw, rad_lw, lon) and ``state``, contracted with the 10
    ``cotangents`` of (QL, QH, Tau_x, Tau_y, Evap, T_s, new state).
    Returns the 13 gradients of the inputs, then of the state."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (*inputs, *state)]
        outs, new = fused_flux_step_plain(
            cfg, *leaves[:8], lon=leaves[8], isecday_utc=isecday_utc,
            skin_state=SkinState(*leaves[9:]))
        return torch.autograd.grad((*outs, *new), leaves, tuple(cotangents),
                                   allow_unused=True, materialize_grads=True)


def fused_flux_step(cfg: AeroBulkConfig, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                    rad_sw, rad_lw, lon=None, isecday_utc=43200,
                    skin_state: Optional[SkinState] = None,
                    grad_backend: str = "kernel"):
    """One stateful flux step (COARE 3.0/3.6 or ECMWF with cool skin and
    warm layer).

    All fields are tensors of one shape, dtype (fp32 or fp64) and device;
    on CUDA they must be contiguous.  ``isecday_utc`` is a Python number
    (UTC seconds since 00h) and reaches the kernel as a scalar argument.
    Returns ``((QL, QH, Tau_x, Tau_y, Evap, T_s), SkinState)``.

    Gradients flow to the 9 fields and the 4 state fields.  On CUDA,
    ``grad_backend`` picks the backward pass: ``"kernel"`` (the
    counterpart of aerobulk_tpu's ``"pallas"``) launches the gradient
    kernel, ``"eager"`` (its ``"jit"``) runs autograd of
    :func:`fused_flux_step_plain`.  The step keeps only its 13 inputs for
    the backward pass either way.  On CUDA its span
    ``aerobulk.kernel1.wrapper`` runs from the fields' checks to the
    return."""
    _check_config(cfg)
    _check_grad_backend(grad_backend)
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
    with span("aerobulk.kernel1.wrapper"):
        ins = (*args, *skin_state)
        with span("aerobulk.kernel1.check"):
            _check_fields("fused_flux_step", _INPUTS, ins, ins[0])
        outs = _FusedStep.apply(cfg, float(isecday_utc), grad_backend, *ins)
        return tuple(outs[:6]), SkinState(*outs[6:])


class _FusedStep(torch.autograd.Function):
    """The kernel step with its VJP: forward launches the step kernel and
    keeps the 13 inputs; backward gets the 10 cotangents (zeros for an
    output that gets none, as autograd materializes them) and returns the
    13 gradients, from the gradient kernel or from eager autograd.

    The backward pass runs on autograd's device thread, where no span of
    its forward's caller is open: while a profiler runs, the forward keeps
    the args of the span it ran in (the record's call and k) for its
    backward span to name as its cause."""

    @staticmethod
    def forward(ctx, cfg, isecday_utc, grad_backend, *ins):
        ctx.cfg, ctx.isecday_utc = cfg, isecday_utc
        ctx.grad_backend = grad_backend
        ctx.cause = open_args()
        ctx.save_for_backward(*ins)
        return _step(cfg, ins, isecday_utc)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cotangents):
        with span("aerobulk.kernel1.backward", ctx.cause):
            ins = ctx.saved_tensors
            cts = tuple(c.contiguous() for c in cotangents)
            if ctx.grad_backend == "kernel":
                grads = fused_flux_step_grad(ctx.cfg, ins, cts,
                                             ctx.isecday_utc)
            else:
                grads = fused_flux_step_vjp_plain(ctx.cfg, ins[:9],
                                                  SkinState(*ins[9:]), cts,
                                                  ctx.isecday_utc)
        return (None, None, None, *grads)


def _check_fields(who, names, tensors, ref):
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{who}: dtype {ref.dtype} is not float32 or float64")
    for name, x in zip(names, tensors):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{who}: {name} is not a tensor")
        if x.device != ref.device or x.dtype != ref.dtype \
                or x.shape != ref.shape:
            raise ValueError(
                f"{who}: {name} is {x.dtype} {tuple(x.shape)} on "
                f"{x.device}; expected {ref.dtype} {tuple(ref.shape)} on "
                f"{ref.device}")
        if not x.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")


def _skin_source(cfg: AeroBulkConfig, kind: str):
    """The source of kernel 1 (``kind="step"``) or 2 (``"grad"``) for the
    config's skin solve: COARE's or ECMWF's."""
    return (f"fused_{kind}_ecmwf.cu" if cfg.algo == "ecmwf"
            else f"fused_{kind}.cu")


def _skin_args(cfg: AeroBulkConfig, isecday_utc: float):
    """Kernels 1 and 2's arguments after n."""
    law, visc, *z0t = _coare_args(cfg.algo)
    return (cfg.niter, law, visc, _HUMIDITY[cfg.humidity], *z0t, cfg.zt,
            cfg.zu, cfg.rdt, cfg.gdept, isecday_utc)


def _step(cfg: AeroBulkConfig, ins, isecday_utc: float):
    global LAUNCHES
    ref = ins[0]
    with span("aerobulk.kernel1.alloc"):
        outs = [torch.empty_like(ref) for _ in range(10)]
    if ref.numel() == 0:
        # an empty block (a rank whose share of the grid is empty): no
        # kernel runs, and none is counted
        return tuple(outs)
    with span("aerobulk.kernel1.launch"):
        _build.launch(_build.entry(_skin_source(cfg, "step"), ref.dtype),
                      (*ins, *outs), *_skin_args(cfg, isecday_utc))
    LAUNCHES += 1
    return tuple(outs)


def fused_flux_step_grad(cfg: AeroBulkConfig, ins, cotangents,
                         isecday_utc: float = 43200):
    """The gradient kernel's wrapper: the VJP of one step at the 13 CUDA
    tensors ``ins`` (9 fields, 4 state) for the 10 ``cotangents`` of
    (QL, QH, Tau_x, Tau_y, Evap, T_s, new state), as 13 gradients.  All
    23 tensors share one shape, dtype and device and are contiguous.
    Its span is ``aerobulk.kernel2.wrapper``."""
    global GRAD_LAUNCHES
    with span("aerobulk.kernel2.wrapper"):
        with span("aerobulk.kernel2.check"):
            ref = _check_grad_args(cfg, ins, cotangents)
        with span("aerobulk.kernel2.alloc"):
            grads = [torch.empty_like(ref) for _ in range(13)]
        if ref.numel() == 0:
            return tuple(grads)     # an empty block: nothing to launch
        with span("aerobulk.kernel2.launch"):
            _build.launch(_build.entry(_skin_source(cfg, "grad"), ref.dtype),
                          (*ins, *cotangents, *grads),
                          *_skin_args(cfg, float(isecday_utc)))
        GRAD_LAUNCHES += 1
        return tuple(grads)


def _check_grad_args(cfg: AeroBulkConfig, ins, cotangents):
    """fused_flux_step_grad's checks; the reference field of the 23."""
    _check_config(cfg)
    if not 0 <= cfg.niter <= GRAD_MAX_NITER:
        raise ValueError(f"fused_flux_step_grad: niter={cfg.niter}; the "
                         f"gradient kernel takes 0 to {GRAD_MAX_NITER} "
                         f"iterations (use grad_backend='eager')")
    ref = ins[0]
    if not isinstance(ref, torch.Tensor) or ref.device.type != "cuda":
        raise ValueError("fused_flux_step_grad: the gradient kernel takes "
                         "CUDA tensors")
    if len(ins) != 13 or len(cotangents) != 10:
        raise ValueError(f"fused_flux_step_grad: {len(ins)} inputs and "
                         f"{len(cotangents)} cotangents; expected 13 and 10")
    _check_fields("fused_flux_step_grad", _INPUTS, ins, ref)
    _check_fields("fused_flux_step_grad",
                  tuple(f"cotangent of {o}" for o in _OUTPUTS), cotangents,
                  ref)
    return ref


# ---------------------------------------------------------------------------
# the stateless (bulk) step: any shape, five algorithms, no backward pass
# ---------------------------------------------------------------------------

_BULK_INPUTS = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp")


def _check_bulk_config(cfg: AeroBulkConfig):
    if cfg.use_skin:
        raise ValueError("fused_bulk_step: the stateless kernel requires a "
                         "use_skin=False config (use fused_flux_step)")
    if cfg.humidity not in _HUMIDITY:
        raise ValueError("fused_bulk_step: resolve humidity='auto' via "
                         "init() and rebuild the config with the detected "
                         "type")


def _bulk_fields(fields):
    """Broadcast and promote the six inputs as the eager path would: a
    Python number or a 0-d tensor combines with the fields without
    changing their dtype, and everything takes the device and broadcast
    shape of the tensors with dimensions.  Tensors of one shape, dtype and
    device, as a series' fields are, are returned as they are."""
    ref = fields[0]
    if isinstance(ref, torch.Tensor) and all(
            isinstance(x, torch.Tensor) and x.shape == ref.shape
            and x.dtype == ref.dtype and x.device == ref.device
            for x in fields[1:]):
        return tuple(fields)
    tensors = [x for x in fields if isinstance(x, torch.Tensor)]
    if not tensors:
        raise TypeError("fused_bulk_step: at least one input must be a "
                        "tensor")
    ranked = [x for x in tensors if x.dim() > 0] or tensors
    dtype = ranked[0].dtype
    for x in ranked[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    device = ranked[0].device
    return torch.broadcast_tensors(*(torch.as_tensor(x, dtype=dtype,
                                                     device=device)
                                     for x in fields))


def fused_bulk_step_plain(cfg: AeroBulkConfig, sst, t_zt, hum_zt, U_zu,
                          V_zu, slp):
    """The plain PyTorch version of the stateless kernel: the eager
    :func:`api.flux_step` on the broadcast inputs, reduced to ``(QL, QH,
    Tau_x, Tau_y, Evap, T_s)``."""
    _check_bulk_config(cfg)
    fields = _bulk_fields((sst, t_zt, hum_zt, U_zu, V_zu, slp))
    out, _ = flux_step(cfg, *fields)
    return out.QL, out.QH, out.Tau_x, out.Tau_y, out.Evap, out.T_s


def fused_bulk_step(cfg: AeroBulkConfig, sst, t_zt, hum_zt, U_zu, V_zu,
                    slp):
    """The stateless flux solve (``use_skin=False``) of any of the five
    ocean algorithms, in one launch over inputs of any shape: the speed
    path of ``run_series(batch_records=True, backend="fused")``.

    Inputs broadcast and promote as in the eager path (a Python-float or
    0-d ``slp`` works); on CUDA they are made contiguous (a broadcast input
    is materialized) and solved in one launch as n points, into outputs of
    the broadcast shape.  Returns ``(QL, QH, Tau_x,
    Tau_y, Evap, T_s)``.  On CPU tensors it is
    :func:`fused_bulk_step_plain`.  The kernel has no backward pass: on
    CUDA an input that requires a gradient (with grad mode on) raises;
    take gradients through the eager path.  On CUDA its span
    ``aerobulk.kernel3.wrapper`` holds ``.check``, ``.alloc`` and
    ``.launch``."""
    global BULK_LAUNCHES
    _check_bulk_config(cfg)
    fields = _bulk_fields((sst, t_zt, hum_zt, U_zu, V_zu, slp))
    if fields[0].device.type == "cpu":
        return fused_bulk_step_plain(cfg, *fields)
    with span("aerobulk.kernel3.wrapper"):
        with span("aerobulk.kernel3.check"):
            # the fields keep their shape: the kernel reads n points from
            # each pointer, and the host does the fewest operations
            fields = _kernel_fields(
                "fused_bulk_step", "run_series(batch_records=True, "
                "backend='eager') or api.flux_step", _BULK_INPUTS, fields,
                flatten=False)
            args = _bulk_args(cfg)
        with span("aerobulk.kernel3.alloc"):
            outs = [torch.empty_like(fields[0]) for _ in range(6)]
        with span("aerobulk.kernel3.launch"):
            _build.launch(_build.entry("bulk_step.cu", fields[0].dtype),
                          (*fields, *outs), *args)
        BULK_LAUNCHES += 1
        return tuple(outs)


def _bulk_args(cfg: AeroBulkConfig):
    """The stateless kernel's arguments after n."""
    law, visc, *z0t = _coare_args(cfg.algo)
    return (_BULK_ALGOS[cfg.algo], cfg.niter, law, visc,
            _HUMIDITY[cfg.humidity], *z0t, cfg.zt, cfg.zu)


def _coare_args(algo):
    """The COARE version's constants as the kernels take them (charn_law,
    visc_at_tzu, z0t_max, z0t_coef, z0t_pow, beta0); the other algorithms
    ignore them."""
    ver = _VERSIONS.get(algo)
    if ver is None:
        return 0, 0, 0.0, 0.0, 0.0, 0.0
    return (_CHARN_LAW[ver.charn], int(ver.visc_at_tzu), ver.z0t_max,
            ver.z0t_coef, ver.z0t_pow, ver.beta0)


# ---------------------------------------------------------------------------
# sea ice and mixed ocean+ice cells: stateless, no backward pass
# ---------------------------------------------------------------------------

#: the algorithm index of abt::IceAlgo (csrc/ice_point.cuh)
_ICE_ALGOS = {"ice_nemo": 0, "ice_easy": 1, "ice_an05": 2, "ice_lu12": 3,
              "ice_lg15": 4, "ice_lg15_io": 5, "ice_best": 6}
_ICE_INPUTS = ("Ts_i", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "frice")
_MIXED_INPUTS = ("Ts_i", "sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp",
                 "frice")
ICE_OUTPUTS = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s")
MIXED_OUTPUTS = ("QL", "QH", "Tau", "Evap", "T_s")
#: ice_easy's scalar settings and their defaults
_EASY_KW = {name: prm.default for name, prm in
            inspect.signature(turb_ice_easy).parameters.items()
            if name in ("CdN", "ChN", "CeN")}


def _ice_kw(ice_algo, zt, zu, algo_kw):
    """The kernel's scalar arguments for ice_easy (CdN, ChN, CeN and the
    host-side doubles sqrt(CdN), log(zt/zu), log(zu/10)), as the JAX
    package folds them; other algorithms take none."""
    allowed = _EASY_KW if ice_algo == "ice_easy" else {}
    unknown = sorted(set(algo_kw) - set(allowed))
    if unknown:
        raise TypeError(f"{ice_algo} takes no settings {unknown}")
    kw = {**_EASY_KW, **algo_kw}
    CdN, ChN, CeN = (float(kw[k]) for k in ("CdN", "ChN", "CeN"))
    return (CdN, ChN, CeN, math.sqrt(CdN), math.log(zt / zu),
            math.log(zu / 10.0))


def _check_ice_args(who, ice_algo, humidity):
    if ice_algo not in _ICE_ALGOS:
        raise ValueError(f"{who}: unknown ice algorithm {ice_algo!r}; "
                         f"available: {sorted(_ICE_ALGOS)}")
    if humidity not in _HUMIDITY:
        raise ValueError(f"{who}: unknown humidity type {humidity!r}")


def _kernel_fields(who, grad_path, names, fields, flatten=True):
    """The fields flattened to one axis of n contiguous points on the card
    (with ``flatten=False`` contiguous in their own shape), after the checks
    the kernels need: one shape, dtype and CUDA device, and no gradient
    request (kernels 3-5 have no backward pass; ``grad_path`` names the path
    that takes gradients)."""
    ref = fields[0]
    if torch.is_grad_enabled() and any(x.requires_grad for x in fields):
        raise RuntimeError(
            f"{who}: the kernel has no backward pass; take gradients "
            f"through {grad_path}")
    if ref.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {ref.device}")
    flat = tuple((x.reshape(-1) if flatten else x).contiguous()
                 for x in fields)
    _check_fields(who, names, flat, flat[0])
    if flatten:     # else the shapes checked were the fields' own
        for name, x in zip(names, fields):
            if x.shape != ref.shape:
                raise ValueError(f"{who}: {name} has shape "
                                 f"{tuple(x.shape)}; expected "
                                 f"{tuple(ref.shape)}")
    return flat


def mixed_source(ocean_algo="ecmwf", simultaneous=False):
    """The source of the mixed kernel's library for ``ocean_algo`` leads, or
    for the simultaneous LG15_IO solve."""
    return ("mixed_step_lg15_io.cu" if simultaneous
            else f"mixed_step_{ocean_algo}.cu")


def launch_shape(source, ice_algo, dtype):
    """``(minimum resident 256-thread blocks per SM, points per thread)`` of
    the instantiation of ``ice_algo`` (a name of ``_ICE_ALGOS``) at ``dtype``
    in the library of ``source``: ``"ice_step.cu"`` or one of the mixed
    kernel's (:func:`mixed_source`), as built."""
    shape = (ctypes.c_int * 2)()
    fn = _build.entry(source, "shape")
    if fn(_ICE_ALGOS[ice_algo], int(dtype == torch.float64), shape) != 0:
        raise ValueError(f"launch_shape: {source} has no instantiation of "
                         f"{ice_algo}")
    return tuple(shape)


def fused_ice_step_plain(ice_algo, zt, zu, Ts_i, t_zt, hum_zt, U_zu, V_zu,
                         slp, frice=None, niter=5, humidity="sh",
                         **algo_kw):
    """The plain PyTorch version of the ice kernel: the eager
    :func:`api.flux_step_ice` reduced to ``(QL, QH, Tau_x, Tau_y, Evap,
    T_s)``."""
    out, _ = flux_step_ice(ice_algo, zt, zu, Ts_i, t_zt, hum_zt, U_zu, V_zu,
                           slp, frice=frice, niter=niter, humidity=humidity,
                           **algo_kw)
    return out.QL, out.QH, out.Tau_x, out.Tau_y, out.Evap, out.T_s


def _ice_args(ice_algo, zt, zu, frice, niter, humidity, algo_kw):
    """fused_ice_step's checks; the ice kernel's arguments after n."""
    _check_ice_args("fused_ice_step", ice_algo, humidity)
    kw = _ice_kw(ice_algo, zt, zu, algo_kw)
    if ICE_ALGOS[ice_algo][1] and frice is None:
        raise ValueError(f"fused_ice_step: {ice_algo} requires the ice "
                         "concentration `frice`")
    return (_ICE_ALGOS[ice_algo], int(niter), _HUMIDITY[humidity], float(zt),
            float(zu), *kw)


def ice_step_launch(ice_algo, zt, zu, Ts_i, t_zt, hum_zt, U_zu, V_zu, slp,
                    frice=None, niter=5, humidity="sh", fn=None, **algo_kw):
    """The kernel launch of :func:`fused_ice_step` on CUDA fields, bound to
    them and to 6 flat outputs allocated here: ``(launch, outs)``.  Each
    ``launch()`` (``_build.launch`` bound with ``functools.partial``, which
    keeps the tensors alive) runs the kernel alone, with none of the
    wrapper's host work and not counted in ``ICE_LAUNCHES``: for timing the
    kernel by itself (``measure.graph_ms``) and for the launch-shape sweep,
    whose ``fn`` is the same entry point of another build."""
    args = _ice_args(ice_algo, zt, zu, frice, niter, humidity, algo_kw)
    needs_frice = ICE_ALGOS[ice_algo][1]
    fields = (Ts_i, t_zt, hum_zt, U_zu, V_zu, slp) + \
        ((frice,) if needs_frice else ())
    flat = _kernel_fields("fused_ice_step", "the eager api.flux_step_ice",
                          _ICE_INPUTS[:len(fields)], fields)
    if not needs_frice:
        # a null pointer (an empty tensor's): the kernel does not read it
        flat = (*flat, flat[0].new_empty(0))
    outs = [torch.empty_like(flat[0]) for _ in range(6)]
    fn = fn or _build.entry("ice_step.cu", Ts_i.dtype)
    return functools.partial(_build.launch, fn, (*flat, *outs), *args), outs


def fused_ice_step(ice_algo, zt, zu, Ts_i, t_zt, hum_zt, U_zu, V_zu, slp,
                   frice=None, niter=5, humidity="sh", **algo_kw):
    """The ice-only flux step (:func:`api.flux_step_ice`) of one of the seven
    sea-ice algorithms in one launch: the ``test_aerobulk_buoy_series_ice
    .f90`` workload on a grid.  Stateless; ``frice`` (ice concentration) is
    required by ice_lu12, ice_lg15 and ice_lg15_io; ``algo_kw`` are
    ice_easy's scalar ``CdN``, ``ChN``, ``CeN``.

    The fields are tensors of one shape (the JAX wrapper takes 2-D
    ``(ny, nx)``; any shape works), dtype (fp32 or fp64) and device.  On
    CUDA they are flattened to n points, solved by ``csrc/ice_step.cu`` and
    the outputs restored to the shape; on CPU tensors this is
    :func:`fused_ice_step_plain`.  The kernel has no backward pass: on CUDA
    an input that requires a gradient (with grad mode on) raises.  Returns
    ``(QL, QH, Tau_x, Tau_y, Evap, T_s)``."""
    global ICE_LAUNCHES
    if Ts_i.device.type == "cpu":
        _ice_args(ice_algo, zt, zu, frice, niter, humidity, algo_kw)
        return fused_ice_step_plain(ice_algo, zt, zu, Ts_i, t_zt, hum_zt,
                                    U_zu, V_zu, slp, frice=frice, niter=niter,
                                    humidity=humidity, **algo_kw)
    with span("aerobulk.kernel4.wrapper"):
        launch, outs = ice_step_launch(ice_algo, zt, zu, Ts_i, t_zt, hum_zt,
                                       U_zu, V_zu, slp, frice=frice,
                                       niter=niter, humidity=humidity,
                                       **algo_kw)
        launch()
        ICE_LAUNCHES += 1
        return tuple(o.reshape(Ts_i.shape) for o in outs)


def fused_mixed_step_plain(zt, zu, Ts_i, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                           frice, ice_algo="ice_lg15", ocean_algo="ecmwf",
                           niter=5, humidity="sh", simultaneous=False):
    """The plain PyTorch version of the mixed kernel: the eager
    :func:`api.flux_step_mixed` reduced to the net ``(QL, QH, Tau, Evap,
    T_s)``."""
    net, _, _ = flux_step_mixed(zt, zu, Ts_i, sst, t_zt, hum_zt, U_zu, V_zu,
                                slp, frice, ice_algo=ice_algo,
                                ocean_algo=ocean_algo, niter=niter,
                                humidity=humidity, simultaneous=simultaneous)
    return net.QL, net.QH, net.Tau, net.Evap, net.T_s


def _mixed_args(zt, zu, ice_algo, ocean_algo, niter, humidity,
                simultaneous):
    """fused_mixed_step's checks; the mixed kernel's arguments after n."""
    _check_ice_args("fused_mixed_step", ice_algo, humidity)
    if ocean_algo not in _BULK_ALGOS:
        raise ValueError(f"fused_mixed_step: unknown ocean algorithm "
                         f"{ocean_algo!r}; available: {sorted(_BULK_ALGOS)}")
    law, visc, *z0t = _coare_args(ocean_algo)
    return (_ICE_ALGOS[ice_algo], _BULK_ALGOS[ocean_algo],
            int(bool(simultaneous)), int(niter), law, visc,
            _HUMIDITY[humidity], *z0t, float(zt), float(zu),
            *_ice_kw("ice_easy", zt, zu, {}))


def mixed_step_launch(zt, zu, Ts_i, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                      frice, ice_algo="ice_lg15", ocean_algo="ecmwf",
                      niter=5, humidity="sh", simultaneous=False, fn=None):
    """The kernel launch of :func:`fused_mixed_step` on CUDA fields, bound to
    them and to 5 flat outputs: ``(launch, outs)``, as
    :func:`ice_step_launch`'s (not counted in ``MIXED_LAUNCHES``)."""
    args, flat = _mixed_checked(zt, zu, Ts_i, sst, t_zt, hum_zt, U_zu, V_zu,
                                slp, frice, ice_algo=ice_algo,
                                ocean_algo=ocean_algo, niter=niter,
                                humidity=humidity, simultaneous=simultaneous)
    outs = [torch.empty_like(flat[0]) for _ in range(5)]
    fn = fn or _build.entry(mixed_source(ocean_algo, simultaneous),
                            Ts_i.dtype)
    return functools.partial(_build.launch, fn, (*flat, *outs), *args), outs


def _mixed_checked(zt, zu, Ts_i, sst, t_zt, hum_zt, U_zu, V_zu, slp, frice,
                   ice_algo, ocean_algo, niter, humidity, simultaneous):
    """The mixed kernel's arguments after n and its 8 flattened CUDA
    fields, checked."""
    args = _mixed_args(zt, zu, ice_algo, ocean_algo, niter, humidity,
                       simultaneous)
    flat = _kernel_fields("fused_mixed_step", "the eager api.flux_step_mixed",
                          _MIXED_INPUTS, (Ts_i, sst, t_zt, hum_zt, U_zu,
                                          V_zu, slp, frice))
    return args, flat


def fused_mixed_step(zt, zu, Ts_i, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                     frice, ice_algo="ice_lg15", ocean_algo="ecmwf",
                     niter=5, humidity="sh", simultaneous=False):
    """The mixed ocean+ice cell (:func:`api.flux_step_mixed`) in one
    launch: the ``test_aerobulk_oce+ice.f90`` workload, BASELINE config 5.
    ``ice_algo`` over the ice fraction ``frice``, ``ocean_algo`` (no skin)
    over the leads, area-weighted; ``simultaneous=True`` solves both
    surfaces with LG15_IO and ignores the two algorithm names.

    Fields as :func:`fused_ice_step`'s: on CUDA one launch of
    ``csrc/mixed_step.cuh``'s kernel for the two algorithms (the library of
    :func:`mixed_source`), on CPU tensors :func:`fused_mixed_step_plain`;
    no backward pass.  Returns the net ``(QL, QH, Tau, Evap, T_s)``, with
    ``Tau`` the stress magnitude.  On CUDA its span
    ``aerobulk.kernel5.wrapper`` holds ``.check``, ``.alloc`` and
    ``.launch``."""
    global MIXED_LAUNCHES
    kw = dict(ice_algo=ice_algo, ocean_algo=ocean_algo, niter=niter,
              humidity=humidity, simultaneous=simultaneous)
    if Ts_i.device.type == "cpu":
        _mixed_args(zt, zu, ice_algo, ocean_algo, niter, humidity,
                    simultaneous)
        return fused_mixed_step_plain(zt, zu, Ts_i, sst, t_zt, hum_zt, U_zu,
                                      V_zu, slp, frice, **kw)
    with span("aerobulk.kernel5.wrapper"):
        with span("aerobulk.kernel5.check"):
            args, flat = _mixed_checked(zt, zu, Ts_i, sst, t_zt, hum_zt,
                                        U_zu, V_zu, slp, frice, **kw)
        with span("aerobulk.kernel5.alloc"):
            outs = [torch.empty_like(flat[0]) for _ in range(5)]
        with span("aerobulk.kernel5.launch"):
            _build.launch(_build.entry(mixed_source(ocean_algo, simultaneous),
                                       Ts_i.dtype), (*flat, *outs), *args)
        MIXED_LAUNCHES += 1
        return tuple(o.reshape(Ts_i.shape) for o in outs)
