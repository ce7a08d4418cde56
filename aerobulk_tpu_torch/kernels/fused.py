"""The fused flux step and its gradient: one CUDA kernel per record for
Hopper each way; the stateless batched step, one CUDA kernel over any
shape; and the plain PyTorch versions of all three.

:func:`fused_flux_step` is the counterpart of
``aerobulk_tpu.kernels.fused.fused_flux_step`` (the Pallas kernel
``_kernel``).  On CUDA tensors it launches ``csrc/fused_step.cu``, which
runs the whole stateful COARE 3.0/3.6 + cool-skin + warm-layer step in
registers, one thread per point.  It is differentiable (``_FusedStep``,
the counterpart of ``_fused_step_ad``): with ``grad_backend="kernel"`` the
backward pass launches ``csrc/fused_grad.cu`` (the counterpart of the
Pallas ``_grad_kernel``), with ``"eager"`` it is autograd of the eager
step recomputed from the saved inputs.  On CPU tensors the step is
:func:`fused_flux_step_plain`, the eager :func:`api.flux_step` reduced to
the same outputs, and autograd runs through it.  There is no fallback
from one to the other.

:func:`fused_bulk_step` is the counterpart of
``aerobulk_tpu.kernels.fused.fused_bulk_step`` (the Pallas kernel
``_bulk_kernel``): the stateless step (``use_skin=False``) of any of the
five ocean algorithms on inputs of any shape, through
``csrc/bulk_step.cu`` on CUDA tensors and :func:`fused_bulk_step_plain`
on CPU tensors.  Like the Pallas kernel it has no backward pass.
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
#: number of launches of the fused-gradient kernel in this process
GRAD_LAUNCHES = 0
#: number of launches of the stateless (bulk) kernel in this process
BULK_LAUNCHES = 0

GRAD_BACKENDS = ("kernel", "eager")

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
    if cfg.algo not in _VERSIONS:
        raise NotImplementedError(
            f"fused_flux_step takes coare3p0/coare3p6; {cfg.algo!r} with "
            "skin in the kernel is the next slice of the port (ROADMAP.md "
            "section 2, kernels 1 and 2); run it with backend='eager'")
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
    """One stateful flux step (COARE 3.0/3.6 with cool skin and warm layer).

    All fields are tensors of one shape, dtype (fp32 or fp64) and device;
    on CUDA they must be contiguous.  ``isecday_utc`` is a Python number
    (UTC seconds since 00h) and reaches the kernel as a scalar argument.
    Returns ``((QL, QH, Tau_x, Tau_y, Evap, T_s), SkinState)``.

    Gradients flow to the 9 fields and the 4 state fields.  On CUDA,
    ``grad_backend`` picks the backward pass: ``"kernel"`` (the
    counterpart of aerobulk_tpu's ``"pallas"``) launches the gradient
    kernel, ``"eager"`` (its ``"jit"``) runs autograd of
    :func:`fused_flux_step_plain`.  The step keeps only its 13 inputs for
    the backward pass either way."""
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
    ins = (*args, *skin_state)
    _check_fields("fused_flux_step", _INPUTS, ins, ins[0])
    outs = _FusedStep.apply(cfg, float(isecday_utc), grad_backend, *ins)
    return tuple(outs[:6]), SkinState(*outs[6:])


class _FusedStep(torch.autograd.Function):
    """The kernel step with its VJP: forward launches the step kernel and
    keeps the 13 inputs; backward gets the 10 cotangents (zeros for an
    output that gets none, as autograd materializes them) and returns the
    13 gradients, from the gradient kernel or from eager autograd."""

    @staticmethod
    def forward(ctx, cfg, isecday_utc, grad_backend, *ins):
        ctx.cfg, ctx.isecday_utc = cfg, isecday_utc
        ctx.grad_backend = grad_backend
        ctx.save_for_backward(*ins)
        return _launch(cfg, ins, isecday_utc)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cotangents):
        ins = ctx.saved_tensors
        cts = tuple(c.contiguous() for c in cotangents)
        if ctx.grad_backend == "kernel":
            grads = fused_flux_step_grad(ctx.cfg, ins, cts, ctx.isecday_utc)
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


def _call(fn, ref, tensors, cfg: AeroBulkConfig, isecday_utc: float):
    """Launch ``fn`` (abt_fused_step_* / abt_fused_grad_*) on the stream of
    ``ref``'s device with the pointers of ``tensors``."""
    ptrs = (ctypes.c_void_p * len(tensors))(*(x.data_ptr() for x in tensors))
    ver = _VERSIONS[cfg.algo]
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = fn(ptrs, ref.numel(), cfg.niter, _CHARN_LAW[ver.charn],
                 int(ver.visc_at_tzu), _HUMIDITY[cfg.humidity],
                 ver.z0t_max, ver.z0t_coef, ver.z0t_pow, ver.beta0,
                 cfg.zt, cfg.zu, cfg.rdt, cfg.gdept, isecday_utc, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: kernel launch failed with CUDA "
                           f"error {err}")


def _launch(cfg: AeroBulkConfig, ins, isecday_utc: float):
    global LAUNCHES
    ref = ins[0]
    lib = load_library("fused_step.cu")
    fn = (lib.abt_fused_step_f32 if ref.dtype == torch.float32
          else lib.abt_fused_step_f64)
    outs = [torch.empty_like(ref) for _ in range(10)]
    _call(fn, ref, (*ins, *outs), cfg, isecday_utc)
    LAUNCHES += 1
    return tuple(outs)


def fused_flux_step_grad(cfg: AeroBulkConfig, ins, cotangents,
                         isecday_utc: float = 43200):
    """The gradient kernel's wrapper: the VJP of one step at the 13 CUDA
    tensors ``ins`` (9 fields, 4 state) for the 10 ``cotangents`` of
    (QL, QH, Tau_x, Tau_y, Evap, T_s, new state), as 13 gradients.  All
    23 tensors share one shape, dtype and device and are contiguous."""
    global GRAD_LAUNCHES
    _check_config(cfg)
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
    lib = load_library("fused_grad.cu")
    fn = (lib.abt_fused_grad_f32 if ref.dtype == torch.float32
          else lib.abt_fused_grad_f64)
    grads = [torch.empty_like(ref) for _ in range(13)]
    _call(fn, ref, (*ins, *cotangents, *grads), cfg, float(isecday_utc))
    GRAD_LAUNCHES += 1
    return tuple(grads)


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
    shape of the tensors with dimensions."""
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
    0-d ``slp`` works); on CUDA they are flattened to one axis of n points
    (a broadcast input is materialized), solved in one launch and the
    outputs restored to the broadcast shape.  Returns ``(QL, QH, Tau_x,
    Tau_y, Evap, T_s)``.  On CPU tensors it is
    :func:`fused_bulk_step_plain`.  The kernel has no backward pass: on
    CUDA an input that requires a gradient (with grad mode on) raises;
    take gradients through the eager path."""
    global BULK_LAUNCHES
    _check_bulk_config(cfg)
    fields = _bulk_fields((sst, t_zt, hum_zt, U_zu, V_zu, slp))
    ref = fields[0]
    if ref.device.type == "cpu":
        return fused_bulk_step_plain(cfg, *fields)
    if ref.device.type != "cuda":
        raise ValueError(f"fused_bulk_step: no kernel for device "
                         f"{ref.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in fields):
        raise RuntimeError(
            "fused_bulk_step: the stateless kernel has no backward pass; "
            "take gradients through run_series(batch_records=True, "
            "backend='eager') or api.flux_step")
    shape = ref.shape
    flat = tuple(x.reshape(-1).contiguous() for x in fields)
    _check_fields("fused_bulk_step", _BULK_INPUTS, flat, flat[0])
    lib = load_library("bulk_step.cu")
    fn = (lib.abt_bulk_step_f32 if ref.dtype == torch.float32
          else lib.abt_bulk_step_f64)
    outs = [torch.empty_like(flat[0]) for _ in range(6)]
    tensors = (*flat, *outs)
    ptrs = (ctypes.c_void_p * len(tensors))(*(x.data_ptr() for x in tensors))
    # the COARE version's constants; the other algorithms ignore them
    ver = _VERSIONS.get(cfg.algo)
    charn_law, visc_at_tzu, z0t = ((_CHARN_LAW[ver.charn],
                                    int(ver.visc_at_tzu),
                                    (ver.z0t_max, ver.z0t_coef, ver.z0t_pow,
                                     ver.beta0))
                                   if ver else (0, 0, (0.0, 0.0, 0.0, 0.0)))
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = fn(ptrs, flat[0].numel(), _BULK_ALGOS[cfg.algo], cfg.niter,
                 charn_law, visc_at_tzu, _HUMIDITY[cfg.humidity], *z0t,
                 cfg.zt, cfg.zu, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: kernel launch failed with CUDA "
                           f"error {err}")
    BULK_LAUNCHES += 1
    return tuple(o.reshape(shape) for o in outs)
