"""Roofline accounting for the port's kernels: the counterpart of
``aerobulk_tpu.roofline``.

* :func:`count_primitives` — the exact per-point op census of an
  elementwise torch function: every ATen op it dispatches on ``(1, 1)``
  CPU tensors, split into the transcendental classes of
  :data:`TRANSCENDENTAL` and the cheap ALU ops;
  :func:`flux_step_counts` applies it to ``api.flux_step`` at any setting.
* :data:`CENSUS` — the census of every step a kernel of the port runs at
  niter=5, the JAX graph's (``aerobulk_tpu.roofline.count_primitives``),
  held equal to it by ``tests/test_torch_kernels.py``: the bound every
  kernel is held to.  :func:`count_primitives` gives the same six
  transcendental counts on the port's own steps
  (``tests/test_torch_census.py``).
* :func:`measure_primitive_throughput` — the sustained per-element rate of
  each op class on the card, from the primitive-chain kernel
  (``kernels/csrc/primitive_chain.cu``), timed by slope over chained
  launches.
* :func:`speed_of_light` — the serial-issue floor that combines them.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Callable, Dict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .kernels.roofline import CLASSES, primitive_chain, primitive_chain_plain
from .measure import slope_cuda
from .skin import default_device

__all__ = ["CENSUS", "TRANSCENDENTAL", "count_primitives",
           "flux_step_counts", "measure_primitive_throughput",
           "primitive_chain_plain", "speed_of_light"]

#: ATen op name -> cost class, the classes of aerobulk_tpu.roofline's
#: table of the same name; every other op counted is "cheap".  A power
#: with an integer exponent is cheap as JAX's ``integer_pow`` is
#: (:func:`_pow_class`); ``log10`` is one log, as ``jnp.log10`` is one
#: ``log`` in the jaxpr; ``reciprocal`` is JAX's ``div`` of ``1 / x``.
TRANSCENDENTAL = {
    "exp": "exp", "exp2": "exp", "expm1": "exp", "tanh": "exp",
    "erf": "exp",
    "log": "log", "log1p": "log", "log2": "log", "log10": "log",
    "pow": "pow",
    "sqrt": "sqrt", "rsqrt": "sqrt",
    "atan": "atan", "atan2": "atan", "sin": "atan", "cos": "atan",
    "div": "div", "reciprocal": "div",
}
#: ops that only make, move or reinterpret data, skipped as the jaxpr
#: census skips broadcast_in_dim, convert_element_type, copy, ...
_SKIP = {"_to_copy", "scalar_tensor", "lift_fresh", "lift_fresh_copy",
         "view", "_unsafe_view", "reshape", "expand", "expand_as",
         "clone", "detach", "alias", "copy", "copy_", "contiguous",
         "unsqueeze", "squeeze", "permute", "t", "transpose", "slice",
         "select", "cat", "stack", "unbind", "split", "as_strided",
         "full", "full_like", "zeros", "zeros_like", "ones", "ones_like",
         "empty", "empty_like", "empty_strided", "new_empty", "new_zeros",
         "new_ones", "new_full", "fill", "arange"}
#: ops that read a tensor's value on the host: a data-dependent branch
_HOST_READ = {"_local_scalar_dense", "is_nonzero", "equal"}


def _pow_class(args) -> str:
    """``pow`` with a Python integer exponent is JAX's ``integer_pow``
    (multiplies); any other exponent (a float, a tensor) is a pow."""
    exponent = args[1] if len(args) > 1 else None
    if isinstance(exponent, int) and not isinstance(exponent, bool):
        return "cheap"
    return "pow"


class _Census(TorchDispatchMode):
    """Counts every ATen op dispatched under it, by cost class
    (``counts``) and by name (``ops``, the skipped ones left out)."""

    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()
        self.ops: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__.rstrip("_")
        if name in _HOST_READ:
            raise ValueError(
                f"roofline census: a data-dependent host branch ({func}) "
                "entered the function; the exact per-point op count is no "
                "longer well-defined")
        if name not in _SKIP:
            cls = _pow_class(args) if name == "pow" else \
                TRANSCENDENTAL.get(name, "cheap")
            self.counts[cls] += 1
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))


def count_primitives(fn: Callable, *args, **kw) -> Counter:
    """Exact per-point op census of an elementwise torch function: ``fn``
    runs once on ``args`` (``(1, 1)`` CPU tensors: one op per point) under
    a dispatch mode that counts each ATen op by the class of
    :data:`TRANSCENDENTAL`.  Raises ``ValueError`` on a data-dependent host
    branch, as the jaxpr census does on ``cond``/``while``."""
    with torch.no_grad(), _Census() as census:
        fn(*args, **kw)
    return census.counts


def _c(*counts) -> Counter:
    """A census from its counts in the order of ``CLASSES`` (classes with
    no op left out, as the jaxpr census leaves them out)."""
    return Counter({k: n for k, n in zip(CLASSES, counts) if n})


#: ops per point with niter=5, by class (exp, log, pow, sqrt, div, atan,
#: cheap), of aerobulk_tpu.roofline: ``skin_<algo>`` and ``<algo>`` are
#: ``flux_step_counts(algo=<algo>, niter=5, use_skin=...)``; the ice
#: entries are ``count_primitives`` of ``api.flux_step_ice`` (the ice-only
#: step, zt=2, zu=10) and the mixed ones of ``api.flux_step_mixed`` (LG15
#: ice + ECMWF leads; the simultaneous LG15_IO solve); ``grad_skin_<algo>``
#: is ``count_primitives`` of ``jax.vjp`` of the stateful step applied to
#: its 10 cotangents (forward and transpose: the body of the Pallas
#: ``_grad_kernel``), the work of one launch of the gradient kernel
CENSUS: Dict[str, Counter] = {
    "skin_coare3p6": _c(103, 67, 62, 111, 237, 25, 3574),
    "skin_ecmwf": _c(122, 80, 45, 243, 392, 22, 5643),
    "skin_coare3p0": _c(103, 67, 62, 111, 243, 25, 3652),
    "coare3p0": _c(29, 59, 30, 45, 90, 25, 1874),
    "coare3p6": _c(29, 59, 30, 45, 84, 25, 1796),
    "ecmwf": _c(54, 69, 10, 93, 79, 22, 2150),
    "ncar": _c(15, 32, 1, 48, 107, 5, 983),
    "andreas": _c(14, 104, 24, 47, 190, 22, 2530),
    "ice_nemo": _c(8, 3, 1, 2, 23, 0, 150),
    "ice_easy": _c(30, 30, 22, 14, 101, 6, 1012),
    "ice_an05": _c(42, 53, 16, 1, 120, 5, 1287),
    "ice_lu12": _c(8, 4, 3, 3, 25, 0, 156),
    "ice_lg15": _c(9, 8, 2, 95, 216, 0, 1220),
    "ice_lg15_io": _c(9, 8, 2, 95, 216, 0, 1220),
    "ice_best": _c(29, 29, 22, 43, 162, 6, 1285),
    "mixed_ice_lg15_ecmwf": _c(63, 77, 12, 188, 295, 22, 3402),
    "mixed_lg15_io": _c(14, 13, 2, 143, 336, 0, 1994),
    "grad_skin_coare3p6": _c(103, 97, 99, 111, 874, 25, 11248),
    "grad_skin_ecmwf": _c(122, 119, 65, 243, 1331, 22, 16768),
}


def flux_step_counts(cfg=None, algo="coare3p6", niter=5,
                     use_skin=True) -> Counter:
    """Per-point op census of one full flux step of the port
    (``api.flux_step`` on ``(1, 1)`` fp32 CPU tensors, the inputs and
    ``isecday_utc`` of ``aerobulk_tpu.roofline.flux_step_counts``), at any
    setting: ``cfg``, or the config of ``algo``, ``niter`` and
    ``use_skin`` at zt=2, zu=10."""
    from .api import AeroBulkConfig, flux_step, init_skin_state

    if cfg is None:
        cfg = AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=niter,
                             use_skin=use_skin)
    z = torch.zeros((1, 1), dtype=torch.float32)
    state = init_skin_state(cfg, (1, 1), torch.float32, device="cpu")

    def fn(sst, t, q, u, v, slp, rsw, rlw, lon, st):
        kw = dict(rad_sw=rsw, rad_lw=rlw, isecday_utc=43200,
                  lon=lon) if cfg.use_skin else {}
        return flux_step(cfg, sst, t, q, u, v, slp, skin_state=st, **kw)

    return count_primitives(fn, z + 290.0, z + 289.0, z + 0.01, z + 5.0,
                            z, z + 1.01e5, z + 200.0, z + 350.0, z, state)


def _slope_host(run, x0, m1, m2, repeats):
    """The same slope on the host clock (CPU tensors)."""
    def chained(m):
        x = x0
        for _ in range(m):
            x = run(x)
        return x

    chained(m2)
    slopes = []
    for _ in range(repeats):
        t = {}
        for m in (m1, m2):
            t0 = time.perf_counter()
            chained(m)
            t[m] = time.perf_counter() - t0
        slopes.append((t[m2] - t[m1]) / (m2 - m1))
    return max(float(np.median(slopes)), 1e-12)


def measure_primitive_throughput(shape=(1024, 1024), K=64, P=2,
                                 dtype=torch.float32, m1=1, m2=9, repeats=3,
                                 device=None, ops=CLASSES) -> Dict[str, float]:
    """Sustained per-element op throughput [applications/s] per op class.

    Each class in ``ops`` runs the primitive-chain kernel over a field of
    ``shape`` filled with 0.37: ``P`` independent chains of depth ``K`` per
    element (independence exposes instruction-level parallelism; one chain
    measures latency).  The rate is ``N K P / dt``, with ``dt`` the slope
    time of one launch over ``m1`` and ``m2`` chained launches.  On the CUDA
    device unless ``device`` names another; with ``device="cpu"`` the plain
    version is timed on the host clock, as aerobulk_tpu times its jit path
    with ``use_pallas=False``."""
    device = default_device(device)
    x0 = torch.full(shape, 0.37, dtype=dtype, device=device)
    n = x0.numel()
    slope = slope_cuda if device.type == "cuda" else _slope_host
    out = {}
    for op in ops:
        def run(x, op=op):
            return primitive_chain(x, op, K, P)
        out[op] = n * K * P / slope(run, x0, m1, m2, repeats)
    return out


def speed_of_light(counts: Counter, throughput: Dict[str, float]) -> dict:
    """Serial-issue bound: points/s if every op class issued serially at
    its micro-benchmarked rate, with the per-class time breakdown.

    A lower bound on attainable throughput, not a ceiling: a kernel that
    overlaps classes (the SFU beside the FMA pipes) or pairs ops beats it.
    Use the FMA ceiling and the implied op rate as the quantitative
    roofline; the breakdown says where the issue slots go."""
    t_point = 0.0
    breakdown = {}
    for cls, n in counts.items():
        thr = throughput.get(cls)
        if thr is None or thr <= 0:
            continue
        t = n / thr
        breakdown[cls] = {"count": int(n), "seconds_frac": t}
        t_point += t
    for v in breakdown.values():
        v["seconds_frac"] = round(v["seconds_frac"] / t_point, 4) \
            if t_point else 0.0
    return {"points_per_s_bound": 1.0 / t_point if t_point else float("inf"),
            "breakdown": breakdown}
