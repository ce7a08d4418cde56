"""The primitive-throughput microbenchmark's kernel and its plain version.

:func:`primitive_chain` is the counterpart of the Pallas ``kernel`` inside
``aerobulk_tpu.roofline.measure_primitive_throughput``: for each element,
``P`` independent chains start at ``x + 0.01 p``, each takes ``K`` chained
applications of one op class, and the chains are summed.  On CUDA tensors
it launches ``csrc/primitive_chain.cu`` for the seven classes of
``aerobulk_tpu.roofline`` (:data:`CLASSES`, IEEE forms) and
``csrc/primitive_chain_forward.cu`` for :data:`FORMS`, the forms of pow,
div and sqrt that kernels 1-5 run, built with their flags (the
class, P and K template parameters, the K loop fully unrolled); on CPU
tensors it is :func:`primitive_chain_plain`.  There is no fallback from one
to the other.
"""

from __future__ import annotations

import torch

from . import _build

#: the op classes, in the order of aerobulk_tpu.roofline._OPS (and of the
#: kernel's class index)
CLASSES = ("exp", "log", "pow", "sqrt", "div", "atan", "cheap")
#: the forms kernels 1-5 compute pow, div and sqrt in (kernel index 7,
#: 8, 9): every power as common.cuh's pow_pos, exp2(c log2 x), in
#: fp32 and fp64; fp32 division and square root under -prec-div=false and
#: -prec-sqrt=false (div.full.f32, sqrt.approx.f32), fp32 only: fp64
#: division and square root are exact under any flag
FORMS = ("pow_pos", "div_approx", "sqrt_approx")
#: the census class each form prices
FORM_CLASS = {"pow_pos": "pow", "div_approx": "div", "sqrt_approx": "sqrt"}
#: the ulps per application the fp32 forms may stand from their plain
#: version: pow_pos's |c log2 y| + 2 (under 3 at y in [1.1, 2.3]) and one
#: of PyTorch's exp2(c log2 y); div.full.f32's 2 and one of PyTorch's
#: 1.7 / y, a reciprocal then a product; sqrt.approx.f32's and PyTorch's
#: correctly rounded sqrt, one each
FORM_ULPS = {"pow_pos": 4, "div_approx": 3, "sqrt_approx": 2}
#: the (P, K) the kernel is instantiated for: every P at K = 64 for every
#: class, and the deeper chains for the cheap class only (the FMA ceiling)
CHAINS = (1, 2, 4, 8)
DEPTHS = (64, 128, 256)

#: number of launches of the primitive-chain kernel in this process
LAUNCHES = 0

#: each class's op, as aerobulk_tpu.roofline._OPS writes it; atan is the
#: exact arctangent (aerobulk_tpu's math_compat.arctan outside a Pallas
#: kernel).  Python-float constants round to the tensor's dtype.
_OPS = {
    "exp": lambda x: torch.exp(-torch.abs(x) * 0.5) + 0.1,
    "log": lambda x: torch.log(torch.abs(x) + 1.1),
    "pow": lambda x: (torch.abs(x) + 1.1) ** 0.72,
    "sqrt": lambda x: torch.sqrt(torch.abs(x) + 1.1),
    "div": lambda x: 1.7 / (torch.abs(x) + 1.2),
    "atan": lambda x: torch.atan(x * 0.9 + 0.05),
    "cheap": lambda x: x * 1.000001 + 1e-6,
}
#: each form's op: the same function as its class, pow_pos written as the
#: kernels write it
_FORM_OPS = {
    "pow_pos": lambda x: torch.exp2(0.72 * torch.log2(torch.abs(x) + 1.1)),
    "div_approx": _OPS["div"],
    "sqrt_approx": _OPS["sqrt"],
}


def _check_op(op):
    if op not in _OPS and op not in _FORM_OPS:
        raise ValueError(f"primitive_chain: unknown op class {op!r}; "
                         f"expected one of {CLASSES + FORMS}")


def instantiated(op: str, P: int, K: int, dtype=torch.float32) -> bool:
    """Whether the kernel is built for class or form ``op`` at ``P``, ``K``
    and ``dtype``."""
    if op in ("div_approx", "sqrt_approx") and dtype != torch.float32:
        return False
    return P in CHAINS and (K == 64 or (op == "cheap" and K in DEPTHS))


def plain_rtol(dtype, K: int, P: int, op: str = "cheap") -> float:
    """The max relative difference allowed between the kernel and its plain
    version: 1e-12 in fp64; in fp32 for a class 1e-5, or one ulp (2^-23)
    per chained application and per lane summed where that is more (the
    cheap class's map is x * 1.000001 + 1e-6, one FMA in the kernel and two
    roundings in PyTorch, and it does not contract, so the difference of
    each application carries to the end of the chain); for a form its
    FORM_ULPS per application and per lane summed."""
    if dtype == torch.float64:
        return 1e-12
    if op in FORM_ULPS:
        return FORM_ULPS[op] * (K + P) * 2.0 ** -23
    return max(1e-5, (K + P) * 2.0 ** -23)


def primitive_chain_plain(x, op: str, K: int, P: int):
    """The plain PyTorch version of the kernel: ``P`` lanes ``x + 0.01 k``,
    ``K`` applications of ``op`` to each, summed."""
    _check_op(op)
    f = _OPS.get(op) or _FORM_OPS[op]
    lanes = [x + 0.01 * k for k in range(P)]
    for _ in range(K):
        lanes = [f(v) for v in lanes]
    acc = lanes[0]
    for v in lanes[1:]:
        acc = acc + v
    return acc


def primitive_chain(x, op: str, K: int = 64, P: int = 2):
    """``P`` chains of ``K`` applications of ``op`` per element of ``x``,
    summed: one launch of ``csrc/primitive_chain.cu`` (a class) or
    ``csrc/primitive_chain_forward.cu`` (a form) on a contiguous CUDA
    tensor (fp32 or fp64, any shape, fp32 only for div_approx and
    sqrt_approx; ``P`` in :data:`CHAINS`, ``K`` = 64, or ``K`` in
    :data:`DEPTHS` for the cheap class), :func:`primitive_chain_plain` on a
    CPU tensor."""
    global LAUNCHES
    _check_op(op)
    if x.device.type == "cpu":
        return primitive_chain_plain(x, op, K, P)
    if x.device.type != "cuda":
        raise ValueError(f"primitive_chain: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"primitive_chain: dtype {x.dtype} is not float32 "
                        "or float64")
    if not instantiated(op, P, K, x.dtype):
        raise ValueError(f"primitive_chain: the kernel is built for P in "
                         f"{CHAINS} and K = 64 (K in {DEPTHS} for the cheap "
                         f"class; fp32 only for div_approx and sqrt_approx), "
                         f"not {op} at P={P}, K={K}, {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("primitive_chain: x is not contiguous")
    fn = _build.entry("primitive_chain.cu" if op in CLASSES
                      else "primitive_chain_forward.cu", x.dtype)
    out = torch.empty_like(x)
    _build.call(fn, x.device, x.data_ptr(), out.data_ptr(), x.numel(),
                (CLASSES + FORMS).index(op), P, K)
    LAUNCHES += 1
    return out
