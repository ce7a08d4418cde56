"""The primitive-throughput microbenchmark's kernel and its plain version.

:func:`primitive_chain` is the counterpart of the Pallas ``kernel`` inside
``aerobulk_tpu.roofline.measure_primitive_throughput``: for each element,
``P`` independent chains start at ``x + 0.01 p``, each takes ``K`` chained
applications of one op class, and the chains are summed.  On CUDA tensors
it launches ``csrc/primitive_chain.cu`` (the class, P and K template
parameters, the K loop fully unrolled); on CPU tensors it is
:func:`primitive_chain_plain`.  There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from ._build import load_library

#: the op classes, in the order of aerobulk_tpu.roofline._OPS (and of the
#: kernel's class index)
CLASSES = ("exp", "log", "pow", "sqrt", "div", "atan", "cheap")
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


def _check_op(op):
    if op not in _OPS:
        raise ValueError(f"primitive_chain: unknown op class {op!r}; "
                         f"expected one of {CLASSES}")


def instantiated(op: str, P: int, K: int) -> bool:
    """Whether the kernel is built for class ``op`` at ``P`` and ``K``."""
    return P in CHAINS and (K == 64 or (op == "cheap" and K in DEPTHS))


def plain_rtol(dtype, K: int, P: int) -> float:
    """The max relative difference allowed between the kernel and its plain
    version: 1e-12 in fp64; in fp32 1e-5, or one ulp (2^-23) per chained
    application and per lane summed where that is more.  The cheap class's
    map is x * 1.000001 + 1e-6, one FMA in the kernel and two roundings in
    PyTorch, and it does not contract, so the difference of each
    application carries to the end of the chain."""
    if dtype == torch.float64:
        return 1e-12
    return max(1e-5, (K + P) * 2.0 ** -23)


def primitive_chain_plain(x, op: str, K: int, P: int):
    """The plain PyTorch version of the kernel: ``P`` lanes ``x + 0.01 k``,
    ``K`` applications of ``op`` to each, summed."""
    _check_op(op)
    f = _OPS[op]
    lanes = [x + 0.01 * k for k in range(P)]
    for _ in range(K):
        lanes = [f(v) for v in lanes]
    acc = lanes[0]
    for v in lanes[1:]:
        acc = acc + v
    return acc


def primitive_chain(x, op: str, K: int = 64, P: int = 2):
    """``P`` chains of ``K`` applications of ``op`` per element of ``x``,
    summed: one launch of ``csrc/primitive_chain.cu`` on a contiguous CUDA
    tensor (fp32 or fp64, any shape; ``P`` in :data:`CHAINS`, ``K`` = 64,
    or ``K`` in :data:`DEPTHS` for the cheap class),
    :func:`primitive_chain_plain` on a CPU tensor."""
    global LAUNCHES
    _check_op(op)
    if x.device.type == "cpu":
        return primitive_chain_plain(x, op, K, P)
    if x.device.type != "cuda":
        raise ValueError(f"primitive_chain: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"primitive_chain: dtype {x.dtype} is not float32 "
                        "or float64")
    if not instantiated(op, P, K):
        raise ValueError(f"primitive_chain: the kernel is built for P in "
                         f"{CHAINS} and K = 64 (K in {DEPTHS} for the cheap "
                         f"class), not {op} at P={P}, K={K}")
    if not x.is_contiguous():
        raise ValueError("primitive_chain: x is not contiguous")
    lib = load_library("primitive_chain.cu")
    fn = (lib.abt_primitive_chain_f32 if x.dtype == torch.float32
          else lib.abt_primitive_chain_f64)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), CLASSES.index(op),
                 P, K, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out
