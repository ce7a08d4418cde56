"""The two transcendental forms the algorithm library routes through one
place.

``aerobulk_tpu.math_compat`` also carries polynomial stand-ins for a TPU
compiler that lacks ``atan`` and ``cbrt``; those are limits of that
compiler, not semantics, so only the exact forms are ported.
"""

from __future__ import annotations

import torch


def arctan(x):
    """Elementwise arctangent."""
    return torch.atan(x)


def inv_cbrt_1p(s):
    """``(1 + s)**(-1/3)`` for ``s >= 0``, as ``1 / cbrt(1 + s)``: a cube
    root and a division, the form of the reference and of the kernels
    (``csrc/flux_point.cuh``), so the op census counts both.  A division
    of ones, not ``torch.reciprocal``: its backward rounds as the
    reference's division does, which the fp32 cool-skin gradient at the
    u* floor needs (``tests/test_torch_grad.py``).

    PyTorch has no ``cbrt``; the power form is defined because
    ``1 + s >= 1`` and agrees with ``cbrt(1 + s)`` to a few ulp."""
    root = torch.pow(1.0 + s, 1.0 / 3.0)
    return torch.ones_like(root) / root
