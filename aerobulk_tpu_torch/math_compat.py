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
    """``(1 + s)**(-1/3)`` for ``s >= 0``.

    PyTorch has no ``cbrt``; the power form is defined because
    ``1 + s >= 1`` and agrees with ``1 / cbrt(1 + s)`` to a few ulp."""
    return torch.pow(1.0 + s, -1.0 / 3.0)
