"""Carry a run's "weights" across from ``aerobulk_tpu``: the static config
and the warm-layer state.

Nothing here imports jax.  A JAX ``AeroBulkConfig`` is read by its
attributes, and a JAX ``SkinState`` crosses as numpy arrays (``np.asarray``
of each field), so both packages can start from the same state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .api import AeroBulkConfig
from .skin import SkinState, default_device

__all__ = ["config_from_reference", "skin_state_from_numpy",
           "skin_state_to_numpy"]


def config_from_reference(cfg) -> AeroBulkConfig:
    """The port's :class:`AeroBulkConfig` with the settings of ``cfg``, any
    object with the attributes of ``aerobulk_tpu.api.AeroBulkConfig``; a
    setting that ``cfg`` lacks (``ice_algo``) keeps the port's default."""
    return AeroBulkConfig(**{f.name: getattr(cfg, f.name, f.default)
                             for f in dataclasses.fields(AeroBulkConfig)})


def skin_state_from_numpy(state, device=None, dtype=torch.float64) -> SkinState:
    """A :class:`SkinState` of tensors on ``device``/``dtype`` from any
    object with the four state fields as arrays (a JAX ``SkinState``, or
    one of numpy arrays as :func:`skin_state_to_numpy` returns).  The
    device is the CUDA device unless the caller names another (pass
    ``device="cpu"`` for the CPU); without a GPU that raises."""
    device = default_device(device)
    return SkinState(*(torch.tensor(np.asarray(getattr(state, f)),
                                    dtype=dtype, device=device)
                       for f in SkinState._fields))


def skin_state_to_numpy(state: SkinState) -> SkinState:
    """The same state with each field a numpy array on the host."""
    return SkinState(*(f.detach().cpu().numpy() for f in state))
