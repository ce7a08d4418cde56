"""Cool-skin / warm-layer schemes (COARE and ECMWF) as functions over an
explicit state.

The reference keeps the warm-layer memory in module arrays
(``mod_skin_coare.f90:31-36``); here it is the :class:`SkinState` tuple of
tensors that the caller carries from one record to the next.  The early
exits of ``WL_COARE`` are masks, so every point runs the same arithmetic.

The state constructors (and :func:`load_skin_state`) build on the CUDA
device unless the caller names another device (``device="cpu"``); without a
GPU they raise instead.  :func:`save_skin_state` and :func:`load_skin_state`
checkpoint the state to .npz with the reference's keys, so a file written by
either package loads in the other.  :func:`save_skin_state_sharded` and
:func:`load_skin_state_sharded` checkpoint a state sharded over ranks
(DTensor fields) with ``torch.distributed.checkpoint``: each rank writes and
reads only its own blocks.  Those files are DCP's format, not the
reference's Orbax directories; the .npz stays the format both packages
share.

Functions cite the reference as ``mod_skin_coare.f90:LINE`` or
``mod_skin_ecmwf.f90:LINE``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import constants as c
from .thermo import (absj, alpha_sw, delta_skin_layer_from_coefs, fsign,
                     maxc, minc, skin_layer_coefs, step)

__all__ = [
    "SkinState", "default_device", "init_skin_state_coare",
    "init_skin_state_ecmwf", "local_solar_seconds", "cs_coare", "cs_ecmwf",
    "wl_coare", "wl_ecmwf", "HWL_MAX", "RD0_ECMWF", "save_skin_state",
    "load_skin_state", "save_skin_state_sharded", "load_skin_state_sharded",
]

HWL_MAX = 20.0     # max warm-layer depth [m]          (mod_skin_coare.f90:38)
RICH0 = 0.65       # critical Richardson number        (mod_skin_coare.f90:40)
RD0_ECMWF = 3.0    # fixed ECMWF warm-layer depth [m]  (mod_skin_ecmwf.f90:57)
_RNUWL0 = 0.5      # temp-profile exponent Nu          (mod_skin_ecmwf.f90:60)


class SkinState(NamedTuple):
    """Warm-layer memory, one value per grid point.  COARE uses all four
    fields; ECMWF uses only ``dT_wl`` (and a constant ``Hz_wl``)."""
    dT_wl: torch.Tensor    # warm-layer temperature increment [K]
    Hz_wl: torch.Tensor    # warm-layer depth [m]
    Qnt_ac: torch.Tensor   # accumulated heat [J/m^2]   (COARE only)
    Tau_ac: torch.Tensor   # accumulated momentum [N.s/m^2] (COARE only)


def default_device(device=None) -> torch.device:
    """The device a constructor builds on: ``device`` when the caller names
    one, else the current CUDA device.  Without a GPU and without
    ``device``, raises rather than building on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "aerobulk_tpu_torch builds on the CUDA device unless told "
            "otherwise, and no CUDA device is available: pass device='cpu' "
            "to build on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _init_skin_state(shape, depth, dtype, device):
    device = default_device(device)
    z = torch.zeros(shape, dtype=dtype, device=device)
    return SkinState(dT_wl=z, Hz_wl=torch.full(shape, depth, dtype=dtype,
                                               device=device),
                     Qnt_ac=z, Tau_ac=z)


def init_skin_state_coare(shape, dtype=torch.float64, device=None):
    """COARE warm-layer init (mod_blk_coare3p6.f90:80-88), on ``device``
    (default: the CUDA device, see :func:`default_device`)."""
    return _init_skin_state(shape, HWL_MAX, dtype, device)


def init_skin_state_ecmwf(shape, dtype=torch.float64, device=None):
    """ECMWF warm-layer init: fixed depth rd0=3 m (mod_blk_ecmwf.f90:399-405),
    on ``device`` (default: the CUDA device, see :func:`default_device`)."""
    return _init_skin_state(shape, RD0_ECMWF, dtype, device)


def save_skin_state(path: str, state: SkinState):
    """Checkpoint the warm-layer state to disk (.npz, one array per field,
    keyed by the field's name as ``aerobulk_tpu.skin.save_skin_state``
    writes it).  The reference has no checkpointing at all: a restart
    loses the warm layer."""
    np.savez(path, **{k: torch.as_tensor(v).detach().cpu().numpy()
                      for k, v in state._asdict().items()})


def load_skin_state(path: str, dtype=None, device=None) -> SkinState:
    """Restore a warm-layer state checkpoint written by
    :func:`save_skin_state` (or by the reference's), on ``device`` (default:
    the CUDA device, see :func:`default_device`), in ``dtype`` (default:
    the file's)."""
    device = default_device(device)
    with np.load(path) as z:
        return SkinState(**{k: torch.as_tensor(z[k], dtype=dtype,
                                               device=device)
                            for k in SkinState._fields})


def save_skin_state_sharded(path: str, state: SkinState):
    """Checkpoint a warm-layer state sharded over ranks (DTensor fields,
    e.g. ``sharding.sharded_run_series``'s) into the directory ``path``
    with ``torch.distributed.checkpoint``: every rank calls it, each
    writes only its own blocks, and no rank gathers the global grid.  An
    existing checkpoint at ``path`` is overwritten, as
    :func:`save_skin_state` overwrites its file, so periodic checkpoints to
    one resume path work.  Returns when the files are written."""
    import os

    import torch.distributed.checkpoint as dcp
    dcp.save(state._asdict(),
             storage_writer=dcp.FileSystemWriter(os.path.abspath(path),
                                                 overwrite=True))


def load_skin_state_sharded(path: str, like: SkinState) -> SkinState:
    """Restore a checkpoint written by :func:`save_skin_state_sharded`,
    each field with the mesh, placements, dtype and shape of the matching
    field of ``like`` (e.g. ``init_skin_state`` laid out by
    ``sharding.shard_grid_inputs``); each rank reads only its own blocks,
    and ``like``'s mesh may have another shape than the saving one's.

    Every field of ``like`` must be a DTensor: a plain tensor has no
    placement to restore onto."""
    import os

    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor

    for name, x in like._asdict().items():
        if not isinstance(x, DTensor):
            raise TypeError(
                f"load_skin_state_sharded: like.{name} is a "
                f"{type(x).__name__}, not a DTensor; pass DTensors (e.g. "
                "init_skin_state laid out by sharding.shard_grid_inputs) "
                "so each field restores with a known placement, or use "
                "load_skin_state for single-file .npz checkpoints")
    restored = {k: torch.empty_like(x) for k, x in like._asdict().items()}
    dcp.load(restored,
             storage_reader=dcp.FileSystemReader(os.path.abspath(path)))
    return SkinState(**restored)


# ---------------------------------------------------------------------------
# cool skin
# ---------------------------------------------------------------------------

def _cs_generic(Qsw, Qnsol, ustar, sst, fr0, Qlat=None):
    """Shared cool-skin solve: 4 implicit iterations on the viscous-layer
    thickness delta (mod_skin_coare.f90:48-93), with the Qd-independent
    coefficients hoisted out of the loop.  COARE uses fr0=0.137 and feeds
    Qlat into the Saunders term; ECMWF uses fr0=0.065 and no Qlat term."""
    alpha = alpha_sw(sst)
    coefs = skin_layer_coefs(alpha, ustar, Qlat)
    Qabs = Qnsol
    delta = delta_skin_layer_from_coefs(coefs, Qabs)
    for _ in range(4):
        fr = maxc(
            fr0 + 11.0 * delta
            - 6.6e-5 / delta * (1.0 - torch.exp(delta * (-1.0 / 8.0e-4))),
            0.01)
        Qabs = Qnsol + fr * Qsw
        delta = delta_skin_layer_from_coefs(coefs, Qabs)
    return Qabs * delta * (1.0 / c.rk0_w)


def cs_coare(Qsw, Qnsol, ustar, sst, Qlat):
    """COARE cool-skin dT (Fairall et al. 1996/2019) (mod_skin_coare.f90:48-93)."""
    return _cs_generic(Qsw, Qnsol, ustar, sst, 0.137, Qlat)


def cs_ecmwf(Qsw, Qnsol, ustar, sst):
    """ECMWF cool-skin dT (Zeng & Beljaars 2005) (mod_skin_ecmwf.f90:68-110)."""
    return _cs_generic(Qsw, Qnsol, ustar, sst, 0.065)


# ---------------------------------------------------------------------------
# warm layer — COARE 3.6 (Fairall et al. 2019)
# ---------------------------------------------------------------------------

def _wl_coare_absorption(Hwl):
    """Fraction of solar flux absorbed in a warm layer of depth ``Hwl``
    (mod_skin_coare.f90:167-168)."""
    return 1.0 - (0.28 * 0.014 * (1.0 - torch.exp(Hwl * (-1.0 / 0.014)))
                  + 0.27 * 0.357 * (1.0 - torch.exp(Hwl * (-1.0 / 0.357)))
                  + 0.45 * 12.82 * (1.0 - torch.exp(Hwl * (-1.0 / 12.82)))) \
        / Hwl


def local_solar_seconds(lon, isecday_utc):
    """Local solar time [s since local solar midnight] from longitude and
    UTC seconds-of-day (mod_skin_coare.f90:146-150).  ``torch.remainder``
    is the floor-mod of the reference's ``MODULO``."""
    rlag = -torch.remainder((360.0 - torch.remainder(lon, 360.0)) / 15.0, 24.0)
    rlag = -fsign(torch.minimum(torch.abs(rlag),
                                torch.abs(torch.remainder(rlag, 24.0))),
                  rlag + 12.0)
    ilag_s = torch.trunc(rlag * 3600.0)          # Fortran INT(): toward zero
    return torch.remainder(isecday_utc + ilag_s, 24.0 * 3600.0)


def wl_coare(Qsw, Qnsol, Tau, sst, lon, isecday_utc, state: SkinState,
             rdt=3600.0, gdept=1.0) -> SkinState:
    """COARE 3.6 warm layer (mod_skin_coare.f90:97-250), branch-free.

    Returns the *committed* new state; the caller decides on which bulk
    iteration to commit (the reference's ``iwait`` flag,
    mod_blk_coare3p6.f90:370)."""
    dTwl0 = state.dT_wl
    Hwl0 = maxc(minc(state.Hz_wl, HWL_MAX), 0.1)
    qac0 = state.Qnt_ac
    tac0 = state.Tau_ac

    rhr_sol = local_solar_seconds(lon, isecday_utc) / 3600.0

    alpha = alpha_sw(sst)
    cd1 = torch.sqrt(2.0 * RICH0 * c.rCp0_w / (alpha * c.grav * c.rho0_w))
    cd2 = (torch.sqrt(2.0 * alpha * c.grav / (RICH0 * c.rho0_w))
           / c.rCp0_w ** 1.5)

    # --- early-exit cascade as masks (mod_skin_coare.f90:159-185) ---------
    dawn = (rhr_sol > 4.0) & (rhr_sol <= 6.5)          # daily reset window
    destroy = dawn

    fr = _wl_coare_absorption(Hwl0)
    Qabs = fr * Qsw + Qnsol
    no_wl_yet = (~dawn) & (torch.abs(dTwl0) < 1.0e-6) & (Qabs <= 0.0)
    exited = dawn | no_wl_yet

    qac_first = qac0 + Qabs * rdt
    drained = (~exited) & (qac_first <= 0.0)
    destroy = destroy | drained
    active = ~(exited | drained)

    # --- main branch (mod_skin_coare.f90:188-227) -------------------------
    tac = tac0 + maxc(Tau, 0.002) * rdt
    qac = qac0
    Hwl = Hwl0
    live = active
    for k in range(5):   # implicit depth solve with masked early-exit
        if k == 0:
            qac_i = qac_first   # the absorption at Hwl0, computed above
        else:
            fr_i = _wl_coare_absorption(Hwl)
            qac_i = qac0 + (fr_i * Qsw + Qnsol) * rdt
        qac = torch.where(live, qac_i, qac)
        cont = qac_i > 0.0
        Hwl_i = maxc(minc(cd1 * tac / torch.sqrt(maxc(qac_i, 1.0e-30)),
                          HWL_MAX), 0.1)
        Hwl = torch.where(live & cont, Hwl_i, Hwl)
        live = live & cont

    ran_dry = active & (qac <= 0.0)
    destroy = destroy | ran_dry
    built = active & (qac > 0.0)

    qac_pos = maxc(qac, 1.0e-30)
    dTwl_new = cd2 * (qac_pos * torch.sqrt(qac_pos)) / tac   # qac**1.5
    flg = step(gdept - Hwl)          # depth correction to the bulk-SST depth
    dTwl_new = dTwl_new * (flg + (1.0 - flg) * gdept / Hwl)

    # --- merge the three outcomes ----------------------------------------
    dT_out = torch.where(destroy, 0.0, torch.where(built, dTwl_new, dTwl0))
    Hz_out = torch.where(destroy, HWL_MAX, torch.where(built, Hwl, Hwl0))
    qac_out = torch.where(destroy, 0.0, torch.where(built, qac, qac0))
    tac_out = torch.where(destroy, 0.0, torch.where(built, tac, tac0))

    return SkinState(dT_wl=dT_out, Hz_wl=Hz_out, Qnt_ac=qac_out,
                     Tau_ac=tac_out)


# ---------------------------------------------------------------------------
# warm layer — ECMWF (Zeng & Beljaars 2005 + Takaya et al. 2010)
# ---------------------------------------------------------------------------

def _phi_takaya(zeta):
    """Stability function, Takaya et al. 2010 Eq. 5 (mod_skin_ecmwf.f90:233-253)."""
    zt2 = zeta * zeta
    tf = step(zeta)
    return (tf * (1.0 + (5.0 * zeta + 4.0 * zt2)
                  / (1.0 + 3.0 * zeta + 0.25 * zt2))
            + (1.0 - tf) / torch.sqrt(1.0 - 16.0 * (-absj(zeta))))


def wl_ecmwf(Qsw, Qnsol, ustar, sst, state: SkinState,
             rdt=3600.0, gdept=1.0, ustk=None) -> SkinState:
    """ECMWF prognostic warm layer, 10-iteration semi-implicit solve
    (mod_skin_ecmwf.f90:113-230).  Commits every call (no ``iwait``)."""
    Hwl = state.Hz_wl      # constant rd0 = 3 m in this scheme

    flg = step(gdept - Hwl)
    tcorr = flg + (1.0 - flg) * gdept / Hwl
    dTwl_b = maxc(state.dT_wl / tcorr, 0.0)

    alpha = alpha_sw(sst)
    fr = (1.0 - 0.28 * torch.exp(-71.5 * Hwl) - 0.27 * torch.exp(-2.8 * Hwl)
          - 0.45 * torch.exp(-0.07 * Hwl))            # IFS Eq. 8.157
    Qabs = fr * Qsw + Qnsol

    usw = maxc(ustar, 1.0e-4) * c.sq_radrw
    usw2 = usw * usw

    if ustk is not None:
        fLa = maxc(torch.sqrt(usw / maxc(ustk, 1.0e-6)) ** (-2.0 / 3.0), 1.0)
    else:
        fLa = max(0.3 ** (-2.0 / 3.0), 1.0)           # Langmuir factor, Eq. 6

    wf = step(Qabs)
    rhocp_w = c.rho0_w * c.rCp0_w
    cst1 = c.vkarmn * c.grav * alpha
    L2 = cst1 * Qabs / (rhocp_w * usw2 * usw)        # 1/L when Qabs > 0
    cst2 = cst1 / (5.0 * Hwl * usw2)
    cst0 = rdt * (_RNUWL0 + 1.0) / Hwl
    zA = cst0 * Qabs / (_RNUWL0 * rhocp_w)
    cst3 = -cst0 * c.vkarmn * usw * fLa

    dTwl_n = dTwl_b
    for _ in range(10):
        dTwl_n = 0.5 * (dTwl_n + dTwl_b)             # semi-implicit
        # 1/L when dTwl > 0 and Qabs < 0; the inner where keeps sqrt's
        # infinite slope at 0 out of the backward pass
        pos = dTwl_n * cst2 > 0.0
        L1 = torch.where(pos,
                         torch.sqrt(torch.where(pos, dTwl_n * cst2, 1.0)), 0.0)
        zeta = (1.0 - wf) * Hwl * L1 + wf * Hwl * L2
        zB = cst3 / _phi_takaya(zeta)
        dTwl_n = maxc(dTwl_b + zA + zB * dTwl_n, 0.0)

    return state._replace(dT_wl=dTwl_n * tcorr)
