"""aerobulk_tpu_torch.algos.coare.turb_coare against aerobulk_tpu's, every
FluxResult field and the committed state, fp64 on the CPU.

The cases cover both versions, the cool skin and warm layer on and off,
zt == zu and zt != zu, and niter in {1, 4, 5}: the warm layer commits on
every iteration that divides niter, so 4 commits at jit = 1, 2, 4 and 5 at
jit = 1, 5.

Tolerance: rtol 1e-12 (docs/PARITY.md §1), with three stated exceptions:
  * dT_cs changes sign, and the warm-layer increment and heat content pass
    through 0 where the accumulated heat cancels: these also get
    atol = 1e-12 * max|ref|;
  * L = 1/one_on_L is infinite at neutral stability: it is compared as
    1/L, with the same atol, since one_on_L crosses zero;
  * Ce gets rtol 2e-11: aerobulk_tpu's own eager and jit evaluations of
    turb_coare differ by up to 4.2e-12 in Ce on these inputs (single
    points where the fixed-point iteration amplifies ulp-level
    differences of the transcendentals), so 1e-12 is below the
    reference's own reproducibility there.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu import skin as jsk
from aerobulk_tpu.algos.coare import turb_coare as j_turb
from aerobulk_tpu_torch.algos import OCEAN_ALGOS
from aerobulk_tpu_torch.algos.coare import turb_coare as t_turb
from aerobulk_tpu_torch.convert import skin_state_from_numpy

N = 256
SKIN = [(False, False), (True, False), (False, True), (True, True)]
HEIGHTS_NITER = [(2.0, 1), (10.0, 1), (2.0, 4), (10.0, 4), (2.0, 5),
                 (10.0, 5)]
_NEAR_ZERO = ("dT_cs", "L", "dT_wl", "Qnt_ac")
_RTOL = {"Ce": 2e-11}
CASES = list(itertools.product(["coare3p0", "coare3p6"], SKIN,
                               HEIGHTS_NITER))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    sst = 271.0 + 32.0 * rng.random(N)
    q_s = 0.98 * (0.004 + 0.02 * rng.random(N))
    # air-sea differences of either sign but kept off zero: Ch and Ce are
    # ratios of them (r*ts/dt, r*qs/dq), ill-conditioned where they vanish
    dt = rng.choice([-1.0, 1.0], N) * (1.5 + 3.0 * rng.random(N))
    fields = dict(
        T_s=sst, t_zt=sst + dt, q_s=q_s,
        q_zt=q_s * (0.4 + 0.45 * rng.random(N)),
        U_zu=0.3 + 22.0 * rng.random(N),
        Qsw=900.0 * rng.random(N), rad_lw=250.0 + 180.0 * rng.random(N),
        slp=97000.0 + 7000.0 * rng.random(N), lon=360.0 * rng.random(N))
    state = jsk.SkinState(dT_wl=jnp.asarray(1.5 * rng.random(N)),
                          Hz_wl=jnp.asarray(0.5 + 19.0 * rng.random(N)),
                          Qnt_ac=jnp.asarray(rng.normal(3e5, 3e5, N)),
                          Tau_ac=jnp.asarray(800.0 * rng.random(N)))
    return fields, state


@pytest.mark.parametrize("version,skin,zt_niter", CASES)
def test_turb_coare_matches_jax(version, skin, zt_niter):
    use_cs, use_wl = skin
    zt, niter = zt_niter
    f, state = _inputs(CASES.index((version, skin, zt_niter)))
    kw = dict(niter=niter, use_cs=use_cs, use_wl=use_wl, isecday_utc=21600,
              rdt=3600.0, gdept=1.0)
    names = ("T_s", "t_zt", "q_s", "q_zt", "U_zu")
    opt = ("Qsw", "rad_lw", "slp", "lon")
    ref, ref_state = j_turb(version, zt, 10.0,
                            *(jnp.asarray(f[n]) for n in names),
                            **{n: jnp.asarray(f[n]) for n in opt},
                            skin_state=state, **kw)
    got, got_state = t_turb(version, zt, 10.0,
                            *(torch.as_tensor(f[n]) for n in names),
                            **{n: torch.as_tensor(f[n]) for n in opt},
                            skin_state=skin_state_from_numpy(state, device="cpu"),
                            **kw)
    assert got._fields == ref._fields
    for name, g, r in zip(got._fields + got_state._fields,
                          got + got_state, ref + ref_state):
        g, r = g.numpy(), np.asarray(r)
        if name == "L":
            g, r = 1.0 / g, 1.0 / r
        atol = 1e-12 * np.max(np.abs(r)) if name in _NEAR_ZERO else 0.0
        np.testing.assert_allclose(g, r, rtol=_RTOL.get(name, 1e-12),
                                   atol=atol, err_msg=name)


def test_turb_coare_wave_and_charn_fn_match_jax():
    """``wave_hs`` with ``wave_cp``, and ``charn_fn``, run and match the
    JAX solve (tests/test_torch_wave_charnock.py holds them at rtol
    1e-12)."""
    x = torch.full((3,), 290.0, dtype=torch.float64)
    q, u = torch.full_like(x, 0.01), torch.full_like(x, 8.0)
    for kw in (dict(wave_hs=torch.full_like(x, 2.0),
                    wave_cp=torch.full_like(x, 9.0)),
               dict(charn_fn=lambda w: 0.0015 * w)):
        res, _ = t_turb("coare3p6", 2.0, 10.0, x + 1.0, x, q, 0.8 * q, u,
                        **kw)
        ref, _ = j_turb("coare3p6", 2.0, 10.0, *(jnp.asarray(a.numpy())
                                                 for a in (x + 1.0, x, q,
                                                           0.8 * q, u)),
                        **{k: (v if callable(v) else jnp.asarray(v.numpy()))
                           for k, v in kw.items()})
        np.testing.assert_allclose(res.Cd.numpy(), np.asarray(ref.Cd),
                                   rtol=1e-12)


@pytest.mark.parametrize("algo", ["ecmwf", "ncar", "andreas"])
def test_unported_algorithms_raise(algo):
    """The eager algorithms are ported and run.  The stateful fused step
    takes ECMWF with its skin (BASELINE config 4; on CPU tensors its plain
    version); NCAR and Andreas have no skin scheme, so it raises and names
    the stateless kernel rather than falling back to COARE."""
    from aerobulk_tpu_torch.api import AeroBulkConfig
    from aerobulk_tpu_torch.kernels import fused_flux_step
    x = torch.full((3,), 290.0, dtype=torch.float64)
    q, u = torch.full_like(x, 0.01), torch.full_like(x, 5.0)
    res = OCEAN_ALGOS[algo][0](2.0, 10.0, x + 1.0, x, q, 0.8 * q, u)
    if algo == "ecmwf":         # turb_ecmwf also returns its state
        res = res[0]
    assert torch.isfinite(res.Cd).all()
    skin = OCEAN_ALGOS[algo][1]
    cfg = AeroBulkConfig(algo=algo, use_skin=skin)
    args = (cfg, x, x, q, u, u, 1e5 + x, x, x)
    if skin:
        outs, state = fused_flux_step(*args, lon=x)
        assert all(bool(torch.isfinite(o).all()) for o in outs + state)
        return
    with pytest.raises(NotImplementedError, match="fused_bulk_step"):
        fused_flux_step(*args)
