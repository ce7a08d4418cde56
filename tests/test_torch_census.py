"""The port's op census (aerobulk_tpu_torch.roofline.count_primitives and
flux_step_counts) against the JAX graph's (aerobulk_tpu.roofline), and the
constant cache of the port's thermo under tracing (F7).

The port counts the ATen ops a step dispatches on (1, 1) CPU tensors; JAX
counts the equations of its jaxpr.  The six transcendental classes agree
exactly for every forward entry of roofline.CENSUS (the niter=5 census the
kernels are held to, itself held to the JAX graph by
tests/test_torch_kernels.py) and at niter=20, except where the JAX graph
counts an op that is no per-point work of the port (CONSTANT_GAPS, each
cause traced below on the two packages' helpers):

  * JAX stages an op on a Python float: ``jnp.log(zu / 10.0)`` in
    thermo.un10_from_ustar (Andreas calls it 6 times: 5 iterations and the
    final UN10) and ``jnp.sqrt(cdn_form_ice)`` with the division by it in
    ice/best.cx_lupkes2015 (6 calls: the first guess and 5 iterations); the
    port computes these constants on the host (``math.log``,
    ``math.sqrt``);
  * ``jnp.searchsorted`` in thermo.z0tq_lkb is a binary search whose 4
    halvings of the interval count as ``div`` (12 calls in Andreas: 2 per
    iteration and 2 for the neutral coefficients); the port's
    ``torch.bucketize`` is one op.

The cheap class differs by how each package writes its ops.  jnp.copysign
is five primitives (abs twice, the sign bit's shift, neg, select_n) where
torch.copysign is one op, and the searchsorted above is some 70 cheap
primitives a call against the port's few: the raw gap is stated per key
(CHEAP_GAP, under 10% of JAX's count except where these two name it) and,
with those two lowerings taken out, every key is within 10%.
"""

import functools
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from aerobulk_tpu import roofline as jr
from aerobulk_tpu import thermo as jthermo
from aerobulk_tpu.api import AeroBulkConfig as JaxConfig
from aerobulk_tpu.ice import best as jbest
from aerobulk_tpu_torch import api as tapi
from aerobulk_tpu_torch import roofline as tr
from aerobulk_tpu_torch import thermo as tthermo
from aerobulk_tpu_torch.ice import best as tbest

TRANS = ("exp", "log", "pow", "sqrt", "div", "atan")
FORWARD_KEYS = sorted(k for k in tr.CENSUS if not k.startswith("grad_"))

#: transcendental ops of the JAX graph that are no per-point work of the
#: port (the module docstring): key -> {class: JAX count - port count}
CONSTANT_GAPS = {"andreas": {"log": 6, "div": 48},
                 "ice_best": {"sqrt": 6, "div": 6}}
#: JAX's cheap count minus the port's, by key, as a fraction of JAX's
#: (measured with this module; the tests hold it within 0.001); over 10%
#: only where the cause is a lowering named in the module docstring
CHEAP_GAP = {"skin_coare3p6": 0.0778, "skin_ecmwf": 0.0457,
             "skin_coare3p0": 0.0794, "coare3p0": 0.0875,
             "coare3p6": 0.0846, "ecmwf": 0.0549, "ncar": 0.0743,
             "andreas": 0.3328, "ice_nemo": 0.0400, "ice_easy": 0.0870,
             "ice_an05": 0.1181, "ice_lu12": 0.0256, "ice_lg15": 0.0270,
             "ice_lg15_io": 0.0270, "ice_best": 0.0778,
             "mixed_ice_lg15_ecmwf": 0.0441, "mixed_lg15_io": 0.0346}
OVER_10_PERCENT = {"andreas": "jnp.searchsorted in z0tq_lkb",
                   "ice_an05": "jnp.copysign (33 of them)"}
#: the cheap primitives jnp.copysign has beyond torch.copysign's one op
COPYSIGN_EXTRA = 4


def _port_census(key):
    """The port's census of one CENSUS entry, traced as
    tests/test_torch_kernels.py traces the JAX graph (niter=5, fp32,
    (1, 1)); returns the census mode (class counts and op names)."""
    z = torch.zeros((1, 1))
    census = tr._Census()
    if not key.startswith(("ice_", "mixed_")):
        algo = key.removeprefix("skin_")
        cfg = tapi.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=5,
                                  use_skin=key.startswith("skin_"))
        st = tapi.init_skin_state(cfg, (1, 1), torch.float32, device="cpu")
        args = (z + 290.0, z + 289.0, z + 0.01, z + 5.0, z, z + 1.01e5)
        skin = dict(rad_sw=z + 200.0, rad_lw=z + 350.0, isecday_utc=43200,
                    lon=z) if cfg.use_skin else {}
        with torch.no_grad(), census:
            tapi.flux_step(cfg, *args, **skin, skin_state=st)
        assert census.counts == tr.flux_step_counts(cfg=cfg)
        return census
    air = (z + 258.0, z + 0.002, z + 5.0, z, z + 1.01e5)
    with torch.no_grad(), census:
        if key.startswith("ice_"):
            tapi.flux_step_ice(key, 2.0, 10.0, z + 260.0, *air,
                               frice=z + 0.5, niter=5)
        else:
            tapi.flux_step_mixed(2.0, 10.0, z + 260.0, z + 271.0, *air,
                                 z + 0.5, niter=5,
                                 simultaneous=key == "mixed_lg15_io")
    return census


@functools.cache
def _lookup_cheap_gap():
    """JAX's cheap primitives minus the port's in one z0tq_lkb call."""
    jz = jnp.zeros((1, 1), jnp.float32)
    z = torch.zeros((1, 1))
    j = jr.count_primitives(lambda r: jthermo.z0tq_lkb(1, r + 3.0, r + 1e-4),
                            jz)
    t = tr.count_primitives(lambda r: tthermo.z0tq_lkb(1, r + 3.0, r + 1e-4),
                            z)
    return j["cheap"] - t["cheap"]


@pytest.mark.parametrize("key", FORWARD_KEYS)
def test_census_matches_the_jax_graph(key):
    """Each forward entry of CENSUS from the port's own step: the six
    transcendental classes exact but for CONSTANT_GAPS; the cheap gap as
    stated, and within 10% once the named lowerings are taken out."""
    census = _port_census(key)
    got, ref = census.counts, tr.CENSUS[key]
    gaps = CONSTANT_GAPS.get(key, {})
    assert {c: ref[c] - got[c] for c in TRANS} == \
        {c: gaps.get(c, 0) for c in TRANS}
    gap = ref["cheap"] - got["cheap"]
    assert gap / ref["cheap"] == pytest.approx(CHEAP_GAP[key], abs=1e-3)
    assert CHEAP_GAP[key] <= 0.10 or key in OVER_10_PERCENT
    named = (COPYSIGN_EXTRA * census.ops["copysign"]
             + _lookup_cheap_gap() * census.ops["bucketize"])
    assert abs(gap - named) <= 0.10 * ref["cheap"]


def test_the_gaps_causes_on_the_helpers():
    """CONSTANT_GAPS per call, traced on the two packages' helpers: one
    staged log in un10_from_ustar, four halvings (div) in z0tq_lkb's
    searchsorted, one staged sqrt and one division in cx_lupkes2015; and
    jnp.copysign's four extra cheap primitives."""
    jz = jnp.zeros((1, 1), jnp.float32)
    z = torch.zeros((1, 1))

    def gap(jfn, tfn):
        j = jr.count_primitives(jfn, jz)
        t = tr.count_primitives(tfn, z)
        return {c: j[c] - t[c] for c in (*TRANS, "cheap") if j[c] != t[c]}

    un10 = gap(lambda x: jthermo.un10_from_ustar(10.0, x + 5.0, x + 0.2, x),
               lambda x: tthermo.un10_from_ustar(10.0, x + 5.0, x + 0.2, x))
    assert un10.pop("log") == 1 and all(v <= 1 for v in un10.values())
    lkb = gap(lambda r: jthermo.z0tq_lkb(1, r + 3.0, r + 1e-4),
              lambda r: tthermo.z0tq_lkb(1, r + 3.0, r + 1e-4))
    assert {c: v for c, v in lkb.items() if c != "cheap"} == {"div": 4}
    air = (258.0, 0.002, 260.0, 0.003)
    cx = gap(lambda u: jbest.cx_lupkes2015(10.0, jz + air[0], jz + air[1],
                                           u + 5.0, jz + air[2], jz + air[3]),
             lambda u: tbest.cx_lupkes2015(10.0, z + air[0], z + air[1],
                                           u + 5.0, z + air[2], z + air[3]))
    assert {c: v for c, v in cx.items() if c != "cheap"} == \
        {"sqrt": 1, "div": 1}
    assert jr.count_primitives(lambda x: jnp.copysign(x, x + 1.0), jz) == \
        Counter({"cheap": 2 + COPYSIGN_EXTRA})
    assert tr.count_primitives(lambda x: torch.copysign(x, x + 1.0), z) == \
        Counter({"cheap": 2})


@pytest.mark.parametrize("algo", ["coare3p6", "ecmwf"])
def test_niter_20_matches_jax(algo):
    """COARE 3.6 and ECMWF + skin at niter=20: the six transcendental
    classes equal aerobulk_tpu.roofline.flux_step_counts(niter=20); the
    cheap class within 10% (copysign's lowering)."""
    ref = jr.flux_step_counts(algo=algo, niter=20, use_skin=True)
    got = tr.flux_step_counts(algo=algo, niter=20, use_skin=True)
    if algo == "coare3p6":
        assert ref == Counter({"exp": 325, "log": 221, "pow": 231,
                               "sqrt": 398, "div": 757, "atan": 85,
                               "cheap": 12109})
    assert {c: got[c] for c in TRANS} == {c: ref[c] for c in TRANS}
    assert 0 <= ref["cheap"] - got["cheap"] <= 0.10 * ref["cheap"]


def test_flux_step_counts_takes_a_config():
    """``cfg=`` counts that configuration (here zt == zu, which drops the
    height shift of t and q), as the JAX function's ``cfg=`` does."""
    kw = dict(algo="coare3p0", zt=10.0, zu=10.0, niter=3, use_skin=True)
    got = tr.flux_step_counts(cfg=tapi.AeroBulkConfig(**kw))
    ref = jr.flux_step_counts(cfg=JaxConfig(**kw))
    assert {c: got[c] for c in TRANS} == {c: ref[c] for c in TRANS}
    assert got != tr.flux_step_counts(algo="coare3p0", niter=3)


def test_transcendental_table_is_jaxs():
    """Every name the two tables share has JAX's class; JAX's integer_pow
    and cbrt have no ATen op (the port's pow with an integer exponent is
    cheap, and its cube root is a pow)."""
    shared = set(jr.TRANSCENDENTAL) & set(tr.TRANSCENDENTAL)
    assert set(jr.TRANSCENDENTAL) - shared == {"integer_pow", "cbrt"}
    assert all(tr.TRANSCENDENTAL[k] == jr.TRANSCENDENTAL[k] for k in shared)
    assert set(tr.TRANSCENDENTAL.values()) == set(TRANS)


@pytest.mark.parametrize("exponent", [2, 2.0, 0.5, "tensor"])
def test_powers_count_as_jax_counts_them(exponent):
    """x ** 2 is JAX's integer_pow (cheap); x ** 2.0, x ** 0.5 and a
    tensor exponent are pows."""
    jz = jnp.zeros((1, 1), jnp.float32) + 1.5
    z = torch.zeros((1, 1)) + 1.5
    je = jz if exponent == "tensor" else exponent
    te = z if exponent == "tensor" else exponent
    assert tr.count_primitives(lambda x: x ** te, z) == \
        jr.count_primitives(lambda x: x ** je, jz)


@pytest.mark.parametrize("branch", ["bool", "item"])
def test_data_dependent_branch_raises(branch):
    """A host branch on a tensor's value makes the per-point count
    ill-defined: ValueError, as JAX's census raises on cond/while."""
    def fn(x):
        if branch == "bool":
            return x * 2.0 if bool(x.sum() > 0) else x
        return x * x.max().item()
    with pytest.raises(ValueError, match="data-dependent"):
        tr.count_primitives(fn, torch.ones((1, 1)))


def _traced_step(algo):
    """One flux step of ``algo`` (niter=1, fp64, 2 x 3) as a function of
    tensors only, and its seeded inputs."""
    cfg = tapi.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=1,
                              use_skin=algo != "ncar")
    st = tapi.init_skin_state(cfg, (2, 3), torch.float64, device="cpu")

    def fn(sst, t, q, u, v, slp, rsw, rlw, lon, *state):
        skin = dict(rad_sw=rsw, rad_lw=rlw, isecday_utc=43200,
                    lon=lon) if cfg.use_skin else {}
        out, _ = tapi.flux_step(cfg, sst, t, q, u, v, slp, **skin,
                                skin_state=tapi.SkinState(*state))
        return out.QL, out.QH, out.Tau_x, out.T_s

    rng = np.random.default_rng(7)
    lows = (285, 283, 0.005, -10, -10, 9.9e4, 0, 250, 0)
    highs = (300, 298, 0.015, 10, 10, 1.02e5, 900, 450, 360)
    args = tuple(torch.as_tensor(rng.uniform(lo, hi, (2, 3)))
                 for lo, hi in zip(lows, highs))
    return fn, (*args, *st)


def test_constant_cache_survives_tracing():
    """F7: thermo's constant cache holds no tensor made under a fake, proxy
    or counting mode.  A fake-mode trace works before and after eager
    calls and after another algorithm's trace, a real-mode trace and the
    census run beside them, and the eager values are bitwise the same
    before and after."""
    ncar, ncar_args = _traced_step("ncar")
    make_fx(ncar, tracing_mode="fake")(*ncar_args)
    coare, args = _traced_step("coare3p6")
    before = coare(*args)
    make_fx(coare, tracing_mode="fake")(*args)
    ecmwf, ecmwf_args = _traced_step("ecmwf")
    make_fx(ecmwf, tracing_mode="fake")(*ecmwf_args)
    graph = make_fx(coare, tracing_mode="real")(*args)
    tr.flux_step_counts(algo="ecmwf", niter=2)
    after = coare(*args)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert all(torch.equal(a, b) for a, b in zip(before, graph(*args)))
    const = tthermo._const(180.0, torch.float64)
    assert type(const) is torch.Tensor and float(const) == 180.0
