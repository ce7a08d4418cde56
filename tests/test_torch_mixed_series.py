"""``run_series`` of a mixed ocean + sea-ice config (``AeroBulkConfig``
with ``ice_algo``): record by record against ``aerobulk_tpu``'s
``flux_step_mixed`` in fp64 on the CPU (rtol 1e-12, as
tests/test_torch_ice.py), the eager, fused and ``batch_records=True``
paths against each other, the config's refusals, and the spans of a CPU
trace; on the card, kernel 5 once a record over a 24-record series against
the eager series in fp64, and its wrapper's sub-spans.

JAX is imported inside the tests that compare with it, so that the
``cuda`` tests run on the card with ``--noconftest`` and no JAX.
"""

import numpy as np
import pytest
import torch

from aerobulk_tpu_torch import api
from aerobulk_tpu_torch.kernels import fused as tfused

FIELDS = ("Ts_i", "sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "frice")
#: the net outputs the mixed kernel returns
KERNEL_OUT = ("QL", "QH", "Tau", "Evap", "T_s")
#: fields that change sign or pass through 0: also atol 1e-12 * max|ref|
NEAR_ZERO = ("QL", "QH", "Tau_x", "Tau_y", "Evap")
#: (ice algorithm, ocean algorithm of the leads)
PAIRS = [("ice_lg15", "ecmwf"), ("ice_an05", "coare3p6")]


def _forcing(nt=3, shape=(4, 7), dtype=torch.float64, device="cpu", seed=21):
    """A mixed series: ice from 243 K to the melting point, air within 15 K
    either side of it, water near freezing, every ice fraction from open
    water to full cover (exact 0 and 1 included)."""
    rng = np.random.default_rng(seed)
    size = (nt, *shape)

    def u(lo, span):
        return lo + span * rng.random(size)
    f = dict(sst=u(271.35, 6.0), Ts_i=u(243.15, 30.0), t_zt=u(248.15, 30.0),
             hum_zt=u(0.0003, 0.0027), U_zu=rng.normal(0.0, 6.0, size),
             V_zu=rng.normal(0.0, 6.0, size), slp=u(98000.0, 4000.0),
             frice=u(0.0, 1.0))
    f["frice"].reshape(-1)[:2] = (0.0, 1.0)
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in f.items()}


def _cfg(ice_algo="ice_lg15", algo="ecmwf", **kw):
    return api.AeroBulkConfig(algo=algo, ice_algo=ice_algo, **kw)


def _close(name, got, ref, rtol=1e-12):
    g, r = np.asarray(got), np.asarray(ref)
    atol = rtol * np.max(np.abs(r)) if name in NEAR_ZERO else 0.0
    np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("ice_algo,algo", PAIRS)
def test_eager_series_matches_jax_record_by_record(ice_algo, algo):
    """Every net output of every record against aerobulk_tpu's
    flux_step_mixed of the same record, and the ocean side's diagnostics
    (``diag``) against its ocean part's."""
    import jax.numpy as jnp
    from aerobulk_tpu import api as japi

    f = _forcing()
    out, _ = api.run_series(_cfg(ice_algo, algo), f)
    for k in range(f["sst"].shape[0]):
        ref, _, ref_w = japi.flux_step_mixed(
            2.0, 10.0, *(jnp.asarray(f[n][k].numpy()) for n in FIELDS),
            ice_algo=ice_algo, ocean_algo=algo, niter=5, humidity="sh")
        for name in ref._fields:
            if name != "diag":
                _close(name, getattr(out, name)[k].numpy(),
                       getattr(ref, name))
        for name in ("Cd", "Ch", "Ce"):
            _close(name, getattr(out.diag, name)[k].numpy(),
                   getattr(ref_w.diag, name))


@pytest.mark.parametrize("ice_algo,algo", PAIRS)
def test_fused_and_batched_series_match_jax(ice_algo, algo):
    """The fused series (on CPU tensors, the mixed kernel's plain version)
    and both batched series: the kernel's five net outputs against JAX's
    flux_step_mixed over the whole (nt, ...) tensors."""
    import jax.numpy as jnp
    from aerobulk_tpu import api as japi

    f = _forcing()
    ref, _, _ = japi.flux_step_mixed(
        2.0, 10.0, *(jnp.asarray(f[n].numpy()) for n in FIELDS),
        ice_algo=ice_algo, ocean_algo=algo, niter=5, humidity="sh")
    cfg = _cfg(ice_algo, algo)
    for kw in (dict(backend="fused"), dict(batch_records=True),
               dict(batch_records=True, backend="fused")):
        out, _ = api.run_series(cfg, f, **kw)
        for name in KERNEL_OUT:
            _close(name, getattr(out, name).numpy(), getattr(ref, name))


@pytest.mark.parametrize("kw", [dict(backend="fused"),
                                dict(batch_records=True),
                                dict(batch_records=True, backend="fused")],
                         ids=["fused", "batched", "batched_fused"])
def test_paths_agree_with_the_eager_series(kw):
    """The fused series is bitwise the eager one on the CPU (the kernel's
    plain version is the eager step); a batch agrees to rounding.  The
    fused paths return the kernel's reduced set."""
    f = _forcing(nt=4)
    cfg = _cfg()
    want, _ = api.run_series(cfg, f)
    got, _ = api.run_series(cfg, f, **kw)
    for name in KERNEL_OUT:
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape == f["sst"].shape
        if kw == dict(backend="fused"):
            assert torch.equal(g, w), name
        else:
            _close(name, g.numpy(), w.numpy())
    fused = kw.get("backend") == "fused"
    for name in ("Tau_x", "Tau_y", "rho_a", "diag"):
        assert (getattr(got, name) is None) == fused, name


def test_rad_lon_and_time_are_not_read():
    f = _forcing(nt=2)
    cfg = _cfg()
    want, _ = api.run_series(cfg, f)
    extra = dict(f, rad_sw=f["sst"] * 0 + 300.0, rad_lw=f["sst"] * 0 + 250.0)
    got, _ = api.run_series(cfg, extra, isecday_utc=[7, 9],
                            lon=f["sst"][0] * 0 + 120.0)
    for name in KERNEL_OUT:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_the_state_is_returned_untouched(backend):
    f = _forcing(nt=2)
    cfg = _cfg()
    given = api.init_skin_state(cfg, f["sst"].shape[1:], torch.float64,
                                device="cpu")
    _, state = api.run_series(cfg, f, skin_state=given, backend=backend)
    assert state is given
    _, fresh = api.run_series(cfg, f, backend=backend)
    for x, y in zip(fresh, given, strict=True):
        assert torch.equal(x, y)


def test_gradients_flow_through_the_eager_series():
    f = _forcing(nt=2)
    f["Ts_i"].requires_grad_()
    out, _ = api.run_series(_cfg(), f)
    (g,) = torch.autograd.grad(out.QH.sum(), f["Ts_i"])
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0.0


@pytest.mark.parametrize("kw,match", [
    (dict(use_skin=True), "without skin"),
    (dict(ice_algo="ice_foo"), "unknown ice algorithm"),
    (dict(humidity="auto"), "resolve 'auto'"),
    (dict(algo="foo"), "unknown algorithm"),
], ids=["skin", "ice_algo", "humidity_auto", "ocean_algo"])
def test_config_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        _cfg(**kw)


@pytest.mark.parametrize("humidity", ["rh", "dp"])
def test_other_humidity_kinds_are_taken(humidity):
    cfg = _cfg(humidity=humidity)
    assert cfg.ice_algo == "ice_lg15" and cfg.humidity == humidity


@pytest.mark.parametrize("missing", ["Ts_i", "frice"])
@pytest.mark.parametrize("batch", [False, True])
def test_a_series_without_ice_fields_raises(missing, batch):
    f = _forcing(nt=2)
    del f[missing]
    with pytest.raises(ValueError, match=missing):
        api.run_series(_cfg(), f, batch_records=batch)


def test_an_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        api.run_series(_cfg(), _forcing(nt=1), backend="foo")


def test_ocean_configs_have_no_ice_algo():
    assert api.AeroBulkConfig().ice_algo is None
    assert api.AeroBulkConfig(algo="ecmwf", use_skin=True).ice_algo is None


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def _traced(fn, cuda=False):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        result = fn()
        if cuda:
            torch.cuda.synchronize()
    return result, list(prof.profiler.kineto_results.events())


def _spans(events, name=None):
    """The program's spans, by start: (name, start, end, args)."""
    out = [(e.name(), e.start_ns(), e.end_ns(), e.kwinputs()) for e in events
           if e.name().startswith("aerobulk.")
           and e.device_type() == torch.autograd.DeviceType.CPU]
    out.sort(key=lambda s: s[1])
    return [s for s in out if name is None or s[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_series_spans_name_the_ice_algorithm(backend):
    """The call's span carries ``ice_algo`` beside backend, nt and call; one
    ``.record`` a record inside it, then ``.stack``; the CPU path opens no
    kernel span.  An ocean config's span has no ``ice_algo``."""
    f = _forcing(nt=3)
    _, events = _traced(lambda: api.run_series(_cfg(), f, backend=backend))
    (call,) = _spans(events, "aerobulk.run_series")
    assert call[3]["ice_algo"] == "ice_lg15"
    assert call[3]["backend"] == backend and call[3]["nt"] == 3
    records = _spans(events, "aerobulk.run_series.record")
    assert [r[3] for r in records] == [{"call": call[3]["call"], "k": k}
                                       for k in range(3)]
    (stack,) = _spans(events, "aerobulk.run_series.stack")
    for s in records + [stack]:
        assert _inside(s, call)
    assert not [s for s in _spans(events) if ".kernel" in s[0]]

    ocean = {n: f[n] for n in ("sst", "t_zt", "hum_zt", "U_zu", "V_zu",
                               "slp")}
    _, events = _traced(lambda: api.run_series(api.AeroBulkConfig(), ocean))
    (call,) = _spans(events, "aerobulk.run_series")
    assert "ice_algo" not in call[3]


def test_a_batched_series_has_no_record_spans():
    _, events = _traced(lambda: api.run_series(_cfg(), _forcing(nt=3),
                                               batch_records=True))
    names = [s[0] for s in _spans(events)]
    assert names == ["aerobulk.run_series", "aerobulk.run_series.init_state"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_kernel5_series_matches_the_eager_series_on_the_card():
    """24 records at fp64: one kernel 5 launch a record, the five net
    outputs of each against the eager series at rtol 1e-9 and atol 1e-9 *
    max|ref| (FMA contraction only, as tests/test_torch_kernels.py holds
    kernel 5 alone); one launch for the whole batched series."""
    _cuda_or_skip()
    f = _forcing(nt=24, shape=(37, 53), device="cuda")
    cfg = _cfg()
    want, _ = api.run_series(cfg, f)
    for kw, launches in ((dict(backend="fused"), 24),
                         (dict(backend="fused", batch_records=True), 1)):
        before = tfused.MIXED_LAUNCHES
        got, _ = api.run_series(cfg, f, **kw)
        torch.cuda.synchronize()
        assert tfused.MIXED_LAUNCHES - before == launches, kw
        for name in KERNEL_OUT:
            g, w = getattr(got, name), getattr(want, name)
            assert g.shape == w.shape and g.dtype == torch.float64
            scale = float(w.abs().max())
            torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-9 * scale,
                                       msg=f"{kw} {name}")


@pytest.mark.cuda
def test_kernel5_wrapper_spans_on_the_card():
    """Each record's kernel 5 wrapper lies in the record and holds its
    check, alloc and launch in that order."""
    _cuda_or_skip()
    nt = 3
    f = _forcing(nt=nt, shape=(64, 128), dtype=torch.float32, device="cuda")
    cfg = _cfg()
    api.run_series(cfg, f, backend="fused")      # build and load the kernel
    torch.cuda.synchronize()
    _, events = _traced(lambda: api.run_series(cfg, f, backend="fused"),
                        cuda=True)
    records = _spans(events, "aerobulk.run_series.record")
    wrappers = _spans(events, "aerobulk.kernel5.wrapper")
    assert len(records) == len(wrappers) == nt
    parts = [_spans(events, f"aerobulk.kernel5.{p}")
             for p in ("check", "alloc", "launch")]
    for r, w, check, alloc, launch in zip(records, wrappers, *parts,
                                          strict=True):
        assert _inside(w, r)
        for s in (check, alloc, launch):
            assert _inside(s, w), (w, s)
        assert check[2] <= alloc[1] and alloc[2] <= launch[1]
    kernels = [e for e in events if "mixed_step_kernel" in e.name()
               and e.device_type() == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == nt
