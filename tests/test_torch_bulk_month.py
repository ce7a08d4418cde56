"""A stateless COARE 3.0 series in one batch (``run_series(batch_records=
True)``), the path of a flux product that solves a month of records in one
call: record by record against ``aerobulk_tpu``'s ``flux_step`` in fp64 on
the CPU (rtol 1e-12, as tests/test_torch_algos.py), through the eager batch
and the fused batch's CPU version; the benchmark's plain reference of the
same step (``fluxbench/reference/bulk.py``) against the same JAX step; on
the card, kernel 3 once over a batched series against the eager series in
fp64, and its wrapper's four spans.

JAX is imported inside the tests that compare with it, so that the
``cuda`` tests run on the card with ``--noconftest`` and no JAX.
"""

import numpy as np
import pytest
import torch

from aerobulk_tpu_torch import api
from aerobulk_tpu_torch.kernels import fused as tfused
from fluxbench.reference import bulk

FIELDS = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp")
#: the outputs the stateless kernel returns
KERNEL_OUT = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s")
#: fields that change sign or pass through 0: also atol 1e-12 * max|ref|
NEAR_ZERO = ("QL", "QH", "Tau_x", "Tau_y", "Evap")
CFG = dict(algo="coare3p0", zt=2.0, zu=10.0, niter=5, use_skin=False,
           humidity="sh")


def _forcing(nt=6, shape=(4, 7), dtype=torch.float64, device="cpu", seed=30):
    """A series of independent records: air within 8 K either side of the
    water (stable and unstable), winds from calm to past 18 m/s (every
    branch of COARE 3.0's Charnock law), one point of no wind at all."""
    rng = np.random.default_rng(seed)
    size = (nt, *shape)
    sst = 271.0 + 32.0 * rng.random(size)
    speed = 25.0 * rng.random(size)
    angle = 2.0 * np.pi * rng.random(size)
    f = dict(sst=sst, t_zt=sst - 8.0 + 16.0 * rng.random(size),
             hum_zt=0.002 + 0.016 * rng.random(size),
             U_zu=speed * np.cos(angle), V_zu=speed * np.sin(angle),
             slp=97000.0 + 6000.0 * rng.random(size))
    f["U_zu"].reshape(-1)[0] = f["V_zu"].reshape(-1)[0] = 0.0
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in f.items()}


def _close(name, k, got, ref, rtol=1e-12):
    g, r = np.asarray(got), np.asarray(ref)
    atol = rtol * np.max(np.abs(r)) if name in NEAR_ZERO else 0.0
    np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                               err_msg=f"{name}[{k}]")


def _jax_records(f):
    """aerobulk_tpu's flux_step of each record of ``f``, in fp64."""
    import jax.numpy as jnp
    from aerobulk_tpu import api as japi

    jcfg = japi.AeroBulkConfig(**CFG)
    return [japi.flux_step(jcfg, *(jnp.asarray(f[n][k].numpy())
                                   for n in FIELDS))[0]
            for k in range(f["sst"].shape[0])]


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_batched_series_matches_jax_record_by_record(backend):
    """Every output the kernel returns, of every record of the batch,
    against JAX's step of that record alone; the state comes back
    untouched."""
    f = _forcing()
    cfg = api.AeroBulkConfig(**CFG)
    given = api.init_skin_state(cfg, f["sst"].shape[1:], torch.float64,
                                device="cpu")
    out, state = api.run_series(cfg, f, skin_state=given,
                                batch_records=True, backend=backend)
    assert state is given
    for k, ref in enumerate(_jax_records(f)):
        for name in KERNEL_OUT:
            _close(name, k, getattr(out, name)[k].numpy(),
                   getattr(ref, name))


def test_the_references_step_matches_jax_record_by_record():
    """The benchmark's plain reference, run over the whole (nt, ...)
    batch, against JAX's step of each record."""
    f = _forcing(seed=31)
    got = bulk.flux_step(dict(CFG), *(f[n] for n in bulk.FORCING))
    for k, ref in enumerate(_jax_records(f)):
        for name, g in zip(bulk.OUTPUTS, got, strict=True):
            _close(name, k, g[k].numpy(), getattr(ref, name))


def test_the_fused_batch_is_its_plain_version_on_the_cpu():
    """On CPU tensors the fused batch is the eager batch reduced to the
    kernel's outputs, bit for bit, and returns no Tau, rho_a or diag."""
    f = _forcing(nt=3, dtype=torch.float32)
    cfg = api.AeroBulkConfig(**CFG)
    want, _ = api.run_series(cfg, f, batch_records=True)
    got, _ = api.run_series(cfg, f, batch_records=True, backend="fused")
    for name in KERNEL_OUT:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in ("Tau", "rho_a", "diag"):
        assert getattr(got, name) is None, name
    assert torch.equal(got.T_s, f["sst"])


def test_a_series_fields_reach_the_batch_as_they_are():
    """Six tensors of one shape, dtype and device pass the batch's field
    step as the very tensors given (no view, no copy); a Python number
    among them still broadcasts and takes the fields' dtype."""
    f = _forcing(nt=2)
    fields = tuple(f[n] for n in FIELDS)
    assert all(a is b for a, b in zip(tfused._bulk_fields(fields), fields))
    got = tfused._bulk_fields((*fields[:5], 101325.0))
    assert all(x.shape == fields[0].shape and x.dtype == torch.float64
               for x in got)
    assert torch.equal(got[5], torch.full_like(fields[0], 101325.0))


@pytest.mark.parametrize("kw,match", [
    (dict(algo="ecmwf"), "no stateless step"),
    (dict(use_skin=True), "no stateless step")], ids=["algo", "skin"])
def test_the_reference_refuses_other_configs(kw, match):
    f = _forcing(nt=1)
    with pytest.raises(ValueError, match=match):
        bulk.flux_step(dict(CFG, **kw), *(f[n] for n in bulk.FORCING))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_kernel3_batch_matches_the_eager_series_on_the_card():
    """24 records at fp64 in one kernel 3 launch, every output against the
    eager series at rtol 1e-9 and atol 1e-9 * max|ref| (FMA contraction
    only, as tests/test_torch_kernels.py holds kernel 3 alone)."""
    _cuda_or_skip()
    f = _forcing(nt=24, shape=(37, 53), device="cuda")
    cfg = api.AeroBulkConfig(**CFG)
    want, _ = api.run_series(cfg, f)
    before = tfused.BULK_LAUNCHES
    got, _ = api.run_series(cfg, f, batch_records=True, backend="fused")
    torch.cuda.synchronize()
    assert tfused.BULK_LAUNCHES - before == 1
    for name in KERNEL_OUT:
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape and g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-9,
                                   atol=1e-9 * float(w.abs().max()),
                                   msg=name)


@pytest.mark.cuda
def test_kernel3_wrapper_spans_on_the_card(monkeypatch):
    """Under a profiler the batch's kernel 3 wrapper holds its check, alloc
    and launch in that order around one kernel, and the fresh state the
    batch returns is made after the launch; with none running the wrapper
    enters no record function."""
    _cuda_or_skip()
    f = _forcing(nt=4, shape=(64, 128), dtype=torch.float32, device="cuda")
    cfg = api.AeroBulkConfig(**CFG)
    api.run_series(cfg, f, batch_records=True, backend="fused")   # build
    torch.cuda.synchronize()

    made = []
    real = torch._C._profiler._RecordFunctionFast
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda *a, **kw: made.append(a) or real(*a, **kw))
    api.run_series(cfg, f, batch_records=True, backend="fused")
    torch.cuda.synchronize()
    assert made == []

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        api.run_series(cfg, f, batch_records=True, backend="fused")
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    spans = {}
    for e in events:
        if e.name().startswith("aerobulk.kernel3") and \
                e.device_type() == torch.autograd.DeviceType.CPU:
            spans.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    names = [f"aerobulk.kernel3.{p}" for p in ("wrapper", "check", "alloc",
                                               "launch")]
    assert sorted(spans) == sorted(names)
    (wrapper,), (check,), (alloc,), (launch,) = (spans[n] for n in names)
    for s in (check, alloc, launch):
        assert wrapper[0] <= s[0] and s[1] <= wrapper[1], (wrapper, s)
    assert check[1] <= alloc[0] and alloc[1] <= launch[0]
    (init,) = [(e.start_ns(), e.end_ns()) for e in events
               if e.name() == "aerobulk.run_series.init_state"]
    assert wrapper[1] <= init[0]
    kernels = [e for e in events if "bulk_step_kernel" in e.name()
               and e.device_type() == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1
