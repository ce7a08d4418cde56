"""The streamed host feed of aerobulk_tpu_torch (``pipeline``) against
aerobulk_tpu's, on the CPU (``device="cpu"``), at a few records of a small
grid.

Tolerances:
  * the host packers (``_pack_i16``, ``_pack_i8_delta``,
    ``_unpack_i16_host``): bitwise, NaN fills included;
  * the exact wire, fp64: rtol 1e-12 (docs/PARITY.md §1), with atol =
    1e-12 * max|ref| on the fields that cross zero (QL, QH, Evap and the
    warm-layer state), as tests/test_torch_series.py holds the series;
  * the device decode of a packed wire (``_recon_wire``), fp32: within 1 ulp
    of the reference's (XLA may contract q * s + o into one FMA), NaN at the
    same points;
  * the fluxes of a packed wire, fp32: docs/PARITY.md's gate, no point with
    an error above 10% of the field's median magnitude (a fraction < 1e-4,
    which at these sizes means none), median relative difference < 2e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from aerobulk_tpu import pipeline as jpipe
from aerobulk_tpu.api import AeroBulkConfig as JConfig
from aerobulk_tpu_torch import pipeline as tpipe
from aerobulk_tpu_torch.api import AeroBulkConfig

SHAPE = (4, 8)
FIELDS = ("QL", "QH", "Tau", "Evap")
_CROSSING = ("QL", "QH", "Evap", "dT_wl", "Qnt_ac")
CFG = AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)
JCFG = JConfig(algo="coare3p6", niter=5, use_skin=True)
# the port's backend for each of the reference's
JAX_BACKEND = {"eager": dict(backend="jit"),
               "fused": dict(backend="fused", fused_block=(8, 128),
                             fused_interpret=True)}


def _lon(shape):
    return np.linspace(0.0, 315.0, int(np.prod(shape))).reshape(shape)


def _records(nt, dtype=np.float64, seed=3, lon=None, shape=SHAPE,
             local_sun=True):
    """Hourly records from 10 UTC with a drifting SST, an air temperature
    wobble and the sun following each point's local day at longitudes
    ``_lon(shape)`` (or a constant sun), so the warm layer builds at some
    points and drains at others; ``lon`` (an array) is carried in each
    record."""
    rng = np.random.default_rng(seed)
    base = {
        "sst": 290.0 + 10.0 * rng.random(shape),
        "t_zt": 289.0 + 10.0 * rng.random(shape),
        "hum_zt": 0.005 + 0.010 * rng.random(shape),
        "U_zu": rng.normal(3.0, 2.0, shape),
        "V_zu": rng.normal(0.0, 2.0, shape),
        "slp": 99000.0 + 3000.0 * rng.random(shape),
        "rad_lw": 350.0 + 60.0 * rng.random(shape),
    }
    rsw0 = 600.0 + 300.0 * rng.random(shape)
    for jt in range(nt):
        local_h = np.mod(10 + jt + _lon(shape) / 15.0, 24.0)
        sun = (np.clip(np.cos((local_h - 12.0) * np.pi / 12.0), 0.0, None)
               if local_sun else 1.0)
        rec = {k: (v + 0.01 * jt * np.abs(v).mean()).astype(dtype)
               for k, v in base.items()}
        rec["t_zt"] = (base["t_zt"]
                       + 0.3 * np.sin(2 * np.pi * jt / 24)).astype(dtype)
        rec["rad_sw"] = (rsw0 * sun).astype(dtype)
        rec["isecday_utc"] = np.int32(((10 + jt) * 3600) % 86400)
        if lon is not None:
            rec["lon"] = lon
        yield rec


def _close(name, got, ref, rtol=1e-12):
    ref = np.asarray(ref)
    atol = 1e-12 * np.max(np.abs(ref)) if name in _CROSSING else 0.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)


def _joined(results, chunked):
    join = np.concatenate if chunked else np.stack
    return {k: join([np.asarray(r[k]) for r in results]) for k in results[0]}


def _sig_gate(got, ref):
    """docs/PARITY.md's fp32 gate on each collected field."""
    rels = []
    for k in FIELDS:
        a, b = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        med = float(np.median(np.abs(b)))
        d = np.abs(a - b)
        assert np.mean(d > 0.1 * med) < 1e-4, k
        rels.append(d / np.maximum(np.abs(b), 1e-3 * med))
    assert np.median(np.concatenate(rels)) < 2e-4


# ---------------------------------------------------------------------------
# the host packers: bitwise
# ---------------------------------------------------------------------------

def _pack_fields():
    rng = np.random.default_rng(7)
    walk = np.cumsum(rng.normal(0.0, 0.05, (6, 40)), 0) + 290.0
    masked = walk.copy()
    masked[:, 5] = np.nan                       # a static land mask
    varying = walk.copy()
    varying[2, 9] = np.nan                      # NaN in one record only
    return {
        "spread": 290.0 + 10.0 * rng.random((3, 5, 8)),
        "masked": masked,
        "varying_mask": varying,
        "all_nan": np.full((2, 4), np.nan),
        "constant": np.full((3, 5), 101325.0),
        "huge_span": np.array([[-1e30, 0.0, 1e30]] * 2),
        "one_record": walk[:1],
        "diurnal_sw": 700.0 * np.clip(np.sin(np.arange(8) / 24 * 2 * np.pi),
                                      0, None)[:, None] * rng.random(16),
    }


@pytest.mark.parametrize("name", list(_pack_fields()))
def test_pack_helpers_equal_reference_bitwise(name):
    v = _pack_fields()[name].astype(np.float32)
    for got, ref in zip(tpipe._pack_i16(v), jpipe._pack_i16(v)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(tpipe._pack_i8_delta(v), jpipe._pack_i8_delta(v)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_unpack_i16_host_equals_reference_bitwise():
    from aerobulk_tpu_torch.skin import SkinState
    v = _pack_fields()["masked"].astype(np.float32)
    q, so = tpipe._pack_i16(v)
    leaf = {"_i16q": q, "_i16so": so}
    tree = {"a": leaf, "b": [leaf, (leaf, 3)],
            "c": SkinState(leaf, leaf, None, np.ones(2))}
    got, ref = tpipe._unpack_i16_host(tree), jpipe._unpack_i16_host(tree)
    for g, r in zip((got["a"], got["b"][0], got["b"][1][0], got["c"].dT_wl),
                    (ref["a"], ref["b"][0], ref["b"][1][0], ref["c"].dT_wl)):
        assert g.dtype == r.dtype == np.float32
        np.testing.assert_array_equal(g, r)
    assert got["b"][1][1] == 3 and got["c"].Qnt_ac is None


@pytest.mark.parametrize("name", ["spread", "masked", "varying_mask",
                                  "one_record", "diurnal_sw"])
@pytest.mark.parametrize("wire", ["i16", "i8d"])
def test_recon_wire_within_one_ulp_of_reference(name, wire):
    v = _pack_fields()[name].astype(np.float32)
    packed = tpipe._pack_wire({"x": v}, wire)
    meta = {"x": packed["x", "so"]}
    if wire == "i16":
        fc = {"x": packed["x", "q"]}
    else:
        fc = {"x": {"base": packed["x", "base"], "dq": packed["x", "dq"]}}
    to = lambda f: {k: ({p: f(a) for p, a in d.items()}
                        if isinstance(d, dict) else f(d))
                    for k, d in fc.items()}
    got = tpipe._recon_wire(to(torch.as_tensor),
                            {"x": torch.as_tensor(meta["x"])}, wire)["x"]
    ref = np.asarray(jpipe._recon_wire(to(jnp.asarray),
                                       {"x": jnp.asarray(meta["x"])},
                                       wire)["x"])
    got = got.numpy()
    assert got.dtype == ref.dtype == np.float32 and got.shape == v.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_array_max_ulp(got[ok], ref[ok], maxulp=1)
    if name == "varying_mask" and wire == "i8d":
        # the reference's chaining: NaN in record 2 stays NaN after it
        assert np.isnan(got[2:, 9]).all() and not np.isnan(got[:2, 9]).any()


# ---------------------------------------------------------------------------
# the exact wire against the reference pipeline, fp64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,jax_backend", [
    ("eager", "eager"), ("fused", "eager"), ("fused", "fused")])
@pytest.mark.parametrize("chunk", [None, 4])
def test_exact_wire_matches_jax(backend, jax_backend, chunk):
    """6 records, per-record or in chunks of 4 (a full chunk and an uneven
    final chunk of 2): every collected field and the final state.  On the
    CPU the port's fused backend is the plain step, held at rtol 1e-12 to
    the reference's jit step; against the reference's fused kernel run in
    interpret mode it is held at rtol 5e-11 (measured: 8.2e-12, dT_wl), the
    interpreted kernel's polynomial arctan and cbrt
    (tests/test_torch_series.py holds one step at 5e-7 over wider inputs)."""
    nt = 6
    rtol = 5e-11 if jax_backend == "fused" else 1e-12
    lon = _lon(SHAPE)
    got, st = tpipe.run_series_pipelined(
        CFG, _records(nt), chunk=chunk, backend=backend, lon=lon,
        device="cpu")
    ref, jst = jpipe.run_series_pipelined(
        JCFG, _records(nt), chunk=chunk, lon=jnp.asarray(lon),
        **JAX_BACKEND[jax_backend])
    assert len(got) == len(ref) == (nt if chunk is None else 2)
    if chunk:
        assert got[-1]["QL"].shape == (2,) + SHAPE
    got, ref = _joined(got, chunk), _joined(ref, chunk)
    for k in FIELDS:
        assert isinstance(got[k], np.ndarray) and got[k].dtype == np.float64
        _close(k, got[k], ref[k], rtol)
    assert float(st.dT_wl.max()) > 0.0      # the state carries a warm layer
    for name, a, b in zip(st._fields, st, jst):
        assert a.device.type == "cpu" and a.dtype == torch.float64
        _close(name, a.numpy(), np.asarray(b), rtol)


@pytest.mark.parametrize("chunk", [None, 2])
def test_record_lon_matches_jax(chunk):
    """A static ``lon`` carried in every record anchors the solar clock as
    in the reference, in both modes, and differs from lon = 0: under a
    constant sun from 10 UTC, the points at 250 and 200 degrees east enter
    the dawn window (4-6.5 h local), which resets their warm layer."""
    lon = np.array([[10.0, 150.0, 250.0], [330.0, 80.0, 200.0]])
    kw = dict(shape=lon.shape, local_sun=False)
    got, st = tpipe.run_series_pipelined(
        CFG, _records(4, lon=lon, **kw), chunk=chunk, device="cpu")
    ref, jst = jpipe.run_series_pipelined(
        JCFG, _records(4, lon=lon, **kw), chunk=chunk)
    got, ref = _joined(got, chunk), _joined(ref, chunk)
    for k in FIELDS:
        _close(k, got[k], ref[k])
    for name, a, b in zip(st._fields, st, jst):
        _close(name, a.numpy(), np.asarray(b))
    _, st0 = tpipe.run_series_pipelined(
        CFG, _records(4, **kw), chunk=chunk, device="cpu")
    assert not np.allclose(st.dT_wl.numpy(), st0.dT_wl.numpy(), rtol=1e-6)


def test_resume_from_user_state_equals_one_stream():
    """Split streams with a host-side state handed over equal one stream
    (the state is moved to the device)."""
    recs = list(_records(6))
    _, full = tpipe.run_series_pipelined(CFG, iter(recs), chunk=2,
                                         device="cpu")
    _, half = tpipe.run_series_pipelined(CFG, iter(recs[:3]), chunk=2,
                                         device="cpu")
    host = type(half)(*(x.numpy() for x in half))
    _, end = tpipe.run_series_pipelined(CFG, iter(recs[3:]), chunk=2,
                                        skin_state=host, device="cpu")
    for a, b in zip(end, full):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# packed wires against the reference pipeline, fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire,collect_wire,nt", [
    ("i16", "f32", 6), ("i8d", "f32", 6), ("i8d", "f32", 5),
    ("f32", "i16", 6)])
def test_packed_wires_match_jax(wire, collect_wire, nt):
    kw = dict(chunk=4, wire=wire, collect_wire=collect_wire)
    got, st = tpipe.run_series_pipelined(
        CFG, _records(nt, np.float32), device="cpu", **kw)
    ref, jst = jpipe.run_series_pipelined(
        JCFG, _records(nt, np.float32), **kw)
    got, ref = _joined(got, True), _joined(ref, True)
    for k in FIELDS:
        assert got[k].dtype == np.float32 and got[k].shape == ref[k].shape
        assert np.isfinite(got[k]).all()
    _sig_gate(got, ref)
    assert st.dT_wl.dtype == torch.float32
    np.testing.assert_allclose(st.dT_wl.numpy(), np.asarray(jst.dT_wl),
                               rtol=1e-3, atol=1e-4)


def test_collect_wire_i16_quantizes_on_device_as_reference():
    """The device quantizer equals the reference's on the same fp64 tree
    (NaN fill and the masked extrema included) up to one quantization
    step, and round-trips through the host unpacker."""
    rng = np.random.default_rng(5)
    x = rng.normal(0.0, 50.0, (3, 4, 8))
    x[0, 1, 2] = np.nan
    x[2, 3, 7] = np.inf
    got = tpipe._device_pack_i16({"QL": torch.as_tensor(x), "n": 3})
    ref = jpipe._device_pack_i16_fn()({"QL": jnp.asarray(x)})
    assert got["n"] == 3
    q, so = got["QL"]["_i16q"].numpy(), got["QL"]["_i16so"].numpy()
    assert q.dtype == np.int16 and so.dtype == np.float32
    np.testing.assert_array_equal(so, np.asarray(ref["QL"]["_i16so"]))
    assert np.abs(q.astype(int) - np.asarray(ref["QL"]["_i16q"])).max() <= 1
    out = tpipe._unpack_i16_host({"QL": {"_i16q": q, "_i16so": so}})["QL"]
    ok = np.isfinite(x)
    assert np.isnan(out[~ok]).all()
    np.testing.assert_allclose(out[ok], x[ok],
                               atol=(np.max(x[ok]) - np.min(x[ok])) / 65534)


# ---------------------------------------------------------------------------
# collection, prefetch and error paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inflight", [0, 3])
def test_collect_selection_materialized_in_order(inflight):
    got, _ = tpipe.run_series_pipelined(
        CFG, _records(5), inflight=inflight, device="cpu",
        collect=lambda out: {"ts": out.T_s, "pair": (out.QL, None)})
    ref, _ = jpipe.run_series_pipelined(
        JCFG, _records(5), inflight=inflight,
        collect=lambda out: {"ts": out.T_s})
    assert len(got) == 5
    assert all(isinstance(r["ts"], np.ndarray) for r in got)
    assert all(r["pair"][1] is None for r in got)
    _close("T_s", np.stack([r["ts"] for r in got]),
           np.stack([r["ts"] for r in ref]))


def test_prefetch_yields_every_record():
    recs = list(tpipe.prefetch_to_device(_records(5), device="cpu"))
    assert len(recs) == 5
    for rec, ref in zip(recs, _records(5)):
        assert list(rec) == list(ref)
        for k, v in ref.items():
            if np.ndim(v):
                assert isinstance(rec[k], torch.Tensor)
                np.testing.assert_array_equal(rec[k].numpy(), v)
            else:
                assert rec[k] == v          # the solar clock stays on host


def test_wire_requires_chunked_mode():
    with pytest.raises(ValueError, match="chunk"):
        tpipe.run_series_pipelined(CFG, _records(2), wire="i16",
                                   device="cpu")
    with pytest.raises(ValueError, match="wire"):
        tpipe.run_series_pipelined(CFG, _records(2), chunk=2, wire="bf16",
                                   device="cpu")
    with pytest.raises(ValueError, match="collect_wire"):
        tpipe.run_series_pipelined(CFG, _records(2), chunk=2,
                                   collect_wire="i8d", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tpipe.run_series_pipelined(CFG, _records(2), backend="jit",
                                   device="cpu")


@pytest.mark.parametrize("chunk", [None, 2])
def test_time_varying_lon_raises(chunk):
    def recs():
        for jt, r in enumerate(_records(4)):
            r["lon"] = np.full(SHAPE, 10.0 * jt)   # a drifting platform
            yield r

    with pytest.raises(ValueError, match="time-varying 'lon'"):
        tpipe.run_series_pipelined(CFG, recs(), chunk=chunk, device="cpu")


@pytest.mark.parametrize("chunk", [None, 2])
def test_producer_exception_propagates(chunk):
    def bad_records():
        yield from _records(3)
        raise RuntimeError("forcing file truncated")

    with pytest.raises(RuntimeError, match="truncated"):
        tpipe.run_series_pipelined(CFG, bad_records(), chunk=chunk,
                                   device="cpu")


def test_without_a_gpu_the_default_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.run_series_pipelined(CFG, _records(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.prefetch_to_device(_records(2))


# ---------------------------------------------------------------------------
# on the card (run with -m cuda; skipped without a GPU)
# ---------------------------------------------------------------------------

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the streams, pinned staging and "
                    "kernel 1 run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("chunk", [None, 3])
def test_streamed_fused_on_gpu_equals_resident_series(chunk, dtype):
    """7 records (per record, or chunks of 3, 3 and 1) through a ring of two
    staging buffers and a collector ring of two, so each is refilled, equal
    the device-resident fused series bitwise, with one launch of kernel 1
    per record; every returned array is pageable memory of its own (no view
    of a pinned buffer the collector reuses)."""
    _cuda_or_skip()
    from aerobulk_tpu_torch import api as tapi
    from aerobulk_tpu_torch.kernels import fused as tfused
    shape = (37, 129)
    recs = list(_records(7, dtype, shape=shape))
    lon = _lon(shape).astype(dtype)
    launches = tfused.LAUNCHES
    got, st = tpipe.run_series_pipelined(CFG, iter(recs), chunk=chunk,
                                         backend="fused", lon=lon,
                                         buffer_size=1, inflight=1)
    assert tfused.LAUNCHES - launches == 7
    for r in got:
        for v in r.values():
            assert v.flags.owndata and not torch.from_numpy(v).is_pinned()
    assert st.dT_wl.device.type == "cuda"
    fc = {k: torch.as_tensor(np.stack([r[k] for r in recs]), device="cuda")
          for k in tpipe._FORCING}
    out, ref_st = tapi.run_series(
        CFG, fc, isecday_utc=[int(r["isecday_utc"]) for r in recs],
        lon=torch.as_tensor(lon, device="cuda"), backend="fused")
    got = _joined(got, chunk)
    ref = {"QL": out.QL, "QH": out.QH, "Evap": out.Evap,
           "Tau": torch.hypot(out.Tau_x, out.Tau_y)}
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], ref[k].cpu().numpy(), k)
    for a, b in zip(st, ref_st):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["i16", "i8d"])
def test_recon_wire_on_gpu_close_to_cpu(wire):
    """The device decode on the card against the same decode on the CPU:
    i16 within 1 ulp, i8d (whose cumsum may add in another order on the
    card) within 2 ulp, NaN at the same points."""
    _cuda_or_skip()
    v = _pack_fields()["diurnal_sw"].astype(np.float32)
    v[3, 4] = np.nan
    packed = tpipe._pack_wire({"x": v}, wire)
    tensors = lambda dev: {key: torch.as_tensor(a, device=dev)
                           for key, a in packed.items()}
    got = tpipe._unpack_staged(tensors("cuda"), wire)["x"].cpu().numpy()
    ref = tpipe._unpack_staged(tensors("cpu"), wire)["x"].numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_array_max_ulp(got[ok], ref[ok],
                                    maxulp=1 if wire == "i16" else 2)


@pytest.mark.cuda
def test_collect_wire_i16_on_gpu_matches_cpu():
    """The collected fluxes of collect_wire='i16' on the card against the
    exact collection: within one quantization step of each field."""
    _cuda_or_skip()
    recs = list(_records(5, np.float32, shape=(16, 40)))
    kw = dict(chunk=2, backend="fused", lon=_lon((16, 40)).astype(np.float32))
    exact, _ = tpipe.run_series_pipelined(CFG, iter(recs), **kw)
    packed, _ = tpipe.run_series_pipelined(CFG, iter(recs),
                                           collect_wire="i16", **kw)
    exact, packed = _joined(exact, True), _joined(packed, True)
    for k in FIELDS:
        assert packed[k].dtype == np.float32
        step = (exact[k].max() - exact[k].min()) / 65534.0
        np.testing.assert_allclose(packed[k], exact[k], rtol=0,
                                   atol=1.01 * step, err_msg=k)
