"""aerobulk_tpu_torch.bench and pin_bench_matrix against the JAX package's
bench.py and tools/pin_bench_matrix.py, on the CPU (the bench itself runs
only on the card; its ``cuda`` test runs ``--all`` there).

Tolerances: the forcing of every mode bitwise; ``parity_fields`` against
bench.py's ``_parity_fields`` at rtol 1e-12 (bench.py adds 1e-30 to its
median and rounds ``parity_max_by_var`` to 8 decimals: atol 5e-9 there);
the bf16 precision budget of the port's eager path within a factor of 2 of
JAX's jit path on the same inputs (each rounds in its own order: measured
ratios 0.79-0.89 on these inputs).
"""

import importlib.util
import inspect
import json
import re
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from aerobulk_tpu_torch import bench as tbench
from aerobulk_tpu_torch import cli as tcli
from aerobulk_tpu_torch import measure
from aerobulk_tpu_torch import pin_bench_matrix as tpin
from aerobulk_tpu_torch.api import AeroBulkConfig
from aerobulk_tpu_torch.kernels import fused as kfused

REPO = Path(__file__).resolve().parent.parent
FULL = (721, 1440)
STATELESS = (((512, 32, 128), "ncar"), ((32, 181, 360), "coare3p0"))
BULK = (("sst", "sst"), ("t_zt", "t"), ("hum_zt", "q"), ("U_zu", "u"),
        ("V_zu", "v"), ("slp", "slp"))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's bench.py, jax.numpy and run_series, imported here
    (the ``cuda`` test runs where jax is not installed)."""
    import jax.numpy as jnp

    import bench
    from aerobulk_tpu.api import AeroBulkConfig, run_series
    return types.SimpleNamespace(bench=bench, jnp=jnp, Config=AeroBulkConfig,
                                 run_series=run_series)


def _bench_lines(jx, fn, first, stop):
    """Run the lines of bench.py's ``fn`` from the one holding ``first`` up
    to the one holding ``stop``; returns their names."""
    src = inspect.getsource(fn).splitlines()
    i = next(k for k, ln in enumerate(src) if first in ln)
    j = next(k for k, ln in enumerate(src) if k > i and stop in ln)
    scope = {"np": np, "jnp": jx.jnp, "shape": FULL,
             "dtype": jx.jnp.float32, "nrec": tbench.NREC}
    exec(textwrap.dedent("\n".join(src[i:j])), scope)
    return scope


def _equal(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)


def test_headline_forcing_is_bench_main(jax_side):
    ref = _bench_lines(jax_side, jax_side.bench.main,
                       "rng = np.random.default_rng(42)",
                       "cfg = AeroBulkConfig")
    got = tbench.headline_forcing("cpu", FULL)
    for x, name in zip(got, ("sst", "t", "q", "u", "v", "slp", "rsw", "rlw",
                             "lon")):
        _equal(x, ref[name])


@pytest.mark.parametrize("cold", [False, True], ids=["warm", "cold"])
def test_grid_forcing_is_mk_inputs(cold, jax_side):
    """--all rows 3-4 and --grad (warm, seed 42); rows 5-6 (cold, with
    Ts_i = min(sst, 271 K) as bench.py sets it)."""
    jnp = jax_side.jnp
    ref = jax_side.bench._mk_inputs(FULL, jnp.float32, cold=cold)
    if cold:
        got = measure.cold_forcing(FULL, "cpu", torch.float32)
        names = ("Ts_i", "sst", "t", "q", "u", "v", "slp", "frice")
        ref["Ts_i"] = jnp.minimum(ref["sst"], 271.0)
        got = dict(zip(names, got))
    else:
        got = measure.mk_inputs(FULL, "cpu", torch.float32)
        assert set(got) == set(ref)
    for name, x in got.items():
        _equal(x, ref[name])


@pytest.mark.parametrize("shape,algo", STATELESS, ids=["ncar", "coare3p0"])
def test_stateless_forcing_is_mk_inputs(shape, algo, jax_side):
    """--all rows 1-2 and --bf16: seed 7, and the bf16 rounding of it."""
    jnp = jax_side.jnp
    ref = jax_side.bench._mk_inputs(shape, jnp.float32, seed=7)
    got = measure.month_forcing(shape, "cpu", torch.float32)
    for name, key in BULK:
        _equal(got[name], ref[key])
        _equal(got[name].to(torch.bfloat16).float(),
               ref[key].astype(jnp.bfloat16).astype(jnp.float32))


def test_streamed_forcing_is_bench_main_streamed(jax_side):
    ref = _bench_lines(jax_side, jax_side.bench.main_streamed,
                       "rng = np.random.default_rng", "def records(n)")
    base, lon, offs = measure.streamed_forcing(tbench.NREC)
    for name in base:
        _equal(base[name], ref["base"][name])
    _equal(lon, ref["lon"])
    for name, key in (("sst", "sst_off"), ("t_zt", "t_off"),
                      ("rad_sw", "r_fac")):
        _equal(offs[name], ref[key])


@pytest.mark.parametrize("kind", ["dense", "mostly_zero", "zero"])
def test_field_scale_is_the_gate_rule(kind):
    """``measure.field_scale`` (the scale of parity_fields and of
    chip_smoke.py's diff_stats): numpy's median magnitude over the nonzero
    points, significance above 10% of it, 1e-6 in a field zero
    everywhere."""
    rng = np.random.default_rng(5)
    ref = rng.normal(0.0, 3.0, 1001)
    if kind != "dense":
        ref[rng.random(ref.size) < (0.9 if kind == "mostly_zero" else 2)] = 0
    scale, thr, zero_field = measure.field_scale(torch.from_numpy(ref))
    nonzero = np.abs(ref[ref != 0])
    want = float(np.median(nonzero)) if nonzero.size else 0.0
    assert scale == want and zero_field == (kind == "zero")
    assert thr == (1e-6 if kind == "zero" else 0.1 * want)


@pytest.mark.parametrize("error,significant", [(1e-5, False), (10.0, True)],
                         ids=["rounding", "tenfold"])
def test_grad_sig_on_a_heavy_tailed_field(error, significant):
    """``measure.grad_sig``: a gradient field heavy-tailed around a median
    of 1, with one point at 1e5 times it.  fp32's accumulated rounding there
    (relative 1e-5) is not significant, though ``field_scale``'s rule
    calls it so (1 against 0.1); a tenfold error there is significant, and
    so is a value that is not finite only in fp32."""
    rng = np.random.default_rng(9)
    ref = rng.lognormal(0.0, 1.0, 2001) * rng.choice([-1.0, 1.0], 2001)
    ref[1000] = 1e5 * np.median(np.abs(ref))
    got = ref * (1.0 + 1e-7 * rng.standard_normal(ref.size))
    got[1000] = ref[1000] * (1.0 + error)
    sig, thr, m = measure.grad_sig(torch.from_numpy(got),
                                   torch.from_numpy(ref))
    assert m == pytest.approx(float(np.median(np.abs(ref))), rel=1e-12)
    assert thr[1000] == pytest.approx(0.1 * abs(ref[1000]))
    assert int(sig.sum()) == int(significant) and bool(sig[1000]) == \
        significant
    _, field_thr, _ = measure.field_scale(torch.from_numpy(ref))
    assert abs(got[1000] - ref[1000]) > field_thr
    got[7] = np.nan
    sig, _, _ = measure.grad_sig(torch.from_numpy(got), torch.from_numpy(ref))
    assert bool(sig[7])
    # a point where the reference is not finite is not compared
    ref[8] = np.inf
    sig, _, _ = measure.grad_sig(torch.from_numpy(got), torch.from_numpy(ref))
    assert not bool(sig[8])


def test_grad_gate_counts_against_fp64():
    """``bench._grad_gate`` with the fp64 yardstick: ``sig_frac_vs_fp64``
    is the fraction ``measure.grad_sig`` marks; the median/p99 gate against
    the eager fp32 gradient is unchanged, and ``measure.grad_sig_ok`` takes
    twice the eager gradient's fraction up to 1e-2."""
    rng = np.random.default_rng(4)
    yard = rng.lognormal(0.0, 2.0, 20000)
    got = (yard * (1.0 + 1e-6 * rng.standard_normal(yard.size))).astype(
        np.float32)
    got[[3, 300, 3000, 6000, 9000]] *= 10.0
    eager = yard.astype(np.float32)
    gate = tbench._grad_gate(torch.from_numpy(got), torch.from_numpy(eager),
                             torch.from_numpy(yard))
    assert gate["parity_ok"]
    assert gate["sig_frac_vs_fp64"] == 5 / 20000
    assert "sig_frac_vs_fp64" not in tbench._grad_gate(got, eager)
    assert not measure.grad_sig_ok(2.5e-4, 0.0)
    assert measure.grad_sig_ok(2.5e-4, 1.25e-4)
    assert measure.grad_sig_ok(1e-4, 0.0)
    assert not measure.grad_sig_ok(2e-2, 1.5e-2)


def _stub_bench(monkeypatch, niter=5):
    """A Bench without a card: the C baseline's line stubbed, every row's
    measurement a single number, the forcing on the CPU at 4 x 8."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "stub")
    monkeypatch.setattr(tbench, "NY", 4)
    monkeypatch.setattr(tbench, "NX", 8)
    b = object.__new__(tbench.Bench)
    b.args = types.SimpleNamespace(niter=niter)
    b.dev, b.check, b.eager, b.backend = torch.device("cpu"), False, False, \
        "fused"
    b.card, b.host_cpu, b.lines = {"name": "stub", "power_limit": "0 W"}, \
        "stub cpu", []
    b.baseline = {"value": 2e5, "points": 200000, "steps": 5, "niter": 5}
    b.stateful = lambda cfg, fields, reps=tbench.REPS: {"value": 4e9}
    b.calls = lambda *a: {"value": 4e9}
    return b


def test_emit_labels_the_baseline_workload(monkeypatch, capsys):
    """Every line names the C baseline's workload and gives its points/s;
    ``vs_baseline`` is not null only on the rows of that workload (the
    headline and ``--all``'s COARE 3.6 + skin row at niter 5), and every
    other row says why in ``vs_baseline_note``."""
    b = _stub_bench(monkeypatch)
    tbench.main_headline(b)
    tbench.main_all(b)
    b20 = _stub_bench(monkeypatch, niter=20)
    tbench.main_headline(b20)
    lines = b.lines + b20.lines
    assert len(lines) == 8 and len(capsys.readouterr().out.splitlines()) == 8
    ratio = {(r["metric"], r.get("niter")): r["vs_baseline"] for r in lines}
    assert {k for k, v in ratio.items() if v is not None} == {
        ("coare3p6_skin_0p25deg_grid_points_per_s_per_chip", 5),
        ("coare3p6_skin_0p25deg_points_per_s", None)}
    for r in lines:
        assert r["baseline_cpu_points_per_s"] == 2e5
        assert r["baseline_workload"].startswith(
            "COARE 3.6 + cool skin + warm layer, niter 5, fp64 C point loop "
            "(bench_baseline/coare36_skin_baseline.c), 200000 points x 5 "
            "records, cc -O3")
        if r["vs_baseline"] is None:
            assert r["vs_baseline_note"]
        else:
            assert r["vs_baseline"] == 4e9 / 2e5
            assert "vs_baseline_note" not in r
    assert lines[-1]["vs_baseline_note"] == \
        "niter 20: the C baseline iterates 5 times"


def test_every_row_decides_its_baseline():
    """Every ``emit`` call of the bench's modes says how its row's workload
    differs from the C baseline's (``differs=``): a new row cannot get a
    cross-workload ratio by default."""
    import ast
    tree = ast.parse(Path(tbench.__file__).read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute) and n.func.attr == "emit"]
    assert calls
    for call in calls:
        assert [k.arg for k in call.keywords] == ["differs"], call.lineno


@pytest.mark.parametrize("chunk", [None, 2], ids=["records", "chunks"])
def test_feed_times_its_producer(chunk):
    """``run_series_pipelined(producer_seconds=...)``, the producer's
    seconds of the streamed mode: one entry per staged record or chunk, and
    the same results as without it."""
    base, lon, offs = measure.streamed_forcing(6, shape=(4, 8))
    cfg = AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=2,
                         use_skin=True)
    kw = dict(chunk=chunk, lon=lon, device="cpu")
    seconds = []
    got, st = tbench.tpipe.run_series_pipelined(
        cfg, measure.stream_records(base, offs, 6), producer_seconds=seconds,
        **kw)
    ref, st_ref = tbench.tpipe.run_series_pipelined(
        cfg, measure.stream_records(base, offs, 6), **kw)
    assert len(seconds) == (6 if chunk is None else 3)
    assert all(s > 0 for s in seconds)
    for a, b in zip(got, ref):
        for k in a:
            _equal(a[k], b[k])
    for a, b in zip(st, st_ref):
        assert torch.equal(a, b)


def _seeded_fields(rng, n=4000):
    """Six fields like a step's outputs: one crossing zero, one small, none
    near-degenerate; the kernel's values within fp32-like noise and a few
    points far off."""
    ref = [rng.normal(50.0, 80.0, n), rng.normal(-5.0, 20.0, n),
           rng.normal(0.0, 0.1, n), 1e-5 * rng.random(n) + 1e-6,
           290.0 + rng.random(n), rng.normal(0.0, 1e3, n)]
    got = []
    for b in ref:
        a = b * (1.0 + 1e-6 * rng.standard_normal(n))
        a[rng.integers(0, n, 3)] *= 1.5
        got.append(a)
    return got, ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parity_fields_match_bench(seed, jax_side):
    got, ref = _seeded_fields(np.random.default_rng(seed))
    names = tuple(f"f{k}" for k in range(len(ref)))
    want = jax_side.bench._parity_fields(names, got, ref)
    have = tbench.parity_fields(names, got, ref)
    assert set(have) == set(want)
    for key in ("parity_median_rel", "parity_p99_rel", "parity_max_rel",
                "parity_worst_frac_abs_gt_10pct_median"):
        np.testing.assert_allclose(have[key], want[key], rtol=1e-12)
    assert have["parity_ok"] == want["parity_ok"]
    for name in names:
        np.testing.assert_allclose(have["parity_max_by_var"][name],
                                   want["parity_max_by_var"][name],
                                   rtol=1e-12, atol=5e-9)
        assert set(have["parity_frac_by_var"][name]) == \
            set(want["parity_frac_by_var"][name])
        for key, v in want["parity_frac_by_var"][name].items():
            np.testing.assert_allclose(have["parity_frac_by_var"][name][key],
                                       v, rtol=1e-12)


def test_parity_scale_of_a_mostly_zero_field(jax_side):
    """The deliberate difference: a Qnt_ac-like field, zero where no warm
    layer is built (70% of the points) and ~1e5 J/m^2 elsewhere, with fp32
    rounding in the kernel's values.  bench.py's rule takes the median over
    every point (0), holds the field absolutely at 1e-6 and reads the
    rounding as 30% significant; the port scales it by the median over the
    nonzero points and passes it."""
    rng = np.random.default_rng(3)
    b = np.where(rng.random(20000) < 0.7, 0.0, 1e5 * (1.0 + rng.random(20000)))
    ql = rng.normal(50.0, 80.0, 20000)
    got = [ql.astype(np.float32).astype(np.float64),
           b.astype(np.float32).astype(np.float64)]
    want = jax_side.bench._parity_fields(("QL", "Qnt_ac"), got, [ql, b])
    have = tbench.parity_fields(("QL", "Qnt_ac"), got, [ql, b])
    assert want["parity_frac_by_var"]["Qnt_ac"]["degenerate_zero_field"]
    assert want["parity_worst_frac_abs_gt_10pct_median"] > 0.25
    assert not want["parity_ok"]
    assert "degenerate_zero_field" not in have["parity_frac_by_var"]["Qnt_ac"]
    assert have["parity_worst_frac_abs_gt_10pct_median"] == 0.0
    assert have["parity_ok"]
    # a field zero everywhere is held absolutely in both
    z = np.zeros(100)
    assert tbench.parity_fields(("E",), [z + 1e-7], [z])["parity_ok"]
    assert not tbench.parity_fields(("E",), [z + 1e-5], [z])["parity_ok"]


@pytest.mark.parametrize("algo", ["ncar", "coare3p0"])
def test_bf16_budget_matches_jax(algo, jax_side):
    """bench.py main_bf16's budget (its lines, JAX's jit path) against the
    port's eager path on the same tiny inputs (seed 7)."""
    jnp = jax_side.jnp
    shape = (4, 16, 32)
    f32 = jax_side.bench._mk_inputs(shape, jnp.float32, seed=7)
    jcfg = jax_side.Config(algo=algo, niter=tbench.NITER, use_skin=False)
    outs = {}
    for dtype in (jnp.bfloat16, jnp.float32):
        out, _ = jax_side.run_series(
            jcfg, {k: f32[n].astype(dtype) for k, n in BULK},
            batch_records=True)
        outs[dtype] = [np.asarray(x, np.float64)
                       for x in (out.QL, out.QH, out.Tau_x)]
    rel = np.concatenate([
        (np.abs(x - y) / np.maximum(np.abs(y), 1e-3 * np.median(np.abs(y))))
        .ravel() for x, y in zip(outs[jnp.bfloat16], outs[jnp.float32])])
    want = {"bf16_vs_fp32_median_rel": float(np.median(rel)),
            "bf16_vs_fp32_p99_rel": float(np.percentile(rel, 99))}
    assert np.isfinite(rel).all()
    have = tbench.bf16_budget(
        AeroBulkConfig(algo=algo, niter=tbench.NITER, use_skin=False),
        measure.month_forcing(shape, "cpu", torch.float32))
    assert have["bf16_nonfinite_frac"] == 0.0
    for key, v in want.items():
        assert 0.5 * v <= have[key] <= 2.0 * v, (key, have[key], v)


def test_no_card_no_bench(monkeypatch, capsys):
    """Without a CUDA device the bench, ``cli bench`` and the matrix exit
    non-zero and name the card; ``cli --device cpu bench`` is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((tbench.main, []), (tbench.main, ["--all"]),
                       (tcli.main, ["bench", "--grad"]),
                       (tpin.main, [])):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code not in (0, None)
        assert re.search(r"no CUDA device.*card", str(exc.value.code))
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--device", "cpu", "bench"])
    assert exc.value.code != 0
    assert "no CPU route" in capsys.readouterr().err


def test_cli_bench_carries_bench_flags(capsys):
    """Every flag bench.py reads (its ``--jit`` is ``--eager``)."""
    flags = set(re.findall(r'"(--[a-z0-9-]+)', (REPO / "bench.py")
                           .read_text()))
    assert {"--all", "--grad", "--streamed", "--jit", "--wire-i16"} <= flags
    with pytest.raises(SystemExit) as exc:
        tcli.main(["bench", "--help"])
    assert exc.value.code == 0
    text = capsys.readouterr().out
    for flag in flags:
        assert ("--eager" if flag == "--jit" else flag) in text, flag


def test_matrix_modes_mirror_the_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_pin_bench_matrix", REPO / "tools" / "pin_bench_matrix.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tpin.MODES == tool.MODES
    assert tpin.OUT.name == "BENCH_TORCH_ALL.json"


def test_c_baseline_builds_and_parses(tmp_path):
    """The C baseline at a tiny size, with this machine's cc."""
    rec = tbench.cpu_baseline(2000, 1, build_dir=tmp_path)
    assert rec["metric"] == "cpu_baseline_coare3p6_skin"
    assert rec["points"] == 2000 and rec["steps"] == 1
    assert rec["niter"] == 5 and rec["value"] > 0
    built = list(tmp_path.iterdir())
    assert len(built) == 1 and built[0].name.startswith(
        "coare36_skin_baseline_")
    assert tbench.build_baseline(tmp_path) == built[0]     # reused


def test_timed_runs_refuse_other_launches(monkeypatch):
    """A row's timed runs must launch its kernel and nothing else: a run
    that took the plain path, or another kernel, fails."""
    monkeypatch.setattr(measure, "timed_call", lambda fn: (fn(), 1.0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)

    def launch(attr, n):
        def run():
            setattr(kfused, attr, getattr(kfused, attr) + n)
        return run

    assert tbench._timed_runs(launch("LAUNCHES", 20),
                              {"fused_step_ecmwf": 20}) == [1.0] * 7
    with pytest.raises(RuntimeError, match="must launch"):
        tbench._timed_runs(lambda: None, {"fused_step": 20})
    with pytest.raises(RuntimeError, match="must launch"):
        tbench._timed_runs(launch("BULK_LAUNCHES", 1), {"fused_step": 1})
    with pytest.raises(RuntimeError, match="no kernel"):
        tbench._timed_runs(launch("ICE_LAUNCHES", 1), {})


@pytest.mark.cuda
def test_bench_all_on_gpu():
    """``bench --all --no-check`` on the card: bench.py's six rows by name,
    each through its kernel, named card and measured baseline."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the bench measures the card")
    res = subprocess.run([sys.executable, "-m", "aerobulk_tpu_torch.bench",
                          "--all", "--no-check"], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines()
             if ln.startswith("{")]
    assert [(r["metric"], r["launches"]) for r in lines] == [
        ("ncar_small_grid_points_per_s", {"fused_bulk": 128}),
        ("coare3p0_bulk_1deg_points_per_s", {"fused_bulk": 32}),
        ("coare3p6_skin_0p25deg_points_per_s", {"fused_step": 20}),
        ("ecmwf_skin_0p25deg_points_per_s", {"fused_step_ecmwf": 20}),
        ("mixed_ice_ocean_0p25deg_points_per_s", {"fused_mixed": 10}),
        ("ice_lg15_0p25deg_points_per_s", {"fused_ice": 80})]
    for r in lines:
        assert r["backend"] == "fused" and r["repeats"] >= 7
        assert r["min"] <= r["value"] <= r["max"]
        assert r["baseline_cpu_points_per_s"] > 0
        assert r["card"]["name"] and r["card"]["power_limit"]
