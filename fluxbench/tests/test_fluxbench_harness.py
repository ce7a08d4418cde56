"""The harness itself on the CPU: nothing of fluxbench imports the JAX
package or the repository's bench scripts; every cell finds its config,
mix, entry, metrics and limits by the names BENCHMARK.json gives; the
copied forcing is, bit for bit, the program's streamed forcing; a run
without a card prints no result; and the card-only run of a cell."""

import ast
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from aerobulk_tpu_torch import measure
from fluxbench import forcing
from fluxbench.run import FORBIDDEN, HERE, ROOT, Cell, forbidden_modules, \
    read_json

BENCH = read_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
#: modules of the repository the benchmark may not read or run
NOT_READ = ("bench", "bench_baseline", "chip_smoke", "grad_stage_cost")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(tests=False):
    return [p for p in HERE.rglob("*.py") if tests or "tests" not in p.parts]


def test_nothing_imports_the_jax_package():
    """Compared by whole top-level name: aerobulk_tpu_torch is allowed,
    aerobulk_tpu is not."""
    for path in _sources(tests=True):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN + NOT_READ, (path, name)
    reference = HERE / "reference"
    for path in reference.glob("*.py"):
        for name in _imports(path):
            assert not name.startswith("aerobulk_tpu"), (path, name)


def test_the_guard_compares_whole_names(monkeypatch):
    assert "aerobulk_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "aerobulk_tpu_torch_lookalike", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "aerobulk_tpu.api", sys)
    assert forbidden_modules() == ["aerobulk_tpu"]


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_finds_its_files_by_name(workload):
    cell = Cell(BENCH, workload)
    assert cell.cfg["name"] == cell.spec["config"]
    assert cell.chips == 1
    assert callable(cell.entry.Call)
    for traced in (False, True):
        for spec, reader in cell.readers(traced):
            assert callable(reader.read), spec["name"]
    names = {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "points_per_s"} <= names
    assert cell.per_layer
    limits = cell.limits()
    assert limits and all(v["limit"] is not None for v in limits.values())


def test_benchmark_json_names_only_its_own_files():
    for c in BENCH["configs"]:
        assert c["file"].startswith("fluxbench/configs/")
        cfg = read_json(ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] == []
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("seed", (42, 2 ** 31 + 11))
def test_forcing_is_the_programs_streamed_forcing(seed):
    shape = (7, 11)
    mix = read_json(HERE / "traffic" / "streamed_2day.json")
    base = forcing.base_fields(mix, seed, shape)
    offs = forcing.offsets(mix, mix["records"])
    want_base, want_lon, want_offs = measure.streamed_forcing(
        mix["records"], seed=seed, shape=shape)
    assert np.array_equal(base.pop("lon"), want_lon)
    assert base.keys() == want_base.keys()
    for k in base:
        assert base[k].dtype == np.float32
        assert np.array_equal(base[k], want_base[k]), k
    for k in offs:
        assert np.array_equal(offs[k], want_offs[k]), k
    base["lon"] = want_lon
    got = list(forcing.stream_records(base, offs, 30, start=3))
    want = list(measure.stream_records(want_base, want_offs, 30, start=3))
    for g, w in zip(got, want, strict=True):
        assert g.keys() == w.keys()
        for k in g:
            assert np.array_equal(g[k], w[k]), k


def test_every_mix_draws_the_same_fields():
    mixes = [read_json(p) for p in (HERE / "traffic").glob("*.json")]
    assert len({json.dumps(m["fields"]) for m in mixes}) == 1
    fields, lon, isd = forcing.series(mixes[0], 5, (3, 4))
    assert lon.shape == (3, 4)
    assert all(v.shape == (mixes[0]["records"], 3, 4) for v in fields.values())
    assert isd[:3] == [0, 3600, 7200]


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA device" in r.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card(workload):
    """One short run of each cell through the command, as the driver runs
    it: a result line that is correct and names the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        workload, "--seed", "123456789", "--seconds", "2",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=1200, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0, line
    assert line["device"]["platform"] == "gpu"
