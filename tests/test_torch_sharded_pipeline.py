"""The sharded streamed feed of ``aerobulk_tpu_torch.pipeline``
(``run_series_pipelined(sharding=...)``) on four gloo ranks on the CPU,
against ``aerobulk_tpu.pipeline``'s unsharded feed and the port's plain
feed.

The ranks are this file run as a script (``python
tests/test_torch_sharded_pipeline.py <init> <outdir> <rank>``), started once
for the whole file: a (2, 2) mesh over a 7 x 13 grid, 3 hourly fp64 records
in chunks of 2 (a full chunk and a short one), COARE 3.6 + skin.  Each
rank's records hold only its own slab, and its record source asserts so.

Tolerances:
  * the exact wire, gathered, against the reference's unsharded feed: rtol
    1e-12 (docs/PARITY.md §1), atol 1e-12 of the largest magnitude where a
    field crosses zero (tests/test_torch_pipeline.py's);
  * the packed wires: each rank's blocks bitwise equal to the port's plain
    feed of that rank's slab (each rank packs its own slab); ``i16``
    gathered against the reference's exact feed at the reference's own
    bound for its sharded ``i16`` feed (tests/test_pipeline.py:404-413:
    rtol 1e-4, atol max(span / 6.5e4, 1e-4));
  * resumes from a user state, DTensors or local blocks: bitwise.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from aerobulk_tpu_torch import pipeline as tpipe
from aerobulk_tpu_torch import sharding as tsh
from aerobulk_tpu_torch.api import AeroBulkConfig
from aerobulk_tpu_torch.skin import SkinState

WORLD, MESH = 4, (2, 2)
NT, SHAPE, CHUNK = 3, (7, 13), 2
FIELDS = ("QL", "QH", "Tau", "Evap")
_CROSSING = ("QL", "QH", "Evap", "dT_wl", "Qnt_ac")
CFG = AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=5,
                     use_skin=True)
#: (wire, collect_wire) of each run on the ranks
RUNS = (("f32", "f32"), ("i16", "f32"), ("i8d", "f32"), ("f32", "i16"))


def _lon():
    return np.linspace(0.0, 350.0, int(np.prod(SHAPE))).reshape(SHAPE)


def _records(start=0, stop=NT):
    """Hourly fp64 records from 10 UTC of the whole grid: a drifting SST, a
    wobbling air temperature and the sun following each point's local
    day, so the warm layer builds at some points."""
    rng = np.random.default_rng(11)
    base = {
        "sst": 290.0 + 10.0 * rng.random(SHAPE),
        "t_zt": 289.0 + 10.0 * rng.random(SHAPE),
        "hum_zt": 0.005 + 0.010 * rng.random(SHAPE),
        "U_zu": rng.normal(3.0, 2.0, SHAPE),
        "V_zu": rng.normal(0.0, 2.0, SHAPE),
        "slp": 99000.0 + 3000.0 * rng.random(SHAPE),
        "rad_lw": 350.0 + 60.0 * rng.random(SHAPE),
    }
    rsw0 = 600.0 + 300.0 * rng.random(SHAPE)
    for jt in range(start, stop):
        local_h = np.mod(10 + jt + _lon() / 15.0, 24.0)
        sun = np.clip(np.cos((local_h - 12.0) * np.pi / 12.0), 0.0, None)
        rec = {k: v + 0.01 * jt * np.abs(v).mean() for k, v in base.items()}
        rec["t_zt"] = base["t_zt"] + 0.3 * np.sin(2 * np.pi * jt / 24)
        rec["rad_sw"] = rsw0 * sun
        rec["isecday_utc"] = np.int32(((10 + jt) * 3600) % 86400)
        yield rec


def _slab_records(ys, xs, start=0, stop=NT):
    """The rank's record source: its own slab of each record, and nothing
    else."""
    want = (ys.stop - ys.start, xs.stop - xs.start)
    for rec in _records(start, stop):
        slab = {k: (np.ascontiguousarray(v[ys, xs]) if np.ndim(v) else v)
                for k, v in rec.items()}
        assert all(np.shape(v) == want for v in slab.values() if np.ndim(v))
        yield slab


# ---------------------------------------------------------------------------
# the rank program
# ---------------------------------------------------------------------------

def _rank_main(init, outdir, rank):
    torch.set_num_threads(1)
    tsh.init_distributed(init, WORLD, rank, device_type="cpu")
    mesh = tsh.make_grid_mesh("cpu", MESH)
    sharding = tsh.grid_sharding(mesh)
    ys, xs = tsh.local_grid_slices(sharding, SHAPE)
    lon = np.ascontiguousarray(_lon()[ys, xs])
    arrays = {}
    seen = {"slices": [ys.start, ys.stop, xs.start, xs.stop]}
    kw = dict(chunk=CHUNK, backend="fused", lon=lon)

    def keep(prefix, results, state):
        for k in FIELDS:
            arrays[f"{prefix}_{k}"] = np.concatenate([r[k] for r in results])
        for n, x in zip(SkinState._fields, state):
            arrays[f"{prefix}_{n}"] = (x.to_local() if isinstance(
                x, tsh.DTensor) else x).numpy()

    for wire, cwire in RUNS:
        tag = f"{wire}_{cwire}"
        res, st = tpipe.run_series_pipelined(
            CFG, _slab_records(ys, xs), sharding=sharding, wire=wire,
            collect_wire=cwire, **kw)
        keep(f"sharded_{tag}", res, st)
        seen[f"{tag}_state"] = [type(st.dT_wl).__name__,
                                list(st.dT_wl.shape),
                                str(st.dT_wl.placements)]
        seen[f"{tag}_chunks"] = len(res)
        # the plain feed of this rank's slab, on this rank alone
        res, st = tpipe.run_series_pipelined(
            CFG, _slab_records(ys, xs), wire=wire, collect_wire=cwire,
            device="cpu", **kw)
        keep(f"plain_{tag}", res, st)

    # resumes: 2 records, then the last from the returned DTensor state or
    # from the rank's local blocks of it
    _, mid = tpipe.run_series_pipelined(
        CFG, _slab_records(ys, xs, 0, 2), sharding=sharding, **kw)
    for how, state in (("dtensor", mid),
                       ("local", SkinState(*(x.to_local().numpy()
                                             for x in mid)))):
        res, st = tpipe.run_series_pipelined(
            CFG, _slab_records(ys, xs, 2, NT), skin_state=state,
            sharding=sharding, **kw)
        keep(f"resume_{how}", res, st)

    for backend in ("fused", "eager"):
        try:
            tpipe.run_series_pipelined(CFG, _slab_records(ys, xs),
                                       sharding=sharding, backend=backend)
        except ValueError as e:
            seen[f"per_record_{backend}"] = str(e)

    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as fh:
        json.dump(seen, fh)
    torch.distributed.destroy_process_group()
    print(f"RANK {rank} OK", flush=True)


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from aerobulk_tpu_torch.distributed_worker import spawn
    out = tmp_path_factory.mktemp("sharded_feed")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    spawn([os.path.abspath(__file__), f"file://{out}/rendezvous", str(out)],
          WORLD, timeout=240, env=env)
    arrays, seen = [], []
    for r in range(WORLD):
        with np.load(out / f"rank{r}.npz") as z:
            arrays.append(dict(z))
        seen.append(json.loads((out / f"rank{r}.json").read_text()))
    return arrays, seen


def _gather(ranks, key):
    arrays, seen = ranks
    full = np.full(arrays[0][key].shape[:-2] + SHAPE, np.nan)
    for a, s in zip(arrays, seen):
        y0, y1, x0, x1 = s["slices"]
        full[..., y0:y1, x0:x1] = a[key]
    return full


@pytest.fixture(scope="module")
def jax_feed():
    """The reference's unsharded exact feed over the same records."""
    import jax.numpy as jnp
    from aerobulk_tpu import pipeline as jpipe
    from aerobulk_tpu.api import AeroBulkConfig as JConfig
    cfg = JConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=5, use_skin=True)
    res, st = jpipe.run_series_pipelined(cfg, _records(), chunk=CHUNK,
                                         lon=jnp.asarray(_lon()))
    return {**{k: np.concatenate([np.asarray(r[k]) for r in res])
               for k in FIELDS},
            **{n: np.asarray(x) for n, x in zip(SkinState._fields, st)}}


def _close(name, got, ref, rtol=1e-12):
    atol = rtol * np.max(np.abs(ref)) if name in _CROSSING else 0.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("name", FIELDS + SkinState._fields)
def test_exact_wire_matches_jax_unsharded(ranks, jax_feed, name):
    got = _gather(ranks, f"sharded_f32_f32_{name}")
    assert not np.isnan(got).any()
    _close(name, got, jax_feed[name])
    if name == "dT_wl":
        assert np.max(got) > 0.0          # a warm layer built


@pytest.mark.parametrize("wire,collect_wire", RUNS)
def test_each_rank_runs_the_plain_feed_of_its_slab(ranks, wire,
                                                   collect_wire):
    """Every wire, per rank: the sharded feed's blocks equal the plain
    feed of the rank's slab bitwise (each rank stages, packs and decodes
    only its own slab)."""
    arrays, seen = ranks
    tag = f"{wire}_{collect_wire}"
    for a, s in zip(arrays, seen):
        assert s[f"{tag}_chunks"] == 2
        for k in FIELDS + SkinState._fields:
            np.testing.assert_array_equal(a[f"sharded_{tag}_{k}"],
                                          a[f"plain_{tag}_{k}"], k)
            dtype = np.float64 if tag == "f32_f32" else np.float32
            if k in FIELDS:
                assert a[f"sharded_{tag}_{k}"].dtype == dtype


def test_i16_wire_within_the_references_sharded_bound(ranks, jax_feed):
    for k in FIELDS:
        got = _gather(ranks, f"sharded_i16_f32_{k}")
        ref = jax_feed[k]
        span = float(ref.max() - ref.min()) + 1e-6
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=max(span / 6.5e4, 1e-4), err_msg=k)


def test_final_state_is_a_dtensor_of_the_grid(ranks):
    _, seen = ranks
    for s in seen:
        for wire, cwire in RUNS:
            assert s[f"{wire}_{cwire}_state"] == [
                "DTensor", list(SHAPE), "(Shard(dim=0), Shard(dim=1))"]


@pytest.mark.parametrize("how", ["dtensor", "local"])
def test_resume_from_a_user_state_equals_one_stream(ranks, how):
    for k in FIELDS + SkinState._fields:
        one = _gather(ranks, f"sharded_f32_f32_{k}")
        got = _gather(ranks, f"resume_{how}_{k}")
        np.testing.assert_array_equal(got, one[2:] if k in FIELDS else one,
                                      k)


@pytest.mark.parametrize("backend", ["fused", "eager"])
def test_per_record_over_several_ranks_raises(ranks, backend):
    _, seen = ranks
    for s in seen:
        assert "use chunk=1" in s[f"per_record_{backend}"]


def test_one_rank_sharding_is_the_plain_feed():
    """A one-rank mesh degrades to the plain feed: plain tensors, the same
    numbers; a sharding of other placements is refused."""
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("gy", "gx"), _init_backend=False,
                      _rank=0)
    kw = dict(chunk=CHUNK, backend="fused", lon=_lon(), device="cpu")
    got, st = tpipe.run_series_pipelined(
        CFG, _records(), sharding=tsh.grid_sharding(mesh), **kw)
    ref, ref_st = tpipe.run_series_pipelined(CFG, _records(), **kw)
    assert not isinstance(st.dT_wl, tsh.DTensor)
    for a, b in zip(got, ref):
        for k in FIELDS:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(st, ref_st):
        assert torch.equal(a, b)
    four = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("gy", "gx"), _init_backend=False,
                      _rank=0)
    with pytest.raises(ValueError, match="placements"):
        tpipe.run_series_pipelined(CFG, _records(),
                                   sharding=tsh.replicated(four), **kw)


if __name__ == "__main__":
    _rank_main(*sys.argv[1:3], int(sys.argv[3]))
