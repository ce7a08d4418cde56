"""``aerobulk_tpu_torch.sharding`` on four gloo ranks on the CPU, against
``aerobulk_tpu.sharding`` and the port's unsharded runs.

The ranks are this file run as a script (``python tests/test_torch_sharding.py
<init> <outdir> <rank>``), started once for the whole file: a (2, 2) mesh
over a 7 x 13 grid (uneven on both axes), 3 hourly records, COARE 3.6 + skin
in fp64.  Each rank writes its local blocks and what it observed; the tests
below put the blocks together and compare.

Tolerances:
  * the sharded forward, gathered, against the reference's sharded series
    (``backend="jit"`` on a (2, 4) mesh of the conftest's 8 virtual
    devices): rtol 1e-12 (docs/PARITY.md §1), atol 1e-12 of the field's
    largest magnitude where a field crosses zero;
  * the sharded forward and gradient against the port's unsharded run:
    rtol 1e-13, the reference's own bound for sharded against unsharded
    (tests/test_pallas_kernel.py:310-343); atol 1e-13 of the largest
    magnitude where a field crosses zero;
  * layouts, padding, checkpoint round trips and resumes: exact.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from aerobulk_tpu_torch import pipeline as tpipe
from aerobulk_tpu_torch import sharding as tsh
from aerobulk_tpu_torch.api import AeroBulkConfig, init_skin_state, run_series
from aerobulk_tpu_torch.skin import (SkinState, load_skin_state_sharded,
                                     save_skin_state_sharded)

WORLD, MESH = 4, (2, 2)
NT, SHAPE = 3, (7, 13)
#: 5 rows over a (4, 1) mesh: blocks of 2, 2, 1 and 0 rows
EMPTY_ROWS = 5
#: the records of the sharded feed: a corner of the grid that the
#: reference's device_put lays on the (2, 2) mesh (it needs even blocks)
FEED = (6, 12)
#: the ranks of make_grid_mesh(devices=...), in mesh order
REVERSED = (3, 2, 1, 0)
NAMES = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "rad_sw", "rad_lw")
OUTS = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s")
_CROSSING = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "dT_wl", "Qnt_ac")
CFG = AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=5,
                     use_skin=True)
ISD = [5 * 3600, 43200, 82800]


def _problem():
    """The reference's uneven-grid forcing (tests/test_pallas_kernel.py:
    325-338, seed 53)."""
    rng = np.random.default_rng(53)
    shape = (NT,) + SHAPE
    f = {
        "sst": 285.0 + 15.0 * rng.random(shape),
        "t_zt": 284.0 + 16.0 * rng.random(shape),
        "hum_zt": 0.004 + 0.012 * rng.random(shape),
        "U_zu": rng.normal(0, 6, shape),
        "V_zu": rng.normal(0, 6, shape),
        "slp": 98000 + 4000 * rng.random(shape),
        "rad_sw": 500 * rng.random(shape),
        "rad_lw": 250 + 150 * rng.random(shape),
    }
    return f, 360.0 * rng.random(SHAPE)


def _loss(out):
    return (out.QL + out.QH + out.Tau_x).sum()


def _slices(ys, xs):
    return [ys.start, ys.stop, xs.start, xs.stop]


# ---------------------------------------------------------------------------
# the rank program
# ---------------------------------------------------------------------------

def _rank_main(init, outdir, rank):
    from torch.distributed.tensor.debug import CommDebugMode

    torch.set_num_threads(1)
    tsh.init_distributed(init, WORLD, rank, device_type="cpu")
    mesh = tsh.make_grid_mesh("cpu", MESH)
    f, lon = _problem()
    ft = {k: torch.as_tensor(v) for k, v in f.items()}
    lont = torch.as_tensor(lon)
    arrays, seen = {}, {}

    def keep(prefix, out, state):
        for n in OUTS:
            arrays[f"{prefix}_{n}"] = getattr(out, n).to_local().detach()
        for n, x in zip(SkinState._fields, state):
            arrays[f"{prefix}_{n}"] = x.to_local().detach()

    ys, xs = tsh.local_grid_slices(mesh, SHAPE)
    seen["slices"] = _slices(ys, xs)
    dt = tsh.shard_grid_inputs(mesh, ft)
    dlon = tsh.shard_grid_inputs(mesh, lont)
    seen["block"] = list(dt["sst"].to_local().shape)
    seen["lon_block"] = list(dlon.to_local().shape)

    # the forward series on DTensors, with every collective counted
    with CommDebugMode() as comm:
        out, st = tsh.sharded_run_series(mesh, CFG, dt, isecday_utc=ISD,
                                         lon=dlon, backend="eager")
    seen["collectives"] = comm.get_total_counts()
    seen["out_placements"] = str(out.QL.placements)
    seen["out_shape"] = list(out.QL.shape)
    keep("eager", out, st)
    # global tensors, distributed inside; the fused backend (its plain
    # version on the CPU)
    out_f, st_f = tsh.sharded_run_series(mesh, CFG, ft, isecday_utc=ISD,
                                         lon=lont, backend="fused")
    keep("fused", out_f, st_f)
    # each rank enters only its own slab
    slab = tsh.global_from_host_local(
        mesh, {k: v[:, ys, xs] for k, v in f.items()}, ndim=3)
    out_h, st_h = tsh.sharded_run_series(
        mesh, CFG, slab, isecday_utc=ISD,
        lon=tsh.global_from_host_local(mesh, lon[ys, xs]), backend="eager")
    keep("host_local", out_h, st_h)
    # one fused step
    with CommDebugMode() as comm:
        outs1, st1 = tsh.sharded_fused_flux_step(
            mesh, CFG, *(dt[n][0] for n in NAMES), lon=dlon,
            isecday_utc=ISD[0])
    seen["step_collectives"] = comm.get_total_counts()
    for n, x in zip(OUTS, outs1):
        arrays[f"step_{n}"] = x.to_local()
    for n, x in zip(SkinState._fields, st1):
        arrays[f"step_{n}"] = x.to_local()

    # the gradient of sum(QL + QH + Tau_x) through the fused backend
    sst = dt["sst"].detach().clone().requires_grad_()
    state0 = tsh.shard_grid_inputs(
        mesh, init_skin_state(CFG, SHAPE, torch.float64, "cpu"))
    state0 = SkinState(*(x.requires_grad_() for x in state0))
    out_g, _ = tsh.sharded_run_series(
        mesh, CFG, {**dt, "sst": sst}, isecday_utc=ISD, lon=dlon,
        skin_state=state0, backend="fused", fused_grad_backend="kernel")
    with CommDebugMode() as comm:
        grads = torch.autograd.grad(_loss(out_g), (sst, *state0))
    seen["grad_collectives"] = comm.get_total_counts()
    for n, g in zip(("sst",) + SkinState._fields, grads):
        arrays[f"grad_{n}"] = g.to_local()

    # checkpoints: the final state first, then overwritten at the same path
    # by the state after 2 records, which the last record resumes from
    ckpt = os.path.join(outdir, "ckpt")
    _, st_mid = tsh.sharded_run_series(
        mesh, CFG, {k: v[:2] for k, v in dt.items()}, isecday_utc=ISD[:2],
        lon=dlon, backend="eager")
    for n, x in zip(SkinState._fields, st_mid):
        arrays[f"mid_{n}"] = x.to_local()
    save_skin_state_sharded(ckpt, st)
    save_skin_state_sharded(ckpt, st_mid)
    like = tsh.shard_grid_inputs(mesh, SkinState(*(
        torch.zeros(SHAPE, dtype=torch.float64) for _ in SkinState._fields)))
    restored = load_skin_state_sharded(ckpt, like)
    seen["round_trip_bitwise"] = all(
        torch.equal(a.to_local(), b.to_local())
        for a, b in zip(restored, st_mid))
    seen["like_untouched"] = all(not x.to_local().any() for x in like)
    out_r, st_r = tsh.sharded_run_series(
        mesh, CFG, {k: v[2:] for k, v in dt.items()}, isecday_utc=ISD[2:],
        lon=dlon, skin_state=restored, backend="eager")
    seen["resume_bitwise"] = all(
        torch.equal(getattr(out_r, n).to_local(),
                    getattr(out, n).to_local()[2:]) for n in OUTS) and all(
        torch.equal(a.to_local(), b.to_local()) for a, b in zip(st_r, st))
    try:
        load_skin_state_sharded(ckpt, SkinState(*(
            torch.zeros(SHAPE, dtype=torch.float64)
            for _ in SkinState._fields)))
    except TypeError as e:
        seen["plain_like_error"] = str(e)

    # the (2, 2) checkpoint onto a (4, 1) mesh
    mesh41 = tsh.make_grid_mesh("cpu", (4, 1))
    ys41, xs41 = tsh.local_grid_slices(mesh41, SHAPE)
    seen["slices41"] = _slices(ys41, xs41)
    like41 = tsh.shard_grid_inputs(mesh41, SkinState(*(
        torch.zeros(SHAPE, dtype=torch.float64) for _ in SkinState._fields)))
    for n, x in zip(SkinState._fields,
                    load_skin_state_sharded(ckpt, like41)):
        arrays[f"ckpt41_{n}"] = x.to_local()

    # the sharded feed: every rank stages only its slab of each record
    recs = [{**{k: f[k][t, :FEED[0], :FEED[1]] for k in NAMES},
             "isecday_utc": ISD[t]} for t in range(NT)]
    for t, rec in enumerate(tpipe.prefetch_to_device(
            recs, sharding=tsh.grid_sharding(mesh))):
        for k in NAMES:
            arrays[f"feed{t}_{k}"] = rec[k].to_local()
        seen.setdefault("feed_isd", []).append(rec["isecday_utc"])
    seen["feed_shape"] = list(rec["sst"].shape)
    seen["feed_placements"] = str(rec["sst"].placements)
    seen["feed_slices"] = _slices(*tsh.local_grid_slices(mesh, FEED))

    # make_grid_mesh: the ranks in a given order, the dimensions named
    rev = tsh.make_grid_mesh("cpu", MESH, devices=REVERSED)
    seen["slices_reversed"] = _slices(*tsh.local_grid_slices(rev, SHAPE))
    seen["reversed_mesh"] = rev.mesh.tolist()
    named = tsh.make_grid_mesh("cpu", MESH, axis_names=("y", "x"))
    seen["named_dims"] = list(named.mesh_dim_names)
    try:
        tsh.grid_sharding(named)
    except ValueError as e:
        seen["named_grid_sharding_error"] = str(e)

    # an empty block: 5 rows over 4 ranks
    ye, xe = tsh.local_grid_slices(mesh41, (EMPTY_ROWS, SHAPE[1]))
    seen["slices_empty"] = _slices(ye, xe)
    for backend in ("eager", "fused"):
        out_e, st_e = tsh.sharded_run_series(
            mesh41, CFG, {k: v[:, :EMPTY_ROWS] for k, v in ft.items()},
            isecday_utc=ISD, lon=lont[:EMPTY_ROWS], backend=backend)
        keep(f"empty_{backend}", out_e, st_e)
        seen[f"empty_{backend}_shape"] = list(out_e.QL.shape)

    np.savez(os.path.join(outdir, f"rank{rank}.npz"),
             **{k: v.detach().numpy() for k, v in arrays.items()})
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as fh:
        json.dump(seen, fh)
    torch.distributed.destroy_process_group()
    print(f"RANK {rank} OK", flush=True)


# ---------------------------------------------------------------------------
# the parent: the ranks once, the references once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from aerobulk_tpu_torch.distributed_worker import spawn
    out = tmp_path_factory.mktemp("sharding")
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


def _gather(ranks, key, slices="slices", shape=SHAPE):
    """The whole field of ``key`` from each rank's block at its slices."""
    arrays, seen = ranks
    lead = arrays[0][key].shape[:-2]
    full = np.full(lead + tuple(shape), np.nan)
    for a, s in zip(arrays, seen):
        y0, y1, x0, x1 = s[slices]
        full[..., y0:y1, x0:x1] = a[key]
    return full


def _close(name, got, ref, rtol):
    ref = np.asarray(ref)
    atol = rtol * np.max(np.abs(ref)) if name in _CROSSING else 0.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded series (eager and fused), its gradient and one
    fused step, on the CPU."""
    from aerobulk_tpu_torch.kernels.fused import fused_flux_step
    f, lon = _problem()
    ft = {k: torch.as_tensor(v) for k, v in f.items()}
    lont = torch.as_tensor(lon)
    res = {}
    for backend in ("eager", "fused"):
        out, st = run_series(CFG, ft, isecday_utc=ISD, lon=lont,
                             backend=backend)
        res[backend] = {**{n: getattr(out, n).numpy() for n in OUTS},
                        **{n: x.numpy() for n, x in zip(SkinState._fields,
                                                        st)}}
    outs, st = fused_flux_step(CFG, *(ft[n][0] for n in NAMES), lon=lont,
                               isecday_utc=ISD[0])
    res["step"] = {**{n: x.numpy() for n, x in zip(OUTS, outs)},
                   **{n: x.numpy() for n, x in zip(SkinState._fields, st)}}
    sst = ft["sst"].clone().requires_grad_()
    # (the fresh state's zero fields are one tensor: a leaf each)
    state0 = SkinState(*(x.clone().requires_grad_() for x in init_skin_state(
        CFG, SHAPE, torch.float64, "cpu")))
    out, _ = run_series(CFG, {**ft, "sst": sst}, skin_state=state0,
                        isecday_utc=ISD, lon=lont, backend="fused",
                        fused_grad_backend="kernel")
    grads = torch.autograd.grad(_loss(out), (sst, *state0))
    res["grad"] = {n: g.numpy() for n, g in
                   zip(("sst",) + SkinState._fields, grads)}
    return res


# ---------------------------------------------------------------------------
# names, padding and layout
# ---------------------------------------------------------------------------

def test_every_name_of_the_reference_exists():
    from aerobulk_tpu import sharding as jsh
    missing = [n for n in jsh.__all__ if not hasattr(tsh, n)]
    assert not missing
    assert set(jsh.__all__) <= set(tsh.__all__)


def _fake_mesh(shape):
    """A DeviceMesh of ``shape`` seen from rank 0, with no process group
    (enough for the padding helpers, which read only its sizes)."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=("gy", "gx"), _init_backend=False,
                      _rank=0)


@pytest.mark.parametrize("grid", [(7, 13), (8, 16), (721, 30), (1, 3)])
@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8), (8, 1)])
def test_padding_equals_reference(grid, mesh_shape):
    """``_mesh_padding``, ``pad_grid_to_mesh`` (a 3-D, a 2-D, a 1-D and a
    0-D leaf) and ``unpad_grid`` against the reference's on a mesh of the 8
    virtual CPU devices: exact."""
    import jax.numpy as jnp
    from aerobulk_tpu import sharding as jsh
    jmesh = jsh.make_grid_mesh(shape=mesh_shape)
    tmesh = _fake_mesh(mesh_shape)
    assert tsh._mesh_padding(tmesh, *grid) == jsh._mesh_padding(jmesh, *grid)
    rng = np.random.default_rng(1)
    tree = {"series": rng.random((2,) + grid), "field": rng.random(grid),
            "vector": rng.random(5), "scalar": np.float64(3.0)}
    got = tsh.pad_grid_to_mesh(tmesh, {k: torch.as_tensor(v)
                                       for k, v in tree.items()})
    ref = jsh.pad_grid_to_mesh(jmesh, {k: jnp.asarray(v)
                                       for k, v in tree.items()})
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), k)
    back = tsh.unpad_grid({k: got[k] for k in ("series", "field")}, *grid)
    jback = jsh.unpad_grid({k: ref[k] for k in ("series", "field")}, *grid)
    for k in back:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))
        np.testing.assert_array_equal(back[k].numpy(), tree[k])


def _reference_blocks(mesh_shape, grid, order=None):
    """The logical blocks the reference's pad-then-slice leaves on each
    device of a mesh of ``mesh_shape`` (the first devices, or those of
    ``order`` in its order): {mesh coordinate: (y0, y1, x0, x1)}."""
    import jax
    from aerobulk_tpu import sharding as jsh
    n = int(np.prod(mesh_shape))
    devices = jax.devices()[:n] if order is None else \
        [jax.devices()[i] for i in order]
    jmesh = jsh.make_grid_mesh(devices, shape=mesh_shape)
    padded = jsh.pad_grid_to_mesh(jmesh, np.zeros(grid))
    arr = jsh.shard_grid_inputs(jmesh, padded)
    where = {d.id: tuple(int(i) for i in np.argwhere(jmesh.devices == d)[0])
             for d in jmesh.devices.flat}
    blocks = {}
    for s in arr.addressable_shards:
        (ys, xs) = s.index
        y0, y1 = ys.indices(padded.shape[0])[:2]
        x0, x1 = xs.indices(padded.shape[1])[:2]
        blocks[where[s.device.id]] = (min(y0, grid[0]), min(y1, grid[0]),
                                      min(x0, grid[1]), min(x1, grid[1]))
    return blocks


def test_rank_blocks_equal_the_references_pad_then_slice(ranks):
    """Each rank's DTensor block and ``local_grid_slices`` equal the block
    the reference's edge-pad-then-slice leaves on the device at the same
    mesh coordinate: on (2, 2) over 7 x 13, and on (4, 1) over 5 x 13,
    where the last block is empty."""
    _, seen = ranks
    for mesh_shape, grid, key in (((2, 2), SHAPE, "slices"),
                                  ((4, 1), SHAPE, "slices41"),
                                  ((4, 1), (EMPTY_ROWS, SHAPE[1]),
                                   "slices_empty")):
        ref = _reference_blocks(mesh_shape, grid)
        for r, s in enumerate(seen):
            coord = divmod(r, mesh_shape[1])
            assert tuple(s[key]) == ref[coord], (mesh_shape, r)
    for s in seen:
        y0, y1, x0, x1 = s["slices"]
        assert s["block"] == [NT, y1 - y0, x1 - x0]
        assert s["lon_block"] == [y1 - y0, x1 - x0]
    assert seen[3]["slices_empty"][:2] == [5, 5]


def test_make_grid_mesh_takes_devices_and_axis_names(ranks):
    """``make_grid_mesh(devices=REVERSED)`` puts the ranks in that order,
    so each rank's block is the one the reference's mesh over the same
    device order gives that device; ``axis_names`` names the dimensions,
    and the grid's placements then refuse the mesh, as the reference's
    grid_sharding refuses a mesh without "gy" and "gx"."""
    import jax
    from aerobulk_tpu import sharding as jsh
    _, seen = ranks
    ref = _reference_blocks(MESH, SHAPE, order=REVERSED)
    where = {r: divmod(i, MESH[1]) for i, r in enumerate(REVERSED)}
    for r, s in enumerate(seen):
        assert tuple(s["slices_reversed"]) == ref[where[r]], r
        assert s["reversed_mesh"] == [[3, 2], [1, 0]]
        assert s["named_dims"] == ["y", "x"]
        assert "no dimension named ['gx', 'gy']" in \
            s["named_grid_sharding_error"]
    jmesh = jsh.make_grid_mesh(jax.devices()[:4], shape=MESH,
                               axis_names=("y", "x"))
    assert jmesh.axis_names == ("y", "x")
    with pytest.raises(ValueError, match="not found in mesh"):
        jsh.grid_sharding(jmesh)


def test_prefetch_to_device_stages_each_ranks_slab(ranks):
    """``prefetch_to_device(sharding=grid_sharding(mesh))`` on each rank
    yields every grid field as a DTensor of the record's grid whose block
    is the rank's slab, bitwise the shard the reference's
    ``prefetch_to_device(sharding=...)`` puts on the device at the same
    mesh coordinate; the solar clock stays a host value."""
    import jax
    from aerobulk_tpu import pipeline as jpipe
    from aerobulk_tpu import sharding as jsh
    arrays, seen = ranks
    f, _ = _problem()
    recs = [{**{k: f[k][t, :FEED[0], :FEED[1]] for k in NAMES},
             "isecday_utc": ISD[t]} for t in range(NT)]
    jmesh = jsh.make_grid_mesh(jax.devices()[:WORLD], shape=MESH)
    coord = {d.id: tuple(int(i) for i in np.argwhere(jmesh.devices == d)[0])
             for d in jmesh.devices.flat}
    fed = list(jpipe.prefetch_to_device(
        recs, sharding=jsh.grid_sharding(jmesh)))
    for t, rec in enumerate(fed):
        assert int(rec["isecday_utc"]) == ISD[t]
        for k in NAMES:
            for shard in rec[k].addressable_shards:
                r = int(np.ravel_multi_index(coord[shard.device.id], MESH))
                np.testing.assert_array_equal(arrays[r][f"feed{t}_{k}"],
                                              np.asarray(shard.data))
    for s in seen:
        assert s["feed_isd"] == ISD
        assert s["feed_shape"] == list(FEED)
        assert s["feed_placements"] == "(Shard(dim=0), Shard(dim=1))"
    full = _gather(ranks, "feed2_sst", slices="feed_slices", shape=FEED)
    np.testing.assert_array_equal(full, recs[2]["sst"])


def test_prefetch_to_device_one_rank_mesh_is_plain():
    """A one-rank mesh takes the plain feed, as the reference's
    prefetch_to_device drops a one-device sharding: plain tensors, equal
    to the reference's arrays."""
    import jax
    from aerobulk_tpu import pipeline as jpipe
    from aerobulk_tpu import sharding as jsh
    f, _ = _problem()
    recs = [{k: f[k][t] for k in NAMES} for t in range(2)]
    mesh = _fake_mesh((1, 1))
    got = list(tpipe.prefetch_to_device(
        recs, sharding=tsh.GridSharding(mesh, tsh._placements(mesh, 2)),
        device="cpu"))
    ref = list(jpipe.prefetch_to_device(recs, sharding=jsh.grid_sharding(
        jsh.make_grid_mesh(jax.devices()[:1], shape=(1, 1)))))
    for g, r in zip(got, ref):
        for k in NAMES:
            assert type(g[k]) is torch.Tensor
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]))


def test_local_grid_slices_tile_the_grid(ranks):
    _, seen = ranks
    for key, shape in (("slices", SHAPE), ("slices41", SHAPE),
                       ("slices_empty", (EMPTY_ROWS, SHAPE[1]))):
        cover = np.zeros(shape, int)
        for s in seen:
            y0, y1, x0, x1 = s[key]
            cover[y0:y1, x0:x1] += 1
        assert (cover == 1).all(), key


# ---------------------------------------------------------------------------
# the forward series and the step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sharded():
    """The reference's sharded series on a (2, 4) mesh, backend="jit"."""
    import jax.numpy as jnp
    from aerobulk_tpu.api import AeroBulkConfig as JConfig
    from aerobulk_tpu.sharding import make_grid_mesh, sharded_run_series
    f, lon = _problem()
    cfg = JConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=5, use_skin=True)
    out, st = sharded_run_series(
        make_grid_mesh(shape=(2, 4)), cfg,
        {k: jnp.asarray(v) for k, v in f.items()},
        isecday_utc=jnp.asarray(ISD, jnp.int32), lon=jnp.asarray(lon),
        backend="jit")
    return {**{n: np.asarray(getattr(out, n)) for n in OUTS},
            **{n: np.asarray(x) for n, x in zip(SkinState._fields, st)}}


@pytest.mark.parametrize("name", OUTS + SkinState._fields)
def test_sharded_forward_matches_jax_sharded(ranks, jax_sharded, name):
    got = _gather(ranks, f"eager_{name}")
    assert not np.isnan(got).any()
    _close(name, got, jax_sharded[name], 1e-12)


@pytest.mark.parametrize("path", ["eager", "fused", "host_local", "step"])
def test_sharded_forward_matches_unsharded(ranks, unsharded, path):
    """Every output and the state, gathered, against the port's unsharded
    run: DTensors entered whole (eager, fused), slabs entered by each rank
    (``global_from_host_local``) and one ``sharded_fused_flux_step``."""
    ref = unsharded["eager" if path == "host_local" else path]
    for name in OUTS + SkinState._fields:
        _close(name, _gather(ranks, f"{path}_{name}"), ref[name], 1e-13)
    if path == "eager":
        assert float(np.max(ref["dT_wl"])) > 0.0   # a warm layer built


def test_outputs_are_dtensors_of_the_logical_grid(ranks):
    _, seen = ranks
    for s in seen:
        assert s["out_shape"] == [NT, *SHAPE]
        assert s["out_placements"] == "(Shard(dim=1), Shard(dim=2))"


def test_no_collective_in_the_step_or_its_gradient(ranks):
    """The counterpart of tests/test_pallas_kernel.py:366: the sharded
    series, the sharded step and the backward pass of the series record
    no collective on any rank."""
    _, seen = ranks
    for s in seen:
        assert s["collectives"] == 0
        assert s["step_collectives"] == 0
        assert s["grad_collectives"] == 0


# ---------------------------------------------------------------------------
# the gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("sst",) + SkinState._fields)
def test_sharded_gradient_matches_unsharded(ranks, unsharded, name):
    """d sum(QL + QH + Tau_x) / d(sst forcing, initial state) through
    ``sharded_run_series(backend="fused", fused_grad_backend="kernel")``,
    gathered, against the unsharded gradient (held against jax.vjp by
    tests/test_torch_grad.py and tests/test_torch_series.py)."""
    ref = unsharded["grad"][name]
    got = _gather(ranks, f"grad_{name}")
    assert np.any(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-13,
                               atol=1e-13 * np.max(np.abs(ref)))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_overwrite_and_resume_bitwise(ranks):
    """A fixed path written twice holds the second state, read back
    bitwise into a fresh ``like`` (left untouched); the last record run
    from it equals the uninterrupted run bitwise, on every rank."""
    _, seen = ranks
    for s in seen:
        assert s["round_trip_bitwise"]
        assert s["like_untouched"]
        assert s["resume_bitwise"]


def test_checkpoint_needs_dtensors(ranks):
    _, seen = ranks
    for s in seen:
        assert "not a DTensor" in s["plain_like_error"]
        assert "load_skin_state" in s["plain_like_error"]


def test_checkpoint_loads_onto_another_mesh(ranks):
    """The (2, 2) save restored onto a (4, 1) mesh: each rank's block is
    its (4, 1) slab of the saved state (the state after 2 records),
    bitwise."""
    for name in SkinState._fields:
        got = _gather(ranks, f"ckpt41_{name}", slices="slices41")
        np.testing.assert_array_equal(got, _gather(ranks, f"mid_{name}"),
                                      name)
    assert np.any(_gather(ranks, "mid_dT_wl"))


def test_load_of_a_plain_like_raises_in_process():
    with pytest.raises(TypeError, match="load_skin_state"):
        load_skin_state_sharded("unused", SkinState(*(torch.zeros(2, 2)
                                                      for _ in range(4))))


# ---------------------------------------------------------------------------
# empty blocks and device rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_empty_block_returns_empty_outputs(ranks, backend):
    """5 rows over a (4, 1) mesh: the last rank's block is (3, 0, 13) and
    its outputs are empty; the gathered grid equals the unsharded run."""
    arrays, seen = ranks
    assert arrays[3][f"empty_{backend}_QL"].shape == (NT, 0, SHAPE[1])
    assert arrays[3][f"empty_{backend}_dT_wl"].shape == (0, SHAPE[1])
    assert seen[3][f"empty_{backend}_shape"] == [NT, EMPTY_ROWS, SHAPE[1]]
    f, lon = _problem()
    out, st = run_series(
        CFG, {k: torch.as_tensor(v[:, :EMPTY_ROWS]) for k, v in f.items()},
        isecday_utc=ISD, lon=torch.as_tensor(lon[:EMPTY_ROWS]),
        backend=backend)
    shape = (EMPTY_ROWS, SHAPE[1])
    for name in OUTS:
        _close(name, _gather(ranks, f"empty_{backend}_{name}",
                             slices="slices_empty", shape=shape),
               getattr(out, name).numpy(), 1e-13)
    for name, x in zip(SkinState._fields, st):
        _close(name, _gather(ranks, f"empty_{backend}_{name}",
                             slices="slices_empty", shape=shape),
               x.numpy(), 1e-13)


def test_without_a_gpu_the_cuda_defaults_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        tsh.make_grid_mesh()
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        tsh.init_distributed("file:///nonexistent", 1, 0)


@pytest.mark.cuda
def test_empty_block_launches_nothing_on_gpu():
    """On the card an empty block returns empty outputs and gradients
    without a launch of kernel 1 or 2, and counts none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernels 1 and 2 run only there")
    from aerobulk_tpu_torch.kernels import fused as tfused
    ins = [torch.zeros((0, 13), device="cuda") for _ in range(13)]
    launches, grads = tfused.LAUNCHES, tfused.GRAD_LAUNCHES
    outs, st = tfused.fused_flux_step(CFG, *ins[:8], lon=ins[8],
                                      skin_state=SkinState(*ins[9:]))
    g = tfused.fused_flux_step_grad(CFG, ins, ins[:10])
    assert all(x.shape == (0, 13) for x in (*outs, *st, *g))
    assert tfused.LAUNCHES == launches and tfused.GRAD_LAUNCHES == grads


if __name__ == "__main__":
    _rank_main(*sys.argv[1:3], int(sys.argv[3]))
