"""Ranks of the sharded paths, started as separate processes.

``spawn`` starts one process per rank and fails if any rank fails, prints
no ``RANK <r> OK`` line or passes its time limit.  ``python3 -m
aerobulk_tpu_torch.distributed_worker`` is the rank program of
``chip_smoke.py``'s phase 24 (the counterpart of the JAX package's
tests/_distributed_worker.py); it imports torch and the port, never jax.

Each rank of ``run <scenario> <init> <world> <outdir> <device_type>
<rank>`` (``device_type`` ``cuda``, or ``cpu`` for a rehearsal at a small
grid, where the kernels' plain versions run):

  * ``two_ranks``: two ranks sharing the card over gloo, mesh (2, 1), at
    721x1440.  Each rank reads only its own slab of the base forcing
    (``<outdir>/base.npy``, memory-mapped), builds its 24 records on the
    card, enters them with ``global_from_host_local`` and runs
    ``sharded_run_series(backend="fused")`` for COARE 3.6 and ECMWF + skin
    (24 launches of kernel 1 each), then the value+grad of the same series
    (24 launches of kernel 2 each), the sharded streamed feed
    (``run_series_pipelined(chunk=8, sharding=...)``, wires f32 and i16)
    over its slab of the streamed records (``<outdir>/stream.npy``, the
    offsets of each record in ``<outdir>/stream_offsets.npz``), and a
    DCP checkpoint after 12 records, resumed on the same mesh.  It writes
    its local blocks to ``<outdir>/<part>_rank<r>.npz``.
  * ``one_rank``: one rank over NCCL, mesh (1, 1): the sharded series of
    each algorithm against ``run_series(backend="fused")`` bitwise, and the
    checkpoint of ``two_ranks`` resumed on this mesh.

The rank prints ``RANK <r> OK <json>`` with its launch counts and seconds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

NT = 24
HALF = NT // 2
CHUNK = 8
NITER = 5
ALGOS = ("coare3p6", "ecmwf")
#: the order of the streamed base fields in ``stream.npy`` (lon last); the
#: base forcing in ``base.npy`` is measure.grid_forcing's nine in its order
STREAM = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "rad_sw",
          "rad_lw")
OUT = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s")
STREAM_OUT = ("QL", "QH", "Tau", "Evap")
WIRES = ("f32", "i16")


def spawn(argv, world: int, timeout: float, env=None):
    """Run ``[python, *argv, rank]`` for every rank at once and wait.
    Returns each rank's standard output; raises if a rank exits with
    another code than 0, prints no ``RANK <r> OK`` line or passes
    ``timeout`` seconds.  Once one rank fails or the time is up, every
    rank still running is killed (the others may wait on it in a
    collective)."""
    with tempfile.TemporaryDirectory() as logs:
        streams = [(open(os.path.join(logs, f"{r}.out"), "w+"),
                    open(os.path.join(logs, f"{r}.err"), "w+"))
                   for r in range(world)]
        procs = [subprocess.Popen([sys.executable, *argv, str(r)],
                                  stdout=out, stderr=err, env=env)
                 for r, (out, err) in enumerate(streams)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline or any(
                        p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs, errors = [], []
        for r, (p, (out, err)) in enumerate(zip(procs, streams)):
            out.seek(0)
            err.seek(0)
            text, log = out.read(), err.read()
            out.close()
            err.close()
            outs.append(text)
            if p.returncode != 0 or f"RANK {r} OK" not in text:
                errors.append(f"rank {r} exited {p.returncode}"
                              f"{' (killed)' if p.returncode < 0 else ''}"
                              f":\n{text[-2000:]}\n{log[-4000:]}")
    if errors:
        if time.monotonic() > deadline:
            errors.insert(0, f"the ranks passed their {timeout} s limit")
        raise RuntimeError("\n".join(errors))
    return outs


def ok_line(out: str, rank: int) -> dict:
    """The JSON object of a rank's ``RANK <r> OK`` line."""
    for line in out.splitlines():
        if line.startswith(f"RANK {rank} OK"):
            return json.loads(line[len(f"RANK {rank} OK"):])
    raise ValueError(f"no OK line of rank {rank}")


def series_forcing(base, nt=NT):
    """``nt`` hourly records of the base fields (sst, t_zt, hum_zt, U_zu,
    V_zu, slp, rad_sw, rad_lw, lon: tensors of one grid, or of one rank's
    slab of it): the sun follows each point's local day and the wind
    varies by 10% over the day.  Every operation is elementwise, so a slab
    of the result is the result of the slab, bit for bit.  Returns
    ``(forcing, lon)``."""
    sst, t, q, u, v, slp, rsw, rlw, lon = base
    shape = (nt,) + tuple(sst.shape)
    hours = torch.arange(nt, device=sst.device,
                         dtype=torch.float32)[:, None, None]
    local_h = torch.remainder(hours + lon / 15.0, 24.0)
    sun = torch.clamp(torch.cos((local_h - 12.0) * (np.pi / 12.0)), min=0.0)
    wind = 1.0 + 0.1 * torch.sin(hours * (2.0 * np.pi / nt))
    forcing = {
        "sst": sst.expand(shape).contiguous(),
        "t_zt": t.expand(shape).contiguous(),
        "hum_zt": q.expand(shape).contiguous(),
        "U_zu": (u * wind).contiguous(), "V_zu": (v * wind).contiguous(),
        "slp": slp.expand(shape).contiguous(),
        "rad_sw": (2.0 * rsw * sun).contiguous(),
        "rad_lw": rlw.expand(shape).contiguous(),
    }
    return forcing, lon


def isecday(nt=NT, start=0):
    return [(jt * 3600) % 86400 for jt in range(start, start + nt)]


def _config(algo):
    from . import AeroBulkConfig
    return AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=NITER,
                          use_skin=True)


def _host(x):
    return x.detach().cpu().numpy()


def _save(outdir, part, rank, **arrays):
    np.savez(os.path.join(outdir, f"{part}_rank{rank}.npz"), **arrays)


def _sync(dev, barrier=False):
    """Wait for the device; with ``barrier``, also for every rank, so that
    the ranks' timed parts start together."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if barrier:
        torch.distributed.barrier()


def two_ranks(outdir, rank, dev):
    """Phase 24 (b)-(e) on one of two ranks: see the module's docstring."""
    from . import init_skin_state
    from . import pipeline as tpipe
    from .measure import stream_records
    from . import sharding as sh
    from .kernels import fused as kfused
    from .skin import (SkinState, load_skin_state_sharded,
                       save_skin_state_sharded)

    mesh = sh.make_grid_mesh(dev.type, (2, 1))
    base_file = np.load(os.path.join(outdir, "base.npy"), mmap_mode="r")
    grid = base_file.shape[1:]
    ys, xs = sh.local_grid_slices(mesh, grid)
    # this rank's hyperslab, and nothing else of the file
    slab = torch.as_tensor(np.ascontiguousarray(base_file[:, ys, xs]),
                           device=dev)
    report = {"slab": [ys.start, ys.stop, xs.start, xs.stop],
              "device": str(dev),
              "launches": {}, "grad_launches": {}, "seconds": {}}
    local_fc, local_lon = series_forcing(tuple(slab))
    fc = sh.global_from_host_local(mesh, local_fc, ndim=3)
    lon = sh.global_from_host_local(mesh, local_lon)
    isd = isecday()
    loss_of = lambda o: (o.QL + o.QH + o.Tau_x).sum()   # noqa: E731
    for algo in ALGOS:
        cfg = _config(algo)
        # (b) the forward series
        sh.sharded_run_series(mesh, cfg, {k: v[:1] for k, v in fc.items()},
                              isecday_utc=isd[:1], lon=lon, backend="fused")
        _sync(dev, barrier=True)
        kfused.LAUNCHES = 0
        t0 = time.perf_counter()
        out, st = sh.sharded_run_series(mesh, cfg, fc, isecday_utc=isd,
                                        lon=lon, backend="fused")
        _sync(dev)
        report["seconds"][f"{algo} series"] = time.perf_counter() - t0
        report["launches"][f"{algo} series"] = kfused.LAUNCHES
        _save(outdir, f"series_{algo}", rank,
              **{n: _host(getattr(out, n).to_local()) for n in OUT},
              **{f"state_{n}": _host(x.to_local())
                 for n, x in zip(SkinState._fields, st)})
        del out
        # (c) value+grad of the same series
        sst = fc["sst"].detach().clone().requires_grad_()
        state0 = sh.global_from_host_local(mesh, SkinState(*(
            x.clone() for x in init_skin_state(cfg, local_lon.shape,
                                               torch.float32, dev))))
        state0 = SkinState(*(x.requires_grad_() for x in state0))
        _sync(dev, barrier=True)
        kfused.GRAD_LAUNCHES = 0
        t0 = time.perf_counter()
        out, _ = sh.sharded_run_series(
            mesh, cfg, {**fc, "sst": sst}, isecday_utc=isd, lon=lon,
            skin_state=state0, backend="fused", fused_grad_backend="kernel")
        grads = torch.autograd.grad(loss_of(out), (sst, *state0),
                                    materialize_grads=True)
        _sync(dev)
        report["seconds"][f"{algo} value+grad"] = time.perf_counter() - t0
        report["grad_launches"][f"{algo} value+grad"] = kfused.GRAD_LAUNCHES
        _save(outdir, f"grad_{algo}", rank,
              **{f"d_{n}": _host(g.to_local())
                 for n, g in zip(("sst",) + SkinState._fields, grads)})
        del out, grads, sst, state0
    # (e) a checkpoint after 12 records, resumed on this mesh
    cfg = _config("coare3p6")
    first = {k: v[:HALF] for k, v in fc.items()}
    rest = {k: v[HALF:] for k, v in fc.items()}
    _, st_mid = sh.sharded_run_series(mesh, cfg, first,
                                      isecday_utc=isd[:HALF], lon=lon,
                                      backend="fused")
    ckpt = os.path.join(outdir, "ckpt")
    save_skin_state_sharded(ckpt, st_mid)
    restored = load_skin_state_sharded(ckpt, st_mid)
    out, st_end = sh.sharded_run_series(mesh, cfg, rest,
                                        isecday_utc=isd[HALF:], lon=lon,
                                        skin_state=restored, backend="fused")
    _save(outdir, "resume", rank,
          **{n: _host(getattr(out, n).to_local()) for n in OUT},
          **{f"state_{n}": _host(x.to_local())
             for n, x in zip(SkinState._fields, st_end)},
          restored_equal=np.asarray(all(
              torch.equal(a.to_local(), b.to_local())
              for a, b in zip(restored, st_mid))))
    del out, fc, rest, first
    # (d) the sharded streamed feed over this rank's slab of the records
    stream_file = np.load(os.path.join(outdir, "stream.npy"), mmap_mode="r")
    sbase = {k: np.ascontiguousarray(stream_file[i, ys, xs])
             for i, k in enumerate(STREAM)}
    slon = np.ascontiguousarray(stream_file[len(STREAM), ys, xs])
    with np.load(os.path.join(outdir, "stream_offsets.npz")) as z:
        offs = dict(z)
    sharding = sh.grid_sharding(mesh)
    for wire in WIRES:
        kw = dict(chunk=CHUNK, backend="fused", wire=wire, lon=slon,
                  sharding=sharding)
        tpipe.run_series_pipelined(cfg, stream_records(sbase, offs, CHUNK),
                                   **kw)
        _sync(dev, barrier=True)
        kfused.LAUNCHES = 0
        t0 = time.perf_counter()
        results, st = tpipe.run_series_pipelined(
            cfg, stream_records(sbase, offs, NT), **kw)
        _sync(dev)
        report["seconds"][f"feed {wire}"] = time.perf_counter() - t0
        report["launches"][f"feed {wire}"] = kfused.LAUNCHES
        if not isinstance(st.dT_wl, sh.DTensor) \
                or tuple(st.dT_wl.shape) != tuple(grid):
            raise RuntimeError(f"feed {wire}: the final state is not a "
                               f"DTensor of the grid {grid}")
        _save(outdir, f"feed_{wire}", rank,
              **{n: np.concatenate([r[n] for r in results])
                 for n in STREAM_OUT},
              state_dT_wl=_host(st.dT_wl.to_local()))
    return report


def one_rank(outdir, rank, dev):
    """Phase 24 (a) and (e) on one rank: see the module's docstring."""
    from . import run_series
    from . import sharding as sh
    from .kernels import fused as kfused
    from .skin import SkinState, load_skin_state_sharded

    mesh = sh.make_grid_mesh(dev.type, (1, 1))
    base = torch.as_tensor(np.load(os.path.join(outdir, "base.npy")),
                           device=dev)
    forcing, lon = series_forcing(tuple(base))
    isd = isecday()
    report = {"launches": {}, "seconds": {}, "bitwise": {}}
    for algo in ALGOS:
        cfg = _config(algo)
        ref, ref_st = run_series(cfg, forcing, isecday_utc=isd, lon=lon,
                                 backend="fused")
        sh.sharded_run_series(mesh, cfg, {k: v[:1] for k, v in
                                          forcing.items()},
                              isecday_utc=isd[:1], lon=lon, backend="fused")
        _sync(dev)
        kfused.LAUNCHES = 0
        t0 = time.perf_counter()
        out, st = sh.sharded_run_series(mesh, cfg, forcing, isecday_utc=isd,
                                        lon=lon, backend="fused")
        _sync(dev)
        report["seconds"][f"{algo} series"] = time.perf_counter() - t0
        report["launches"][f"{algo} series"] = kfused.LAUNCHES
        same = all(torch.equal(getattr(out, n).to_local(), getattr(ref, n))
                   for n in OUT) and all(
            torch.equal(a.to_local(), b) for a, b in zip(st, ref_st))
        report["bitwise"][f"{algo} series"] = same
        if not same:
            raise RuntimeError(f"one rank: the sharded {algo} series differs "
                               "from run_series(backend='fused')")
        del out, ref
    # (e) the checkpoint written by two ranks, resumed on mesh (1, 1)
    cfg = _config("coare3p6")
    ref, ref_st = run_series(cfg, forcing, isecday_utc=isd, lon=lon,
                             backend="fused")
    like = sh.shard_grid_inputs(mesh, SkinState(*(
        torch.zeros(base.shape[1:], device=dev) for _ in SkinState._fields)))
    restored = load_skin_state_sharded(os.path.join(outdir, "ckpt"), like)
    out, st = sh.sharded_run_series(
        mesh, cfg, {k: v[HALF:] for k, v in forcing.items()},
        isecday_utc=isd[HALF:], lon=lon, skin_state=restored,
        backend="fused")
    same = all(torch.equal(getattr(out, n).to_local(), getattr(ref, n)[HALF:])
               for n in OUT) and all(
        torch.equal(a.to_local(), b) for a, b in zip(st, ref_st))
    report["bitwise"]["resume on (1, 1)"] = same
    if not same:
        raise RuntimeError("one rank: the run resumed from the two ranks' "
                           "checkpoint differs from the uninterrupted run")
    return report


def main(argv):
    scenario, init, world, outdir, device_type, rank = argv
    world, rank = int(world), int(rank)
    from . import sharding as sh
    # NCCL refuses two ranks on one card: those share it over gloo
    backend = ("nccl" if scenario == "one_rank" and device_type == "cuda"
               else "gloo")
    sh.init_distributed(init, world, rank, backend=backend,
                        device_type=device_type)
    if device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index != 0:
            raise RuntimeError(f"rank {rank} is on {dev}, not the one card")
    else:
        dev = torch.device(device_type)
    run = {"two_ranks": two_ranks, "one_rank": one_rank}[scenario]
    try:
        report = run(outdir, rank, dev)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    print(f"RANK {rank} OK {json.dumps(report)}", flush=True)


if __name__ == "__main__":
    main(sys.argv[2:] if sys.argv[1:2] == ["run"] else sys.argv[1:])
