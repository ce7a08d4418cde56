"""Multiple devices: the (y, x) grid sharded over a mesh of ranks.

The counterpart of ``aerobulk_tpu.sharding``.  The flux computation is
pointwise (no stencil, no halo), so sharding the grid is pure data
parallelism: every rank steps its own block of points, the forward step
issues no collective, and the warm-layer :class:`SkinState` is sharded like
the inputs and never moves.

The reference is single-controller: one process sees every device and
``shard_map`` runs the same program on each.  The port is SPMD, one process
per device over ``torch.distributed``:

  * :func:`init_distributed` joins the process group (NCCL on CUDA, gloo on
    the CPU) and pins the rank's CUDA device;
  * :func:`make_grid_mesh` builds a ``DeviceMesh`` with the dimensions
    ``("gy", "gx")``;
  * a :class:`GridSharding` ``(mesh, placements)`` plays the role of a
    ``NamedSharding``: the trailing two axes of a field are ``Shard``-ed
    over ``gy`` and ``gx``, leading (time) axes are whole on every rank;
  * :func:`sharded_run_series` and :func:`sharded_fused_flux_step` run the
    single-device code (``api.run_series``, ``kernels.fused.
    fused_flux_step``) on each rank's ``DTensor.to_local()`` block and wrap
    the results back with ``DTensor.from_local`` at the logical shape.
    Both are differentiable: ``to_local`` and ``from_local`` are.

DTensor lays an uneven grid out in ``torch.chunk``'s blocks (ceil(n / k)
rows or columns each, the last ones shorter or empty); these are exactly
the blocks the reference's edge-pad-then-slice leaves on each device
(:func:`pad_grid_to_mesh`), so every rank runs its own unequal block and
nothing is padded inside.  :func:`pad_grid_to_mesh` and :func:`unpad_grid`
remain for callers who want even blocks.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from .api import init_skin_state, run_series
from .skin import SkinState

__all__ = ["init_distributed", "make_grid_mesh", "grid_sharding",
           "shard_grid_inputs", "replicated", "sharded_fused_flux_step",
           "sharded_run_series", "global_from_host_local",
           "pad_grid_to_mesh", "unpad_grid", "GridSharding",
           "local_grid_slices"]

_AXES = ("gy", "gx")
_FORCING = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "rad_sw",
            "rad_lw")


class GridSharding(NamedTuple):
    """Where a field lives on the mesh: the counterpart of the reference's
    ``NamedSharding`` (a mesh and one ``Placement`` per mesh dimension)."""
    mesh: DeviceMesh
    placements: tuple


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device_type: str = "cuda"):
    """Join the process group (one process per device).

    ``coordinator_address`` is a ``tcp://host:port`` or ``file://path``
    rendezvous (a bare ``host:port`` means tcp), with ``num_processes`` and
    this process's ``process_id``; with none of them the rendezvous comes
    from the environment (``env://``, as ``torchrun`` sets it).  The
    backend is NCCL for ``device_type="cuda"`` and gloo for ``"cpu"``
    unless ``backend`` names another (gloo lets two ranks share one card,
    which NCCL refuses).  On CUDA the rank's device is pinned before any
    mesh is built: ``LOCAL_RANK`` (or the rank) modulo the cards on the
    host.  Without a GPU and with ``device_type="cuda"`` this raises.  A
    second call in an initialized process does nothing."""
    if dist.is_initialized():
        return
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_distributed: no CUDA device is available; pass "
            "device_type='cpu' to run the ranks on the CPU (gloo)")
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    kw = {}
    if coordinator_address is not None:
        if "://" not in coordinator_address:
            coordinator_address = f"tcp://{coordinator_address}"
        kw = dict(init_method=coordinator_address,
                  world_size=int(num_processes), rank=int(process_id))
    else:
        kw = dict(init_method="env://")
    if device_type == "cuda":
        rank = int(process_id if process_id is not None
                   else os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, **kw)


def make_grid_mesh(device_type: Optional[str] = None,
                   shape: Optional[tuple] = None, devices=None,
                   axis_names=_AXES) -> DeviceMesh:
    """A mesh of the ranks over the grid axes.

    ``devices`` lists the ranks in mesh order (default: every rank,
    ``0 .. world size - 1``), as the reference's list of devices; ``shape``
    lays them out: ``None`` puts them in a row over ``gx`` (``(1, n)``),
    which is all a pointwise workload needs, ``(2, 4)`` gives a 2-D
    decomposition.  ``axis_names`` names the mesh's dimensions (the grid's
    placements need ``("gy", "gx")``).  Every rank of the process group
    calls it alike.  ``device_type`` is ``"cuda"`` unless the caller names
    ``"cpu"``; without a GPU and without ``"cpu"`` it raises (the rule of
    ``skin.default_device``)."""
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_grid_mesh builds on CUDA unless told otherwise, and no "
                "CUDA device is available: pass device_type='cpu'")
        device_type = "cuda"
    ranks = torch.arange(dist.get_world_size()) if devices is None \
        else torch.as_tensor(list(devices), dtype=torch.int64)
    if shape is None:
        shape = (1, ranks.numel())
    return DeviceMesh(device_type, ranks.reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def _placements(mesh: DeviceMesh, ndim: int) -> tuple:
    if ndim == 1:
        spec = {"gx": Shard(0)}
    else:
        spec = {"gy": Shard(ndim - 2), "gx": Shard(ndim - 1)}
    names = mesh.mesh_dim_names or _AXES
    missing = set(spec) - set(names)
    if missing:
        raise ValueError(
            f"the grid's placements shard over {sorted(spec)}, and the mesh "
            f"has no dimension named {sorted(missing)} (its names: "
            f"{tuple(names)})")
    return tuple(spec.get(n, Replicate()) for n in names)


def grid_sharding(mesh: DeviceMesh, ndim: int = 2) -> GridSharding:
    """The placements of a grid field: a 1-D field shards over ``gx`` only
    (``[Replicate(), Shard(0)]``), a field of 2 or more dims shards its
    trailing two axes over ``gy`` and ``gx``, leading (time) axes whole."""
    return GridSharding(mesh, _placements(mesh, ndim))


def replicated(mesh: DeviceMesh) -> GridSharding:
    """Every rank holds the whole field."""
    return GridSharding(mesh, (Replicate(),) * mesh.ndim)


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _tree_map(fn, tree):
    """``fn`` over the tensor and array leaves of dicts, named tuples,
    tuples and lists (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def shard_grid_inputs(mesh: DeviceMesh, tree):
    """Every leaf of ``tree`` (a tensor or array that every rank holds
    whole, e.g. seeded forcing) as a ``DTensor`` laid out by
    :func:`grid_sharding`.  Each rank keeps its own block of its copy; no
    data moves between ranks."""
    device = _mesh_device(mesh)

    def put(x):
        x = torch.as_tensor(x, device=device)
        placements = (replicated(mesh).placements if x.ndim == 0
                      else _placements(mesh, x.ndim))
        return distribute_tensor(x, mesh, placements, src_data_rank=None)
    return _tree_map(put, tree)


def _block(n: int, k: int, i: int) -> slice:
    """Block ``i`` of ``k`` of an axis of length ``n`` in DTensor's
    ``Shard`` layout (``torch.chunk``'s, with empty blocks at the end)."""
    size = -(-n // k)
    start = min(i * size, n)
    return slice(start, min(start + size, n))


def _coordinate(mesh: DeviceMesh, rank: Optional[int] = None):
    """The mesh coordinate of ``rank`` (default: this process)."""
    if rank is None:
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        return tuple(coord)
    hit = (mesh.mesh == rank).nonzero()
    if hit.numel() == 0:
        return None
    return tuple(int(i) for i in hit[0])


def _local_slices(mesh, placements, shape, coord):
    """The slices of a field of logical ``shape`` that the rank at mesh
    coordinate ``coord`` holds under ``placements``."""
    sl = [slice(0, n) for n in shape]
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            d = p.dim
            sl[d] = _block(shape[d], mesh.size(m), coord[m])
    return tuple(sl)


def local_grid_slices(sharding, grid_shape):
    """The ``(y, x)`` slices of a grid of ``grid_shape`` that this rank
    owns: the counterpart of ``NamedSharding.addressable_devices_indices_
    map``, so a reader takes only its own hyperslab of a file.
    ``sharding`` is a :class:`GridSharding` or a mesh (then
    :func:`grid_sharding` of the grid's rank)."""
    if isinstance(sharding, DeviceMesh):
        sharding = grid_sharding(sharding, len(grid_shape))
    mesh, placements = sharding
    return _local_slices(mesh, placements, tuple(grid_shape),
                         _coordinate(mesh))


def _contiguous_stride(shape):
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


def _from_local(mesh, placements, local, shape):
    """``local`` (this rank's block) as a DTensor of logical ``shape``;
    no collective."""
    shape = tuple(int(n) for n in shape)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _logical_shapes(mesh: DeviceMesh, placements_list, local_shapes):
    """The logical shapes of fields of which each rank holds the blocks
    ``local_shapes`` (one all-gather of the extents over the world), each
    checked against the layout DTensor gives that shape."""
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, [tuple(s) for s in local_shapes])
    coords = {}
    for r, shapes in enumerate(gathered):
        c = _coordinate(mesh, r)
        if c is not None:
            coords[c] = shapes
    me = _coordinate(mesh)
    out = []
    for i, (placements, local) in enumerate(zip(placements_list,
                                                local_shapes)):
        shape = list(local)
        for m, p in enumerate(placements):
            if isinstance(p, Shard):
                along = [me[:m] + (j,) + me[m + 1:]
                         for j in range(mesh.size(m))]
                shape[p.dim] = sum(coords[c][i][p.dim] for c in along)
        for c, shapes in coords.items():
            want = tuple(s.stop - s.start for s in
                         _local_slices(mesh, placements, shape, c))
            if tuple(shapes[i]) != want:
                raise ValueError(
                    f"global_from_host_local: the rank at mesh coordinate "
                    f"{c} holds a block of shape {tuple(shapes[i])}; a "
                    f"field of logical shape {tuple(shape)} puts "
                    f"{want} there (local_grid_slices gives each rank's "
                    "slab)")
        out.append(tuple(shape))
    return out


def global_from_host_local(mesh: DeviceMesh, tree, ndim: Optional[int] = None):
    """Global DTensors from *rank-local* slabs.

    Each rank reads only its own ``(y, x)`` slab of the forcing (its
    hyperslab of a file, :func:`local_grid_slices`) and passes the local
    arrays or tensors; the result is a DTensor per leaf laid out by
    :func:`grid_sharding` (of ``ndim`` dims if given, else the leaf's),
    whose local block is exactly the slab: no rank builds the global grid
    and no data moves between ranks.  The logical shapes come from one
    small all-gather of the slabs' extents per call, which also checks that
    every slab is the block DTensor's layout gives that rank."""
    device = _mesh_device(mesh)
    flat = _leaves(tree)
    locals_ = [torch.as_tensor(x, device=device).contiguous()
               for x in flat]
    placements = [_placements(mesh, ndim if ndim is not None else x.ndim)
                  for x in locals_]
    shapes = _logical_shapes(mesh, placements, [x.shape for x in locals_])
    it = iter(_from_local(mesh, p, x, s)
              for p, x, s in zip(placements, locals_, shapes))
    return _tree_map(lambda _: next(it), tree)


def _mesh_sizes(mesh) -> tuple:
    names = tuple(mesh.mesh_dim_names or ())
    return tuple(mesh.size(names.index(a)) if a in names else 1
                 for a in _AXES)


def _mesh_padding(mesh, ny: int, nx: int):
    """Per-axis padding that rounds ``(ny, nx)`` up to mesh-shape
    multiples (the 0.25-degree grid's 721 = 7 x 103 rows divide by no
    2-D mesh)."""
    gy, gx = _mesh_sizes(mesh)
    return (-ny % gy), (-nx % gx)


def _pad_grid_axes(x, py: int, px: int):
    """Edge-pad the trailing two axes of ``x`` by ``(py, px)``."""
    if (py == 0 and px == 0) or x is None:
        return x
    if py:
        x = torch.cat([x, x[..., -1:, :].expand(
            *x.shape[:-2], py, x.shape[-1])], dim=-2)
    if px:
        x = torch.cat([x, x[..., -1:].expand(*x.shape[:-1], px)], dim=-1)
    return x


def pad_grid_to_mesh(mesh, tree):
    """Edge-pad the trailing two ``(y, x)`` axes of every leaf to mesh-shape
    multiples (pair with :func:`unpad_grid` on outputs), for callers who
    want equal blocks on every rank.  Leaves with fewer than 2 dims pass
    through.  :func:`sharded_run_series` does not need it: DTensor lays
    out uneven grids itself."""
    def pad(x):
        x = torch.as_tensor(x)
        if x.ndim < 2:
            return x
        py, px = _mesh_padding(mesh, x.shape[-2], x.shape[-1])
        return _pad_grid_axes(x, py, px)
    return _tree_map(pad, tree)


def unpad_grid(tree, ny: int, nx: int):
    """Slice the trailing two axes back to the logical ``(ny, nx)`` grid."""
    return _tree_map(lambda x: x[..., :ny, :nx], tree)


def _as_dtensor(mesh: DeviceMesh, x, what: str):
    """``x`` as a DTensor of :func:`grid_sharding`'s layout: a DTensor is
    checked, a tensor that every rank holds whole is distributed."""
    if isinstance(x, DTensor):
        want = _placements(mesh, x.ndim)
        if x.device_mesh != mesh or tuple(x.placements) != want:
            raise ValueError(
                f"{what} is a DTensor on {x.device_mesh} with placements "
                f"{tuple(x.placements)}; expected {want} on {mesh} "
                "(redistribute it first)")
        return x
    return shard_grid_inputs(mesh, x)


def _wrap(mesh: DeviceMesh, tree, grid_shape):
    """Each rank's local results as DTensors of the logical grid: a leaf of
    2 or more dims whose trailing axes are this rank's block."""
    def wrap(x):
        if not isinstance(x, torch.Tensor) or x.ndim < 2:
            return x
        return _from_local(mesh, _placements(mesh, x.ndim), x,
                           tuple(x.shape[:-2]) + tuple(grid_shape))
    return _tree_map(wrap, tree)


def _local(x):
    return x.to_local().contiguous() if x is not None else None


def sharded_fused_flux_step(mesh: DeviceMesh, cfg, sst, t_zt, hum_zt, U_zu,
                            V_zu, slp, rad_sw, rad_lw, lon=None,
                            isecday_utc=43200,
                            skin_state: Optional[SkinState] = None):
    """One fused step on every rank's block of the grid: kernel 1 (one
    launch per rank, none on an empty block) on CUDA, its plain version on
    the CPU.  The fields are DTensors of :func:`grid_sharding`'s layout or
    tensors every rank holds whole (distributed first).  Returns ``((QL,
    QH, Tau_x, Tau_y, Evap, T_s), SkinState)`` as DTensors of the logical
    shape; the same contract as ``kernels.fused.fused_flux_step``, with no
    collective."""
    from .kernels.fused import fused_flux_step

    fields = [_as_dtensor(mesh, x, n) for n, x in zip(
        _FORCING, (sst, t_zt, hum_zt, U_zu, V_zu, slp, rad_sw, rad_lw))]
    grid = tuple(fields[0].shape)
    local = [_local(x) for x in fields]
    lon = (torch.zeros_like(local[0]) if lon is None
           else _local(_as_dtensor(mesh, lon, "lon")))
    if skin_state is None:
        state = init_skin_state(cfg, local[0].shape, local[0].dtype,
                                local[0].device)
    else:
        state = SkinState(*(_local(_as_dtensor(mesh, x, f"skin_state.{n}"))
                            for n, x in zip(SkinState._fields, skin_state)))
    outs, new = fused_flux_step(cfg, *local, lon=lon,
                                isecday_utc=isecday_utc, skin_state=state)
    return _wrap(mesh, tuple(outs), grid), _wrap(mesh, new, grid)


def sharded_run_series(mesh: DeviceMesh, cfg, forcing: dict,
                       isecday_utc=None, lon=None,
                       skin_state: Optional[SkinState] = None,
                       backend: str = "eager", remat: bool = False,
                       fused_grad_backend: str = "kernel"):
    """:func:`api.run_series` on every rank's block of the grid: the time
    loop runs rank-local, so the warm-layer state carries from record to
    record on each rank's own device with no collective per step.

    ``forcing`` maps names to ``(nt, ny, nx)`` DTensors laid out by
    :func:`grid_sharding` or to tensors every rank holds whole
    (distributed first); ``lon`` and ``skin_state`` likewise at ``(ny,
    nx)``.  ``isecday_utc`` is the host list of ``run_series``.
    ``backend`` is ``"eager"`` or ``"fused"`` (one launch of kernel 1 per
    record per rank; none on an empty block), with ``remat`` and
    ``fused_grad_backend`` as in ``run_series``.  Differentiable: the
    gradient of a loss on the outputs reaches DTensor forcing and state
    that require grad, each rank's backward pass running on its own block
    (kernel 2 once per record with ``fused_grad_backend="kernel"``).
    Returns ``(stacked FluxOutput, final SkinState)`` as DTensors of the
    logical shape."""
    fc = {k: _as_dtensor(mesh, v, f"forcing[{k!r}]")
          for k, v in forcing.items()}
    grid = tuple(fc["sst"].shape[1:])
    local = {k: _local(v) for k, v in fc.items()}
    ref = local["sst"]
    lo = None if lon is None else _local(_as_dtensor(mesh, lon, "lon"))
    if skin_state is None:
        state = init_skin_state(cfg, ref.shape[1:], ref.dtype, ref.device)
    else:
        state = SkinState(*(_local(_as_dtensor(mesh, x, f"skin_state.{n}"))
                            for n, x in zip(SkinState._fields, skin_state)))
    outs, final = run_series(cfg, local, skin_state=state,
                             isecday_utc=isecday_utc, lon=lo,
                             backend=backend, remat=remat,
                             fused_grad_backend=fused_grad_backend)
    return _wrap(mesh, outs, grid), _wrap(mesh, final, grid)

