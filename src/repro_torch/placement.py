"""Helpers for code that runs on plain tensors and on DTensors alike.

On a ``DeviceMesh`` the model's tensors are DTensors (``distributed.
sharding``), and DTensor ops take no plain tensor beside a DTensor, and
have no sharding rule for a few ops. Each helper is the identity on a
plain tensor, so the mesh-less path runs exactly as without them.
``per_shard`` runs such an op on each rank's shard where the op is
independent along the sharded dimensions (or sums over them: a partial
sum), which also pins a layout that DTensor's own choice would break;
``on_whole`` replicates first, for an op that is not. ``pinned`` holds a
gradient to its tensor's layout, and ``write_at`` writes rows into a
sharded tensor in place, each rank into its own shard.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset


def on_mesh_of(ref: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` (a tensor the code made itself, on the device of ``ref``) as a
    replicated DTensor on the mesh of ``ref`` when ``ref`` is a DTensor;
    ``t`` itself otherwise."""
    if isinstance(ref, DTensor) and not isinstance(t, DTensor):
        mesh = ref.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return t


def replicated(x: torch.Tensor) -> torch.Tensor:
    """``x`` whole on every rank (every placement ``Replicate()``): what
    GSPMD does with a collective before an op it cannot run sharded."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def on_whole(fn, *xs):
    """``fn(*xs)`` for an op DTensor cannot run: each DTensor argument is
    replicated first, so its local tensor is the whole tensor, ``fn`` runs
    on the local tensors, and each tensor it returns (one, or a tuple) is a
    replicated DTensor on their mesh (both steps are differentiable). Never
    ``to_local()`` of a shard: a shard is not the whole tensor. Plain
    arguments: ``fn(*xs)``."""
    meshes = [x.device_mesh for x in xs if isinstance(x, DTensor)]
    if not meshes:
        return fn(*xs)
    mesh = meshes[0]
    out = fn(*(replicated(x).to_local() if isinstance(x, DTensor) else x
               for x in xs))

    def wrap(t):
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def pinned(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, its gradient redistributed to ``x``'s own placements
    on the way back: for a view whose backward DTensor cannot take in the
    layout the gradient arrives in (an unflatten of a dimension sharded
    over more ways than its outer factor has)."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, x.placements)


def write_at(dst: torch.Tensor, idx: torch.Tensor, pos: torch.Tensor,
             src: torch.Tensor) -> None:
    """``dst[idx, pos] = src`` in place, ``dst`` [B, S, ...], ``idx`` and
    ``pos`` [B] (each row's index and the position it writes), ``src``
    [B, ...] (cast to ``dst``'s dtype). On a DTensor (DTensor refuses an
    in-place write that would move ``dst``'s shards) each rank writes into
    its own shard: the rows of its row shard whose position falls in its
    position shard, at that position, the others writing back what their
    clamped position holds; ``idx``, ``pos`` and ``src`` are first placed
    to match ``dst``'s shards."""
    if not isinstance(dst, DTensor):
        dst[idx, pos] = src.to(dst.dtype)
        return
    mesh, pl = dst.device_mesh, dst.placements
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in pl]
    cols = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 2 else r
            for p, r in zip(pl, rows)]
    shape, off = compute_local_shape_and_global_offset(dst.shape, mesh, pl)
    local = dst.to_local()
    i = idx.redistribute(mesh, rows).to_local() - off[0]
    p = pos.redistribute(mesh, rows).to_local() - off[1]
    inside = ((p >= 0) & (p < shape[1])).view((-1,) + (1,) * (src.ndim - 1))
    p = p.clamp(0, shape[1] - 1)
    new = src.redistribute(mesh, cols).to_local().to(local.dtype)
    local[i, p] = torch.where(inside, new, local[i, p])


def whole(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with tensor dimension ``dim`` whole on every rank (each
    ``Shard(dim)`` placement redistributed to ``Replicate()``), for an op
    DTensor cannot run over that dimension sharded."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    want = [Replicate() if p == Shard(dim) else p for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def per_shard(fn, *args, out):
    """``fn`` on each rank's local tensors, for an op DTensor has no rule
    for, or whose output layout DTensor would choose unfit for the next op,
    that is independent along some dimensions (tokens, batch, heads,
    channels): shards along those stay where they are.

    Each argument is ``(x, dims)``, ``dims`` naming the dimensions of ``x``
    along which ``fn`` is independent (``{name: dim}``); ``out`` names
    those of each output (one dict, or a tuple of them), or maps a name to
    ``Partial()`` where ``fn`` sums over that dimension (a contraction): the
    output is then a partial sum over its shards. A mesh dimension
    that shards a DTensor argument along a named dimension stays split (the
    first such argument decides): there every argument is sharded along its
    dimension of that name, or replicated if it has none (its gradient is
    then a partial sum over that mesh dimension). Every other mesh
    dimension is replicated first, so ``fn`` sees every other dimension
    whole; so is every mesh dimension if a named dimension does not split
    evenly. Plain arguments: ``fn`` on them."""
    xs = [x for x, _ in args]
    dts = [(x, dims) for x, dims in args if isinstance(x, DTensor)]
    if not dts:
        return fn(*xs)
    mesh = dts[0][0].device_mesh

    def name_on(i):
        for x, dims in dts:
            p = x.placements[i]
            n = next((n for n, d in dims.items()
                      if isinstance(p, Shard) and p == Shard(d % x.ndim)),
                     None)
            if n is not None:
                return n
        return None
    names = [name_on(i) for i in range(mesh.ndim)]
    for x, dims in args:
        for n, d in dims.items():
            ways = math.prod(mesh.size(i) for i, m in enumerate(names)
                             if m == n)
            if x.shape[d] % ways:
                names = [None] * mesh.ndim
    local = []
    for x, dims in args:
        if not isinstance(x, DTensor):
            local.append(x)
            continue
        want = [Shard(dims[n] % x.ndim) if n in dims else Replicate()
                for n in names]
        grad = [Partial() if n is not None and n not in dims else w
                for n, w in zip(names, want)]
        local.append(x.redistribute(mesh, want).to_local(
            grad_placements=grad))
    res = fn(*local)

    def wrap(t, dims):
        missing = [n for n in names if n is not None and n not in dims]
        if missing:
            raise ValueError(f"per_shard: an output has no dimension "
                             f"{missing[0]!r} to stay split along")
        return DTensor.from_local(
            t, mesh, [Replicate() if n is None else dims[n]
                      if isinstance(dims[n], Partial)
                      else Shard(dims[n] % t.ndim) for n in names],
            run_check=False)
    if isinstance(res, tuple):
        return tuple(wrap(t, d) for t, d in zip(res, out))
    return wrap(res, out)
