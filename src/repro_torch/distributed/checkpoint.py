"""Fault-tolerant checkpointing: atomic, checksummed, in the JAX package's
on-disk format (port of ``repro/distributed/checkpoint.py``).

Layout of one checkpoint:

    <dir>/step_00000042/
        MANIFEST.json          # step, format, extra, per-array shape/dtype/crc32
        shard_00000.npz        # the arrays, keys flattened with "/"

so a checkpoint the JAX trainer wrote restores here and the reverse.
bfloat16 leaves are written as their raw 2-byte bits viewed as numpy's
``V2`` (what ``np.savez`` makes of JAX's ml_dtypes bfloat16), with
``"dtype": "bfloat16"`` in the manifest: the same bytes, and so the same
crc32, as the JAX package writes. On restore a ``V2`` array is read back as
``torch.bfloat16`` by the manifest's dtype.

Guarantees
----------
* **Atomicity**: written to ``step_X.tmp-<nonce>`` then renamed; a crash
  mid-write never corrupts the latest valid checkpoint, and ``latest_step``
  only ever sees complete directories.
* **Integrity**: per-array CRC32 in the manifest, verified on load.
* **Retention**: the ``keep`` most recent checkpoints are retained; older
  ones are removed after a successful save (never before), and so are
  temporary directories of crashed writers older than an hour.

One process writes shard 0, so the arrays on disk always have their
global shapes: rank 0 assembles each DTensor leaf on its host, its own
shard copied and every other distinct shard received from one rank that
holds it, so no card ever holds more of a leaf than its shard.
``restore`` puts the tree on one device, or, given ``mesh`` and
``placements`` (the reference's ``shardings``), reads each array at its
global shape on the host and moves to each rank's card only that rank's
shard of it (``DTensor.from_local``): a restore onto another mesh is the
reshard. The host holds a whole array at a time in both.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import resolve_device

SEP = "/"
_HOST = 0   # the shard a single process writes and reads


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        out: dict[str, Any] = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{SEP}"))
        return out
    return {prefix.rstrip(SEP): tree}


def _unflatten(flat: dict[str, Any]) -> Any:
    tree: dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _shard_slices(shape, mesh, placements, coord) -> tuple[slice, ...]:
    """The part of a global array of ``shape`` that the rank at mesh
    coordinate ``coord`` holds under ``placements``: DTensor's even split
    (``torch.chunk``'s, the last chunks short or empty), mesh dimensions
    applied in order."""
    start, size = [0] * len(shape), list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            chunk = -(-size[p.dim] // mesh.size(i))
            lo = min(coord[i] * chunk, size[p.dim])
            start[p.dim] += lo
            size[p.dim] = min(chunk, size[p.dim] - lo)
        elif not isinstance(p, Replicate):
            raise ValueError(f"a checkpoint leaf placed {p}: only Shard and "
                             f"Replicate are stored")
    return tuple(slice(a, a + n) for a, n in zip(start, size))


def _mesh_ranks(mesh) -> list[tuple[int, tuple[int, ...]]]:
    """(global rank, mesh coordinate) of every rank of ``mesh``."""
    return [(int(mesh.mesh[c]), c)
            for c in itertools.product(*map(range, mesh.mesh.shape))]


def _gather_to_host(t: DTensor, writer: int) -> Optional[torch.Tensor]:
    """The global tensor of ``t`` on ``writer``'s host (None elsewhere).
    Every rank of the mesh calls it; each distinct shard the writer does
    not hold is sent to it once, by the first rank that holds it."""
    mesh, me = t.device_mesh, dist.get_rank()
    ranks = _mesh_ranks(mesh)
    where = {r: _shard_slices(t.shape, mesh, t.placements, c)
             for r, c in ranks}
    key = lambda sl: tuple((x.start, x.stop) for x in sl)   # noqa: E731
    sender: dict[tuple, int] = {key(where[writer]): writer}
    for r, _ in ranks:
        sender.setdefault(key(where[r]), r)
    local = t.to_local().detach()
    if me != writer:
        if sender[key(where[me])] == me and local.numel():
            dist.send(local.contiguous(), dst=writer)
        return None
    out = torch.empty(t.shape, dtype=t.dtype)
    for r in sender.values():
        sl = where[r]
        if r == writer:
            out[sl] = local.cpu()
        elif out[sl].numel():
            buf = torch.empty(out[sl].shape, dtype=t.dtype,
                              device=local.device)
            dist.recv(buf, src=r)
            out[sl] = buf.cpu()
    return out


def _local_shard(arr: np.ndarray, dtype: str, mesh, placements,
                 dev: torch.device) -> DTensor:
    """This rank's shard of the global array ``arr`` (on the host) on its
    card, as a DTensor of ``arr``'s global shape."""
    part = np.ascontiguousarray(arr[_shard_slices(
        arr.shape, mesh, placements, mesh.get_coordinate())]) if arr.ndim \
        else arr
    local = _to_tensor(part, dtype).to(dev)
    whole = torch.empty(arr.shape, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=whole.shape, stride=whole.stride())


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the array as written, the dtype the manifest names)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _crc32(arr: np.ndarray) -> int:
    """crc32 of the array's bytes in C order (``arr.tobytes()``'s, without
    the copy)."""
    return zlib.crc32(np.ascontiguousarray(arr))


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- paths
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp" not in name:
                path = os.path.join(self.dir, name)
                if os.path.exists(os.path.join(path, "MANIFEST.json")):
                    steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        """Write ``tree`` as checkpoint ``step`` (atomically). With a
        process group, every rank calls it (rank 0 gathers the DTensor
        leaves to its host and writes), and it returns on each rank once
        the checkpoint is complete."""
        group = dist.is_available() and dist.is_initialized()
        flat = _flatten(tree)
        flat = {k: _gather_to_host(v, 0) if isinstance(v, DTensor) else v
                for k, v in flat.items()}
        if not group or dist.get_rank() == 0:
            self._write(step, flat, extra)
        if group and dist.get_world_size() > 1:
            dist.barrier()
        return self._step_dir(step)

    def _write(self, step: int, flat: dict[str, torch.Tensor],
               extra: Optional[dict]) -> None:
        nonce = f"{os.getpid()}-{int(time.time() * 1e6) & 0xFFFFFF:x}"
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{nonce}"
        os.makedirs(tmp, exist_ok=True)

        manifest: dict[str, Any] = {
            "step": step, "format": 1, "extra": extra or {}, "arrays": {}}
        shard: dict[str, np.ndarray] = {}
        for key, val in flat.items():
            arr, dtype = _to_numpy(val)
            shard[key] = arr
            manifest["arrays"][key] = {
                "shape": list(arr.shape),
                "dtype": dtype,
                "crc32": _crc32(arr),
            }
        np.savez(os.path.join(tmp, f"shard_{_HOST:05d}.npz"), **shard)
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):            # idempotent re-save of a step
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        # clean up orphaned tmp dirs from crashed writers
        for name in os.listdir(self.dir):
            if ".tmp-" in name:
                age = time.time() - os.path.getmtime(
                    os.path.join(self.dir, name))
                if age > 3600:
                    shutil.rmtree(os.path.join(self.dir, name),
                                  ignore_errors=True)

    # ----------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None,
                device: str | torch.device = "cuda",
                mesh=None, placements: Optional[Any] = None,
                ) -> tuple[int, Any, dict]:
        """Load a checkpoint (the latest without ``step``) onto ``device``
        (CUDA unless the caller asks for the CPU), or with ``mesh`` and
        ``placements`` (a tree of placement lists shaped like the saved
        tree) onto the mesh's device as DTensors: each array is read at its
        global shape on the host and each rank's shard of it moved to that
        rank's card. Raises on a checksum mismatch."""
        if (mesh is None) != (placements is None):
            raise ValueError("restore onto a mesh takes both mesh and "
                             "placements")
        dev = resolve_device(mesh.device_type if mesh is not None else device)
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self._step_dir(step)
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, f"shard_{_HOST:05d}.npz")) as z:
            flat = {k: z[k] for k in z.files}
        for key, meta in manifest["arrays"].items():
            arr = flat[key]
            if _crc32(arr) != meta["crc32"]:
                raise IOError(f"checksum mismatch for {key} in {path}")
            if mesh is None:
                flat[key] = _to_tensor(arr, meta["dtype"]).to(dev)
                continue
            where = placements
            for part in key.split(SEP):
                where = where[part]
            flat[key] = _local_shard(arr, meta["dtype"], mesh, where, dev)
        return step, _unflatten(flat), manifest.get("extra", {})
