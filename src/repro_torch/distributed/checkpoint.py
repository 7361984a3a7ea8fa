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

One process writes shard 0. Restoring onto another device layout (the
reference's ``shardings``) waits for the port's device mesh (ROADMAP, queue
A item 4); ``restore`` puts the tree on one device.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

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
        flat = _flatten(tree)
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
        return final

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
                ) -> tuple[int, Any, dict]:
        """Load a checkpoint (the latest without ``step``) onto ``device``
        (CUDA unless the caller asks for the CPU); raises on a checksum
        mismatch."""
        dev = resolve_device(device)
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
            flat[key] = _to_tensor(arr, meta["dtype"]).to(dev)
        return step, _unflatten(flat), manifest.get("extra", {})
