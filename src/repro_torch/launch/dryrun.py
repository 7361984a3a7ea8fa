"""Dry run on meta tensors: count every (arch x shape) cell's step and its
roofline terms on a production mesh, with no device (port of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's jitted SPMD step for 256 and
512 placeholder devices and reads XLA's memory and cost analyses. Eager
PyTorch has no partitioned program to compile, so here ``count_cell`` runs
the cell's step once on ``meta`` tensors (shapes and dtypes, no data, no
card) and counts it:

* FLOPs with ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  attention and convolutions, at 2 per multiply-add);
* bytes touched by summing every aten op's input and output bytes under a
  ``TorchDispatchMode`` (views and allocations excluded: they move no
  data). That is the eager program's traffic, every op a round trip to
  memory, unfused: an upper bound on what a fused program moves.

The step is the train step of ``build_train_step`` (forward, backward,
AdamW) for ``train`` cells, and ``prefill`` or ``decode_step`` for serving
cells, all on the torch path with ``moe_impl="einsum"``: the grouped
matmul's plain version reads the group sizes to the host, which a meta
tensor cannot give, and the CUDA kernels take no meta tensor. The port has
no rematerialisation, so the train step counts no recompute.

Per device, for a mesh:
* argument bytes are exact: each input leaf's bytes (the train state and
  the batch, or the params, the tokens and the cache) over the product of
  the mesh-axis sizes its spec shards it on, summed (a dimension that does
  not divide holds its largest shard);
* FLOPs and bytes touched are the counted totals over the device count,
  an even split: eager torch has no partitioned program to count, so any
  imbalance or replicated work between devices is not seen.
There is no collective term: the reference parses collectives out of the
optimized HLO (``collective_bytes``), and the eager step has no such
program; no number stands in for it.

The roofline denominators are NVIDIA's published H100 SXM figures (data
sheet, dense): 989 TFLOP/s bf16 on the tensor cores and 3.35 TB/s of HBM3
bandwidth, with 80 GB of HBM; a cell whose per-device argument bytes exceed
80 GB is flagged (``over_hbm``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape train_4k --mesh single                                 # one cell

Artifacts (one JSON per cell and mesh) go to ``build/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import os
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs import (ARCH_IDS, SHAPES, ArchConfig, ShapeCell,
                       cell_applicable, get_config)
from ..data.pipeline import batch_spec
from ..distributed import sharding as shd
from ..models import model as M
from ..models.layers import META
from ..training import OptimConfig, TrainConfig, build_train_step
from ..training.train import init_train_state, train_state_axes
from .mesh import make_production_mesh, rules_for

# NVIDIA H100 SXM data sheet (dense): the roofline denominators
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card (tensor cores)
HBM_BW = 3.35e12             # bytes/s per card (HBM3)
HBM_BYTES = 80e9             # bytes of HBM per card

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun_torch")

_ATEN = torch.ops.aten
#: ops that allocate or rename storage without moving data
_NO_TRAFFIC = {_ATEN.empty.memory_format, _ATEN.empty_strided.default,
               _ATEN.empty_like.default, _ATEN.detach.default,
               _ATEN.lift_fresh.default, _ATEN.alias.default}


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class ByteTally(TorchDispatchMode):
    """Bytes each aten op reads and writes (its tensor inputs and outputs,
    counted once each per op), in total, by op and by (shape, op)."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_op: collections.Counter = collections.Counter()
        self.count_op: collections.Counter = collections.Counter()
        self.by_shape: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func in _NO_TRAFFIC:
            return out
        ins = sum(_nbytes(t) for t in _tensors((args, kwargs or {})))
        outs = _tensors(out)
        b = ins + sum(_nbytes(t) for t in outs)
        name = func.overloadpacket.__name__
        self.total += b
        self.by_op[name] += b
        self.count_op[name] += 1
        if outs:
            o = outs[0]
            dt = str(o.dtype).replace("torch.", "")
            self.by_shape[f"{dt}{list(o.shape)} {name}"] += b
        return out


@dataclass
class Tally:
    """What one run of a cell's step counted."""
    flops: int
    bytes: int
    by_op: dict = field(default_factory=dict)
    count_op: dict = field(default_factory=dict)
    by_shape: dict = field(default_factory=dict)
    seconds: float = 0.0


def count(fn, *args) -> Tally:
    """Run ``fn(*args)`` under the FLOP counter and the byte tally."""
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, ByteTally() as bt:
        fn(*args)
    return Tally(flops=int(fc.get_total_flops()), bytes=bt.total,
                      by_op=dict(bt.by_op), count_op=dict(bt.count_op),
                      by_shape=dict(bt.by_shape),
                      seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# step functions + input specs per cell kind
# ---------------------------------------------------------------------------


def serve_step(cfg: ArchConfig):
    """One decode step: a new token against a seq_len cache. (On meta
    tensors every sharding constraint is the identity, so none is
    passed.)"""

    def fn(params, tokens, cache, pos):
        return M.decode_step(params, cfg, tokens, cache, pos,
                             attn_impl="torch", moe_impl="einsum")

    return fn


def prefill_step(cfg: ArchConfig):
    def fn(params, tokens, cache, frontend=None):
        return M.prefill(params, cfg, tokens, cache, attn_impl="torch",
                         ssm_impl="torch", moe_impl="einsum",
                         frontend=frontend)

    return fn


def _cell(shape: Union[str, ShapeCell]) -> ShapeCell:
    return SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(arch: str, shape: Union[str, ShapeCell],
                cfg: Optional[ArchConfig] = None) -> dict[str, Any]:
    """Meta tensors standing in for every input of the cell's step (the
    reference's ShapeDtypeStructs)."""
    cfg = cfg if cfg is not None else get_config(arch)
    cell = _cell(shape)
    b, s = cell.global_batch, cell.seq_len
    specs: dict[str, Any] = {}

    def frontend():
        return torch.empty((b, cfg.frontend_tokens, cfg.frontend_dim),
                           dtype=torch.bfloat16, device=META)
    if cell.kind == "train":
        specs.update(batch_spec(b, s))
        if cfg.frontend:
            specs["frontend"] = frontend()
    elif cell.kind == "prefill":
        specs["tokens"] = torch.empty((b, s), dtype=torch.int32, device=META)
        specs["cache"] = M.cache_spec(cfg, b, s)
        if cfg.frontend:
            specs["frontend"] = frontend()
    else:  # decode
        specs["tokens"] = torch.empty((b, 1), dtype=torch.int32, device=META)
        specs["cache"] = M.cache_spec(cfg, b, s)
        specs["pos"] = torch.empty((b,), dtype=torch.int32, device=META)
    return specs


def params_spec(cfg: ArchConfig) -> dict:
    return M.param_spec(cfg)


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    else:
        yield path, tree


def model_flops(cfg: ArchConfig, cell: ShapeCell, pspec: Any) -> float:
    """6*N*D (train) / 2*N*D (serve) with N = active params, D = tokens.

    N is counted exactly from the parameter spec tree; MoE expert weights
    are scaled by top_k / num_experts (only routed experts are active).
    """
    total = active = 0.0
    for keys, leaf in _leaves_with_path(pspec):
        size = float(leaf.numel())
        total += size
        if cfg.num_experts and "moe" in keys and any(
                k in ("wi", "wg", "wo") for k in keys):
            size *= cfg.num_experts_per_tok / cfg.num_experts
        active += size
    if cell.kind == "train":
        return 6.0 * active * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * active * cell.global_batch * cell.seq_len
    return 2.0 * active * cell.global_batch     # decode: one token per seq


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def _cell_inputs(cfg: ArchConfig, cell: ShapeCell) -> tuple[dict, dict]:
    """(the step's inputs as meta tensors, their logical axes), by name."""
    specs = input_specs(cfg.name, cell, cfg)
    batch_axes = {"tokens": ("batch", "act_seq"),
                  "labels": ("batch", "act_seq"),
                  "frontend": ("batch", None, None)}
    if cell.kind == "train":
        tcfg = TrainConfig(optim=OptimConfig())
        state = init_train_state(None, cfg, tcfg, META)
        batch = {k: specs[k] for k in batch_axes if k in specs}
        return ({"state": state, "batch": batch},
                {"state": train_state_axes(cfg, tcfg),
                 "batch": {k: batch_axes[k] for k in batch}})
    inputs = {"params": params_spec(cfg), **specs}
    axes = {"params": M.param_axes(cfg), "tokens": ("batch", None),
            "cache": M.cache_axes(cfg)}
    if "frontend" in specs:
        axes["frontend"] = batch_axes["frontend"]
    if "pos" in specs:
        axes["pos"] = ("batch",)
    return inputs, axes


def tally_cell(arch: str, shape: Union[str, ShapeCell],
               cfg: Optional[ArchConfig] = None) -> Tally:
    """Run the cell's step once on meta tensors and count it. The counts
    do not depend on the mesh: on meta tensors every ``constrain`` is the
    identity."""
    cfg = cfg if cfg is not None else get_config(arch)
    cell = _cell(shape)
    inputs, _ = _cell_inputs(cfg, cell)
    if cell.kind == "train":
        step = build_train_step(cfg, TrainConfig(optim=OptimConfig()))
        return count(step, inputs["state"], inputs["batch"])
    if cell.kind == "prefill":
        args = [inputs["params"], inputs["tokens"], inputs["cache"]]
        if "frontend" in inputs:
            args.append(inputs["frontend"])
        return count(prefill_step(cfg), *args)
    return count(serve_step(cfg), inputs["params"], inputs["tokens"],
                 inputs["cache"], inputs["pos"])


def _shard_bytes(t: torch.Tensor, spec: tuple, sizes: dict) -> int:
    """Bytes of the largest shard of ``t`` under ``spec``."""
    n = 1
    for dim, entry in zip(t.shape, spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        parts = math.prod(sizes.get(a, 1) for a in axes)
        n *= -(-dim // parts)
    return n * t.element_size()


def argument_bytes(inputs: dict, axes: dict, rules: dict, mesh) -> int:
    """Per-device bytes of the step's inputs on ``mesh`` under ``rules``."""
    sizes = shd.mesh_axis_sizes(mesh)
    total = 0
    for keys, leaf in _leaves_with_path(inputs):
        lg = axes
        for k in keys:
            lg = lg[k]
        total += _shard_bytes(leaf, shd.spec_for(lg, rules), sizes)
    return total


def count_cell(arch: str, shape: Union[str, ShapeCell], mesh, *,
               cfg: Optional[ArchConfig] = None,
               tally: Optional[Tally] = None,
               verbose: bool = True) -> dict:
    """The counterpart of the reference's ``lower_cell``: the cell's
    counts (``tally``, made by ``tally_cell`` when not given) and its
    roofline terms per device of ``mesh`` (a ``MeshShape`` or a
    ``DeviceMesh``). ``cfg`` replaces the arch's published config (a
    reduced one, in tests)."""
    cfg = cfg if cfg is not None else get_config(arch)
    cell = _cell(shape)
    tally = tally if tally is not None else tally_cell(arch, cell, cfg)
    rules = rules_for(cfg, mesh, cell)
    sizes = shd.mesh_axis_sizes(mesh)
    n_dev = math.prod(sizes.values())
    inputs, axes = _cell_inputs(cfg, cell)
    arg = argument_bytes(inputs, axes, rules, mesh)
    state_bytes = (argument_bytes(inputs["state"], axes["state"], rules, mesh)
                   if cell.kind == "train" else None)
    flops_dev = tally.flops / n_dev
    bytes_dev = tally.bytes / n_dev
    terms = {"compute_s": flops_dev / PEAK_FLOPS,
             "memory_s": bytes_dev / HBM_BW}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, cell, params_spec(cfg))
    result = {
        "arch": arch, "shape": cell.name,
        "mesh": "x".join(map(str, sizes.values())),
        "mesh_axes": list(sizes),
        "n_devices": int(n_dev),
        "kind": cell.kind,
        "flops": tally.flops,
        "bytes": tally.bytes,
        "flops_per_dev": flops_dev,
        "bytes_per_dev": bytes_dev,
        "memory": {"argument_bytes": arg, "state_bytes": state_bytes},
        "over_hbm": arg > HBM_BYTES,
        "terms_s": terms,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": mf / max(tally.flops, 1.0),
        "count_s": round(tally.seconds, 2),
    }
    if verbose:
        print(f"[dryrun] {arch:>24s} {cell.name:<12s} mesh={result['mesh']:<8s} "
              f"compute={terms['compute_s']*1e3:9.3f}ms "
              f"memory={terms['memory_s']*1e3:9.3f}ms "
              f"dom={dominant.split('_')[0]:<8s} "
              f"args/dev={arg / 1e9:8.3f}GB"
              f"{' OVER HBM' if result['over_hbm'] else ''} "
              f"count={tally.seconds:6.1f}s", flush=True)
    return result


def run_cells(archs, shapes, meshes, out_dir: str = ARTIFACT_DIR
              ) -> list[dict]:
    """Every applicable (arch, shape), counted once and reported for each
    mesh ("single": (16, 16), "multipod": (2, 16, 16))."""
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes:
            if not cell_applicable(cfg, shape):
                print(f"[dryrun] {arch:>24s} {shape:<12s} SKIP "
                      f"(full-attention arch)")
                continue
            try:
                tally = tally_cell(arch, shape, cfg)
            except Exception as e:  # noqa: BLE001 — record, keep going
                tally, err = None, e
                tb = traceback.format_exc()
                print(f"[dryrun] {arch:>24s} {shape:<12s} ERROR {e!r}")
            for mesh_name in meshes:
                mesh = make_production_mesh(multi_pod=(mesh_name ==
                                                       "multipod"))
                if tally is None:
                    res = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": repr(err),
                           "traceback": tb}
                else:
                    res = count_cell(arch, shape, mesh, tally=tally)
                    res["status"] = "ok"
                results.append(res)
                path = os.path.join(out_dir,
                                    f"{mesh_name}__{arch}__{shape}.json")
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
    return results


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args()
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = (["single", "multipod"] if args.mesh == "both"
              else [args.mesh])
    results = run_cells(archs, shapes, meshes, out_dir=args.out)
    ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"[dryrun] {ok}/{len(results)} cells counted OK")
    if ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
