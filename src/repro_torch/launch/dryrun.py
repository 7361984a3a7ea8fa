"""Dry run on meta tensors: count every (arch x shape) cell's step and its
roofline terms on a production mesh, with no device (port of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's jitted SPMD step for 256 and
512 placeholder devices and reads XLA's cost and memory analyses and the
collectives of the optimized HLO. Eager PyTorch has no partitioned program
to compile; here the partitioned program is the DTensor step itself, run
once as rank 0 of the production mesh (``count_cell``):

* the mesh is a ``DeviceMesh`` of device type ``"cuda"`` over a fake
  process group of ``prod(mesh shape)`` ranks (``fake_mesh``), which the
  dry-run sets up and destroys itself: its collectives return without
  moving data, and no card is needed (on a ``"cpu"`` mesh DTensor would
  replace every all-to-all by an all-gather and a chunk, which the card's
  NCCL does not);
* every input is a DTensor whose local tensor is a meta tensor of rank 0's
  shard (placed by ``train_state_axes`` / ``param_axes`` / ``cache_axes``
  and ``rules_for``), and the step is the cell's train step
  (``build_train_step``), ``prefill`` or ``decode_step`` with
  ``constrain`` bound to the same rules;
* ``LocalTally`` counts what rank 0 runs: the FLOPs (FlopCounterMode's
  table, at 2 per multiply-add) and the bytes touched (every op's input
  and output bytes, views and allocations excluded) of the ops on its local
  tensors only (a DTensor op is left to DTensor, which runs it as local
  ops and collectives on the shards), and the collectives by family under
  the reference's HLO names and by mesh axis, each as one traversal of its
  result bytes (the reference's approximation in ``collective_bytes``).

So ``flops_per_dev``, ``bytes_per_dev`` and ``collective_bytes_per_dev``
are rank 0's own: imbalance and work replicated over the mesh show, and
``useful_flops_ratio`` is the reference's ``model_flops / (flops_per_dev *
n_devices)``. ``flops`` and ``bytes`` stay the global count of the
unsharded step (``tally_cell``, plain meta tensors, no mesh). The bytes are
the eager program's traffic, every op a round trip to memory, unfused; the
counts see neither XLA's fusion nor a collective that a compiler would
overlap with compute or elide.

Train cells run with the rematerialisation policy ``remat`` ("dots" by
default, as the reference lowers them; ``--remat``), each layer group of
``forward`` checkpointed by ``models.remat``; prefill and decode cells with
none. The recompute runs inside the backward as rank 0 runs it, so it is
counted like any other op, its collectives included.

The memory analysis (``memory`` in each result) is ``LocalTally``'s tally of
the storages rank 0 allocates inside the step, each rounded up to the
caching allocator's 512-byte blocks, from its allocation to its release
(its Python storage dying): ``temp_bytes`` is the peak of the bytes alive at
once, less ``output_bytes``, the bytes of the returned tensors whose
storage the step allocated (the metrics, prefill's and decode's logits). A
state updated in place is the arguments' storage and no output here; XLA,
which compiles the reference's step without donation, counts the new state
as output. Tensors autograd saves for the backward are alive until the
backward frees them: they make the peak. ``code_bytes`` has no counterpart
in an eager program (no compiled executable) and is not reported.

The step runs on the torch path with ``moe_impl="einsum"``: the grouped
matmul's plain version reads the group sizes to the host, which a meta
tensor cannot give, and the CUDA kernels take no meta tensor. The AdamW
update is counted as the card runs it: one op a leaf (``kernels.ops``'
``repro_torch::adamw`` on meta tensors), reading p, g, m and v and writing
p, m and v once, on rank 0's shard.

Argument bytes per device are exact: each input leaf's bytes over the
product of the mesh-axis sizes its spec shards it on, summed (a dimension
that does not divide holds its largest shard).

The roofline denominators are NVIDIA's published H100 SXM figures (data
sheet, dense): 989 TFLOP/s bf16 on the tensor cores and 3.35 TB/s of HBM3
bandwidth, with 80 GB of HBM (a cell whose per-device argument bytes plus
its peak of bytes allocated inside the step exceed 80 GB is flagged,
``over_hbm``). The collective term divides the bytes by
50 GB/s a direction per card: one ConnectX-7 NDR 400 Gb/s InfiniBand port
per GPU, as in a DGX H100. Both production mesh axes span more than one
8-card NVLink domain (``model`` = 16 at stride 1 spans two nodes), so the
slowest hop of every collective is InfiniBand; NVLink 4's 450 GB/s a
direction (``NVLINK_BW``) is quoted, not used.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --jobs 8        # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape train_4k --mesh single --remat dots_nobatch            # one cell

Artifacts (one JSON per cell and mesh) go to ``build/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import logging
import math
import multiprocessing
import os
import time
import traceback
import weakref
from dataclasses import dataclass, field, replace
from typing import Any, Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..configs import (ARCH_IDS, SHAPES, ArchConfig, ShapeCell,
                       cell_applicable, get_config)
from ..data.pipeline import batch_spec
from ..distributed import sharding as shd
from ..models import model as M
from ..models import remat as R
from ..models.layers import META
from ..training import OptimConfig, TrainConfig, build_train_step
from ..training.train import init_train_state, train_state_axes
from .mesh import MeshShape, make_production_mesh, rules_for

# NVIDIA H100 SXM data sheet (dense): the roofline denominators
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card (tensor cores)
HBM_BW = 3.35e12             # bytes/s per card (HBM3)
HBM_BYTES = 80e9             # bytes of HBM per card
LINK_BW = 50e9               # bytes/s a direction per card: one NDR IB port
NVLINK_BW = 450e9            # NVLink 4 a direction per card (not used)

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun_torch")

_ATEN = torch.ops.aten
#: ops that allocate or rename storage without moving data
_NO_TRAFFIC = {_ATEN.empty.memory_format, _ATEN.empty_strided.default,
               _ATEN.empty_like.default, _ATEN.detach.default,
               _ATEN.lift_fresh.default, _ATEN.alias.default}
#: the reference's collective families (HLO op names)
FAMILIES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute")
#: namespaces of the collective ops DTensor issues
_COMM_NAMESPACES = {"_c10d_functional", "_c10d_functional_autograd", "c10d",
                    "_dtensor"}
#: each collective op (by overload packet name) -> its family
_FAMILY_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
}
#: ops of those namespaces that move no data between ranks
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}
#: the CUDA caching allocator's block: every allocation rounds up to it
ALLOC_BLOCK = 512


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _alloc_bytes(nbytes: int) -> int:
    """The bytes the caching allocator holds for an allocation of
    ``nbytes`` (none for an empty one)."""
    return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK


def _group_name(func, args, kwargs) -> str:
    if "group_name" in kwargs:
        return kwargs["group_name"]
    names = [a.name for a in func._schema.arguments]
    return args[names.index("group_name")]


class LocalTally(TorchDispatchMode):
    """What this rank runs on its own tensors: the FLOPs
    (``FlopCounterMode``'s table) and bytes (each op's tensor inputs and
    outputs, once each per op; an op that returns nothing writes the
    arguments it mutates) of every op on plain tensors, in total, by op and
    by (shape, op); the result bytes of every collective, by family and by
    the group it runs on; and the bytes alive at once of the storages those
    ops allocate (``live``, its high-water mark ``peak``): an op's output
    whose storage is none of its inputs' and not seen before is an
    allocation, counted until its storage is released. An op on DTensors is
    returned to DTensor (``NotImplemented``), which runs it as local ops and
    collectives that come back here. On plain tensors that is every op."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        #: each allocated storage alive -> (its bytes, a weak reference
        #: whose callback releases it)
        self._alive: dict = {}
        self.flops = 0
        self.total = 0
        self.by_op: collections.Counter = collections.Counter()
        self.count_op: collections.Counter = collections.Counter()
        self.by_shape: collections.Counter = collections.Counter()
        self.collectives: collections.Counter = collections.Counter()
        self.by_group: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation inferring shapes: no work
            return func(*args, **kwargs)
        if func.namespace in _COMM_NAMESPACES:
            return self._collective(func, args, kwargs)
        packet = func.overloadpacket
        if packet not in flop_registry and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self._allocated(out, (args, kwargs))
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if func.is_view or func in _NO_TRAFFIC:
            return out
        outs = _tensors(out)
        written = outs or [a for a, s in zip(args, func._schema.arguments)
                           if isinstance(a, torch.Tensor)
                           and s.alias_info is not None
                           and s.alias_info.is_write]
        b = sum(_nbytes(t) for t in _tensors((args, kwargs)) + written)
        name = packet.__name__
        self.total += b
        self.by_op[name] += b
        self.count_op[name] += 1
        if written:
            o = written[0]
            dt = str(o.dtype).replace("torch.", "")
            self.by_shape[f"{dt}{list(o.shape)} {name}"] += b
        return out

    def _allocated(self, out, inputs) -> None:
        """Count the storages of ``out`` that are new: neither an input's
        (a view, an in-place op) nor one counted before."""
        given = {StorageWeakRef(t.untyped_storage())
                 for t in _tensors(inputs)}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = StorageWeakRef(st)
            if key in given or key in self._alive:
                continue
            n = _alloc_bytes(st.nbytes())
            # the Python storage lives as long as the storage itself
            self._alive[key] = (n, weakref.ref(
                st, functools.partial(self._released, key)))
            self.live += n
            self.peak = max(self.peak, self.live)

    def _released(self, key, _ref) -> None:
        n, _ = self._alive.pop(key)
        self.live -= n

    def allocated_bytes(self, tree) -> int:
        """The bytes of the storages alive in ``tree`` that were allocated
        under this tally, each once."""
        keys = {StorageWeakRef((t._local_tensor if isinstance(t, DTensor)
                                else t).untyped_storage())
                for t in _tensors(tree)}
        return sum(self._alive[k][0] for k in keys if k in self._alive)

    def _collective(self, func, args, kwargs):
        out = func(*args, **kwargs)
        self._allocated(out, (args, kwargs))
        name = func.overloadpacket.__name__
        if name in _NOT_COLLECTIVES:
            return out
        if name not in _FAMILY_OF:
            raise NotImplementedError(f"LocalTally: collective {func} has "
                                      f"no family")
        b = sum(_nbytes(t) for t in _tensors(out))
        self.collectives[_FAMILY_OF[name]] += b
        self.by_group[_group_name(func, args, kwargs)] += b
        return out


@dataclass
class Tally:
    """What one run of a cell's step counted (on one rank)."""
    flops: int
    bytes: int
    by_op: dict = field(default_factory=dict)
    count_op: dict = field(default_factory=dict)
    by_shape: dict = field(default_factory=dict)
    collectives: dict = field(default_factory=dict)
    by_group: dict = field(default_factory=dict)
    seconds: float = 0.0
    #: the most bytes allocated in the run and alive at once
    peak_bytes: int = 0
    #: the bytes of the returned tensors the run allocated
    output_bytes: int = 0

    def collective_bytes(self) -> dict:
        """Bytes by family under the reference's keys, and their total."""
        out = {f: float(self.collectives.get(f, 0)) for f in FAMILIES}
        out["total"] = sum(out.values())
        return out


def count(fn, *args) -> Tally:
    """Run ``fn(*args)`` under ``LocalTally``."""
    t0 = time.perf_counter()
    with LocalTally() as lt:
        out = fn(*args)
        output_bytes = lt.allocated_bytes(out)
    return Tally(flops=lt.flops, bytes=lt.total, by_op=dict(lt.by_op),
                 count_op=dict(lt.count_op), by_shape=dict(lt.by_shape),
                 collectives=dict(lt.collectives),
                 by_group=dict(lt.by_group),
                 seconds=time.perf_counter() - t0, peak_bytes=lt.peak,
                 output_bytes=output_bytes)


# ---------------------------------------------------------------------------
# a production mesh on a fake process group
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_mesh(mesh: MeshShape, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``mesh``'s shape and axis names as seen by rank 0
    of a fake process group of ``prod(shape)`` ranks (no communication, no
    device: its collectives return without writing), made the default
    group here and destroyed on exit. Refuses to run beside another default
    group. ``device_type`` "cuda" is the card's; on a "cpu" mesh DTensor
    runs each all-to-all as gloo's all-gather and a chunk (as on two real
    gloo ranks, which the tests count it against)."""
    # registers the "fake" backend (it ships with PyTorch)
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a default process group exists; "
                           "count in a process of its own")
    n = math.prod(mesh.shape)
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=n)
    # DTensor warns of every redistribution it runs as several collectives
    log = logging.getLogger("torch.distributed.tensor._redistribute")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        yield DeviceMesh(device_type, torch.arange(n).view(mesh.shape),
                         mesh_dim_names=mesh.axis_names)
    finally:
        log.setLevel(level)
        dist.destroy_process_group()


def _on_mesh(tree, axes, rules: dict, mesh: DeviceMesh):
    """Every meta leaf of ``tree`` as a DTensor on ``mesh`` placed by its
    logical ``axes`` under ``rules``, whose local tensor is a meta tensor of
    this rank's shard."""
    if isinstance(tree, dict):
        return {k: _on_mesh(v, axes[k], rules, mesh) for k, v in tree.items()}
    placements = shd.placements_for(mesh, shd.spec_for(axes, rules))
    local, _ = compute_local_shape_and_global_offset(tree.shape, mesh,
                                                     placements)
    return DTensor.from_local(
        torch.empty(local, dtype=tree.dtype, device=META), mesh, placements,
        run_check=False, shape=tree.shape, stride=tree.stride())


# ---------------------------------------------------------------------------
# step functions + input specs per cell kind
# ---------------------------------------------------------------------------


def _constrain(rules: Optional[dict]):
    return functools.partial(shd.constrain, rules=rules)


def serve_step(cfg: ArchConfig, rules: Optional[dict] = None):
    """One decode step: a new token against a seq_len cache, its sharding
    constraints bound to ``rules`` (the identity on plain tensors)."""

    def fn(params, tokens, cache, pos):
        return M.decode_step(params, cfg, tokens, cache, pos,
                             attn_impl="torch", moe_impl="einsum",
                             constrain=_constrain(rules))

    return fn


def prefill_step(cfg: ArchConfig, rules: Optional[dict] = None):
    def fn(params, tokens, cache, frontend=None):
        return M.prefill(params, cfg, tokens, cache, attn_impl="torch",
                         ssm_impl="torch", moe_impl="einsum",
                         frontend=frontend, constrain=_constrain(rules))

    return fn


def _cell(shape: Union[str, ShapeCell]) -> ShapeCell:
    return SHAPES[shape] if isinstance(shape, str) else shape


def cell_config(cfg: ArchConfig, cell: ShapeCell,
                remat: str = "dots") -> ArchConfig:
    """``cfg`` as the cell's step runs it: a train cell under the
    rematerialisation policy ``remat``, a serving cell under none (the
    reference's ``lower_cell``)."""
    R.check(remat)
    return replace(cfg, remat=remat if cell.kind == "train" else "none")


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


def _run_step(cfg: ArchConfig, cell: ShapeCell, inputs: dict,
              rules: Optional[dict]) -> Tally:
    """Count the cell's step on ``inputs`` (plain or DTensor leaves)."""
    if cell.kind == "train":
        step = build_train_step(cfg, TrainConfig(optim=OptimConfig()), rules)
        return count(step, inputs["state"], inputs["batch"])
    if cell.kind == "prefill":
        args = [inputs["params"], inputs["tokens"], inputs["cache"]]
        if "frontend" in inputs:
            args.append(inputs["frontend"])
        return count(prefill_step(cfg, rules), *args)
    return count(serve_step(cfg, rules), inputs["params"], inputs["tokens"],
                 inputs["cache"], inputs["pos"])


def tally_cell(arch: str, shape: Union[str, ShapeCell],
               cfg: Optional[ArchConfig] = None,
               remat: str = "dots") -> Tally:
    """Run the cell's step once on plain meta tensors (no mesh: every
    ``constrain`` is the identity), a train cell under ``remat``, and count
    it: the global count."""
    cell = _cell(shape)
    cfg = cell_config(cfg if cfg is not None else get_config(arch), cell,
                      remat)
    return _run_step(cfg, cell, _cell_inputs(cfg, cell)[0], None)


def mesh_tally(cfg: ArchConfig, cell: ShapeCell, mesh: DeviceMesh,
               rules: dict) -> Tally:
    """Run the cell's step once as this rank of ``mesh``, every input a
    DTensor of meta shards placed by ``rules``, and count this rank's ops
    and collectives (``Tally.by_group`` keyed by mesh axis name). ``cfg``
    runs as it is (``cell_config`` sets the remat)."""
    inputs, axes = _cell_inputs(cfg, cell)
    tally = _run_step(cfg, cell, _on_mesh(inputs, axes, rules, mesh), rules)
    axis_of = {mesh.get_group(i).group_name: name
               for i, name in enumerate(mesh.mesh_dim_names)}
    by_axis = collections.Counter()
    for g, b in tally.by_group.items():
        by_axis[axis_of.get(g, g)] += b
    tally.by_group = dict(by_axis)
    return tally


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
               tally: Optional[Tally] = None, remat: str = "dots",
               verbose: bool = True) -> dict:
    """The counterpart of the reference's ``lower_cell``: the cell's step
    counted as rank 0 of ``mesh``, a train cell under the rematerialisation
    policy ``remat``, its roofline terms and its memory. ``mesh`` is a
    ``DeviceMesh`` (used as it is) or a ``MeshShape`` (a ``fake_mesh`` is
    made for the count); ``tally`` is the global count
    (``tally_cell``'s under the same ``remat``, made when not given);
    ``cfg`` replaces the arch's published config (a reduced one, in
    tests)."""
    cell = _cell(shape)
    cfg = cell_config(cfg if cfg is not None else get_config(arch), cell,
                      remat)
    tally = tally if tally is not None else tally_cell(arch, cell, cfg,
                                                       cfg.remat)
    rules = rules_for(cfg, mesh, cell)
    sizes = shd.mesh_axis_sizes(mesh)
    n_dev = math.prod(sizes.values())
    if isinstance(mesh, DeviceMesh):
        local = mesh_tally(cfg, cell, mesh, rules)
    else:
        with fake_mesh(mesh) as dm:
            local = mesh_tally(cfg, cell, dm, rules)
    inputs, axes = _cell_inputs(cfg, cell)
    arg = argument_bytes(inputs, axes, rules, mesh)
    state_bytes = (argument_bytes(inputs["state"], axes["state"], rules, mesh)
                   if cell.kind == "train" else None)
    coll = local.collective_bytes()
    terms = {"compute_s": local.flops / PEAK_FLOPS,
             "memory_s": local.bytes / HBM_BW,
             "collective_s": coll["total"] / LINK_BW}
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
        "flops_per_dev": float(local.flops),
        "bytes_per_dev": float(local.bytes),
        "collective_bytes_per_dev": coll,
        "collective_bytes_by_axis": {a: float(local.by_group.get(a, 0))
                                     for a in sizes},
        "memory": {"argument_bytes": arg, "state_bytes": state_bytes,
                   "output_bytes": local.output_bytes,
                   "temp_bytes": local.peak_bytes - local.output_bytes},
        "over_hbm": arg + local.peak_bytes > HBM_BYTES,
        "terms_s": terms,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": mf / max(local.flops * n_dev, 1.0),
        "count_s": round(tally.seconds + local.seconds, 2),
        "remat": cfg.remat,
    }
    if verbose:
        print(_line(result), flush=True)
    return result


def peak_bytes(res: dict) -> int:
    """A result's peak of bytes allocated in the step: temporaries and
    outputs."""
    return res["memory"]["temp_bytes"] + res["memory"]["output_bytes"]


def _line(res: dict) -> str:
    """One cell's result as a line of text."""
    t = res["terms_s"]
    fam = " ".join(f"{k}={v / 1e9:.3f}GB"
                   for k, v in res["collective_bytes_per_dev"].items()
                   if v and k != "total")
    return (f"[dryrun] {res['arch']:>24s} {res['shape']:<12s} "
            f"mesh={res['mesh']:<8s} "
            f"compute={t['compute_s'] * 1e3:9.3f}ms "
            f"memory={t['memory_s'] * 1e3:9.3f}ms "
            f"coll={t['collective_s'] * 1e3:9.3f}ms "
            f"dom={res['dominant'].split('_')[0]:<10s} "
            f"args/dev={res['memory']['argument_bytes'] / 1e9:8.3f}GB "
            f"temp/dev={res['memory']['temp_bytes'] / 1e9:8.3f}GB "
            f"peak/dev={peak_bytes(res) / 1e9:8.3f}GB"
            f"{' OVER HBM' if res['over_hbm'] else ''} "
            f"remat={res['remat']} "
            f"count={res['count_s']:6.1f}s [{fam or 'no collectives'}]")


# ---------------------------------------------------------------------------
# every cell
# ---------------------------------------------------------------------------


def _count_one(arch: str, shape: str, meshes: tuple,
               remat: str = "dots") -> list[dict]:
    """One cell: its global count, then its count on each named mesh
    ("single": (16, 16), "multipod": (2, 16, 16)), a train cell under
    ``remat``; a failure is recorded in the cell's result, with its
    traceback."""
    out = []
    try:
        tally = tally_cell(arch, shape, remat=remat)
    except Exception as e:  # noqa: BLE001 — record, keep going
        return [{"arch": arch, "shape": shape, "mesh": m, "status": "error",
                 "error": repr(e), "traceback": traceback.format_exc()}
                for m in meshes]
    for m in meshes:
        mesh = make_production_mesh(multi_pod=(m == "multipod"))
        try:
            res = count_cell(arch, shape, mesh, tally=tally, remat=remat,
                             verbose=False)
            res["status"] = "ok"
        except Exception as e:  # noqa: BLE001 — record, keep going
            res = {"arch": arch, "shape": shape, "mesh": m,
                   "status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()}
        res["mesh_name"] = m
        out.append(res)
    return out


def _count_star(job) -> list[dict]:
    return _count_one(*job)


def run_cells(archs, shapes, meshes, out_dir: str = ARTIFACT_DIR,
              jobs: int = 1, remat: str = "dots") -> list[dict]:
    """Every applicable (arch, shape), counted on each mesh ("single",
    "multipod"), train cells under ``remat``, over ``jobs`` worker
    processes (spawned; each cell's counts in one worker, each count on a
    fake group of its own). Prints one line a cell and mesh as results
    arrive and writes each as JSON."""
    os.makedirs(out_dir, exist_ok=True)
    work = []
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes:
            if cell_applicable(cfg, shape):
                work.append((arch, shape, tuple(meshes), remat))
            else:
                print(f"[dryrun] {arch:>24s} {shape:<12s} SKIP "
                      f"(full-attention arch)")
    results = []

    def take(batch):
        for res in batch:
            results.append(res)
            if res["status"] == "ok":
                print(_line(res), flush=True)
            else:
                print(f"[dryrun] {res['arch']:>24s} {res['shape']:<12s} "
                      f"mesh={res['mesh']:<8s} ERROR {res['error']}",
                      flush=True)
            path = os.path.join(out_dir, f"{res['mesh_name']}__{res['arch']}"
                                         f"__{res['shape']}.json")
            with open(path, "w") as f:
                json.dump(res, f, indent=1)

    if jobs <= 1:
        for job in work:
            take(_count_one(*job))
        return results
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(jobs, len(work))) as pool:
        for batch in pool.imap_unordered(_count_star, work):
            take(batch)
    return results


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (one cell at a time each)")
    ap.add_argument("--remat", default="dots", choices=list(R.POLICIES),
                    help="rematerialisation policy of the train cells")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args()
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = (["single", "multipod"] if args.mesh == "both"
              else [args.mesh])
    t0 = time.perf_counter()
    results = run_cells(archs, shapes, meshes, out_dir=args.out,
                        jobs=args.jobs, remat=args.remat)
    ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"[dryrun] {ok}/{len(results)} cells counted OK in "
          f"{time.perf_counter() - t0:.1f} s with {args.jobs} job(s)")
    if ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
