"""Logical-axis sharding onto a ``DeviceMesh`` (port of
``repro/distributed/sharding.py``).

Every parameter and activation is annotated with *logical* axis names
("batch", "embed", "heads", "experts", ...). A rule table maps the logical
names onto mesh axes; swapping the table re-shards the whole model (DP /
FSDP / TP / EP / SP) without touching model code.

The mesh axes (``launch/mesh.py``):
  pod    — across pods
  data   — data parallel / FSDP within a pod
  model  — tensor / expert / sequence parallel

Rules are (logical_axis -> mesh axis | tuple | None); ``None`` = replicated.

The reference's ``Mesh`` and ``NamedSharding`` become a
``torch.distributed.device_mesh.DeviceMesh`` and DTensor placements
(``placements_for``: one per mesh dimension), and
``with_sharding_constraint`` becomes ``DTensor.redistribute``
(``constrain``). A spec is a plain tuple whose entries are the entries of
the reference's ``PartitionSpec``.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from ..models.layers import is_axes

MeshAxes = Optional[Any]  # str | tuple[str, ...] | None
Spec = tuple

#: Default rule table: FSDP over (pod, data), TP/EP/SP over model.
DEFAULT_RULES: dict[str, MeshAxes] = {
    # activations
    "batch": ("pod", "data"),
    "act_seq": None,            # sequence-parallel activations (long ctx)
    "act_seq_q": None,          # attention-logits q rows (context parallel)
    "kv_seq": None,             # KV-cache sequence axis (decode SP fallback)
    "embed": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_ffn": "model",
    "act_experts": "model",
    "vocab_out": "model",
    # parameters
    "fsdp": ("pod", "data"),    # the FSDP-sharded param axis (usually embed)
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "ssm_inproj": "model",      # fused mamba in_proj output columns
    "ffn_noshard": None,        # per-expert hidden (EP shards experts instead)
    "experts": "model",
    "vocab": "model",
    "layers": None,             # stacked layer-group axis
    "ssm_state": None,
    "conv_kernel": None,
    "head_dim": None,
}


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``launch.mesh.MeshShape``."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


def spec_for(logical: Sequence[Optional[str]],
             rules: Mapping[str, MeshAxes] | None = None) -> Spec:
    """The spec of a tuple of logical axis names (None = replicated): one
    entry per tensor dimension, a mesh axis, a tuple of them or None."""
    rules = DEFAULT_RULES if rules is None else rules
    return tuple(rules.get(ax) if ax is not None else None for ax in logical)


def _axes_of(entry: MeshAxes) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_for(mesh, spec: Spec) -> list[Placement]:
    """One DTensor placement per mesh dimension: ``Shard(d)`` where tensor
    dimension ``d`` is mapped to that mesh axis (a dimension over a tuple
    of axes shards on each of them), ``Replicate()`` elsewhere.

    A mesh axis of size 1 holds every dimension whole, and is
    ``Replicate()`` whatever the spec: the same layout as ``Shard(d)``, but
    DTensor's view rules refuse to merge or drop a sharded dimension of
    size 1 (a one-head MQA key projection inside an einsum), which a
    replicated one they let through."""
    sizes = mesh_axis_sizes(mesh)
    names = tuple(sizes)
    out: list[Placement] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for ax in _axes_of(entry):
            if ax not in names:
                raise ValueError(f"spec {spec} names mesh axis {ax!r}, not "
                                 f"in the mesh's {names}")
            i = names.index(ax)
            if isinstance(out[i], Shard):
                raise ValueError(f"spec {spec} maps mesh axis {ax!r} twice")
            if sizes[ax] > 1:
                out[i] = Shard(d)
    return out


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]],
              rules: Mapping[str, MeshAxes] | None = None) -> torch.Tensor:
    """``x`` redistributed to the spec of ``logical`` on its own mesh.

    A plain tensor (no mesh) and an all-replicated spec return ``x``
    unchanged, as the reference's ``constrain`` does outside a mesh and
    for a spec of Nones."""
    spec = spec_for(logical, rules)
    if not isinstance(x, DTensor) or all(s is None for s in spec):
        return x
    return x.redistribute(x.device_mesh, placements_for(x.device_mesh, spec))


def tree_specs(logical_tree: Any,
               rules: Mapping[str, MeshAxes] | None = None) -> Any:
    """A tree of logical-axis tuples -> the same tree of specs."""
    if is_axes(logical_tree):
        return spec_for(logical_tree, rules)
    return {k: tree_specs(v, rules) for k, v in logical_tree.items()}


def tree_placements(mesh, logical_tree: Any,
                    rules: Mapping[str, MeshAxes] | None = None) -> Any:
    """A tree of logical-axis tuples -> the same tree of placement lists on
    ``mesh`` (the reference's ``tree_shardings``)."""
    if is_axes(logical_tree):
        return placements_for(mesh, spec_for(logical_tree, rules))
    return {k: tree_placements(mesh, v, rules)
            for k, v in logical_tree.items()}


def distribute_tree(tree: dict, mesh, placements: Any) -> dict:
    """Every tensor leaf of ``tree`` distributed onto ``mesh`` by the
    placement list at the same place in ``placements``, in place: each leaf
    is replaced as its DTensor is made, so a plain leaf is freed before the
    next one is copied. Returns ``tree``."""
    for k, v in tree.items():
        tree[k] = (distribute_tree(v, mesh, placements[k])
                   if isinstance(v, dict)
                   else distribute_tensor(v, mesh, placements[k]))
    return tree


def full_tree(tree: Any) -> Any:
    """Every DTensor leaf gathered into a plain tensor (``full_tensor``; a
    collective: every rank calls it); plain leaves as they are."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


# -- divisibility-aware rule adaptation --------------------------------------

def adapt_rules_for(rules: Mapping[str, MeshAxes], mesh,
                    dim_of: Mapping[str, int]) -> dict[str, MeshAxes]:
    """Drop mesh axes a tensor dimension cannot be divided over.

    ``dim_of`` maps logical axis name -> concrete dimension size for this
    model (e.g. {"kv_heads": 1} for an MQA model). Any rule whose dimension
    is not divisible by the product of its mesh-axis sizes is degraded to
    replication, so the same rule table serves every architecture.
    """
    out = dict(rules)
    axis_size = mesh_axis_sizes(mesh)
    for name, dim in dim_of.items():
        prod = 1
        for a in _axes_of(out.get(name)):
            prod *= axis_size.get(a, 1)
        if out.get(name) is not None and dim % prod != 0:
            out[name] = None
    return out
