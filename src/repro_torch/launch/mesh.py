"""Production mesh shapes and per-(arch, mesh) sharding rule resolution
(port of ``repro/launch/mesh.py``).

The rule functions are pure functions of a mesh's axis names and shape:
they take a ``torch.distributed.device_mesh.DeviceMesh``
(``mesh_dim_names``, ``shape``) or a ``MeshShape`` record, so a rule table
for a 256-device mesh is resolved in one process with no device at all.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from ..configs import ArchConfig, ShapeCell
from ..distributed.sharding import (DEFAULT_RULES, adapt_rules_for,
                                    mesh_axis_sizes)


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices."""
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: (data=16, model=16) = 256 devices. Multi-pod: a leading
    'pod' axis of 2 = 512 devices; FSDP state shards over (pod, data).

    Returns the shape, not a ``DeviceMesh``: one process cannot hold 256
    devices, and the dry-run and the rule tables need only the axis names
    and sizes."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def rules_for_mesh(mesh, base: Optional[dict] = None) -> dict:
    """Specialize the logical-axis rule table to the mesh's axis names
    (single-pod meshes have no 'pod' axis; drop it from composite rules)."""
    base = dict(DEFAULT_RULES if base is None else base)
    names = set(mesh_axis_sizes(mesh))
    out = {}
    for k, v in base.items():
        if v is None:
            out[k] = None
        elif isinstance(v, str):
            out[k] = v if v in names else None
        else:
            kept = tuple(a for a in v if a in names)
            out[k] = kept if len(kept) > 1 else (kept[0] if kept else None)
    return out


def _axis_size(mesh, rule) -> int:
    if rule is None:
        return 1
    sizes = mesh_axis_sizes(mesh)
    if isinstance(rule, str):
        return sizes.get(rule, 1)
    n = 1
    for a in rule:
        n *= sizes.get(a, 1)
    return n


def rules_for(cfg: ArchConfig, mesh, cell: Optional[ShapeCell] = None,
              base: Optional[dict] = None) -> dict:
    """Mesh- and architecture-aware rule table.

    Degrades any rule whose tensor dimension is not divisible by its mesh
    axes (MQA kv heads, odd vocab sizes, batch=1 long-context cells), and
    re-targets the freed capacity where it helps:
      * kv_heads unshardable on 'model'  -> shard the KV cache on kv_seq
        instead, so long caches still spread over the mesh.
      * batch unshardable (long_500k b=1) -> shard activations on act_seq.
    """
    rules = rules_for_mesh(mesh, base)
    d_inner = cfg.ssm_expand * cfg.d_model if cfg.ssm_state else cfg.d_ff
    dim_of = {
        "heads": cfg.num_heads or 1,
        "kv_heads": cfg.num_kv_heads or 1,
        "act_heads": (cfg.ssm_heads if cfg.is_attention_free
                      else cfg.num_heads) or 1,
        "act_kv_heads": cfg.num_kv_heads or 1,
        "ffn": (min(cfg.d_ff, d_inner) if cfg.d_ff else d_inner),
        "ssm_inproj": (2 * d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
                       if cfg.ssm_state else 1 << 30),
        "experts": cfg.num_experts or 1,
        "vocab": cfg.vocab_size,
        "vocab_out": cfg.vocab_size,
        "fsdp": cfg.d_model,
    }
    if cell is not None:
        dim_of["batch"] = cell.global_batch
    rules = adapt_rules_for(rules, mesh, dim_of)

    model_sz = _axis_size(mesh, "model")
    # attention logits: shard q rows over 'model' when the head count does
    # not divide it (context parallelism: rows of a causal softmax are
    # independent)
    if (cell is not None and rules.get("act_heads") is None
            and model_sz > 1 and cell.seq_len % model_sz == 0):
        rules["act_seq_q"] = "model"
    else:
        rules.setdefault("act_seq_q", None)
    if cell is not None:
        # KV cache: prefer head sharding; fall back to sequence sharding
        if (rules.get("act_kv_heads") is None and model_sz > 1
                and cell.seq_len % model_sz == 0):
            rules["kv_seq"] = "model"
        else:
            rules["kv_seq"] = None
        # batch=1 cells: push the parallelism into the sequence dim
        if rules.get("batch") is None:
            data_rule = rules_for_mesh(mesh, base).get("fsdp")
            if data_rule is not None and cell.seq_len % _axis_size(
                    mesh, data_rule) == 0:
                rules["kv_seq"] = data_rule
            if cell.kind != "decode" and cell.seq_len % model_sz == 0:
                rules["act_seq"] = "model"
    rules.setdefault("act_seq", None)
    rules.setdefault("kv_seq", None)
    return rules
