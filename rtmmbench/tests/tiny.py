"""Tiny-width stand-ins of the benchmark's configurations and traffic, for
rehearsals on the CPU: every width cut, the structure (kinds of layer,
cascade, supernet variants, slices, engine settings) kept."""
from __future__ import annotations

import copy
import json

from rtmmbench.harness import PKG, reference_module

#: each model entry's widths at tiny size, by family, where its reference
#: module has no ``TINY`` of its own
_TINY = {
    "dense": dict(d_model=64, num_heads=4, num_kv_heads=4, d_ff=96,
                  vocab_size=256),
    "moe": dict(d_model=64, num_heads=4, num_kv_heads=2, d_ff=64,
                vocab_size=200, num_experts=16),
    "ssm": dict(d_model=32, vocab_size=128, ssm_state=16, ssm_heads=4,
                ssm_chunk=8),
    "hybrid": dict(d_model=32, num_heads=4, num_kv_heads=4, d_ff=64,
                   vocab_size=128, ssm_state=8, ssm_heads=4, ssm_chunk=8,
                   shared_attn_every=2),
}


def config(name: str, limit: float = 0.05, share: float = 0.03,
           keep_depth: bool = False) -> dict:
    """The configuration ``name`` at tiny width, with the same ``limit``
    on every model's logit gap and ``share`` on a routed model's share of
    positions over ``harness.SHARE_OVER`` (the configuration's own limits
    with ``keep_depth``, which keeps every model's depth and variants as
    they are). A model's tiny widths are its reference module's ``TINY``
    where it has one; its tiny depth is ``TINY``'s ``num_layers``, and each
    supernet variant's the module's ``TINY_VARIANT_LAYERS``, where the
    module gives them, else the cut of its family (``_tiny_depth``)."""
    c = json.loads((PKG / "configs" / f"{name}.json").read_text())
    for role in c["serves"]:
        m = c[role]
        module = reference_module(m, role)
        widths = getattr(module, "TINY", None)
        if widths is None:
            widths = _TINY[m["config"]["family"]]
        m["config"].update({k: v for k, v in widths.items()
                            if k != "num_layers"})
        if keep_depth:
            if m["config"].get("shared_attn_every"):
                m["config"]["shared_attn_every"] = 6
            continue
        depth, variant_depth = _tiny_depth(m)
        m["config"]["num_layers"] = widths.get("num_layers", depth)
        if "supernet" in m:
            n = getattr(module, "TINY_VARIANT_LAYERS", variant_depth)
            m["supernet"] = {v: {"num_layers": n} for v in m["supernet"]}
    if not keep_depth:
        c["limits"] = {}
        for role in c["serves"]:
            for name in [role, *c[role].get("supernet", {})]:
                if c[role]["config"].get("num_experts"):
                    c["limits"][f"logit_share.{name}"] = share
                else:
                    c["limits"][f"logit_err.{name}"] = limit
    return c


def _tiny_depth(m: dict) -> tuple[int, int]:
    """(depth, each supernet variant's depth) of model entry ``m`` at tiny
    size by its family: a hybrid 4 and 2, a model with variants 2 and 1,
    any other at most 2."""
    if m["config"]["family"] == "hybrid":
        return 4, 2
    if "supernet" in m:
        return 2, 1
    return min(m["config"]["num_layers"], 2), 1


def mix(name: str, seq: int = 16, fps: float = 40.0,
        traffic: str = "steady") -> dict:
    """The traffic ``traffic`` of ``name`` with short frames and head
    rates of ``fps``."""
    t = copy.deepcopy(json.loads(
        (PKG / "traffic" / traffic / f"{name}.json").read_text()))
    for st in t["streams"].values():
        st["seq"] = seq
        if "fps" in st:
            st["fps"] = fps
    t["drain_s"] = 0.5
    return t
