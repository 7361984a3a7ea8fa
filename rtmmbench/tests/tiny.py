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
    where it has one."""
    c = json.loads((PKG / "configs" / f"{name}.json").read_text())
    for role in c["serves"]:
        m = c[role]
        widths = getattr(reference_module(m, role), "TINY", None)
        m["config"].update(widths if widths is not None
                           else _TINY[m["config"]["family"]])
        if keep_depth:
            if m["config"].get("shared_attn_every"):
                m["config"]["shared_attn_every"] = 6
            continue
        if m["config"]["family"] == "hybrid":
            m["config"]["num_layers"] = 4
            m["supernet"] = {v: {"num_layers": 2} for v in m.get("supernet", {})}
        elif "supernet" in m:
            m["config"]["num_layers"] = 2
            m["supernet"] = {v: {"num_layers": 1} for v in m["supernet"]}
        else:
            m["config"]["num_layers"] = min(m["config"]["num_layers"], 2)
    if not keep_depth:
        c["limits"] = {}
        for role in c["serves"]:
            for name in [role, *c[role].get("supernet", {})]:
                if c[role]["config"].get("num_experts"):
                    c["limits"][f"logit_share.{name}"] = share
                else:
                    c["limits"][f"logit_err.{name}"] = limit
    return c


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
