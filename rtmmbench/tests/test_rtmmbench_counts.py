"""The benchmark's counts of operations and bytes: against hand counts for
one layer of each architecture, and against ``FlopCounterMode`` over the
plain reference at a tiny shape."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from rtmmbench import counts, weights
from rtmmbench.reference import model as ref
from rtmmbench.tests import tiny

S = 64


def _one(cfg: dict, **over) -> dict:
    c = dict(cfg, **over)
    return counts.call_counts(c, S)


def _dense(moe: bool) -> dict:
    c = tiny.config("rtmm_vision")
    cfg = c["verifier" if moe else "detector"]["config"]
    return dict(cfg, num_layers=1)


def test_dense_layer_by_hand():
    cfg = _dense(moe=False)
    d, n, k, f, v = (cfg[x] for x in ("d_model", "num_heads", "num_kv_heads",
                                      "d_ff", "vocab_size"))
    h = d // n
    c = counts.call_counts(cfg, S)
    assert c["layers"]["proj"] == (2 * S * d * (n + 2 * k) * h
                                   + 2 * S * n * h * d + 6 * S * d * f
                                   + 2 * S * d * v)
    assert c["layers"]["attn"] == 4 * n * h * S * (S + 1) // 2
    fl, nb, launches = c["kernels"]["flash"]
    assert launches == 1 and fl == c["layers"]["attn"]
    assert nb == (2 * S * n * h + 2 * S * k * h) * 2


def test_moe_layer_by_hand():
    cfg = _dense(moe=True)
    d, f, e, top = (cfg[x] for x in ("d_model", "d_ff", "num_experts",
                                     "num_experts_per_tok"))
    c = counts.call_counts(cfg, S)
    assert c["layers"]["experts"] == 6 * S * top * d * f
    fl, nb, launches = c["kernels"]["gmm"]
    t = S * top
    assert launches == 3 and fl == 6 * t * d * f
    per = (e * d * f + t * d + t * f) * 2 + 4 * e
    assert nb == 3 * per
    # fewer live experts read fewer weights
    fewer = counts.call_counts(cfg, S, live_experts=[e // 2])
    assert fewer["kernels"]["gmm"][1] == nb - 3 * (e - e // 2) * d * f * 2


def test_mamba_layer_by_hand():
    cfg = dict(tiny.config("rtmm_audio")["kws"]["config"], num_layers=1)
    d, n, h, ch = (cfg[x] for x in ("d_model", "ssm_state", "ssm_heads",
                                    "ssm_chunk"))
    di = 2 * d
    p = di // h
    c = counts.call_counts(cfg, S)
    assert c["layers"]["proj"] == (2 * S * d * (2 * di + 2 * n + h)
                                   + 2 * S * di * d
                                   + 2 * S * d * cfg["vocab_size"])
    assert c["layers"]["conv"] == 2 * S * (di + 2 * n) * 4
    nc, tri = S // ch, ch * (ch + 1) // 2
    assert c["layers"]["ssd"] == 2 * nc * (tri * n + h * (tri * p
                                                          + 2 * ch * n * p))
    fl, nb, launches = c["kernels"]["ssd"]
    assert launches == 1 and fl == c["layers"]["ssd"]
    assert nb == 2 * S * h * p * 2 + 4 * (S * h + 2 * S * n + 2 * h
                                          + h * n * p)


def _reference_flops(cfg: dict, seed: int = 0) -> int:
    w = weights.make({"m": cfg}, {"m": ref}, seed, torch.device("cpu"),
                     torch.float32)
    tokens = torch.randint(0, cfg["vocab_size"], (1, S))
    with FlopCounterMode(display=False) as fc:
        ref.forward(w.trees["m"], cfg, tokens)
    return fc.get_total_flops()


@pytest.mark.parametrize("role", ["detector", "verifier", "kws", "speech"])
def test_counts_match_flop_counter_over_the_reference(role):
    """The reference computes attention over the whole [S, S] square and the
    state space in its quadratic form; the rest is the same products."""
    name = "rtmm_vision" if role in ("detector", "verifier") else "rtmm_audio"
    cfg = tiny.config(name)[role]["config"]
    c = counts.call_counts(cfg, S)
    want = c["layers"]["proj"] + c["layers"]["experts"]
    groups = ref.num_groups(cfg)
    if cfg.get("num_heads"):
        n = cfg["num_heads"]
        shared = cfg.get("shared_attn_every")
        h = 2 * cfg["d_model"] // n if shared else cfg["d_model"] // n
        attn_layers = groups if shared else cfg["num_layers"]
        want += attn_layers * 4 * n * h * S * S
    if cfg.get("ssm_state"):
        mamba = groups * len(ref.group_kinds(cfg))
        di = 2 * cfg["d_model"]
        want += mamba * (2 * S * S * cfg["ssm_state"] + 2 * S * S * di)
    assert _reference_flops(cfg) == want
