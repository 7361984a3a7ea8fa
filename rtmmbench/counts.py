"""Floating-point operations and bytes of one served call, by layer and by
kernel, from a configuration's model entry and the frame's length alone.

Operations are 2 per multiply-add. ``layers`` holds the model's operations
by kind: the weight products (``proj``: attention and Mamba2 projections,
MLPs, the router, the unembedding), the routed experts (``experts``), the
attention core over the causal (query, key) pairs (``attn``), the chunked
state-space scan (``ssd``) and the depthwise conv (``conv``). ``kernels``
holds, for each hand-written kernel the call launches, its operations and
the bytes its inputs need moved (each input read once, each output written
once), summed over the call's launches; a kernel's bound is the larger of
operations over the bf16 peak and bytes over the memory peak. Peaks: one
NVIDIA H100 SXM, NVIDIA's data sheet (dense bf16 989 TFLOP/s, 3.35 TB/s).

These are the counts of the architectures ``reference.model`` computes,
its ``call_counts``; a configuration that brings its own reference module
brings its counts with it (``reference``'s contract), and may build them
from the helpers here.

Where the work depends on the data (the experts that receive rows), the
count takes what the frame's inputs need: with ``live_experts`` not given,
every expert that can receive a row (at most ``S * top_k``) does.
"""
from __future__ import annotations

from typing import Callable, Optional

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2
FP32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take for the work."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def _add(acc: dict, key: str, flops: int, nbytes: int = 0) -> None:
    f, b, n = acc.get(key, (0, 0, 0))
    acc[key] = (f + flops, b + nbytes, n + 1)


def attention_counts(s: int, d_in: int, n: int, k: int, hd: int, d_out: int,
                     layers: dict, kernels: dict) -> None:
    layers["proj"] += 2 * s * d_in * (n + 2 * k) * hd + 2 * s * n * hd * d_out
    core = 4 * n * hd * _causal_pairs(s)
    layers["attn"] += core
    _add(kernels, "flash", core, (2 * s * n * hd + 2 * s * k * hd) * BF16)


def mlp_counts(s: int, d: int, f: int, layers: dict) -> None:
    layers["proj"] += 3 * 2 * s * d * f


def moe_counts(s: int, d: int, f: int, e: int, top_k: int,
               live: Optional[int], layers: dict, kernels: dict) -> None:
    t = s * top_k
    live = min(e, t) if live is None else live
    layers["proj"] += 2 * s * d * e                     # router
    layers["experts"] += 3 * 2 * t * d * f
    for d_in, d_out in ((d, f), (d, f), (f, d)):
        _add(kernels, "gmm", 2 * t * d_in * d_out,
             (live * d_in * d_out + t * d_in + t * d_out) * BF16 + 4 * e)


def ssd_flops(s: int, h: int, p: int, n: int, chunk: int) -> int:
    """The chunked scan: C.B^T over each chunk's j <= i half (shared by the
    heads), per head G@x over that half, and C@state and the state update
    over every position."""
    ch = min(chunk, s)
    nc = -(-s // ch)
    tri = ch * (ch + 1) // 2
    return 2 * nc * (tri * n + h * (tri * p + 2 * ch * n * p))


def mamba_counts(cfg: dict, s: int, layers: dict, kernels: dict) -> None:
    d = cfg["d_model"]
    di = cfg.get("ssm_expand", 2) * d
    n, h = cfg["ssm_state"], cfg["ssm_heads"]
    p = di // h
    ch = di + 2 * n
    k = cfg.get("ssm_conv_kernel", 4)
    layers["proj"] += 2 * s * d * (2 * di + 2 * n + h) + 2 * s * di * d
    layers["conv"] += 2 * s * ch * k
    scan = ssd_flops(s, h, p, n, cfg.get("ssm_chunk", 256))
    layers["ssd"] += scan
    sp = -(-s // min(cfg.get("ssm_chunk", 256), s)) * min(
        cfg.get("ssm_chunk", 256), s)
    _add(kernels, "ssd", scan,
         2 * sp * h * p * BF16 + FP32 * (sp * h + 2 * sp * n + 2 * h
                                         + h * n * p))


def call_counts(cfg: dict, s: int,
                live_experts: Optional[list[int]] = None) -> dict:
    """{"flops": total, "layers": {kind: flops}, "kernels": {kernel:
    (flops, bytes, launches)}} of one forward of a [1, s] frame."""
    d, v = cfg["d_model"], cfg["vocab_size"]
    layers = dict.fromkeys(("proj", "experts", "attn", "ssd", "conv"), 0)
    kernels: dict = {}
    shared = cfg.get("shared_attn_every", 0)
    per_group = shared or len(cfg.get("layer_pattern", ("global",)))
    groups = cfg["num_layers"] // per_group
    kinds = ("mamba",) * shared if shared else tuple(
        cfg.get("layer_pattern", ("global",)))
    moe_layer = 0
    for _ in range(groups):
        if shared:
            hd = 2 * d // cfg["num_heads"]
            attention_counts(s, 2 * d, cfg["num_heads"], cfg["num_kv_heads"],
                             hd, d, layers, kernels)
            mlp_counts(s, d, cfg["d_ff"], layers)
        for kind in kinds:
            if kind == "mamba":
                mamba_counts(cfg, s, layers, kernels)
                continue
            hd = cfg.get("head_dim") or d // cfg["num_heads"]
            attention_counts(s, d, cfg["num_heads"], cfg["num_kv_heads"], hd,
                             d, layers, kernels)
            if cfg.get("num_experts"):
                live = (live_experts[moe_layer] if live_experts is not None
                        else None)
                moe_layer += 1
                moe_counts(s, d, cfg["d_ff"], cfg["num_experts"],
                           cfg["num_experts_per_tok"], live, layers, kernels)
            else:
                mlp_counts(s, d, cfg["d_ff"], layers)
    layers["proj"] += 2 * s * d * v                     # unembedding
    return {"flops": sum(layers.values()), "layers": layers,
            "kernels": kernels}


def kernel_bound_s(cfg: dict, s: int, kernel: str,
                   count: Callable[[dict, int], dict] = call_counts
                   ) -> Optional[float]:
    """Seconds the chip needs at least for ``kernel``'s launches in one
    call, each launch bounded alone; None where the call launches none.
    ``count`` is the model's ``call_counts`` (its reference module's)."""
    c = count(cfg, s)["kernels"].get(kernel)
    if c is None:
        return None
    flops, nbytes, launches = c
    return launches * bound_s(flops / launches, nbytes / launches)
