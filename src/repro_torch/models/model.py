"""The LM: composes attention and SSD blocks into an architecture (port of
``repro/models/model.py``: config plumbing, ``init_params`` and
``forward``).

Params are plain dicts of tensors with the JAX package's names; the layer
groups of ``params["blocks"]`` are stacked along a leading group axis, as
``jax.lax.scan`` wants them there, and run here as a Python loop
(``scan_layers`` and ``remat`` have no numeric effect). ``LM`` is a thin
``nn.Module`` veneer over the functions.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .. import resolve_device
from ..configs import ArchConfig
from . import attention as attn
from . import layers, ssm
from .layers import Tensor

_LATER = "the MoE / remaining-architectures slice"


# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.num_experts:
        raise NotImplementedError(f"MoE blocks ({cfg.name}) come with {_LATER}")
    if cfg.shared_attn_every:
        raise NotImplementedError(
            f"the zamba2 shared attention block ({cfg.name}) comes with {_LATER}")
    if cfg.frontend or cfg.pos_embed != "rope":
        raise NotImplementedError(
            f"frontends and absolute positions ({cfg.name}) come with {_LATER}")


def attn_cfg_for(cfg: ArchConfig, kind: str) -> attn.AttnConfig:
    return attn.AttnConfig(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta,
        logit_softcap=cfg.attn_logit_softcap,
        window=cfg.local_window if kind == "local" else None,
        scale=cfg.attn_scale,
    )


def ssm_cfg_for(cfg: ArchConfig) -> ssm.SSMConfig:
    return ssm.SSMConfig(
        d_model=cfg.d_model,
        state=cfg.ssm_state,
        heads=cfg.ssm_heads,
        expand=cfg.ssm_expand,
        conv_kernel=cfg.ssm_conv_kernel,
        chunk=cfg.ssm_chunk,
    )


def group_pattern(cfg: ArchConfig) -> tuple[str, ...]:
    """Block kinds inside one layer group."""
    return cfg.layer_pattern


def num_groups(cfg: ArchConfig) -> int:
    pat = len(group_pattern(cfg))
    assert cfg.num_layers % pat == 0, (cfg.num_layers, pat)
    return cfg.num_layers // pat


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------


def _block_init(gen: torch.Generator, cfg: ArchConfig, kind: str) -> dict:
    dev = gen.device
    if kind == "mamba":
        return {"ln": layers.rmsnorm_init(cfg.d_model, dev),
                "ssm": ssm.ssm_init(gen, ssm_cfg_for(cfg))}
    p = {
        "ln1": layers.rmsnorm_init(cfg.d_model, dev),
        "attn": attn.attn_init(gen, attn_cfg_for(cfg, kind)),
        "ln2": layers.rmsnorm_init(cfg.d_model, dev),
        "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated),
    }
    if cfg.post_norms:
        p["post_ln1"] = layers.rmsnorm_init(cfg.d_model, dev)
        p["post_ln2"] = layers.rmsnorm_init(cfg.d_model, dev)
    return p


def _apply_block(params: dict, cfg: ArchConfig, kind: str, x: Tensor,
                 positions: Tensor, attn_impl: str, ssm_impl: str) -> Tensor:
    if kind == "mamba":
        h = layers.rmsnorm(params["ln"], x)
        return x + ssm.ssm_apply(params["ssm"], ssm_cfg_for(cfg), h,
                                 impl=ssm_impl)
    h = layers.rmsnorm(params["ln1"], x)
    a = attn.attend_full(params["attn"], attn_cfg_for(cfg, kind), h,
                         positions, impl=attn_impl)
    if cfg.post_norms:
        a = layers.rmsnorm(params["post_ln1"], a)
    x = x + a
    h = layers.rmsnorm(params["ln2"], x)
    m = layers.mlp(params["mlp"], h, act=cfg.mlp_act)
    if cfg.post_norms:
        m = layers.rmsnorm(params["post_ln2"], m)
    return x + m


# ---------------------------------------------------------------------------
# whole-model init / forward
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ArchConfig,
                device: str | torch.device = "cuda") -> dict:
    """Random float32 parameters on ``device`` (CUDA unless the caller asks
    for the CPU), drawn from ``gen``, a generator on that device."""
    _check_supported(cfg)
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, parameters asked for "
                         f"on {dev}")
    pat = group_pattern(cfg)
    params: dict = {
        "embed": layers.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                       cfg.tie_embeddings),
        "final_norm": layers.rmsnorm_init(cfg.d_model, gen.device),
    }
    groups = [{str(i): _block_init(gen, cfg, kind)
               for i, kind in enumerate(pat)} for _ in range(num_groups(cfg))]
    params["blocks"] = _stack(groups)
    return params


def _stack(trees: list[dict]) -> dict:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def forward(params: dict, cfg: ArchConfig, tokens: Tensor,
            attn_impl: str = "kernel",
            ssm_impl: str = "kernel") -> tuple[Tensor, Tensor]:
    """Causal LM forward. tokens: [B, S] int -> (logits [B,S,V] f32, aux).
    ``aux`` is the MoE load-balance loss of the JAX package, zero here."""
    _check_supported(cfg)
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    x = layers.embed_tokens(params["embed"], tokens, cfg.embed_scale,
                            compute_dtype(cfg))
    for gi in range(num_groups(cfg)):
        gparams = tree_map(lambda p: p[gi], params["blocks"])
        for i, kind in enumerate(group_pattern(cfg)):
            x = _apply_block(gparams[str(i)], cfg, kind, x, positions,
                             attn_impl, ssm_impl)
    x = layers.rmsnorm(params["final_norm"], x)
    logits = layers.unembed(params["embed"], x, cfg.final_logit_softcap)
    return logits, torch.zeros((), dtype=torch.float32, device=dev)


# ---------------------------------------------------------------------------
# convenience
# ---------------------------------------------------------------------------


class LM(nn.Module):
    """Thin ``nn.Module`` veneer over the functional API. Parameters are
    drawn from ``seed`` on ``device`` (CUDA unless the caller asks for the
    CPU) unless given."""

    def __init__(self, cfg: ArchConfig, params: Optional[dict] = None, *,
                 device: str | torch.device = "cuda", seed: int = 0,
                 attn_impl: str = "kernel", ssm_impl: str = "kernel"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, cfg, self.device)
        self.params = params
        self.attn_impl = attn_impl
        self.ssm_impl = ssm_impl

    def forward(self, tokens: Tensor) -> tuple[Tensor, Tensor]:
        return forward(self.params, self.cfg, tokens, self.attn_impl,
                       self.ssm_impl)
