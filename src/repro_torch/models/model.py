"""The LM: composes attention, MoE and SSD blocks into any of the ten
architectures (port of ``repro/models/model.py``: config plumbing,
``init_params``, ``forward``, the stacked decode cache, ``prefill`` and
``decode_step``).

Beside the per-layer blocks: zamba2's shared attention block (one set of
weights, ``params["shared_attn"]``, applied over ``concat(x, x0)`` at the
head of every group of six mamba blocks, with a KV cache of its own per
group, ``cache[...]["shared"]``), the frontend stub of the vision and audio
models (``frontend`` embeddings projected by ``params["frontend"]["proj"]``
fill the head of the prompt in ``forward`` and ``prefill``), and MusicGen's
absolute sinusoidal positions (added to the embeddings, and no RoPE).

Params are plain dicts of tensors with the JAX package's names; the layer
groups of ``params["blocks"]`` are stacked along a leading group axis, as
``jax.lax.scan`` wants them there, and run here as a Python loop
(``scan_layers`` has no numeric effect). ``forward`` checkpoints each group
under ``cfg.remat`` when grad mode is on (``models.remat``: "full", "dots"
or "dots_nobatch", the reference's ``jax.checkpoint`` policies);
``prefill`` and ``decode_step`` never do, as in the reference. ``LM`` is a thin
``nn.Module`` veneer over the functions.

``moe_impl`` picks the MoE dispatch of attention blocks with experts:
``"kernel"`` (sort + grouped-matmul kernel, no token dropped; the card's
path) or ``"einsum"`` (capacity-dropped dispatch, the JAX package's default
``cfg.moe_impl``); see ``models.moe``.

The decode cache mirrors the reference's tree (per block of a group
``{"k", "v"}`` or ``{"conv", "ssm"}``, each leaf stacked along the group
axis), but ``prefill`` and ``decode_step`` write it in place and return the
dict they were given: a cache that a step has consumed holds that step's
result, and is not the cache from before it.

Sharding: ``param_axes`` and ``cache_axes`` name the logical axes of every
leaf (the blocks' with the leading ``"layers"`` axis of the group stack),
``param_spec`` and ``cache_spec`` are the trees as meta tensors (the
counterparts of ``jax.eval_shape(init_params)`` and the reference's
``ShapeDtypeStruct`` cache), and ``forward``, ``prefill``, ``decode_step``
and ``LM`` take the reference's ``constrain`` callback (identity by
default; ``distributed.sharding.constrain`` bound to a rule table on a
mesh). On a mesh the frontend projection goes through ``layers.dense`` and
``ssm_prefill``'s decode state (a pad and a slice of the last positions,
whose DTensor pad raises in torch 2.11) through ``placement.per_shard``.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..configs import ArchConfig
from ..placement import on_mesh_of, per_shard
from . import attention as attn
from . import layers, moe, remat, ssm
from .layers import Constrain, Tensor, no_constraint

# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------


def _check_moe_impl(moe_impl: str) -> None:
    if moe_impl not in moe.IMPLS:
        raise ValueError(f"moe_impl {moe_impl!r} not in {moe.IMPLS}")


def attn_cfg_for(cfg: ArchConfig, kind: str) -> attn.AttnConfig:
    """The attention of a block of ``kind``; "shared" is zamba2's shared
    block."""
    if kind == "shared":
        return shared_attn_cfg_for(cfg)
    return attn.AttnConfig(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias,
        rope_theta=None if cfg.pos_embed == "absolute" else cfg.rope_theta,
        logit_softcap=cfg.attn_logit_softcap,
        window=cfg.local_window if kind == "local" else None,
        scale=cfg.attn_scale,
    )


def shared_attn_cfg_for(cfg: ArchConfig) -> attn.AttnConfig:
    """Zamba2's shared block: input concat(x, x_embed) of width 2D, head
    dim 2D / heads (160 at zamba2-2.7b), output width D."""
    return attn.AttnConfig(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=(2 * cfg.d_model) // cfg.num_heads,
        rope_theta=cfg.rope_theta,
        q_in_dim=2 * cfg.d_model,
        out_dim=cfg.d_model,
    )


def moe_cfg_for(cfg: ArchConfig) -> moe.MoEConfig:
    return moe.MoEConfig(
        d_model=cfg.d_model,
        d_ff=cfg.d_ff,
        num_experts=cfg.num_experts,
        top_k=cfg.num_experts_per_tok,
        capacity_factor=cfg.moe_capacity_factor,
        act=cfg.mlp_act,
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
    """Block kinds inside one layer group (zamba2: the mamba blocks between
    two applications of the shared block)."""
    if cfg.shared_attn_every:
        return ("mamba",) * cfg.shared_attn_every
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


def tree_leaves(tree) -> list:
    """Every tensor leaf of a nested dict, over sorted keys (the order of
    ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> dict:
    """A tree shaped like ``like`` holding ``leaves`` (in ``tree_leaves``'
    order)."""
    return _fill(like, iter(leaves))


def _fill(like, it):
    # a module-level function: a nested one that calls itself is a
    # reference cycle, which would keep ``leaves`` (a step's gradients)
    # alive until the garbage collector runs
    if isinstance(like, dict):
        return {k: _fill(like[k], it) for k in sorted(like)}
    return next(it)


# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------


def _block_init(gen: Optional[torch.Generator], cfg: ArchConfig,
                kind: str) -> dict:
    dev = layers.gen_device(gen)
    if kind == "mamba":
        return {"ln": layers.rmsnorm_init(cfg.d_model, dev),
                "ssm": ssm.ssm_init(gen, ssm_cfg_for(cfg))}
    p = {
        "ln1": layers.rmsnorm_init(cfg.d_model, dev),
        "attn": attn.attn_init(gen, attn_cfg_for(cfg, kind)),
        "ln2": layers.rmsnorm_init(cfg.d_model, dev),
    }
    if cfg.post_norms:
        p["post_ln1"] = layers.rmsnorm_init(cfg.d_model, dev)
        p["post_ln2"] = layers.rmsnorm_init(cfg.d_model, dev)
    if cfg.num_experts:
        p["moe"] = moe.moe_init(gen, moe_cfg_for(cfg))
    else:
        p["mlp"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff,
                                   gated=cfg.mlp_gated)
    return p


def _block_axes(cfg: ArchConfig, kind: str) -> dict:
    if kind == "mamba":
        return {"ln": layers.rmsnorm_axes(), "ssm": ssm.ssm_axes()}
    p = {
        "ln1": layers.rmsnorm_axes(),
        "attn": attn.attn_axes(attn_cfg_for(cfg, kind)),
        "ln2": layers.rmsnorm_axes(),
    }
    if cfg.post_norms:
        p["post_ln1"] = layers.rmsnorm_axes()
        p["post_ln2"] = layers.rmsnorm_axes()
    if cfg.num_experts:
        p["moe"] = moe.moe_axes()
    else:
        p["mlp"] = layers.mlp_axes(gated=cfg.mlp_gated)
    return p


def _apply_block(params: dict, cfg: ArchConfig, kind: str, x: Tensor,
                 mix: Callable[[Tensor], Tensor], moe_impl: str,
                 constrain: Constrain = no_constraint
                 ) -> tuple[Tensor, Optional[Tensor]]:
    """One block around its mixer ``mix`` (attention or the SSD block,
    normed input -> output): pre-norm, residual, and for attention blocks
    the MLP or MoE and gemma2's post-norms. Returns (x, the MoE aux loss,
    None without experts)."""
    aux = None
    if kind == "mamba":
        return x + mix(layers.rmsnorm(params["ln"], x)), aux
    a = mix(layers.rmsnorm(params["ln1"], x))
    if cfg.post_norms:
        a = layers.rmsnorm(params["post_ln1"], a)
    x = x + a
    h = layers.rmsnorm(params["ln2"], x)
    if cfg.num_experts:
        m, aux = moe.moe_apply(params["moe"], moe_cfg_for(cfg), h, moe_impl,
                               constrain)
    else:
        m = layers.mlp(params["mlp"], h, act=cfg.mlp_act)
    if cfg.post_norms:
        m = layers.rmsnorm(params["post_ln2"], m)
    return constrain(x + m, ("batch", "act_seq", "embed")), aux


def _apply_shared_attn(params: dict, cfg: ArchConfig, x: Tensor, x0: Tensor,
                       mix: Callable[[Tensor], Tensor]) -> Tensor:
    """Zamba2's shared block around its attention ``mix``: attention over
    rmsnorm(concat(x, x0)), residual, then the MLP on rmsnorm(x), residual."""
    x = x + mix(layers.rmsnorm(params["ln"], torch.cat([x, x0], dim=-1)))
    return x + layers.mlp(params["mlp"], layers.rmsnorm(params["ln2"], x),
                          act=cfg.mlp_act)


def _run_group(params: dict, cfg: ArchConfig, x: Tensor,
               aux: Optional[Tensor], gparams: dict, x0: Tensor,
               gcache: Optional[dict], mix: Callable, moe_impl: str,
               constrain: Constrain) -> tuple[Tensor, Optional[Tensor]]:
    """One layer group, the reference's ``group_body``: zamba2's shared
    block (over ``x`` and the embeddings ``x0``), then the group's blocks.
    Returns (x, aux plus the group's MoE aux loss; None without experts)."""
    if cfg.shared_attn_every:
        sp = params["shared_attn"]
        sc = gcache["shared"] if gcache is not None else None
        x = _apply_shared_attn(sp, cfg, x, x0,
                               lambda h: mix("shared", sp, sc, h))
    for i, kind in enumerate(group_pattern(cfg)):
        bp = gparams[str(i)]
        bc = gcache[str(i)] if gcache is not None else None
        x, a = _apply_block(bp, cfg, kind, x,
                            lambda h: mix(kind, bp, bc, h), moe_impl,
                            constrain)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _run_blocks(params: dict, cfg: ArchConfig, x: Tensor, mix: Callable,
                moe_impl: str, cache: Optional[dict] = None,
                constrain: Constrain = no_constraint,
                policy: str = "none") -> tuple[Tensor, Optional[Tensor]]:
    """Every layer group in order (``_run_group``), each under the
    rematerialisation ``policy`` (``models.remat``); ``mix(kind,
    block_params, block_cache, h)`` runs a block's mixer, with
    ``block_cache`` a view into ``cache`` (None without one). Returns (x,
    the summed MoE aux loss, None without experts)."""
    aux = None
    x0 = x
    # one unbind, outside the checkpointed groups, whose backward stacks
    # the groups' gradients once (indexing a group would add a zeroed
    # gradient of the whole stack for each group)
    groups = tree_map(lambda p: p.unbind(0), params["blocks"])
    group = remat.checkpointed(
        functools.partial(_run_group, params, cfg, mix=mix,
                          moe_impl=moe_impl, constrain=constrain), policy)
    for gi in range(num_groups(cfg)):
        gparams = tree_map(lambda p: p[gi], groups)
        gcache = tree_map(lambda c: c[gi], cache) if cache is not None else None
        x, aux = group(x, aux, gparams, x0, gcache)
    return x, aux


def _logits(params: dict, cfg: ArchConfig, x: Tensor) -> Tensor:
    x = layers.rmsnorm(params["final_norm"], x)
    return layers.unembed(params["embed"], x, cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# whole-model init / forward
# ---------------------------------------------------------------------------


def init_params(gen: Optional[torch.Generator], cfg: ArchConfig,
                device: str | torch.device = "cuda") -> dict:
    """Random float32 parameters on ``device`` (CUDA unless the caller asks
    for the CPU), drawn from ``gen``, a generator on that device, in the
    reference's layout. ``gen=None`` with ``device="meta"`` gives the tree
    as meta tensors (``param_spec``)."""
    return assemble_params(init_parts(gen, cfg, device))


def param_spec(cfg: ArchConfig) -> dict:
    """The parameter tree as meta tensors: shapes and dtypes, no data."""
    return init_params(None, cfg, layers.META)


def init_parts(gen: Optional[torch.Generator], cfg: ArchConfig,
               device: str | torch.device = "cuda"):
    """``init_params``' draws in order, as pieces: first the tree outside
    ``blocks``, then each layer group's blocks, drawn as they are taken."""
    dev = resolve_device(device)
    if layers.gen_device(gen).type != dev.type:
        raise ValueError(f"generator on {layers.gen_device(gen)}, parameters "
                         f"asked for on {dev}")
    pat = group_pattern(cfg)
    params: dict = {
        "embed": layers.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                       cfg.tie_embeddings),
        "final_norm": layers.rmsnorm_init(cfg.d_model, dev),
    }
    if cfg.frontend:
        params["frontend"] = {"proj": layers.dense_init(
            gen, (cfg.frontend_dim, cfg.d_model), cfg.frontend_dim)}
    if cfg.shared_attn_every:
        params["shared_attn"] = {
            "ln": layers.rmsnorm_init(2 * cfg.d_model, dev),
            "attn": attn.attn_init(gen, shared_attn_cfg_for(cfg)),
            "ln2": layers.rmsnorm_init(cfg.d_model, dev),
            "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff,
                                   gated=cfg.mlp_gated),
        }
    yield params
    for _ in range(num_groups(cfg)):
        yield {str(i): _block_init(gen, cfg, kind)
               for i, kind in enumerate(pat)}


def assemble_params(parts) -> dict:
    """``init_parts``' pieces as one tree, the groups stacked under
    ``blocks``."""
    parts = iter(parts)
    params = next(parts)
    params["blocks"] = _stack(list(parts))
    return params


def _stack(trees: list[dict]) -> dict:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _with_layers(axes: dict) -> dict:
    """Every leaf's axes behind the leading ``"layers"`` axis of the group
    stack."""
    if layers.is_axes(axes):
        return ("layers",) + axes
    return {k: _with_layers(v) for k, v in axes.items()}


def param_axes(cfg: ArchConfig) -> dict:
    """The logical axes of every leaf of ``init_params``' tree."""
    pat = group_pattern(cfg)
    axes: dict = {
        "embed": layers.embedding_axes(cfg.tie_embeddings),
        "final_norm": layers.rmsnorm_axes(),
    }
    if cfg.frontend:
        axes["frontend"] = {"proj": ("fsdp", None)}
    if cfg.shared_attn_every:
        axes["shared_attn"] = {
            "ln": layers.rmsnorm_axes(),
            "attn": attn.attn_axes(shared_attn_cfg_for(cfg)),
            "ln2": layers.rmsnorm_axes(),
            "mlp": layers.mlp_axes(gated=cfg.mlp_gated),
        }
    axes["blocks"] = _with_layers(
        {str(i): _block_axes(cfg, kind) for i, kind in enumerate(pat)})
    return axes


def _embed_input(params: dict, cfg: ArchConfig, tokens: Tensor,
                 frontend: Optional[Tensor], positions: Tensor,
                 constrain: Constrain = no_constraint) -> Tensor:
    """Token embeddings; the projected frontend embeddings [B, F, E] in
    place of the first F (vision and audio stubs); absolute positions where
    the config has them."""
    dtype = compute_dtype(cfg)
    x = layers.embed_tokens(params["embed"], tokens, cfg.embed_scale, dtype)
    if cfg.frontend and frontend is not None:
        f = layers.dense("bfe,ed->bfd", frontend.to(dtype),
                         params["frontend"]["proj"].to(dtype), {}, {})
        x = torch.cat([f, x[:, f.shape[1]:]], dim=1)
    if cfg.pos_embed == "absolute":
        x = x + layers.sinusoidal_pos(positions, cfg.d_model, dtype)
    return constrain(x, ("batch", "act_seq", "embed"))


def _positions(tokens: Tensor) -> Tensor:
    """[B, S] int32 positions 0..S-1 on the device (and mesh) of tokens."""
    b, s = tokens.shape
    pos = torch.arange(s, dtype=torch.int32, device=tokens.device)
    return on_mesh_of(tokens, pos)[None].expand(b, s)


def forward(params: dict, cfg: ArchConfig, tokens: Tensor,
            attn_impl: str = "kernel", ssm_impl: str = "kernel",
            moe_impl: str = "kernel",
            frontend: Optional[Tensor] = None,
            constrain: Constrain = no_constraint) -> tuple[Tensor, Tensor]:
    """Causal LM forward. tokens: [B, S] int -> (logits [B,S,V] f32, aux).
    ``frontend`` [B, F, frontend_dim] (vision and audio configs) fills the
    first F positions. ``aux`` is the MoE load-balance loss summed over the
    layers (f32; zero without experts). With grad mode on, each layer group
    runs under the rematerialisation policy ``cfg.remat``
    (``models.remat``), as the reference's ``jax.checkpoint`` does; with it
    off (serving), the groups run as they are."""
    _check_moe_impl(moe_impl)
    remat.check(cfg.remat)
    positions = _positions(tokens)
    x = _embed_input(params, cfg, tokens, frontend, positions, constrain)

    def mix(kind, bp, _, h):
        if kind == "mamba":
            return ssm.ssm_apply(bp["ssm"], ssm_cfg_for(cfg), h, ssm_impl,
                                 constrain)
        return attn.attend_full(bp["attn"], attn_cfg_for(cfg, kind), h,
                                positions, attn_impl, constrain)
    x, aux = _run_blocks(params, cfg, x, mix, moe_impl, constrain=constrain,
                         policy=cfg.remat if torch.is_grad_enabled()
                         else "none")
    if aux is None:
        aux = on_mesh_of(x, torch.zeros((), dtype=torch.float32,
                                        device=tokens.device))
    logits = _logits(params, cfg, x)
    return constrain(logits, ("batch", "act_seq", "vocab_out")), aux


# ---------------------------------------------------------------------------
# decode cache
# ---------------------------------------------------------------------------


def _group_cache(cfg: ArchConfig, batch: int, max_seq: int,
                 dtype: torch.dtype, device: torch.device) -> dict:
    cache: dict = {}
    for i, kind in enumerate(group_pattern(cfg)):
        if kind == "mamba":
            cache[str(i)] = ssm.init_state(batch, ssm_cfg_for(cfg),
                                           device=device)
        else:
            cache[str(i)] = attn.init_cache(batch, max_seq,
                                            attn_cfg_for(cfg, kind), dtype,
                                            device)
    if cfg.shared_attn_every:
        cache["shared"] = attn.init_cache(batch, max_seq,
                                          shared_attn_cfg_for(cfg), dtype,
                                          device)
    return cache


def _stack_cache(cfg: ArchConfig, group_cache: dict) -> dict:
    """Every leaf repeated along a leading group axis. ``repeat`` allocates
    each group its own memory: the reference's ``broadcast_to`` has a torch
    twin, ``expand``, that would make every group one cache once the decode
    writes in place."""
    g = num_groups(cfg)
    return tree_map(lambda x: x[None].repeat(g, *([1] * x.ndim)), group_cache)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda") -> dict:
    """The zeroed decode cache on ``device`` (CUDA unless the caller asks
    for the CPU): KV caches in ``dtype``, SSM states in float32."""
    dev = resolve_device(device)
    return _stack_cache(cfg, _group_cache(cfg, batch, max_seq, dtype, dev))


def cache_spec(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """The decode cache as meta tensors: shapes and dtypes, no data."""
    return init_cache(cfg, batch, max_seq, dtype, layers.META)


def cache_axes(cfg: ArchConfig) -> dict:
    """The logical axes of every leaf of the decode cache."""
    ax: dict = {}
    for i, kind in enumerate(group_pattern(cfg)):
        ax[str(i)] = (ssm.state_axes() if kind == "mamba"
                      else attn.cache_axes())
    if cfg.shared_attn_every:
        ax["shared"] = attn.cache_axes()
    return _with_layers(ax)


# ---------------------------------------------------------------------------
# prefill + decode
# ---------------------------------------------------------------------------


def ssm_prefill(params: dict, scfg: ssm.SSMConfig, u: Tensor,
                impl: str = "kernel") -> tuple[Tensor, dict]:
    """Mamba2 full-sequence apply that also returns the decode state: the
    last K-1 pre-conv inputs (left-padded with zeros when the prompt is
    shorter) in fp32, and the scan's final state."""
    out, fin, xbc_pre = ssm.ssm_full(params, scfg, u, impl)
    k, s = scfg.conv_kernel, u.shape[1]
    # on a mesh on each rank's batch and channel shard: torch 2.11's
    # DTensor pad raises an IndexError
    conv = per_shard(
        lambda x: F.pad(x, (0, 0, max(k - 1 - s, 0), 0))[:, -(k - 1):, :],
        (xbc_pre, {"batch": 0, "channel": 2}),
        out={"batch": 0, "channel": 2})
    return out, {"conv": conv.float(), "ssm": fin}


def prefill(params: dict, cfg: ArchConfig, tokens: Tensor, cache: dict,
            attn_impl: str = "kernel", ssm_impl: str = "kernel",
            moe_impl: str = "kernel",
            frontend: Optional[Tensor] = None,
            constrain: Constrain = no_constraint) -> tuple[Tensor, dict]:
    """Run the prompt (its head from ``frontend``, as in ``forward``), fill
    ``cache`` in place. Returns (logits [B,S,V] f32, cache)."""
    _check_moe_impl(moe_impl)
    positions = _positions(tokens)
    x = _embed_input(params, cfg, tokens, frontend, positions, constrain)

    def mix(kind, bp, bc, h):
        if kind == "mamba":
            y, st = ssm_prefill(bp["ssm"], ssm_cfg_for(cfg), h, ssm_impl)
            bc["conv"].copy_(st["conv"])
            bc["ssm"].copy_(st["ssm"])
            return y
        return attn.attend_prefill(bp["attn"], attn_cfg_for(cfg, kind), h,
                                   positions, bc, attn_impl, constrain)[0]
    x, _ = _run_blocks(params, cfg, x, mix, moe_impl, cache, constrain)
    return _logits(params, cfg, x), cache


def decode_step(params: dict, cfg: ArchConfig, tokens: Tensor, cache: dict,
                pos: Tensor, attn_impl: str = "kernel",
                moe_impl: str = "kernel",
                constrain: Constrain = no_constraint) -> tuple[Tensor, dict]:
    """One decode step. tokens: [B, 1], pos: [B] (write index). Advances
    ``cache`` in place. Returns (logits [B, 1, V] f32, cache)."""
    _check_moe_impl(moe_impl)
    x = _embed_input(params, cfg, tokens, None, pos[:, None])

    def mix(kind, bp, bc, h):
        if kind == "mamba":
            return ssm.ssm_decode(bp["ssm"], ssm_cfg_for(cfg), h, bc)[0]
        return attn.attend_decode(bp["attn"], attn_cfg_for(cfg, kind), h, bc,
                                  pos, attn_impl, constrain)[0]
    x, _ = _run_blocks(params, cfg, x, mix, moe_impl, cache, constrain)
    return _logits(params, cfg, x), cache


# ---------------------------------------------------------------------------
# convenience
# ---------------------------------------------------------------------------


class LM(nn.Module):
    """Thin ``nn.Module`` veneer over the functional API. Parameters are
    drawn from ``seed`` on ``device`` (CUDA unless the caller asks for the
    CPU) unless given."""

    def __init__(self, cfg: ArchConfig, params: Optional[dict] = None, *,
                 device: str | torch.device = "cuda", seed: int = 0,
                 attn_impl: str = "kernel", ssm_impl: str = "kernel",
                 moe_impl: str = "kernel",
                 constrain: Constrain = no_constraint):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, cfg, self.device)
        self.params = params
        self.attn_impl = attn_impl
        self.ssm_impl = ssm_impl
        self.moe_impl = moe_impl
        self.constrain = constrain

    def forward(self, tokens: Tensor,
                frontend: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
        return forward(self.params, self.cfg, tokens, self.attn_impl,
                       self.ssm_impl, self.moe_impl, frontend, self.constrain)

    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        return init_cache(self.cfg, batch, max_seq, dtype, self.device)

    def prefill(self, tokens: Tensor, cache: dict,
                frontend: Optional[Tensor] = None) -> tuple[Tensor, dict]:
        return prefill(self.params, self.cfg, tokens, cache, self.attn_impl,
                       self.ssm_impl, self.moe_impl, frontend, self.constrain)

    def decode_step(self, tokens: Tensor, cache: dict,
                    pos: Tensor) -> tuple[Tensor, dict]:
        return decode_step(self.params, self.cfg, tokens, cache, pos,
                           self.attn_impl, self.moe_impl, self.constrain)
