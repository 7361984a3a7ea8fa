"""Plain float32 forwards of the four served architectures, and the layout
of their parameters.

The models: a dense decoder with multi-head attention, QKV bias and SwiGLU
(qwen1.5), one whose MLP is a top-k mixture of experts with grouped-query
attention (phi3.5-moe), Mamba2 blocks (mamba2), and Mamba2 blocks under a
shared attention block applied at the head of every group of them, over
the concatenation of the stream and the embeddings (zamba2). Equations:

* RMSNorm: ``x / sqrt(mean(x^2) + 1e-6) * (1 + scale)``;
* RoPE, NeoX style: each head split in halves rotated by
  ``pos * theta^(-i / half)``;
* attention: causal softmax of ``q.k * head_dim^-0.5``, kv heads repeated
  over their query groups;
* gated MLP: ``act(x Wg) * (x Wi) Wo``, act SiLU or tanh-GELU;
* MoE: softmax router in float32, top-k, weights renormalised over the k,
  every expert a gated MLP;
* Mamba2: ``in_proj`` -> z | xBC | dt, a causal depthwise conv (K taps, a
  bias) and SiLU over xBC, ``dt = softplus(dt + dt_bias)``,
  ``A = -exp(A_log)``, the state space ``h_t = exp(A dt_t) h_{t-1} + dt_t
  B_t x_t^T``, ``y_t = C_t^T h_t + D x_t``, written out in its quadratic
  (dual) form over the whole sequence, then ``RMSNorm(y * silu(z))`` and
  ``out_proj``.

Every weight arrives in the type it is served in and is taken to float32
as it is used, one layer at a time; every product runs in float32 with
TF32 off. ``quant="fp8"`` is the control: the same forward with both
operands of every weight product rounded to float8 e4m3 under a
per-tensor scale, the step below the served bfloat16.

This is the reference module of every model entry that names none
(``reference``'s contract, in its ``__init__``): a configuration whose
architecture these equations do not cover names a module of its own.
Its counts of a call are ``counts.call_counts``.

Nothing here imports the program under test, or JAX.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from ..counts import call_counts  # noqa: F401  (the contract's counts)

Tensor = torch.Tensor

#: leaves served in the configuration's dtype; the rest are float32
COMPUTE_KINDS = ("dense", "embed", "bias", "conv_w", "conv_b")

_UNSUPPORTED = ("post_norms", "attn_logit_softcap", "final_logit_softcap",
                "local_window", "embed_scale", "frontend")


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def check_config(cfg: dict) -> None:
    """Raise on a feature this reference does not compute."""
    for key in _UNSUPPORTED:
        if cfg.get(key):
            raise ValueError(f"the reference does not compute {key}")
    if cfg.get("pos_embed", "rope") != "rope":
        raise ValueError("the reference computes RoPE positions only")


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]


def group_kinds(cfg: dict) -> tuple[str, ...]:
    """The block kinds of one layer group."""
    if cfg.get("shared_attn_every"):
        return ("mamba",) * cfg["shared_attn_every"]
    return tuple(cfg.get("layer_pattern", ("global",)))


def num_groups(cfg: dict) -> int:
    per = len(group_kinds(cfg))
    if cfg["num_layers"] % per:
        raise ValueError(f"{cfg['num_layers']} layers are not whole groups "
                         f"of {per}")
    return cfg["num_layers"] // per


def variant_tree(tree: dict, cfg: dict) -> dict:
    """A supernet variant's tree: the first ``num_groups(cfg)`` layer groups
    of ``tree``'s blocks (views: the variant shares the weights), the rest
    shared as it is."""
    groups = num_groups(cfg)

    def cut(node):
        if isinstance(node, dict):
            return {k: cut(v) for k, v in node.items()}
        return node[:groups]
    return {k: cut(v) if k == "blocks" else v for k, v in tree.items()}


def _ssm_dims(cfg: dict) -> tuple[int, int, int, int]:
    """(d_inner, conv channels, in_proj width, head dim) of a Mamba2 block."""
    di = cfg.get("ssm_expand", 2) * cfg["d_model"]
    n, h = cfg["ssm_state"], cfg["ssm_heads"]
    return di, di + 2 * n, 2 * di + 2 * n + h, di // h


# ---------------------------------------------------------------------------
# parameter layout
# ---------------------------------------------------------------------------


def param_layout(cfg: dict) -> list[tuple[tuple[str, ...], tuple[int, ...],
                                          str, int]]:
    """Every leaf as (path, shape, kind, fan_in), in the nested-dict layout
    the serving program takes (``[in, out]`` products, each layer group's
    leaves stacked along a leading axis under ``blocks``). ``kind`` says how
    the benchmark draws it (``weights.KINDS``)."""
    check_config(cfg)
    d, v = cfg["d_model"], cfg["vocab_size"]
    out: list = [(("embed", "table"), (v, d), "embed", d)]
    if not cfg.get("tie_embeddings", True):
        out.append((("embed", "unembed"), (d, v), "dense", d))
    out.append((("final_norm", "scale"), (d,), "norm", 0))
    if cfg.get("shared_attn_every"):
        hd = 2 * d // cfg["num_heads"]
        out += [(("shared_attn", "ln", "scale"), (2 * d,), "norm", 0)]
        out += _attn_layout(("shared_attn", "attn"), 2 * d, cfg["num_heads"],
                            cfg["num_kv_heads"], hd, d, False, ())
        out += [(("shared_attn", "ln2", "scale"), (d,), "norm", 0)]
        out += _mlp_layout(("shared_attn", "mlp"), d, cfg["d_ff"], ())
    g = (num_groups(cfg),)
    for i, kind in enumerate(group_kinds(cfg)):
        p = ("blocks", str(i))
        if kind == "mamba":
            di, ch, proj, _ = _ssm_dims(cfg)
            h, k = cfg["ssm_heads"], cfg.get("ssm_conv_kernel", 4)
            out += [
                (p + ("ln", "scale"), g + (d,), "norm", 0),
                (p + ("ssm", "in_proj"), g + (d, proj), "dense", d),
                (p + ("ssm", "conv_w"), g + (k, ch), "conv_w", 0),
                (p + ("ssm", "conv_b"), g + (ch,), "conv_b", 0),
                (p + ("ssm", "A_log"), g + (h,), "A_log", 0),
                (p + ("ssm", "D"), g + (h,), "D", 0),
                (p + ("ssm", "dt_bias"), g + (h,), "dt_bias", 0),
                (p + ("ssm", "norm", "scale"), g + (di,), "norm", 0),
                (p + ("ssm", "out_proj"), g + (di, d), "dense", di),
            ]
            continue
        out += [(p + ("ln1", "scale"), g + (d,), "norm", 0)]
        out += _attn_layout(p + ("attn",), d, cfg["num_heads"],
                            cfg["num_kv_heads"], head_dim(cfg), d,
                            cfg.get("qkv_bias", False), g)
        out += [(p + ("ln2", "scale"), g + (d,), "norm", 0)]
        if cfg.get("num_experts"):
            e, f = cfg["num_experts"], cfg["d_ff"]
            out += [
                (p + ("moe", "router"), g + (d, e), "dense", d),
                (p + ("moe", "wi"), g + (e, d, f), "dense", d),
                (p + ("moe", "wg"), g + (e, d, f), "dense", d),
                (p + ("moe", "wo"), g + (e, f, d), "dense", f),
            ]
        else:
            out += _mlp_layout(p + ("mlp",), d, cfg["d_ff"], g)
    return out


def _attn_layout(p, d_in, n, k, hd, d_out, bias, g) -> list:
    out = [(p + ("wq",), g + (d_in, n, hd), "dense", d_in),
           (p + ("wk",), g + (d_in, k, hd), "dense", d_in),
           (p + ("wv",), g + (d_in, k, hd), "dense", d_in),
           (p + ("wo",), g + (n, hd, d_out), "dense", n * hd)]
    if bias:
        out += [(p + ("bq",), g + (n, hd), "bias", 0),
                (p + ("bk",), g + (k, hd), "bias", 0),
                (p + ("bv",), g + (k, hd), "bias", 0)]
    return out


def _mlp_layout(p, d, f, g) -> list:
    return [(p + ("wi",), g + (d, f), "dense", d),
            (p + ("wg",), g + (d, f), "dense", d),
            (p + ("wo",), g + (f, d), "dense", f)]


# ---------------------------------------------------------------------------
# float32 arithmetic
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def strict_fp32():
    """float32 products in float32: TF32 off for matmuls and convolutions,
    restored afterwards."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(prec)


def fp8_round(t: Tensor) -> Tensor:
    """``t`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to e4m3's largest (448), back in float32."""
    amax = t.abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class _Products:
    """The weight products of one forward: float32, or (the control) both
    operands rounded to float8 first."""

    def __init__(self, quant: Optional[str], routed: Optional[list]):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant {quant!r}: None or 'fp8'")
        self.fp8 = quant == "fp8"
        self.routed = routed

    def __call__(self, eq: str, x: Tensor, w: Tensor) -> Tensor:
        w = w.float()
        if self.fp8:
            x, w = fp8_round(x), fp8_round(w)
        return torch.einsum(eq, x, w)


def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    var = x.pow(2).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale.float())


def rope(x: Tensor, theta: float) -> Tensor:
    """x [S, N, H] at positions 0..S-1."""
    s, _, h = x.shape
    half = h // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freq
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _act(name: str, x: Tensor) -> Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"activation {name!r}")


def attention(p: dict, x: Tensor, n: int, k: int, theta: float,
              mm: _Products) -> Tensor:
    """Causal self-attention of x [S, D_in] -> [S, D_out]."""
    q = mm("sd,dnh->snh", x, p["wq"])
    kk = mm("sd,dkh->skh", x, p["wk"])
    v = mm("sd,dkh->skh", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].float()
        kk = kk + p["bk"].float()
        v = v + p["bv"].float()
    q, kk = rope(q, theta), rope(kk, theta)
    kk = kk.repeat_interleave(n // k, dim=1)
    v = v.repeat_interleave(n // k, dim=1)
    s, hd = x.shape[0], q.shape[-1]
    scores = torch.einsum("qnh,knh->nqk", q, kk) * hd ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("nqk,knh->qnh", probs, v)
    return mm("snh,nho->so", o, p["wo"])


def mlp(p: dict, x: Tensor, act: str, mm: _Products) -> Tensor:
    h = _act(act, mm("sd,df->sf", x, p["wg"])) * mm("sd,df->sf", x, p["wi"])
    return mm("sf,fd->sd", h, p["wo"])


def route(router: Tensor, x: Tensor, top_k: int,
          mm: _Products) -> tuple[Tensor, Tensor]:
    """(weights [S, k] renormalised, experts [S, k]) of the float32
    softmax router."""
    probs = torch.softmax(mm("sd,de->se", x, router), dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1)
    return w / w.sum(dim=-1, keepdim=True), idx


def moe(p: dict, x: Tensor, top_k: int, act: str, mm: _Products) -> Tensor:
    """Top-k mixture of gated-MLP experts, one expert at a time over the
    rows routed to it."""
    w, idx = route(p["router"], x, top_k, mm)
    if mm.routed is not None:
        mm.routed.append((int(torch.unique(idx).numel()),
                          rounding_flips(p["router"], x, idx)))
    y = torch.zeros_like(x)
    for e in range(p["wi"].shape[0]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        ye = mlp({"wi": p["wi"][e], "wg": p["wg"][e], "wo": p["wo"][e]},
                 x[rows], act, mm)
        y.index_add_(0, rows, ye * w[rows, slot][:, None])
    return y


def rounding_flips(router: Tensor, x: Tensor, idx: Tensor) -> int:
    """Tokens whose top-k experts change when only the router's input and
    weights are rounded to bfloat16 (the served dtype): near ties that
    rounding alone decides."""
    logits = x.bfloat16().float() @ router.bfloat16().float()
    alt = torch.topk(logits, idx.shape[-1], dim=-1).indices
    same = (alt.sort(dim=-1).values == idx.sort(dim=-1).values).all(dim=-1)
    return int((~same).sum())


def ssd(x: Tensor, dt: Tensor, a: Tensor, b: Tensor, c: Tensor,
        d: Tensor, heads_per_block: int = 16) -> Tensor:
    """The state space over a whole sequence in its quadratic form:
    ``y_t = sum_{s<=t} (C_t.B_s) exp(sum_{r=s+1..t} A dt_r) dt_s x_s + D x_t``.
    x [S, H, P], dt [S, H], a [H], b and c [S, N], d [H] -> y [S, H, P],
    a block of heads at a time."""
    s = x.shape[0]
    cs = torch.cumsum((a[None, :] * dt).double(), dim=0)      # [S, H]
    cb = c @ b.t()                                            # [S, S]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    ys = []
    for h0 in range(0, x.shape[1], heads_per_block):
        sl = slice(h0, h0 + heads_per_block)
        seg = cs[:, sl].t()[:, :, None] - cs[:, sl].t()[:, None, :]
        decay = torch.exp(seg.masked_fill(~causal, float("-inf"))).float()
        m = decay * cb[None] * dt[:, sl].t()[:, None, :]       # [h, t, s]
        ys.append(torch.einsum("hts,shp->thp", m, x[:, sl]))
    return torch.cat(ys, dim=1) + d[None, :, None] * x


def mamba(p: dict, u: Tensor, cfg: dict, mm: _Products) -> Tensor:
    """One Mamba2 mixer: u [S, D] -> [S, D]."""
    di, ch, _, pdim = _ssm_dims(cfg)
    n, h = cfg["ssm_state"], cfg["ssm_heads"]
    zxbcdt = mm("sd,dk->sk", u, p["in_proj"])
    z, xbc, dt = zxbcdt[:, :di], zxbcdt[:, di:di + ch], zxbcdt[:, di + ch:]
    w = p["conv_w"].float()                                   # [K, C]
    k = w.shape[0]
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(w[j] * padded[j:j + xbc.shape[0]] for j in range(k))
    xbc = F.silu(conv + p["conv_b"].float())
    x, bm, cm = xbc[:, :di], xbc[:, di:di + n], xbc[:, di + n:]
    dt = F.softplus(dt + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    y = ssd(x.reshape(-1, h, pdim), dt, a, bm, cm, p["D"].float())
    y = rmsnorm(y.reshape(-1, di) * F.silu(z), p["norm"]["scale"])
    return mm("sk,kd->sd", y, p["out_proj"])


def _index(tree: dict, g: int) -> dict:
    return {k: _index(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


def forward(params: dict, cfg: dict, tokens: Tensor,
            quant: Optional[str] = None,
            routed: Optional[list] = None) -> Tensor:
    """Logits [S, V] in float32 of one sequence ``tokens`` [S] (or [1, S])
    under ``cfg`` (the configuration's model entry). ``routed``, if given,
    gets, for each MoE layer, the number of experts that receive a row and the
number of tokens whose routing bfloat16 rounding alone would flip."""
    check_config(cfg)
    mm = _Products(quant, routed)
    tokens = tokens.reshape(-1).long()
    d, n, kv = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    act = cfg.get("mlp_act", "silu")
    theta = cfg.get("rope_theta", 10000.0)
    with torch.no_grad(), strict_fp32():
        x = params["embed"]["table"][tokens].float()
        x0 = x
        for gi in range(num_groups(cfg)):
            if cfg.get("shared_attn_every"):
                sp = params["shared_attn"]
                h = rmsnorm(torch.cat([x, x0], dim=-1), sp["ln"]["scale"])
                x = x + attention(sp["attn"], h, n, kv, theta, mm)
                x = x + mlp(sp["mlp"], rmsnorm(x, sp["ln2"]["scale"]), act,
                            mm)
            for i, kind in enumerate(group_kinds(cfg)):
                bp = _index(params["blocks"][str(i)], gi)
                if kind == "mamba":
                    x = x + mamba(bp["ssm"], rmsnorm(x, bp["ln"]["scale"]),
                                  cfg, mm)
                    continue
                x = x + attention(bp["attn"], rmsnorm(x, bp["ln1"]["scale"]),
                                  n, kv, theta, mm)
                h = rmsnorm(x, bp["ln2"]["scale"])
                if cfg.get("num_experts"):
                    x = x + moe(bp["moe"], h, cfg["num_experts_per_tok"],
                                act, mm)
                else:
                    x = x + mlp(bp["mlp"], h, act, mm)
        x = rmsnorm(x, params["final_norm"]["scale"])
        emb = params["embed"]
        if "unembed" in emb:
            return mm("sd,dv->sv", x, emb["unembed"])
        return mm("sd,vd->sv", x, emb["table"])
