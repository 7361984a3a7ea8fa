"""The four architectures of the last model slice against the JAX package:
zamba2-2.7b (the shared attention block over concat(x, x0), head dim
2 D / heads), phi-3-vision (a vision frontend stub), musicgen-large (an
audio frontend stub, absolute sinusoidal positions, no RoPE, a plain GeLU
MLP) and minitron-8b (GQA, untied unembedding).

Inputs are made with numpy from a seed and handed to both sides; parameters
come from the JAX package's ``init_params`` and cross with
``repro_torch.convert.from_jax_params``, with the zero-initialised leaves
(norm scales, biases) redrawn so that they matter. Everything is float32 on
the CPU at smoke width: atol = rtol = 1e-4 for whole models, 1e-5 for single
layers, 1e-3 for decode against forward (as tests/test_models.py holds it).
The attention kernels' plain versions at head dims 96 and 160 are held
against the JAX Pallas kernels in interpret mode at the reference's
tolerances (3e-5 in float32, 2e-2 in bfloat16).

The port writes its caches in place, so each side gets a cache of its own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.convert import (COMPUTE_LEAVES, from_jax_params,
                                 init_compute_params, to_compute_dtype)
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM

ARCHS = ["zamba2-2.7b", "phi-3-vision-4.2b", "musicgen-large", "minitron-8b"]
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = dict(atol=1e-3, rtol=1e-3)
_REDRAWN = ("scale", "bq", "bk", "bv", "conv_b")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=3e-5, rtol=3e-5)


def _numpy_tree(tree, rng):
    """JAX params as numpy, with the zero-initialised leaves redrawn."""
    def walk(t):
        out = {}
        for name, leaf in t.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf)
            else:
                a = np.asarray(leaf)
                if name in _REDRAWN:
                    a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
                out[name] = a
        return out
    return walk(tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_trees_close(got: dict, want: dict, **tol):
    assert sorted(got) == sorted(want)
    for name in want:
        if isinstance(want[name], dict):
            _assert_trees_close(got[name], want[name], **tol)
        else:
            assert tuple(got[name].shape) == tuple(want[name].shape), name
            np.testing.assert_allclose(_np(got[name]), _np(want[name]),
                                       err_msg=name, **tol)


def _jcfg(arch):
    return dataclasses.replace(jconfigs.smoke_config(arch), dtype="float32")


def _tcfg(arch):
    return dataclasses.replace(tconfigs.smoke_config(arch), dtype="float32")


def _frontend(cfg, rng, b):
    """The stub's embeddings [b, frontend_tokens, frontend_dim], or None."""
    if not cfg.frontend:
        return None
    return rng.standard_normal((b, cfg.frontend_tokens, cfg.frontend_dim),
                               np.float32)


def _opt(a, to):
    return None if a is None else to(a)


# ---------------------------------------------------------------------------
# configs and layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_configs_keep_what_the_arch_exercises(arch):
    cfg = tconfigs.smoke_config(arch)
    assert cfg.shared_attn_every == (2 if arch == "zamba2-2.7b" else 0)
    assert cfg.frontend_tokens == (4 if cfg.frontend else 0)
    assert (cfg.pos_embed == "absolute") == (arch == "musicgen-large")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    jcfg = jconfigs.smoke_config(arch)
    want = jax.tree.map(lambda a: tuple(a.shape),
                        JM.init_params(jax.random.PRNGKey(0), jcfg))
    gen = torch.Generator().manual_seed(0)
    got = TM.tree_map(lambda t: tuple(t.shape),
                      TM.init_params(gen, tconfigs.smoke_config(arch), "cpu"))
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_has_the_reference_layout(arch):
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        JM.init_cache(jconfigs.smoke_config(arch), 2, 10))
    got = TM.tree_map(lambda t: (tuple(t.shape),
                                 str(t.dtype).replace("torch.", "")),
                      TM.init_cache(tconfigs.smoke_config(arch), 2, 10,
                                    device="cpu"))
    assert got == want


def test_zamba2_shared_block_has_head_dim_160_at_full_width():
    cfg = tconfigs.get_config("zamba2-2.7b")
    scfg = TM.shared_attn_cfg_for(cfg)
    assert (scfg.head_dim, scfg.in_dim, scfg.o_dim) == (160, 5120, 2560)
    assert TM.group_pattern(cfg) == ("mamba",) * 6 and TM.num_groups(cfg) == 9
    assert tconfigs.get_config("phi-3-vision-4.2b").resolved_head_dim == 96


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "phi-3-vision-4.2b"])
def test_compute_dtype_casts_the_frontend_and_the_shared_block(arch):
    gen = torch.Generator().manual_seed(0)
    params = to_compute_dtype(
        TM.init_params(gen, tconfigs.smoke_config(arch), "cpu"), torch.bfloat16)
    extra = params["shared_attn"] if arch == "zamba2-2.7b" else params["frontend"]
    leaves = {}

    def walk(t, prefix=""):
        for name, leaf in t.items():
            if isinstance(leaf, dict):
                walk(leaf, prefix + name + ".")
            else:
                leaves[prefix + name] = leaf
    walk(extra)
    assert leaves
    for name, leaf in leaves.items():
        cast = name.rsplit(".", 1)[-1] in COMPUTE_LEAVES
        assert leaf.dtype == (torch.bfloat16 if cast else torch.float32), name
        assert cast == (not name.endswith("scale")), name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_in_the_compute_dtype_casts_the_same_draws(arch):
    """``init_compute_params`` (how the card builds a full-width model,
    casting group by group) equals the float32 draw cast afterwards."""
    cfg = tconfigs.smoke_config(arch)
    want = to_compute_dtype(TM.init_params(torch.Generator().manual_seed(3),
                                           cfg, "cpu"), torch.bfloat16)
    got = init_compute_params(torch.Generator().manual_seed(3), cfg, "cpu",
                              torch.bfloat16)
    got_l, want_l = [], []
    TM.tree_map(got_l.append, got)
    TM.tree_map(want_l.append, want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoidal_pos_matches(dtype):
    # positions up to the 1056-row caches of the full-width runs: the two
    # float32 exp's may differ in a frequency's last bit, which a position
    # p multiplies into the angle (~4e-6 at 1055, past 1e-5 at 4096)
    pos = np.array([[0, 1, 7, 100, 1055], [3, 2, 1, 0, 1000]], np.int32)
    jd, td = DTYPES[dtype]
    got = tlayers.sinusoidal_pos(torch.from_numpy(pos), 48, td)
    want = jlayers.sinusoidal_pos(jnp.asarray(pos), 48, jd)
    assert got.dtype == td and got.shape == (2, 5, 48)
    tol = LAYER_TOL if dtype == "float32" else _tol(dtype)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_attention_with_other_in_and_out_widths_matches(impl):
    """zamba2's shared attention: input 2 D wide, head dim 2 D / heads,
    output D wide, RoPE on."""
    kw = dict(d_model=32, num_heads=4, num_kv_heads=4, head_dim=16,
              q_in_dim=64, out_dim=32)
    jcfg, tcfg = jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    rng = np.random.default_rng(5)
    params = _numpy_tree(jattn.attn_init(jax.random.PRNGKey(0), jcfg), rng)
    assert params["wq"].shape == (64, 4, 16) and params["wo"].shape == (4, 16, 32)
    x = rng.standard_normal((2, 20, 64), np.float32)
    pos = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    want = jattn.attend_full(_jax(params), jcfg, jnp.asarray(x),
                             jnp.asarray(pos))
    got = tattn.attend_full(from_jax_params(params, "cpu"), tcfg,
                            torch.from_numpy(x), torch.from_numpy(pos),
                            impl=impl)
    assert got.shape == (2, 20, 32)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_attention_without_rope_matches(impl):
    kw = dict(d_model=32, num_heads=4, num_kv_heads=4, head_dim=8,
              rope_theta=None)
    jcfg, tcfg = jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    rng = np.random.default_rng(6)
    params = _numpy_tree(jattn.attn_init(jax.random.PRNGKey(1), jcfg), rng)
    x = rng.standard_normal((1, 12, 32), np.float32)
    pos = np.arange(12, dtype=np.int32)[None] + 9
    want = jattn.attend_full(_jax(params), jcfg, jnp.asarray(x),
                             jnp.asarray(pos))
    got = tattn.attend_full(from_jax_params(params, "cpu"), tcfg,
                            torch.from_numpy(x), torch.from_numpy(pos),
                            impl=impl)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


# ---------------------------------------------------------------------------
# the attention kernels' plain versions at head dims 96 and 160
# ---------------------------------------------------------------------------


NEW_HEAD_DIM_FLASH = [
    # (b, sq, n, kv, h, window, softcap)
    (1, 40, 2, 2, 96, None, None),
    (1, 40, 4, 1, 96, 17, 30.0),
    (1, 40, 2, 2, 160, None, 50.0),
    (2, 33, 4, 1, 160, 9, None),
]

NEW_HEAD_DIM_DECODE = [
    # (b, s, n, kv, h, window)
    (2, 64, 4, 4, 96, None),
    (1, 96, 4, 1, 96, 20),
    (2, 64, 4, 4, 160, None),
    (1, 96, 8, 2, 160, 20),
]


@pytest.mark.parametrize("case", NEW_HEAD_DIM_FLASH)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_at_head_dims_96_and_160_matches_jax_kernel(case, dtype):
    b, sq, n, kv, h, win, cap = case
    rng = np.random.default_rng(h + sq)
    jd, td = DTYPES[dtype]
    arrays = [rng.standard_normal(shape, np.float32) for shape in
              ((b, sq, n, h), (b, sq, kv, h), (b, sq, kv, h))]
    jq, jk, jv = (jnp.asarray(a, jd) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in arrays)
    want = jops.flash_attention(jq, jk, jv, window=win, softcap=cap,
                                block_q=32, block_k=32, interpret=True)
    got = ops.flash_attention(tq, tk, tv, window=win, softcap=cap,
                              block_q=32, block_k=32)
    assert got.dtype == td and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("case", NEW_HEAD_DIM_DECODE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_at_head_dims_96_and_160_matches_jax_kernel(case, dtype):
    b, s, n, kv, h, win = case
    rng = np.random.default_rng(h + s)
    jd, td = DTYPES[dtype]
    arrays = [rng.standard_normal(shape, np.float32) for shape in
              ((b, n, h), (b, s, kv, h), (b, s, kv, h))]
    pos = rng.integers(0, s, (b,)).astype(np.int32)
    jq, jk, jv = (jnp.asarray(a, jd) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in arrays)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(pos), window=win,
                                 block_k=32, interpret=True)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(pos), window=win,
                               block_k=32)
    assert got.dtype == td and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


# ---------------------------------------------------------------------------
# the architectures as a whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs():
    """Per arch: numpy params, tokens, frontend, the JAX forward, prefill
    and one decode step (computed once)."""
    memo = {}

    def get(arch):
        if arch not in memo:
            cfg = _jcfg(arch)
            rng = np.random.default_rng(0)
            params = _numpy_tree(JM.init_params(jax.random.PRNGKey(0), cfg),
                                 rng)
            b, s, max_seq = 2, 12, 16
            tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            fe = _frontend(cfg, rng, b)
            jfe = _opt(fe, jnp.asarray)
            flogits, _ = JM.forward(_jax(params), cfg, jnp.asarray(tokens),
                                    jfe)
            cache0 = JM.init_cache(cfg, b, max_seq, jnp.float32)
            plogits, pcache = JM.prefill(_jax(params), cfg,
                                         jnp.asarray(tokens), cache0, jfe)
            nxt = np.asarray(jnp.argmax(plogits[:, -1], -1)).astype(
                np.int32)[:, None]
            pos = np.array([s, s - 4], np.int32)    # a write index each
            dlogits, dcache = JM.decode_step(_jax(params), cfg,
                                             jnp.asarray(nxt), pcache,
                                             jnp.asarray(pos))
            memo[arch] = dict(params=params, tokens=tokens, frontend=fe,
                              nxt=nxt, pos=pos, flogits=np.asarray(flogits),
                              cache0=jax.tree.map(np.asarray, cache0),
                              plogits=np.asarray(plogits),
                              pcache=jax.tree.map(np.asarray, pcache),
                              dlogits=np.asarray(dlogits),
                              dcache=jax.tree.map(np.asarray, dcache))
        return memo[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_forward_matches_jax(jax_runs, arch, impl):
    run = jax_runs(arch)
    got, aux = TM.forward(from_jax_params(run["params"], "cpu"), _tcfg(arch),
                          torch.from_numpy(run["tokens"]), attn_impl=impl,
                          ssm_impl=impl,
                          frontend=_opt(run["frontend"], torch.from_numpy))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), run["flogits"], **MODEL_TOL)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "musicgen-large"])
def test_frontend_fills_the_head_of_the_prompt(jax_runs, arch):
    """The stub's embeddings, not the tokens, feed the first positions: the
    logits there move with the frontend and not with those tokens."""
    run = jax_runs(arch)
    cfg = _tcfg(arch)
    params = from_jax_params(run["params"], "cpu")
    tokens = torch.from_numpy(run["tokens"])
    fe = torch.from_numpy(run["frontend"])
    base, _ = TM.forward(params, cfg, tokens, frontend=fe)
    other = tokens.clone()
    other[:, :cfg.frontend_tokens] = (other[:, :cfg.frontend_tokens] + 1) \
        % cfg.vocab_size
    same, _ = TM.forward(params, cfg, other, frontend=fe)
    moved, _ = TM.forward(params, cfg, tokens, frontend=fe + 1.0)
    f = cfg.frontend_tokens
    assert torch.equal(same[:, :f], base[:, :f])
    assert not torch.allclose(moved[:, :f], base[:, :f])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_prefill_matches_jax(jax_runs, arch, impl):
    run = jax_runs(arch)
    cache = from_jax_params(run["cache0"], "cpu")
    logits, got = TM.prefill(from_jax_params(run["params"], "cpu"),
                             _tcfg(arch), torch.from_numpy(run["tokens"]),
                             cache, attn_impl=impl, ssm_impl=impl,
                             frontend=_opt(run["frontend"], torch.from_numpy))
    assert got is cache
    np.testing.assert_allclose(logits.numpy(), run["plogits"], **MODEL_TOL)
    _assert_trees_close(got, run["pcache"], **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_decode_step_matches_jax(jax_runs, arch, impl):
    """From the JAX prefill's cache, carried across: the port's step gives
    JAX's logits and cache (zamba2's shared-block caches included)."""
    run = jax_runs(arch)
    cache = from_jax_params(run["pcache"], "cpu")
    logits, got = TM.decode_step(
        from_jax_params(run["params"], "cpu"), _tcfg(arch),
        torch.from_numpy(run["nxt"]), cache, torch.from_numpy(run["pos"]),
        attn_impl=impl)
    assert got is cache and logits.shape == run["dlogits"].shape
    np.testing.assert_allclose(logits.numpy(), run["dlogits"], **MODEL_TOL)
    _assert_trees_close(got, run["dcache"], **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_decode_matches_forward_fp32(arch, impl):
    """The port's prefill (with the frontend) + decode_step equal its
    forward on the extended sequence (tests/test_models.py's check, on the
    port alone)."""
    cfg = _tcfg(arch)
    lm = TM.LM(cfg, device="cpu", seed=1, attn_impl=impl, ssm_impl=impl)
    b, s = 2, 12
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                              .astype(np.int32))
    fe = _opt(_frontend(cfg, rng, b), torch.from_numpy)
    cache = lm.init_cache(b, s + 2, torch.float32)
    plogits, cache = lm.prefill(tokens, cache, frontend=fe)
    logits, _ = lm(tokens, frontend=fe)
    np.testing.assert_allclose(plogits.numpy(), logits.numpy(), **MODEL_TOL)
    nxt = plogits[:, -1].argmax(-1).to(torch.int32)[:, None]
    dlogits, cache = lm.decode_step(nxt, cache,
                                    torch.full((b,), s, dtype=torch.int32))
    flogits, _ = lm(torch.cat([tokens, nxt], 1), frontend=fe)
    np.testing.assert_allclose(dlogits[:, 0].numpy(), flogits[:, -1].numpy(),
                               **DECODE_TOL)
