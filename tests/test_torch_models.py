"""The port's model layers and whole forward pass against the JAX package.

Inputs are made with numpy from a seed and handed to both sides; parameters
come from the JAX package's ``init_params`` and cross with
``repro_torch.convert.from_jax_params``, with the zero-initialised leaves
(norm scales, biases) redrawn so that they matter. Everything here is
float32 on the CPU: atol = rtol = 1e-4 for the whole model (as
tests/test_models.py holds decode to forward), 1e-5 for single layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.convert import COMPUTE_LEAVES, from_jax_params, to_compute_dtype
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm

ARCHS = ["gemma-2b", "qwen1.5-4b", "gemma2-2b", "mamba2-130m",
         "phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b"]
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
_REDRAWN = ("scale", "bq", "bk", "bv", "conv_b")


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


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_copies_match_the_reference(arch):
    assert dataclasses.asdict(tconfigs.get_config(arch)) == \
        dataclasses.asdict(jconfigs.get_config(arch))
    assert dataclasses.asdict(tconfigs.smoke_config(arch)) == \
        dataclasses.asdict(jconfigs.smoke_config(arch))


def test_registry_holds_every_arch_and_unknown_ids_raise_keyerror():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS and len(tconfigs.ARCH_IDS) == 10
    for arch in ("no-such-arch", "gemma", "zamba2-2.7B"):
        with pytest.raises(KeyError, match="unknown"):
            tconfigs.get_config(arch)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rmsnorm_is_fp32_with_one_plus_scale():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32), np.float32) * 3
    scale = rng.standard_normal(32).astype(np.float32)
    _close(tlayers.rmsnorm({"scale": torch.from_numpy(scale)},
                           torch.from_numpy(x)),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
           **LAYER_TOL)
    # bf16 in, bf16 out, statistics in fp32
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tlayers.rmsnorm({"scale": torch.from_numpy(scale)}, xb)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)},
                           jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("act,gated", [("gelu", True), ("silu", True),
                                       ("gelu", False)])
def test_mlp_matches(act, gated):
    rng = np.random.default_rng(1)
    params = {k: rng.standard_normal(s, np.float32) * 0.2 for k, s in
              (("wi", (16, 24)), ("wo", (24, 16)), ("wg", (16, 24)))
              if gated or k != "wg"}
    x = rng.standard_normal((2, 3, 16), np.float32)
    _close(tlayers.mlp({k: torch.from_numpy(v) for k, v in params.items()},
                       torch.from_numpy(x), act=act),
           jlayers.mlp(_jax(params), jnp.asarray(x), act=act), **LAYER_TOL)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    got = tlayers._ACTS["gelu"](x)
    want = jax.nn.gelu(jnp.asarray(x.numpy()), approximate=True)
    _close(got, want, **LAYER_TOL)
    # and not torch's default erf form, which differs by ~1e-3 here
    assert (got - torch.nn.functional.gelu(x)).abs().max() > 1e-4


def test_rope_splits_heads_in_halves():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16), np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32) + 3, (2, 1))
    _close(tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0),
           jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0),
           **LAYER_TOL)


@pytest.mark.parametrize("scale", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_tokens_casts_then_gathers_then_scales(scale, dtype):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((50, 24), np.float32)
    tokens = rng.integers(0, 50, (2, 9)).astype(np.int32)
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    got = tlayers.embed_tokens({"table": torch.from_numpy(table)},
                               torch.from_numpy(tokens), scale, td)
    want = jlayers.embed_tokens({"table": jnp.asarray(table)},
                                jnp.asarray(tokens), scale, jd)
    assert got.dtype == td
    # the same casts in the same order: equal bit for bit
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_unembed_matches(tied, softcap):
    rng = np.random.default_rng(4)
    params = {"table": rng.standard_normal((40, 16), np.float32)}
    if not tied:
        params["unembed"] = rng.standard_normal((16, 40), np.float32)
    x = rng.standard_normal((2, 5, 16), np.float32) * 4
    got = tlayers.unembed({k: torch.from_numpy(v) for k, v in params.items()},
                          torch.from_numpy(x), softcap)
    assert got.dtype == torch.float32
    _close(got, jlayers.unembed(_jax(params), jnp.asarray(x), softcap),
           **LAYER_TOL)


ATTN_CASES = [
    # (num_heads, num_kv_heads, head_dim, qkv_bias, window, softcap)
    (4, 1, 16, False, None, None),       # MQA (gemma-2b)
    (4, 4, 16, True, None, None),        # MHA + bias (qwen1.5)
    (4, 2, 16, False, 8, 50.0),          # GQA, window, softcap (gemma2 local)
]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_attend_full_matches(case, impl):
    n, kv, h, bias, win, cap = case
    jcfg = jattn.AttnConfig(d_model=32, num_heads=n, num_kv_heads=kv,
                            head_dim=h, qkv_bias=bias, logit_softcap=cap,
                            window=win)
    tcfg = tattn.AttnConfig(d_model=32, num_heads=n, num_kv_heads=kv,
                            head_dim=h, qkv_bias=bias, logit_softcap=cap,
                            window=win)
    rng = np.random.default_rng(5)
    params = _numpy_tree(jattn.attn_init(jax.random.PRNGKey(0), jcfg), rng)
    x = rng.standard_normal((2, 20, 32), np.float32)
    pos = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    want = jattn.attend_full(_jax(params), jcfg, jnp.asarray(x),
                             jnp.asarray(pos))
    got = tattn.attend_full(from_jax_params(params, "cpu"), tcfg,
                            torch.from_numpy(x), torch.from_numpy(pos),
                            impl=impl)
    _close(got, want, **LAYER_TOL)


def test_attention_gqa_repeats_each_kv_head_in_place():
    k = torch.arange(3.0).reshape(1, 1, 3, 1)
    assert tattn._repeat_kv(k, 6).flatten().tolist() == [0, 0, 1, 1, 2, 2]


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_ssm_apply_matches(impl):
    jcfg = jssm.SSMConfig(d_model=32, state=16, heads=4, chunk=8)
    tcfg = tssm.SSMConfig(d_model=32, state=16, heads=4, chunk=8)
    rng = np.random.default_rng(6)
    params = _numpy_tree(jssm.ssm_init(jax.random.PRNGKey(1), jcfg), rng)
    x = rng.standard_normal((2, 21, 32), np.float32)     # ragged vs chunk
    want = jssm.ssm_apply(_jax(params), jcfg, jnp.asarray(x))
    got = tssm.ssm_apply(from_jax_params(params, "cpu"), tcfg,
                         torch.from_numpy(x), impl=impl)
    _close(got, want, **LAYER_TOL)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_forward():
    """Per arch: the numpy params, tokens and JAX logits (computed once)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = dataclasses.replace(jconfigs.smoke_config(arch),
                                      dtype="float32")
            rng = np.random.default_rng(0)
            params = _numpy_tree(JM.init_params(jax.random.PRNGKey(0), cfg),
                                 rng)
            # S = 24 > the smoke window of 8, so gemma2's local layers mask
            tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
            logits, aux = JM.forward(_jax(params), cfg, jnp.asarray(tokens))
            cache[arch] = (params, tokens, np.asarray(logits), float(aux))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_forward_matches_jax(jax_forward, arch, impl):
    params, tokens, want, want_aux = jax_forward(arch)
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), dtype="float32")
    if arch == "gemma2-2b":
        assert cfg.local_window < tokens.shape[1]
    got, aux = TM.forward(from_jax_params(params, "cpu"), cfg,
                          torch.from_numpy(tokens), attn_impl=impl,
                          ssm_impl=impl)
    # the MoE archs' load-balance loss; zero without experts
    assert got.dtype == aux.dtype == torch.float32
    assert (float(aux) == 0.0) == (want_aux == 0.0) == (not cfg.num_experts)
    np.testing.assert_allclose(float(aux), want_aux, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    jcfg = jconfigs.smoke_config(arch)
    want = jax.tree.map(lambda a: tuple(a.shape),
                        JM.init_params(jax.random.PRNGKey(0), jcfg))
    gen = torch.Generator().manual_seed(0)
    got = TM.tree_map(lambda t: tuple(t.shape),
                      TM.init_params(gen, tconfigs.smoke_config(arch), "cpu"))
    assert got == want


def test_dense_init_is_truncated_at_two_std():
    gen = torch.Generator().manual_seed(0)
    w = tlayers.dense_init(gen, (256, 512), 64)
    std = 1 / 8
    assert float(w.abs().max()) <= 2 * std
    # a normal truncated at +-2 std has std 0.8796 of the untruncated one
    assert abs(float(w.std()) / std - 0.8796) < 0.01


def test_init_params_needs_a_generator_on_the_device():
    cfg = tconfigs.smoke_config("gemma-2b")
    with pytest.raises(ValueError, match="generator"):
        TM.init_params(torch.Generator().manual_seed(0), cfg, "meta")


def test_lm_module_equals_functional_forward():
    cfg = dataclasses.replace(tconfigs.smoke_config("gemma2-2b"),
                              dtype="float32")
    lm = TM.LM(cfg, device="cpu", seed=3)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (1, 12)).astype(np.int32))
    got, _ = lm(tokens)
    want, _ = TM.forward(lm.params, cfg, tokens)
    assert torch.equal(got, want)


def test_compute_dtype_cast_leaves_fp32_where_the_reference_keeps_it():
    cfg = tconfigs.smoke_config("mamba2-130m")
    params = to_compute_dtype(
        TM.init_params(torch.Generator().manual_seed(0), cfg, "cpu"),
        torch.bfloat16)
    dtypes = {}

    def walk(t):
        for name, leaf in t.items():
            if isinstance(leaf, dict):
                walk(leaf)
            else:
                dtypes.setdefault(name, set()).add(leaf.dtype)
    walk(params)
    for name, seen in dtypes.items():
        want = torch.bfloat16 if name in COMPUTE_LEAVES else torch.float32
        assert seen == {want}, name
    assert dtypes["A_log"] == {torch.float32}
