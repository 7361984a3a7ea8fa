"""The port's decode path against the JAX package's, on shared numpy inputs.

Covered: the decode-attention wrapper and its plain version, the KV cache
functions, ``attend_prefill`` / ``attend_decode``, the SSM decode state,
and ``prefill`` / ``decode_step`` of the four ported architectures, with
parameters and caches carried across by ``repro_torch.convert``. The JAX
side runs its Pallas decode kernel in interpret mode, as
tests/test_kernels.py does. Tolerances are the reference's: atol = rtol =
3e-5 for float32 kernels and 2e-2 for bfloat16 (``_tol``), 1e-5 for single
layers and 1e-4 for whole models (float32), and 1e-3 for decode against
forward, as tests/test_models.py holds it.

The port writes its caches in place, so every test hands each side a cache
of its own and never reuses one that a step has consumed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.convert import COMPUTE_LEAVES, from_jax_params
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm

ARCHS = ["gemma-2b", "qwen1.5-4b", "gemma2-2b", "mamba2-130m"]
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = dict(atol=1e-3, rtol=1e-3)
_REDRAWN = ("scale", "bq", "bk", "bv", "conv_b")

DECODE_CASES = [
    # (b, s, n, kv, h, window): tests/test_kernels.py's list
    (2, 64, 4, 2, 16, None),
    (3, 100, 8, 8, 32, None),
    (1, 96, 8, 1, 64, 20),                  # MQA + window
    (2, 256, 4, 4, 64, 128),
]

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=3e-5, rtol=3e-5)


def _both(a: np.ndarray, dtype: str = "float32"):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.ascontiguousarray(a)).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


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


def _assert_trees_close(got: dict, want: dict, **tol):
    assert sorted(got) == sorted(want)
    for name in want:
        if isinstance(want[name], dict):
            _assert_trees_close(got[name], want[name], **tol)
        else:
            assert tuple(got[name].shape) == tuple(want[name].shape), name
            np.testing.assert_allclose(_np(got[name]), _np(want[name]),
                                       err_msg=name, **tol)


def _cache_inputs(rng, b, s, n, kv, h):
    return (rng.standard_normal((b, n, h), np.float32),
            rng.standard_normal((b, s, kv, h), np.float32),
            rng.standard_normal((b, s, kv, h), np.float32),
            rng.integers(0, s, (b,)).astype(np.int32))


# ---------------------------------------------------------------------------
# decode attention: wrapper and plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax_kernel(case, dtype):
    b, s, n, kv, h, win = case
    q, kc, vc, pos = _cache_inputs(np.random.default_rng(7), b, s, n, kv, h)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, kc, vc))
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(pos), window=win,
                                 block_k=32, interpret=True)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(pos), window=win,
                               block_k=32)
    assert got.dtype == DTYPES[dtype][1] and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("case", DECODE_CASES[2:])
def test_ref_decode_attention_matches_jax_ref(case, softcap):
    b, s, n, kv, h, win = case
    q, kc, vc, pos = _cache_inputs(np.random.default_rng(3), b, s, n, kv, h)
    q = 8 * q                        # scores large enough for the cap to bend
    (jq, tq), (jk, tk), (jv, tv) = (_both(a) for a in (q, kc, vc))
    want = jref.decode_attention(jq, jk, jv, jnp.asarray(pos), window=win,
                                 softcap=softcap)
    got = ref.decode_attention(tq, tk, tv, torch.from_numpy(pos), window=win,
                               softcap=softcap)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-5, rtol=3e-5)


def test_ref_decode_attention_promotes_a_bf16_cache_like_jax():
    """float32 q over a bfloat16 cache (an fp32 model with the default
    cache dtype): both promote the cache to float32."""
    q, kc, vc, pos = _cache_inputs(np.random.default_rng(4), 2, 48, 4, 2, 16)
    jq, tq = _both(q)
    (jk, tk), (jv, tv) = (_both(a, "bfloat16") for a in (kc, vc))
    want = jref.decode_attention(jq, jk, jv, jnp.asarray(pos), window=9)
    got = ref.decode_attention(tq, tk, tv, torch.from_numpy(pos), window=9)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-5, rtol=3e-5)


def test_decode_attention_ignores_stale_cache():
    """Entries beyond pos must not affect the output (999 / -999 there)."""
    b, s, n, kv, h = 1, 64, 2, 2, 16
    q, kc, vc, _ = _cache_inputs(np.random.default_rng(7), b, s, n, kv, h)
    pos = torch.tensor([20], dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, kc, vc))
    out1 = ops.decode_attention(tq, tk, tv, pos, block_k=16)
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[:, 21:] = 999.0
    tv2[:, 21:] = -999.0
    out2 = ops.decode_attention(tq, tk2, tv2, pos, block_k=16)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(tk2.numpy()),
                                 jnp.asarray(tv2.numpy()), jnp.asarray(pos),
                                 block_k=16, interpret=True)
    np.testing.assert_allclose(out2.numpy(), _np(want), atol=3e-5, rtol=3e-5)


def test_decode_attention_cpu_path_counts_no_launch_and_binding_refuses_cpu():
    q, kc, vc, pos = (torch.from_numpy(a) for a in
                      _cache_inputs(np.random.default_rng(1), 2, 32, 4, 2, 16))
    dec.launches = 0
    ops.decode_attention(q, kc, vc, pos)
    with pytest.raises(ValueError, match="CUDA"):
        dec.decode_attention(q, kc, vc, pos)
    assert dec.launches == 0


def test_bound_counts_only_the_live_keys():
    # pos 10, no window: keys 0..10; window 4 at pos 10: keys 7..10; pos 2
    # with window 4: keys 0..2
    assert dec.live_keys([10, 10, 2], 64, None) == [11, 11, 3]
    assert dec.live_keys([10, 2], 64, 4) == [4, 3]
    assert dec.flops([10], 64, 2, 16, None) == 4 * 2 * 16 * 11
    # K and V rows of the live keys, q read and out written, pos
    assert dec.hbm_bytes([10], 64, 2, 1, 16, 4, 4, 2) == \
        2 * 4 * 1 * 16 * 2 + 2 * 2 * 16 * 4 + 4


def test_num_splits_fills_the_card_within_the_live_range():
    # gemma2-2b at B = 1: 4 KV heads of groups of 2 at head_dim 256, 5120
    # cache rows, 64-key tiles; the mma kernel fills the 132 SMs once (one
    # block each at head_dim 256), the fp32 kernel aims at 528 blocks
    assert dec.num_splits(1, 4, 5120, None, 2, 256) == 33
    assert dec.num_splits(1, 4, 5120, 4096, 2, 256) == 33
    assert dec.num_splits(1, 4, 5120, None, 2, 256, "fp32") == 80
    assert dec.num_splits(1, 4, 5120, 4096, 2, 256, "fp32") == 64
    # qwen1.5-4b: 20 KV heads at head_dim 128, two blocks an SM
    assert dec.num_splits(1, 20, 4096, None, 1, 128) == 13
    # the merge's caps: gemma-2b's one KV head of 8 over 8192 rows (128
    # tiles) takes isqrt(64 * 128 / 8) = 32, less what the merge stages: 200
    # KB over 8 KB and 128 bytes a split, 24; qwen3-moe's groups of 16 over
    # 1056 rows (17 tiles) isqrt(68) = 8, phi3.5-moe's groups of 4 16
    assert dec.num_splits(1, 1, 8192, None, 8, 256) == 24
    assert dec.num_splits(1, 4, 1056, None, 16, 128) == 8
    assert dec.num_splits(1, 8, 1056, None, 4, 128) == 16
    # head dims 96 (phi-3-vision, 32 KV heads, two blocks an SM) and 160
    # (zamba2's shared block, 32 KV heads, one block an SM) over 1056 rows
    assert (dec.mma_blocks_per_sm(96), dec.mma_blocks_per_sm(160)) == (2, 1)
    assert dec.num_splits(1, 32, 1056, None, 1, 96) == 8
    assert dec.num_splits(1, 32, 1056, None, 1, 160) == 4
    assert dec.num_splits(1, 32, 1056, None, 1, 160, "fp32") == 17
    # a short cache never gets more splits than it has tiles
    assert dec.num_splits(1, 1, 100, None) == 2
    assert dec.num_splits(1, 1, 100, None, kernel="fp32") == 2
    assert dec.num_splits(64, 20, 8192, None) == 1
    assert dec.num_splits(64, 20, 8192, None, kernel="fp32") == 1


@pytest.mark.parametrize("kernel", ["mma", "fp32"])
def test_num_splits_is_bounded_by_the_live_tiles_and_the_merge(kernel):
    """Over batch, KV heads, groups, head dims, cache rows and windows: at
    least one split, never more than the tiles of the longest live range or
    the merge's limit; for the mma kernel never more blocks than the SMs
    hold at once unless one split a (sequence, KV head) already exceeds it,
    never so many that the merge reads more than a block streams or stages
    more than ``MERGE_BYTES``; for
    the fp32 kernel never more blocks than its target beyond one split a
    pair. The rule reads no pos, so one value serves every step of a
    captured graph."""
    import inspect
    assert "pos" not in inspect.signature(dec.num_splits).parameters
    for b in (1, 2, 3, 8, 64):
        for kv in (1, 4, 8, 20):
            for g in (1, 2, 4, 8, 16):
                for h in (64, 96, 128, 160, 256):
                    for s in (1, 63, 64, 65, 1056, 5120, 8192):
                        for window in (None, 1, 100, 4096, 10000):
                            n = dec.num_splits(b, kv, s, window, g, h, kernel)
                            live = min(s, window) if window is not None else s
                            tiles = -(-live // dec.TILE)
                            assert 1 <= n <= tiles
                            assert n <= dec.MAX_SPLITS[kernel]
                            if kernel == "fp32":
                                assert n == 1 or b * kv * n < \
                                    dec.TARGET_BLOCKS[kernel] + b * kv
                                continue
                            resident = dec.TARGET_BLOCKS[kernel] * \
                                dec.mma_blocks_per_sm(h)
                            assert n == 1 or b * kv * n <= resident
                            assert n == 1 or n * n * g * 4 <= \
                                tiles * dec.TILE * 4
                            assert n == 1 or n * (128 + 4 * g * h) <= \
                                dec.MERGE_BYTES


def test_kernel_for_picks_by_the_dtype_pair():
    assert dec.kernel_for(torch.bfloat16, torch.bfloat16) == "mma"
    assert dec.kernel_for(torch.float32, torch.float32) == "fp32"
    assert dec.kernel_for(torch.float32, torch.bfloat16) == "fp32"
    assert set(dec.kernel_launches) == {"mma", "fp32"}
    for pair in ((torch.bfloat16, torch.float32),
                 (torch.float16, torch.float16)):
        with pytest.raises(ValueError, match="dtypes"):
            dec.kernel_for(*pair)


# ---------------------------------------------------------------------------
# attention layer: cache functions, prefill and decode
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # (num_heads, num_kv_heads, head_dim, qkv_bias, window, softcap)
    (4, 1, 16, False, None, None),       # MQA (gemma-2b)
    (4, 4, 16, True, None, None),        # MHA + bias (qwen1.5)
    (4, 2, 16, False, 8, 50.0),          # GQA, window, softcap (gemma2 local)
]


def _attn_cfgs(case):
    n, kv, h, bias, win, cap = case
    kw = dict(d_model=32, num_heads=n, num_kv_heads=kv, head_dim=h,
              qkv_bias=bias, logit_softcap=cap, window=win)
    return jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)


def test_update_and_fill_cache_match_and_write_in_place():
    rng = np.random.default_rng(8)
    b, s, kv, h = 3, 20, 2, 16
    k0, v0 = (rng.standard_normal((b, s, kv, h), np.float32) for _ in range(2))
    k_new, v_new = (rng.standard_normal((b, 1, kv, h), np.float32)
                    for _ in range(2))
    pos = np.array([0, 7, 19], np.int32)
    jc = {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}
    tc = from_jax_params({"k": k0, "v": v0}, "cpu")
    want = jattn.update_cache(jc, jnp.asarray(k_new), jnp.asarray(v_new),
                              jnp.asarray(pos))
    got = tattn.update_cache(tc, torch.from_numpy(k_new),
                             torch.from_numpy(v_new), torch.from_numpy(pos))
    assert got is tc
    _assert_trees_close(got, want, atol=0, rtol=0)
    kf, vf = (rng.standard_normal((b, 5, kv, h), np.float32) for _ in range(2))
    want = jattn.fill_cache(want, jnp.asarray(kf), jnp.asarray(vf))
    got = tattn.fill_cache(tc, torch.from_numpy(kf), torch.from_numpy(vf))
    assert got is tc
    _assert_trees_close(got, want, atol=0, rtol=0)


def test_fill_cache_rounds_to_the_cache_dtype():
    rng = np.random.default_rng(9)
    kf = rng.standard_normal((1, 4, 1, 16), np.float32)
    jc = jattn.init_cache(1, 8, jattn.AttnConfig(32, 2, 1, 16))
    tc = tattn.init_cache(1, 8, tattn.AttnConfig(32, 2, 1, 16), device="cpu")
    assert tc["k"].dtype == torch.bfloat16
    want = jattn.fill_cache(jc, jnp.asarray(kf), jnp.asarray(kf))
    got = tattn.fill_cache(tc, torch.from_numpy(kf), torch.from_numpy(kf))
    np.testing.assert_array_equal(_np(got["k"]), _np(want["k"]))


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_attend_prefill_matches(case, impl):
    jcfg, tcfg = _attn_cfgs(case)
    rng = np.random.default_rng(5)
    params = _numpy_tree(jattn.attn_init(jax.random.PRNGKey(0), jcfg), rng)
    b, s, max_seq = 2, 13, 20
    x = rng.standard_normal((b, s, 32), np.float32)
    positions = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    jc = jattn.init_cache(b, max_seq, jcfg, jnp.float32)
    want, want_c = jattn.attend_prefill(_jax(params), jcfg, jnp.asarray(x),
                                        jnp.asarray(positions), jc)
    tc = from_jax_params(jc, "cpu")
    got, got_c = tattn.attend_prefill(
        from_jax_params(params, "cpu"), tcfg, torch.from_numpy(x),
        torch.from_numpy(positions), tc, impl=impl)
    assert got_c is tc
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)
    _assert_trees_close(got_c, want_c, **LAYER_TOL)


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_attend_decode_matches(case, impl):
    """B = 3 with a different write index each, over a cache of random
    rows, so that both the window and the causal bound cut keys."""
    jcfg, tcfg = _attn_cfgs(case)
    rng = np.random.default_rng(6)
    params = _numpy_tree(jattn.attn_init(jax.random.PRNGKey(0), jcfg), rng)
    b, max_seq = 3, 24
    n, kv, h = case[:3]
    cache = {name: rng.standard_normal((b, max_seq, kv, h), np.float32)
             for name in ("k", "v")}
    x = rng.standard_normal((b, 1, 32), np.float32)
    pos = np.array([0, 11, 23], np.int32)
    want, want_c = jattn.attend_decode(_jax(params), jcfg, jnp.asarray(x),
                                       _jax(cache), jnp.asarray(pos))
    got, got_c = tattn.attend_decode(
        from_jax_params(params, "cpu"), tcfg, torch.from_numpy(x),
        from_jax_params(cache, "cpu"), torch.from_numpy(pos), impl=impl)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)
    _assert_trees_close(got_c, want_c, **LAYER_TOL)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_attend_decode_fp32_over_a_bf16_cache_matches(impl):
    jcfg, tcfg = _attn_cfgs(ATTN_CASES[2])
    rng = np.random.default_rng(12)
    params = _numpy_tree(jattn.attn_init(jax.random.PRNGKey(0), jcfg), rng)
    cache = {name: rng.standard_normal((2, 16, 2, 16), np.float32)
             for name in ("k", "v")}
    jcache = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), cache)
    tcache = {k: torch.from_numpy(a).to(torch.bfloat16) for k, a in cache.items()}
    x = rng.standard_normal((2, 1, 32), np.float32)
    pos = np.array([5, 15], np.int32)
    want, want_c = jattn.attend_decode(_jax(params), jcfg, jnp.asarray(x),
                                       jcache, jnp.asarray(pos))
    got, got_c = tattn.attend_decode(
        from_jax_params(params, "cpu"), tcfg, torch.from_numpy(x), tcache,
        torch.from_numpy(pos), impl=impl)
    assert got.dtype == torch.float32 and got_c["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)
    _assert_trees_close(got_c, want_c, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# SSM: decode state, prefill and decode
# ---------------------------------------------------------------------------


def _ssm_cfgs():
    kw = dict(d_model=32, state=16, heads=4, chunk=8)
    return jssm.SSMConfig(**kw), tssm.SSMConfig(**kw)


@pytest.mark.parametrize("s", [2, 21])        # shorter than K-1 = 3; ragged
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_ssm_prefill_matches(s, impl):
    jcfg, tcfg = _ssm_cfgs()
    rng = np.random.default_rng(6)
    params = _numpy_tree(jssm.ssm_init(jax.random.PRNGKey(1), jcfg), rng)
    u = rng.standard_normal((2, s, 32), np.float32)
    want, want_st = JM.ssm_prefill(_jax(params), jcfg, jnp.asarray(u))
    got, got_st = TM.ssm_prefill(from_jax_params(params, "cpu"), tcfg,
                                 torch.from_numpy(u), impl=impl)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)
    assert got_st["conv"].dtype == torch.float32
    _assert_trees_close(got_st, want_st, **LAYER_TOL)


def test_ssm_decode_matches_and_advances_the_state_in_place():
    jcfg, tcfg = _ssm_cfgs()
    rng = np.random.default_rng(7)
    params = _numpy_tree(jssm.ssm_init(jax.random.PRNGKey(1), jcfg), rng)
    state = {"conv": rng.standard_normal((2, 3, tcfg.conv_channels),
                                         np.float32),
             "ssm": rng.standard_normal((2, 4, 16, tcfg.head_dim), np.float32)}
    tstate = from_jax_params(state, "cpu")
    tp = from_jax_params(params, "cpu")
    jstate = _jax(state)
    for step in range(3):
        u = rng.standard_normal((2, 1, 32), np.float32)
        want, jstate = jssm.ssm_decode(_jax(params), jcfg, jnp.asarray(u),
                                       jstate)
        got, out_state = tssm.ssm_decode(tp, tcfg, torch.from_numpy(u), tstate)
        assert out_state is tstate
        np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)
        _assert_trees_close(tstate, jstate, **LAYER_TOL)


def test_init_state_matches_the_reference_layout():
    jcfg, tcfg = _ssm_cfgs()
    want = jssm.init_state(3, jcfg)
    got = tssm.init_state(3, tcfg, device="cpu")
    _assert_trees_close(got, want, atol=0, rtol=0)
    assert {t.dtype for t in got.values()} == {torch.float32}


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_decode():
    """Per (arch, cache dtype): numpy params, tokens, the JAX prefill and
    one JAX decode step (computed once)."""
    memo = {}

    def get(arch, cache_dtype):
        key = (arch, cache_dtype)
        if key not in memo:
            cfg = dataclasses.replace(jconfigs.smoke_config(arch),
                                      dtype="float32")
            rng = np.random.default_rng(0)
            params = _numpy_tree(JM.init_params(jax.random.PRNGKey(0), cfg),
                                 rng)
            b, s, max_seq = 2, 12, 16
            # S = 12 > the smoke window of 8: gemma2's local layers mask
            tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            cache0 = JM.init_cache(cfg, b, max_seq, DTYPES[cache_dtype][0])
            plogits, pcache = JM.prefill(_jax(params), cfg,
                                         jnp.asarray(tokens), cache0)
            nxt = np.asarray(jnp.argmax(plogits[:, -1], -1)).astype(
                np.int32)[:, None]
            # a different write index per sequence
            pos = np.array([s, s - 4], np.int32)
            dlogits, dcache = JM.decode_step(_jax(params), cfg,
                                             jnp.asarray(nxt), pcache,
                                             jnp.asarray(pos))
            memo[key] = dict(params=params, tokens=tokens, nxt=nxt, pos=pos,
                             cache0=jax.tree.map(np.asarray, cache0),
                             plogits=np.asarray(plogits),
                             pcache=jax.tree.map(np.asarray, pcache),
                             dlogits=np.asarray(dlogits),
                             dcache=jax.tree.map(np.asarray, dcache))
        return memo[key]
    return get


def _tcfg(arch):
    return dataclasses.replace(tconfigs.smoke_config(arch), dtype="float32")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_prefill_matches_jax(jax_decode, arch, impl):
    ref_run = jax_decode(arch, "float32")
    cache = from_jax_params(ref_run["cache0"], "cpu")
    logits, got = TM.prefill(from_jax_params(ref_run["params"], "cpu"),
                             _tcfg(arch), torch.from_numpy(ref_run["tokens"]),
                             cache, attn_impl=impl, ssm_impl=impl)
    assert got is cache
    np.testing.assert_allclose(logits.numpy(), ref_run["plogits"], **MODEL_TOL)
    _assert_trees_close(got, ref_run["pcache"], **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(jax_decode, arch, impl, cache_dtype):
    """From the JAX prefill's cache, carried across: the port's step gives
    JAX's logits and cache. A bfloat16 KV cache under a float32 model is
    promoted on both sides."""
    ref_run = jax_decode(arch, cache_dtype)
    cache = from_jax_params(ref_run["pcache"], "cpu")
    logits, got = TM.decode_step(
        from_jax_params(ref_run["params"], "cpu"), _tcfg(arch),
        torch.from_numpy(ref_run["nxt"]), cache,
        torch.from_numpy(ref_run["pos"]), attn_impl=impl)
    assert got is cache and logits.shape == (2, 1, 256)
    np.testing.assert_allclose(logits.numpy(), ref_run["dlogits"], **MODEL_TOL)
    _assert_trees_close(got, ref_run["dcache"], **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_decode_matches_forward_fp32(arch, impl):
    """The port's prefill + decode_step equal its forward on the extended
    sequence (tests/test_models.py's check, on the port alone)."""
    cfg = _tcfg(arch)
    lm = TM.LM(cfg, device="cpu", seed=1, attn_impl=impl, ssm_impl=impl)
    b, s = 2, 12
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32))
    cache = lm.init_cache(b, s + 2, torch.float32)
    plogits, cache = lm.prefill(tokens, cache)
    logits, _ = lm(tokens)
    np.testing.assert_allclose(plogits.numpy(), logits.numpy(), **MODEL_TOL)
    nxt = plogits[:, -1].argmax(-1).to(torch.int32)[:, None]
    dlogits, cache = lm.decode_step(nxt, cache,
                                    torch.full((b,), s, dtype=torch.int32))
    flogits, _ = lm(torch.cat([tokens, nxt], 1))
    np.testing.assert_allclose(dlogits[:, 0].numpy(), flogits[:, -1].numpy(),
                               **DECODE_TOL)


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m"])
def test_stacked_cache_groups_do_not_share_memory(arch):
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), num_layers=6)
    cache = TM.init_cache(cfg, 2, 8, device="cpu")
    assert TM.num_groups(cfg) > 1
    leaves = []
    TM.tree_map(leaves.append, cache)
    for leaf in leaves:
        assert leaf.is_contiguous()
        leaf[0].fill_(1.0)
        assert float(leaf[1:].abs().max()) == 0.0
        ptrs = {leaf[g].data_ptr() for g in range(leaf.shape[0])}
        assert len(ptrs) == leaf.shape[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_has_the_reference_layout(arch):
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        JM.init_cache(jconfigs.smoke_config(arch), 2, 10))
    got = TM.tree_map(lambda t: (tuple(t.shape),
                                 str(t.dtype).replace("torch.", "")),
                      TM.init_cache(tconfigs.smoke_config(arch), 2, 10,
                                    device="cpu"))
    assert got == want


def test_from_jax_params_carries_a_cache_tree_as_it_is():
    """No cache leaf is a compute leaf, so ``dtype`` leaves the cache
    alone and a JAX cache crosses leaf for leaf."""
    cfg = jconfigs.smoke_config("gemma2-2b")
    jcache = JM.init_cache(cfg, 1, 4)
    leaves = set()

    def names(t):
        for name, leaf in t.items():
            names(leaf) if isinstance(leaf, dict) else leaves.add(name)
    names(jcache)
    names(JM.init_cache(jconfigs.smoke_config("mamba2-130m"), 1, 4))
    assert leaves == {"k", "v", "conv", "ssm"}
    assert not leaves & COMPUTE_LEAVES
    got = from_jax_params(jcache, "cpu", dtype=torch.float32)
    assert got["0"]["k"].dtype == torch.bfloat16
    _assert_trees_close(got, jcache, atol=0, rtol=0)

