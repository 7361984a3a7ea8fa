"""The port's MoE path against the JAX package's, on shared numpy inputs.

Covered: the grouped matmul (``ops.gmm`` and its plain version against the
JAX package's Pallas kernel in interpret mode and its oracle), routing,
the capacity-dropped einsum dispatch (with and without drops), the sort
dispatch, and ``forward``, ``prefill`` and ``decode_step`` of the two MoE
architectures under both of the port's ``moe_impl`` values: ``"kernel"``
against the JAX package's ``moe_impl="gmm"``, ``"einsum"`` against its
``"einsum"``. Parameters and caches cross with ``repro_torch.convert``.

Tolerances are the reference's: atol = rtol = 3e-5 for float32 kernels and
2e-2 for bfloat16 (``_tol``), 1e-5 for single layers and 1e-4 for whole
models (float32), 1e-3 for decode against forward.
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
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.convert import COMPUTE_LEAVES, from_jax_params
from repro_torch.kernels import gmm as gmm_mod
from repro_torch.kernels import ops, ref
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe

MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b"]
#: the port's moe_impl -> the JAX package's
IMPLS = {"kernel": "gmm", "einsum": "einsum"}
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = dict(atol=1e-3, rtol=1e-3)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

GMM_CASES = [
    # (t, d, f, e): tests/test_kernels.py's list, then its empty-groups case
    (16, 8, 16, 2), (37, 16, 24, 4), (100, 32, 64, 8), (64, 16, 48, 16),
]
EMPTY_GROUPS = [5, 0, 0, 3]


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


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _numpy_tree(tree, rng):
    """JAX params as numpy, with the zero-initialised norm scales redrawn."""
    def walk(t):
        out = {}
        for name, leaf in t.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf)
            else:
                a = np.asarray(leaf)
                if name == "scale":
                    a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
                out[name] = a
        return out
    return walk(tree)


def _assert_trees_close(got: dict, want: dict, **tol):
    assert sorted(got) == sorted(want)
    for name in want:
        if isinstance(want[name], dict):
            _assert_trees_close(got[name], want[name], **tol)
        else:
            assert tuple(got[name].shape) == tuple(want[name].shape), name
            np.testing.assert_allclose(_np(got[name]), _np(want[name]),
                                       err_msg=name, **tol)


def _gmm_inputs(case, seed=7):
    rng = np.random.default_rng(seed)
    if case == "empty":
        sizes = np.array(EMPTY_GROUPS, np.int32)
        t, d, f, e = int(sizes.sum()), 8, 8, len(sizes)
    else:
        t, d, f, e = case
        sizes = np.bincount(rng.integers(0, e, t), minlength=e).astype(np.int32)
    x = rng.standard_normal((t, d), np.float32)
    w = rng.standard_normal((e, d, f), np.float32)
    return x, w, sizes


# ---------------------------------------------------------------------------
# grouped matmul: wrapper and plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", GMM_CASES + ["empty"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_matches_jax_kernel_and_oracle(case, dtype):
    x, w, sizes = _gmm_inputs(case)
    (jx, tx), (jw, tw) = _both(x, dtype), _both(w, dtype)
    block = 4 if case == "empty" else 16
    want = jops.gmm(jx, jw, jnp.asarray(sizes), block_t=block, block_f=block,
                    interpret=True)
    got = ops.gmm(tx, tw, torch.from_numpy(sizes), block_t=block,
                  block_f=block)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (x.shape[0],
                                                          w.shape[2])
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_allclose(
        _np(got), _np(jref.gmm(jx, jw, jnp.asarray(sizes))), **_tol(dtype))


def test_gmm_empty_groups_leave_the_neighbours_alone():
    """Experts with no rows take none of their neighbours' rows: every row
    is its own expert's product."""
    x, w, sizes = _gmm_inputs("empty")
    got = ops.gmm(torch.from_numpy(x), torch.from_numpy(w),
                  torch.from_numpy(sizes)).numpy()
    np.testing.assert_allclose(got[:5], x[:5] @ w[0], **LAYER_TOL)
    np.testing.assert_allclose(got[5:], x[5:] @ w[3], **LAYER_TOL)


def test_ref_gmm_refuses_sizes_that_do_not_split_the_rows():
    x, w, sizes = _gmm_inputs("empty")
    sizes = torch.from_numpy(sizes)
    with pytest.raises(ValueError, match="split"):
        ref.gmm(torch.from_numpy(x), torch.from_numpy(w), sizes - 1)


def test_gmm_cpu_path_counts_no_launch_and_binding_refuses_cpu():
    x, w, sizes = (torch.from_numpy(a) for a in _gmm_inputs(GMM_CASES[0]))
    gmm_mod.launches = 0
    ops.gmm(x, w, sizes)
    with pytest.raises(ValueError, match="CUDA"):
        gmm_mod.gmm(x, w, sizes)
    assert gmm_mod.launches == 0


def test_gmm_bound_counts_only_the_experts_with_rows():
    # experts 0 and 3 have rows: their [8, 8] weights, 8 rows in and out
    assert gmm_mod.hbm_bytes(EMPTY_GROUPS, 8, 8, 2) == \
        (2 * 8 * 8 + 8 * 8 + 8 * 8) * 2 + 4 * 4
    assert gmm_mod.flops(8, 16, 24) == 2 * 8 * 16 * 24


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


def _moe_cfgs(e=4, k=2, cf=1.25, group_size=256, d=32, f=48):
    kw = dict(d_model=d, d_ff=f, num_experts=e, top_k=k, capacity_factor=cf,
              group_size=group_size)
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _moe_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed),
                                                  jcfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_jax(dtype):
    jcfg, tcfg = _moe_cfgs(e=8, k=3)
    params = _moe_params(jcfg)
    x = np.random.default_rng(3).standard_normal((64, 32), np.float32)
    (jx, tx), = [_both(x, dtype)]
    jw, jidx, jaux = jmoe.route(_jax(params), jcfg, jx)
    # drawn without ties: the k-th and (k+1)-th probabilities differ
    logits = jnp.einsum("td,de->te", jx, jnp.asarray(params["router"], jx.dtype))
    top = np.sort(np.asarray(jax.nn.softmax(logits.astype(jnp.float32))), -1)
    assert (top[:, -3] > top[:, -4]).all() and (np.diff(top[:, -3:]) > 0).all()
    tw, tidx, taux = tmoe.route(from_jax_params(params, "cpu"), tcfg, tx)
    assert tw.dtype == DTYPES[dtype][1] and tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(_np(tw), _np(jw), **_tol(dtype))
    np.testing.assert_allclose(float(taux), float(jaux), **LAYER_TOL)


@pytest.mark.parametrize("cf", [1.0, 2.0])
def test_moe_einsum_drops_what_jax_drops(cf):
    """At capacity factor 1.0 some (token, choice) pairs are dropped: the
    tokens the port drops a pair of are exactly those where the JAX
    package's einsum dispatch and its no-drop gmm dispatch differ, and the
    port's output equals JAX's. At 2.0 an expert has a slot for every token
    of a group, so nothing is dropped."""
    jcfg, tcfg = _moe_cfgs(cf=cf, group_size=16)
    params = _moe_params(jcfg, seed=1)
    x = np.random.default_rng(4).standard_normal((2, 24, 32), np.float32)
    want, jaux = jmoe.moe_einsum(_jax(params), jcfg, jnp.asarray(x))
    tparams = from_jax_params(params, "cpu")
    got, taux = tmoe.moe_einsum(tparams, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **LAYER_TOL)

    _, idx, _ = tmoe.route(tparams, tcfg, torch.from_numpy(x).reshape(48, 32))
    g = 16                                  # 48 tokens, group_size 16
    _, keep = tmoe.capacity_slots(idx.reshape(48 // g, g * 2), 4,
                                  tmoe._capacity(tcfg, g))
    dropped = ~keep.reshape(48, 2).all(dim=1).numpy()
    no_drop, _ = jmoe.moe_gmm(_jax(params), jcfg, jnp.asarray(x))
    differs = np.abs(np.asarray(want) - np.asarray(no_drop)).reshape(
        48, 32).max(axis=1) > 1e-4
    np.testing.assert_array_equal(dropped, differs)
    assert dropped.any() == (cf == 1.0)


@pytest.mark.parametrize("e,k", [(4, 2), (16, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_matches_jax(e, k, dtype):
    """The sort dispatch at smoke width (d_model 64, d_ff 128), against the
    JAX package's moe_gmm with its Pallas kernel in interpret mode."""
    jcfg, tcfg = _moe_cfgs(e=e, k=k, d=64, f=128)
    params = _moe_params(jcfg, seed=2)
    x = np.random.default_rng(5).standard_normal((2, 12, 64), np.float32)
    (jx, tx), = [_both(x, dtype)]
    want, jaux = jmoe.moe_gmm(_jax(params), jcfg, jx)
    got, taux = tmoe.moe_gmm(from_jax_params(params, "cpu"), tcfg, tx)
    assert got.dtype == DTYPES[dtype][1] and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_allclose(float(taux), float(jaux), **LAYER_TOL)


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_flops_per_token_matches_jax(impl):
    jcfg, tcfg = _moe_cfgs(e=16, k=2, d=4096, f=6400)
    want = jmoe.flops_per_token(dataclasses.replace(jcfg, impl=IMPLS[impl]))
    assert tmoe.flops_per_token(tcfg, impl) == want


def test_moe_gmm_makes_no_host_sync(monkeypatch):
    """Nothing on the sort dispatch reads a tensor's value on the host: the
    group sizes reach ``ops.gmm`` as a tensor. Every Python-level way to read
    a value raises here, and ``ops.gmm`` is a stand-in that only records
    its arguments."""
    jcfg, tcfg = _moe_cfgs(e=8, k=2, d=64, f=128)
    params = from_jax_params(_moe_params(jcfg), "cpu")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 12, 64), np.float32))
    calls = []

    def stand_in(xs, w, group_sizes, **_):
        calls.append((tuple(xs.shape), tuple(w.shape), group_sizes))
        return torch.zeros((xs.shape[0], w.shape[2]), dtype=xs.dtype)

    def sync(*_, **__):
        raise AssertionError("host sync on the MoE dispatch")
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, sync)
    monkeypatch.setattr(ops, "gmm", stand_in)
    y, _ = tmoe.moe_gmm(params, tcfg, x)
    monkeypatch.undo()
    assert [c[:2] for c in calls] == [((48, 64), (8, 64, 128))] * 2 + \
        [((48, 128), (8, 128, 64))]
    for _, _, sizes in calls:
        assert isinstance(sizes, torch.Tensor) and sizes.dtype == torch.int32
        assert int(sizes.sum()) == 48
    assert y.shape == x.shape


def test_unknown_moe_impl_raises():
    cfg = dataclasses.replace(tconfigs.smoke_config(MOE_ARCHS[0]),
                              dtype="float32")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="moe_impl"):
        TM.forward(params, cfg, tokens, moe_impl="gmm")
    with pytest.raises(ValueError, match="moe_impl"):
        tmoe.moe_apply(params["blocks"]["0"]["moe"], TM.moe_cfg_for(cfg),
                       torch.zeros((1, 4, cfg.d_model)), impl="torch")


def test_from_jax_params_carries_a_moe_tree_leaf_by_leaf():
    cfg = jconfigs.smoke_config(MOE_ARCHS[1])
    jparams = JM.init_params(jax.random.PRNGKey(0), cfg)
    got = from_jax_params(jparams, "cpu", dtype=torch.bfloat16)
    moe = got["blocks"]["0"]["moe"]
    g, e, d, f = cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff
    assert {k: tuple(v.shape) for k, v in moe.items()} == {
        "router": (g, d, e), "wi": (g, e, d, f), "wg": (g, e, d, f),
        "wo": (g, e, f, d)}
    assert "router" in COMPUTE_LEAVES
    assert {v.dtype for v in moe.values()} == {torch.bfloat16}
    want = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)
                                             .astype(jnp.float32)),
                        jparams["blocks"]["0"]["moe"])
    for name, leaf in moe.items():
        np.testing.assert_array_equal(leaf.float().numpy(), want[name])


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def _cfgs(arch, impl):
    """float32 smoke configs; the einsum cases run at capacity factor 1.0,
    where the smoke batch drops pairs (at the smoke config's 2.0 it drops
    none, and the two impls would compute one function)."""
    cf = 1.0 if impl == "einsum" else tconfigs.smoke_config(arch).moe_capacity_factor
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), dtype="float32",
                               moe_impl=IMPLS[impl], moe_capacity_factor=cf)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), dtype="float32",
                               moe_capacity_factor=cf)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_runs():
    """Per (arch, impl): numpy params, tokens, the JAX forward, prefill and
    one decode step (computed once)."""
    memo = {}

    def get(arch, impl):
        key = (arch, impl)
        if key not in memo:
            jcfg, _ = _cfgs(arch, impl)
            rng = np.random.default_rng(0)
            params = _numpy_tree(JM.init_params(jax.random.PRNGKey(0), jcfg),
                                 rng)
            b, s, max_seq = 2, 24, 28
            tokens = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
            flogits, aux = JM.forward(_jax(params), jcfg, jnp.asarray(tokens))
            cache0 = JM.init_cache(jcfg, b, max_seq, jnp.float32)
            plogits, pcache = JM.prefill(_jax(params), jcfg,
                                         jnp.asarray(tokens), cache0)
            nxt = np.asarray(jnp.argmax(plogits[:, -1], -1)).astype(
                np.int32)[:, None]
            pos = np.array([s, s - 5], np.int32)
            dlogits, dcache = JM.decode_step(_jax(params), jcfg,
                                             jnp.asarray(nxt), pcache,
                                             jnp.asarray(pos))
            memo[key] = dict(params=params, tokens=tokens, nxt=nxt, pos=pos,
                             flogits=np.asarray(flogits), aux=float(aux),
                             cache0=jax.tree.map(np.asarray, cache0),
                             plogits=np.asarray(plogits),
                             pcache=jax.tree.map(np.asarray, pcache),
                             dlogits=np.asarray(dlogits),
                             dcache=jax.tree.map(np.asarray, dcache))
        return memo[key]
    return get


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_forward_matches_jax(jax_runs, arch, impl):
    run = jax_runs(arch, impl)
    _, tcfg = _cfgs(arch, impl)
    logits, aux = TM.forward(from_jax_params(run["params"], "cpu"), tcfg,
                             torch.from_numpy(run["tokens"]), moe_impl=impl)
    assert logits.dtype == aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(logits.numpy(), run["flogits"], **MODEL_TOL)
    np.testing.assert_allclose(float(aux), run["aux"], **LAYER_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_prefill_matches_jax(jax_runs, arch, impl):
    run = jax_runs(arch, impl)
    _, tcfg = _cfgs(arch, impl)
    cache = from_jax_params(run["cache0"], "cpu")
    logits, got = TM.prefill(from_jax_params(run["params"], "cpu"), tcfg,
                             torch.from_numpy(run["tokens"]), cache,
                             moe_impl=impl)
    assert got is cache
    np.testing.assert_allclose(logits.numpy(), run["plogits"], **MODEL_TOL)
    _assert_trees_close(got, run["pcache"], **MODEL_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_decode_step_matches_jax(jax_runs, arch, impl):
    run = jax_runs(arch, impl)
    _, tcfg = _cfgs(arch, impl)
    cache = from_jax_params(run["pcache"], "cpu")
    logits, got = TM.decode_step(
        from_jax_params(run["params"], "cpu"), tcfg,
        torch.from_numpy(run["nxt"]), cache, torch.from_numpy(run["pos"]),
        moe_impl=impl)
    assert got is cache and logits.shape == (2, 1, tcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), run["dlogits"], **MODEL_TOL)
    _assert_trees_close(got, run["dcache"], **MODEL_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_forward_fp32(arch):
    """The port's prefill + decode_step equal its forward on the extended
    sequence, through the grouped matmul (tests/test_models.py's check, on
    the port alone)."""
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), dtype="float32")
    lm = TM.LM(cfg, device="cpu", seed=1)
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
