"""The graphed serving step (``repro_torch.graphs``) on the CPU, where it
runs eagerly, against the JAX package's compiled step.

The port's ``build_handle(..., device="cpu")`` logits equal the reference's
``jax.jit``-wrapped ``build_handle`` function on the same weights (converted
by ``convert.from_jax_params``), for the four served architectures in
float32 at ``tests/test_models.py::test_decode_matches_forward_fp32``'s
tolerance (1e-4 on logits). A decode loop that copies each step's token and
position into static tensors, as ``GraphedDecode`` does before a replay,
equals the JAX package's step-by-step ``decode_step`` (logits and final
cache, 1e-4), and ``GraphedDecode`` on the CPU equals that loop bit for bit.
The launch-count bookkeeping of a capture (``kernels.build.recording``,
``add_counts``) is checked through the bindings' own ``_count``. The card's
side (captures, replays, bit-equality with the eager step, two streams) is
in ``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro import configs as jconfigs
from repro.models import model as JM
import repro_torch.launch.serve as tserve
from repro_torch import configs as tconfigs
from repro_torch import graphs
from repro_torch.convert import from_jax_params
from repro_torch.kernels import build
from repro_torch.kernels import adamw as adamw_mod
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gmm as gmm_mod
from repro_torch.kernels import mamba_front as front_mod
from repro_torch.kernels import ssd as ssd_mod
from repro_torch.models import model as TM

#: tests/test_models.py::test_decode_matches_forward_fp32 (prefill against
#: forward, float32)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
#: the four served architectures at their ``launch.serve`` depths
SERVED = [("gemma-2b", 2), ("qwen1.5-4b", 2), ("gemma2-2b", 4),
          ("mamba2-130m", 2)]
#: zero-initialised leaves redrawn, so that they bite (as in
#: tests/test_torch_decode.py)
_REDRAWN = ("scale", "bq", "bk", "bv", "conv_b")


def _float32_smoke(monkeypatch):
    """Both packages' ``build_handle`` on float32 smoke configs."""
    for mod in (jserve, tserve):
        monkeypatch.setattr(
            mod, "smoke_config",
            lambda arch, _orig=mod.smoke_config: dataclasses.replace(
                _orig(arch), dtype="float32"))


@pytest.mark.parametrize("arch,layers", SERVED, ids=[a for a, _ in SERVED])
def test_cpu_handle_matches_the_jitted_reference(monkeypatch, arch, layers):
    _float32_smoke(monkeypatch)
    want_h = jserve.build_handle(arch, "m", layers=layers, seed=0)
    got_h = tserve.build_handle(arch, "m", layers=layers, device="cpu")
    assert dataclasses.asdict(got_h.cfg) == dataclasses.asdict(want_h.cfg)
    assert not isinstance(got_h.fn, graphs.GraphedForward)
    params = from_jax_params(jax.tree.map(np.asarray, want_h.params), "cpu")
    tokens = np.random.default_rng(5).integers(
        0, want_h.cfg.vocab_size, (1, 32)).astype(np.int32)
    want = want_h.fn(want_h.params, jnp.asarray(tokens))
    got = got_h.fn(params, torch.from_numpy(tokens))
    assert got.shape == want.shape == (1, 32, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def _numpy_params(cfg, rng):
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
    return walk(JM.init_params(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m"])
def test_static_input_decode_loop_matches_jax_steps(arch):
    """Prefill in JAX, then three greedy steps: JAX's ``decode_step`` one by
    one, and the port's with each token and position copied into the same
    two static tensors (``GraphedDecode``'s inputs), from the same cache
    carried across. Then ``GraphedDecode`` itself, eager on the CPU, over
    another copy of that cache."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), dtype="float32")
    rng = np.random.default_rng(0)
    params = _numpy_params(jcfg, rng)
    jparams = jax.tree.map(jnp.asarray, params)
    b, s, max_seq, steps = 2, 12, 16, 3
    tokens = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    plogits, jcache = JM.prefill(jparams, jcfg, jnp.asarray(tokens),
                                 JM.init_cache(jcfg, b, max_seq, jnp.float32))
    pcache = jax.tree.map(np.asarray, jcache)
    nxt = jnp.argmax(plogits[:, -1], -1).astype(jnp.int32)[:, None]
    feed, poss, want = [], [], []
    for i in range(steps):
        pos = np.array([s + i, s - 4 + i], np.int32)   # one write index each
        logits, jcache = JM.decode_step(jparams, jcfg, nxt, jcache,
                                        jnp.asarray(pos))
        feed.append(np.asarray(nxt))
        poss.append(pos)
        want.append(np.asarray(logits))
        nxt = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)[:, None]

    tparams = from_jax_params(params, "cpu")
    cache = from_jax_params(pcache, "cpu")
    static_tok = torch.zeros((b, 1), dtype=torch.int32)
    static_pos = torch.zeros((b,), dtype=torch.int32)
    got = []
    with torch.inference_mode():
        for tok, pos, w in zip(feed, poss, want):
            static_tok.copy_(torch.tensor(tok))
            static_pos.copy_(torch.tensor(pos))
            logits, out_cache = TM.decode_step(tparams, tcfg, static_tok,
                                               cache, static_pos)
            assert out_cache is cache
            np.testing.assert_allclose(logits.numpy(), w, **MODEL_TOL)
            got.append(logits.clone())
    got_cache, want_cache = _flat(cache), _flat(jcache)
    assert sorted(got_cache) == sorted(want_cache)
    for name, leaf in got_cache.items():
        np.testing.assert_allclose(leaf.numpy(), want_cache[name],
                                   err_msg=name, **MODEL_TOL)

    gcache = from_jax_params(pcache, "cpu")
    step = graphs.GraphedDecode(tparams, tcfg, gcache)
    for tok, pos, g in zip(feed, poss, got):
        logits, out_cache = step(torch.tensor(tok), torch.tensor(pos))
        assert out_cache is gcache and torch.equal(logits, g)
    assert step.graphs == {}                  # nothing captured on the CPU
    for name, leaf in _flat(gcache).items():
        assert torch.equal(leaf, got_cache[name]), name


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict; JAX leaves as numpy arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = (v if isinstance(v, torch.Tensor)
                                   else np.asarray(v))
    return out


def test_graphed_decode_refuses_a_reallocated_cache():
    cfg = dataclasses.replace(tconfigs.smoke_config("gemma2-2b"),
                              dtype="float32")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    cache = TM.init_cache(cfg, 1, 8, torch.float32, "cpu")
    step = graphs.GraphedDecode(params, cfg, cache)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    step(tok, torch.zeros(1, dtype=torch.int32))
    cache["0"]["k"] = cache["0"]["k"].clone()
    with pytest.raises(RuntimeError, match="reallocated"):
        step(tok, torch.ones(1, dtype=torch.int32))


def test_graphed_forward_runs_the_eager_function_on_cpu_tensors():
    seen = []

    def fn(p, tokens):
        seen.append(tokens)
        return tokens * p["w"]

    g = graphs.GraphedForward(fn)
    assert g.eager is fn
    p, t = {"w": torch.full((3,), 2.0)}, torch.arange(3.0)
    assert torch.equal(g(p, t), t * 2) and seen == [t]
    assert g.graphs == {}


@pytest.mark.parametrize("mod,name,kernel", [
    (fa, "flash_attention", "wgmma"), (ssd_mod, "ssd", None),
    (dec, "decode_attention", "mma"), (gmm_mod, "gmm", "wgmma_splitk"),
    (adamw_mod, "adamw", None), (front_mod, "mamba_front", None)],
    ids=["flash", "ssd", "decode", "gmm", "adamw", "mamba_front"])
def test_recording_holds_a_capture_s_launches_until_added(monkeypatch, mod,
                                                         name, kernel):
    """A binding's ``_count`` inside ``build.recording`` (a capture) leaves
    the counters alone and fills the delta; each ``add_counts`` of that
    delta (a replay) adds it."""
    monkeypatch.setattr(mod, "launches", 0)
    if kernel is not None:
        monkeypatch.setattr(mod, "kernel_launches",
                            dict.fromkeys(mod.kernel_launches, 0))
    count = (lambda: mod._count(kernel)) if kernel else mod._count
    before = build.counts()
    with build.recording() as delta:
        count()
        count()
        with pytest.raises(RuntimeError, match="already recording"):
            with build.recording():
                pass
    assert build.counts() == before
    assert delta == {name: (2, {kernel: 2} if kernel else {})}
    for replays in (1, 2):
        build.add_counts(delta)
        n, by_kernel = before[name]
        want = (n + 2 * replays,
                {k: v + (2 * replays if k == kernel else 0)
                 for k, v in by_kernel.items()})
        assert build.counts()[name] == want
    count()                                        # outside: counted again
    assert build.counts()[name][0] == before[name][0] + 5
