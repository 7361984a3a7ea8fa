"""The port's compiled train step on the CPU, against the JAX package.

The AdamW update's plain version (``kernels.ref.adamw``, what the CUDA
kernel ``csrc/adamw.cu`` is held to bit for bit on the card) equals the JAX
package's ``apply_updates`` leaf by leaf, over float32 and bfloat16 params,
with and without clipping, on matrix (decayed) and vector leaves. One port
train step with accumulation and compression keeps every state leaf at its
address (the in-place error state a captured step needs), and its error
state equals the JAX package's compression of the same gradients.
``graphs.GraphedTrainStep`` on the CPU runs the eager step (bit for bit),
and the CPU ``Trainer`` matches the JAX ``Trainer`` over three steps.

Inputs are made with numpy from a seed and handed to both sides. Tolerances
are ``tests/test_torch_training.py``'s: metrics rtol 1e-5, the updated
params, m and v atol 1e-5, rtol 1e-4; the compression exactly. The card's
side (captures, replays, the kernel) is in ``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.distributed import compression as jcomp
from repro.training import optim as JO
from repro.training import train as JT
from repro_torch import configs as tconfigs
from repro_torch import graphs
from repro_torch.convert import from_jax_params
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import compression as tcomp
from repro_torch.kernels import adamw as adamw_mod
from repro_torch.kernels import ops, ref
from repro_torch.models import model as TM
from repro_torch.training import optim as TO
from repro_torch.training import train as TT

METRIC_TOL = dict(rtol=1e-5)
STATE_TOL = dict(atol=1e-5, rtol=1e-4)


def _cfgs(arch, vocab=128):
    j = dataclasses.replace(jconfigs.smoke_config(arch), vocab_size=vocab,
                            dtype="float32")
    t = dataclasses.replace(tconfigs.smoke_config(arch), vocab_size=vocab,
                            dtype="float32")
    return j, t


def _to_torch(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree), device="cpu")


def _mid_run(state, seed=7):
    """``state`` (the JAX package's) with m, v and the step of a run under
    way: from zeros Adam's first update is the sign of a gradient's float
    noise (see tests/test_torch_training.py)."""
    rng = np.random.default_rng(seed)
    out = dict(state)
    out["opt"] = {
        "m": jax.tree.map(lambda p: jnp.asarray(
            (1e-2 * rng.standard_normal(p.shape)).astype(np.float32)),
            state["params"]),
        "v": jax.tree.map(lambda p: jnp.asarray(
            rng.uniform(1e-5, 1e-4, p.shape).astype(np.float32)),
            state["params"]),
        "step": jnp.asarray(10, jnp.int32)}
    return out


# ---------------------------------------------------------------------------
# the update's plain version, leaf by leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 8), (33,)], ids=["matrix", "vector"])
@pytest.mark.parametrize("clip_norm", [None, 1.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_adamw_matches_the_reference_leaf_by_leaf(dtype, clip_norm,
                                                        shape):
    """One leaf through ``JO.apply_updates`` and through ``ref.adamw`` with
    the scalars the port's ``apply_updates`` makes (lr, bias corrections and
    clip scale as float32 tensors); a matrix is decayed, a vector not."""
    rng = np.random.default_rng(3)
    p = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        p = np.asarray(jnp.asarray(p, jnp.bfloat16).astype(jnp.float32))
    g = (2 * rng.standard_normal(shape)).astype(np.float32)
    m = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    v = rng.uniform(0, 1e-2, shape).astype(np.float32)
    cfg = dict(learning_rate=1e-2, warmup_steps=3, total_steps=20,
               clip_norm=clip_norm)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp, js, _ = JO.apply_updates(
        {"w": jnp.asarray(p, jdt)}, {"w": jnp.asarray(g)},
        {"m": {"w": jnp.asarray(m)}, "v": {"w": jnp.asarray(v)},
         "step": jnp.asarray(5, jnp.int32)}, JO.OptimConfig(**cfg))

    tcfg = TO.OptimConfig(**cfg)
    tp = torch.from_numpy(p.copy()).to(getattr(torch, dtype))
    tg, tm, tv = (torch.from_numpy(x.copy()) for x in (g, m, v))
    gnorm = TO.global_norm({"w": tg})
    scale = (TO._clip_scale(gnorm, clip_norm) if clip_norm is not None
             else None)
    step = torch.tensor(6, dtype=torch.int32)
    lr = TO.lr_at(tcfg, step)
    b1c = 1.0 - tcfg.b1 ** step.float()
    b2c = 1.0 - tcfg.b2 ** step.float()
    decay = tcfg.weight_decay if TO._is_matrix(tp) else 0.0
    assert (decay != 0) == (len(shape) == 2)
    g_before = tg.clone()
    ref.adamw(tp, tg, tm, tv, lr, b1c, b2c, scale, b1=tcfg.b1, b2=tcfg.b2,
              eps=tcfg.eps, weight_decay=decay)
    assert torch.equal(tg, g_before)                 # g is read only
    assert tp.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(tp.float().numpy(),
                               np.asarray(jp["w"].astype(jnp.float32)),
                               **STATE_TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(js["m"]["w"]),
                               **STATE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(js["v"]["w"]),
                               **STATE_TOL)
    # the wrapper takes the plain version on CPU tensors, bit for bit
    again = [torch.from_numpy(x.copy()) for x in (p, m, v)]
    again[0] = again[0].to(getattr(torch, dtype))
    ops.adamw(again[0], g_before, again[1], again[2], lr=lr, b1c=b1c,
              b2c=b2c, scale=scale, b1=tcfg.b1, b2=tcfg.b2, eps=tcfg.eps,
              weight_decay=decay)
    for a, b in zip(again, (tp, tm, tv)):
        assert torch.equal(a, b)


def test_adamw_binding_refuses_what_the_kernel_does_not_take():
    """The binding refuses an input that requires grad under grad mode (the
    kernel writes p in place behind autograd's back) and CPU tensors; the
    ops wrapper never launches for CPU tensors and counts nothing."""
    p, g, m, v = (torch.ones(8) for _ in range(4))
    lr, b1c, b2c = (torch.tensor(0.5) for _ in range(3))
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0)
    with pytest.raises(RuntimeError, match="no backward pass"):
        adamw_mod.adamw(p.clone().requires_grad_(), g, m, v, lr, b1c, b2c,
                        None, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        adamw_mod.adamw(p, g, m, v, lr, b1c, b2c, None, **kw)
    with pytest.raises(ValueError, match="float32"):
        adamw_mod.adamw(p, g.double(), m, v, lr, b1c, b2c, None, **kw)
    before = adamw_mod.launches
    ops.adamw(p, g, m, v, lr=lr, b1c=b1c, b2c=b2c, scale=None, **kw)
    assert adamw_mod.launches == before and not torch.equal(p, g)


def test_adamw_counts_its_bytes_and_operations():
    assert adamw_mod.hbm_bytes(10, 4) == 10 * 28 + 16
    assert adamw_mod.hbm_bytes(10, 2) == 10 * 24 + 16
    assert adamw_mod.flops(10, clip=True, decay=True) == 170
    assert adamw_mod.flops(10, clip=False, decay=False) == 140


# ---------------------------------------------------------------------------
# the train step: state in place, the error state
# ---------------------------------------------------------------------------


def test_train_step_keeps_every_state_leaf_in_place():
    """One port step of qwen1.5-4b with accum 2 and int8 compression: every
    state leaf (params, m, v, step, err) keeps its ``data_ptr``; the new
    error state equals the JAX package's ``compress_with_feedback`` of the
    step's own gradients exactly, and the params the JAX step's within the
    state tolerance. (The JAX step's error state itself is not compared
    exactly: its gradients agree with the port's to ~1e-6, which puts an
    element near an int8 rounding boundary one quantum apart.)"""
    jcfg, tcfg = _cfgs("qwen1.5-4b")
    opt = dict(learning_rate=1e-2, warmup_steps=2, total_steps=20)
    jt = JT.TrainConfig(optim=JO.OptimConfig(**opt), accum=2,
                        compression=jcomp.CompressionConfig(block=64))
    tt = TT.TrainConfig(optim=TO.OptimConfig(**opt), accum=2,
                        compression=tcomp.CompressionConfig(block=64))
    js = _mid_run(JT.init_train_state(jax.random.PRNGKey(1), jcfg, jt))
    rng = np.random.default_rng(4)
    js["err"] = jax.tree.map(lambda p: jnp.asarray(
        (1e-3 * rng.standard_normal(p.shape)).astype(np.float32)),
        js["params"])
    ts = _to_torch(js)
    err0 = TM.tree_map(torch.clone, ts["err"])
    b = tpipe.SyntheticLMData(vocab_size=128, seq_len=16, global_batch=4,
                              seed=3).batch(0)
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    grads, _ = TT.build_grad_fn(tcfg, tt)(ts["params"], bt)
    ptrs = [x.data_ptr() for x in TM.tree_leaves(ts)]
    ts2, _ = TT.build_train_step(tcfg, tt)(ts, bt)
    assert ts2 is ts
    assert [x.data_ptr() for x in TM.tree_leaves(ts)] == ptrs
    _, jerr = jcomp.compress_with_feedback(
        jax.tree.map(jnp.asarray, TM.tree_map(lambda x: x.numpy(), grads)),
        jax.tree.map(jnp.asarray, TM.tree_map(lambda x: x.numpy(), err0)),
        jt.compression)
    got, want = TM.tree_leaves(ts["err"]), jax.tree.leaves(jerr)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    assert int(ts["opt"]["step"]) == 11


def test_compression_writes_the_error_state_in_place():
    """``compress_with_feedback`` returns the ``err`` tree it was given,
    each leaf at its address, holding the new error (the values of before:
    ``tests/test_torch_training.py`` holds them to the JAX package's)."""
    rng = np.random.default_rng(6)
    grads = {"a": torch.from_numpy(rng.standard_normal((5, 9)).astype(
        np.float32)), "b": {"c": torch.from_numpy(rng.standard_normal(
            70).astype(np.float32))}}
    err = TM.tree_map(lambda g: 0.01 * torch.ones_like(g), grads)
    ptrs = [e.data_ptr() for e in TM.tree_leaves(err)]
    q, e = tcomp.compress_with_feedback(grads, err,
                                        tcomp.CompressionConfig(block=16))
    assert e is err and [x.data_ptr() for x in TM.tree_leaves(e)] == ptrs
    for g, qq, ee in zip(TM.tree_leaves(grads), TM.tree_leaves(q),
                         TM.tree_leaves(e)):
        assert torch.equal(ee, (g + 0.01) - qq)


# ---------------------------------------------------------------------------
# GraphedTrainStep and Trainer on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "mamba2-130m"])
def test_graphed_train_step_on_the_cpu_is_the_eager_step(arch):
    """On CPU tensors ``GraphedTrainStep`` runs the eager step: four steps
    with accum 2 and compression give the eager loop's metrics and state bit
    for bit, and nothing is captured."""
    _, cfg = _cfgs(arch)
    tcfg = TT.TrainConfig(optim=TO.OptimConfig(learning_rate=1e-2,
                                               warmup_steps=2,
                                               total_steps=20),
                          accum=2, compression=tcomp.CompressionConfig())
    data = tpipe.SyntheticLMData(vocab_size=128, seq_len=16, global_batch=4,
                                 seed=5)
    states = [TT.init_train_state(torch.Generator().manual_seed(0), cfg,
                                  tcfg, "cpu") for _ in range(2)]
    eager = TT.build_train_step(cfg, tcfg)
    graphed = graphs.GraphedTrainStep(TT.build_train_step(cfg, tcfg))
    for i in range(4):
        b = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
        s0, m0 = eager(states[0], b)
        s1, m1 = graphed(states[1], b)
        assert s1 is states[1]
        assert {k: float(v) for k, v in m0.items()} == \
            {k: float(v) for k, v in m1.items()}
    assert graphed.graphs == {}
    for a, c in zip(TM.tree_leaves(states[0]), TM.tree_leaves(states[1])):
        assert torch.equal(a, c)


def test_cpu_trainer_is_eager_and_matches_the_jax_trainer():
    """The port's CPU ``Trainer`` (its step not graphed) and the JAX
    ``Trainer`` from the same mid-run state over the same three batches:
    every step's metrics within rtol 1e-5, the final params, m and v within
    the state tolerance."""
    jcfg, tcfg = _cfgs("qwen1.5-4b")
    opt = dict(learning_rate=1e-2, warmup_steps=2, total_steps=20)
    data = dict(vocab_size=128, seq_len=16, global_batch=4, seed=8)
    jtr = JT.Trainer(cfg=jcfg, tcfg=JT.TrainConfig(optim=JO.OptimConfig(
        **opt)), data=iter(jpipe.SyntheticLMData(**data)), log_every=1000,
        log_fn=lambda s: None)
    jtr.init_or_resume(resume="never")
    jtr.state = _mid_run(jtr.state)
    ttr = TT.Trainer(cfg=tcfg, tcfg=TT.TrainConfig(optim=TO.OptimConfig(
        **opt)), data=iter(tpipe.SyntheticLMData(**data)), log_every=1000,
        device="cpu")
    assert not isinstance(ttr._step_fn, graphs.GraphedTrainStep)
    ttr.init_or_resume(resume="never")
    ttr.state = _to_torch(jtr.state)
    want, got = jtr.run(3), ttr.run(3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["step"] == w["step"]
        assert g["tokens"] == w["tokens"]
        for k in w:
            np.testing.assert_allclose(g[k], w[k], **METRIC_TOL, err_msg=k)
    for part in (["params"], ["opt", "m"], ["opt", "v"]):
        a, w = ttr.state, jtr.state
        for k in part:
            a, w = a[k], w[k]
        for x, y in zip(TM.tree_leaves(a), jax.tree.leaves(w)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), **STATE_TOL)
