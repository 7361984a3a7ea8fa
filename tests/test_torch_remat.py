"""Rematerialisation (``cfg.remat``, ``repro_torch.models.remat``) against
the port's own run without it and against the JAX package's
``jax.checkpoint`` policies, and the dry-run's count of it.

Everything is float32 on the CPU at smoke size. Tolerances: against
``remat="none"`` exact (``torch.equal``: non-reentrant checkpointing keeps
the autograd graph, so the gradients are summed in the same order, and the
recompute repeats the same ops); against the JAX step
``tests/test_torch_training.py``'s ``GRAD_TOL`` and ``STATE_TOL``.

What a policy keeps for the backward is measured as the bytes of the
storages the forward allocated that are still alive when it returns: the
tensors autograd saved, the selective checkpoint's cache of matmul outputs
and the checkpoints' inputs (``saved_tensors_hooks`` see a checkpoint's
inputs but not that cache, which the checkpoint holds itself).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import configs as C
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model as M
from repro_torch.models import remat
from repro_torch.training import loss as L
from test_torch_training import STEP_ARCHS, check_train_step

ARCHS = ["qwen1.5-4b", "gemma2-2b", "mamba2-130m", "phi3.5-moe-42b-a6.6b",
         "zamba2-2.7b"]
REMATS = ["full", "dots", "dots_nobatch"]


def _cfg(arch, remat_policy="none", **kw):
    return dataclasses.replace(C.smoke_config(arch), vocab_size=128,
                               dtype="float32", remat=remat_policy, **kw)


def _tokens(vocab, batch, seq, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (batch, seq),
                                         dtype=np.int32))


def _forward(params, cfg, tokens):
    return M.forward(params, cfg, tokens, attn_impl="torch",
                     ssm_impl="torch", moe_impl="einsum")


def _loss_logits_grads(arch, policy):
    cfg = _cfg(arch, policy)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    leaves = [p.requires_grad_() for p in M.tree_leaves(params)]
    tokens = _tokens(cfg.vocab_size, 2, 16)
    logits, aux = _forward(params, cfg, tokens)
    loss, _ = L.lm_loss(logits, tokens.long(), aux)
    return loss, logits, aux, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("policy", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat_bit_for_bit(arch, policy):
    want = _loss_logits_grads(arch, "none")
    got = _loss_logits_grads(arch, policy)
    for name, g, w in zip(("loss", "logits", "aux"), got, want):
        assert torch.equal(g, w), name
    assert len(got[3]) == len(want[3])
    for i, (g, w) in enumerate(zip(got[3], want[3])):
        assert torch.equal(g, w), i


@pytest.mark.parametrize("policy", REMATS)
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_under_remat_matches_the_reference(arch, policy):
    check_train_step(arch, policy)


# ---------------------------------------------------------------------------
# what each policy keeps for the backward
# ---------------------------------------------------------------------------


class _Allocations(TorchDispatchMode):
    """Every storage an op allocates (an output storage none of its inputs
    has), with its bytes and the shape it was made with."""

    def __init__(self):
        super().__init__()
        self.made = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        given = {StorageWeakRef(t.untyped_storage())
                 for t in tree_flatten((args, kwargs))[0]
                 if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                key = StorageWeakRef(t.untyped_storage())
                if key not in given and key not in self.made:
                    self.made[key] = (t.untyped_storage().nbytes(),
                                      tuple(t.shape))
        return out

    def alive(self):
        return [v for k, v in self.made.items() if not k.expired()]


#: gemma2-2b smoke (4 heads of 16) cut to 8 layers, batch 2 x 256: the
#: [2, 4, 256, 256] scores are its largest activation
KEEP = dict(num_layers=8, batch=2, seq=256)


def _kept(policy):
    """The bytes the forward allocated that are alive after it returns (the
    logits and the loss among them), and their shapes."""
    cfg = _cfg("gemma2-2b", policy, num_layers=KEEP["num_layers"])
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    for p in M.tree_leaves(params):
        p.requires_grad_()
    tokens = _tokens(cfg.vocab_size, KEEP["batch"], KEEP["seq"])
    with _Allocations() as mode:
        logits, aux = _forward(params, cfg, tokens)
        loss, _ = L.lm_loss(logits, tokens.long(), aux)
    alive = mode.alive()
    return sum(n for n, _ in alive), {s for _, s in alive}, cfg


def test_policies_keep_strictly_less_in_order():
    """none > dots > dots_nobatch > full; the [B, N, S, S] scores (made by
    ``bmm`` as [B * N, S, S]) are kept by "none" and "dots" only."""
    kept = {p: _kept(p) for p in remat.POLICIES}
    n = {p: k[0] for p, k in kept.items()}
    assert n["none"] > n["dots"] > n["dots_nobatch"] > n["full"], n
    cfg = kept["none"][2]
    scores = KEEP["batch"] * cfg.num_heads * KEEP["seq"] ** 2
    sizes = {p: {math.prod(s) for s in k[1]} for p, k in kept.items()}
    assert max(sizes["none"]) == scores
    assert scores in sizes["dots"]
    assert max(sizes["dots_nobatch"]) < scores
    assert max(sizes["full"]) < scores


# ---------------------------------------------------------------------------
# plumbing
# ---------------------------------------------------------------------------


def test_unknown_policy_raises():
    cfg = _cfg("gemma2-2b", "everything")
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match="remat policy"):
        _forward(params, cfg, _tokens(cfg.vocab_size, 1, 8))
    with pytest.raises(ValueError, match="remat policy"):
        remat.checkpointed(lambda x: x, "some")
    with pytest.raises(ValueError, match="remat policy"):
        D.cell_config(cfg, C.ShapeCell("t", 8, 1, "train"), "nothing")


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((str(func), tuple(
            tuple(t.shape) for t in tree_flatten(out)[0]
            if isinstance(t, torch.Tensor))))
        return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_without_grad_runs_the_same_ops(arch):
    """With grad off (serving), every policy runs exactly the ops of
    ``remat="none"``."""
    runs = {}
    for policy in remat.POLICIES:
        cfg = _cfg(arch, policy)
        params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        with torch.no_grad(), _Ops() as mode:
            logits, _ = _forward(params, cfg, _tokens(cfg.vocab_size, 2, 16))
        runs[policy] = (mode.ops, logits)
    for policy in REMATS:
        assert runs[policy][0] == runs["none"][0], policy
        assert torch.equal(runs[policy][1], runs["none"][1])


def test_matmuls_are_classed_by_their_batch():
    x = torch.empty(2, 3, 4, device="meta")
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert remat.is_dot(mm) and remat.is_dot(bmm)
    assert not remat.is_dot(torch.ops.aten.mul.Tensor)
    assert not remat.has_batch(mm, (x[0], x[0].T))
    assert remat.has_batch(bmm, (x, x.transpose(1, 2)))
    assert not remat.has_batch(bmm, (x[:1], x[:1].transpose(1, 2)))
    baddbmm = torch.ops.aten.baddbmm.default
    assert remat.has_batch(baddbmm, (x, x, x.transpose(1, 2)))


# ---------------------------------------------------------------------------
# the dry-run: the recompute's FLOPs and the memory analysis
# ---------------------------------------------------------------------------


class _GroupFlops(TorchDispatchMode):
    """FLOPs (FlopCounterMode's table) of every op, and of the batched
    matmuls alone."""

    def __init__(self):
        super().__init__()
        self.all = self.batched = self.last_dot = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.overloadpacket in flop_registry:
            f = int(flop_registry[func.overloadpacket](*args, **kwargs,
                                                       out_val=out))
            self.all += f
            if remat.is_dot(func):
                self.last_dot = f
                if remat.has_batch(func, args):
                    self.batched += f
        return out


def _groups_forward_flops(cfg, cell):
    """The layer groups' forward on meta tensors: (its FLOPs, those of its
    batched matmuls, those of each group's last matmul)."""
    params = M.param_spec(cfg)
    tokens = torch.empty((cell.global_batch, cell.seq_len), dtype=torch.int32,
                         device="meta")
    positions = M._positions(tokens)
    x = M._embed_input(params, cfg, tokens, None, positions)

    def mix(kind, bp, _, h):
        if kind == "mamba":
            return M.ssm.ssm_apply(bp["ssm"], M.ssm_cfg_for(cfg), h, "torch")
        return M.attn.attend_full(bp["attn"], M.attn_cfg_for(cfg, kind), h,
                                  positions, "torch")
    with torch.no_grad(), _GroupFlops() as mode:
        M._run_blocks(params, cfg, x, mix, "einsum")
    return mode.all, mode.batched, mode.last_dot * M.num_groups(cfg)


def _smoke(arch, **kw):
    return dataclasses.replace(C.smoke_config(arch), vocab_size=512, **kw)


def test_dryrun_counts_exactly_the_recompute():
    """gemma2-2b (two groups): "dots" recomputes no matmul, "full" the
    groups' whole forward, "dots_nobatch" the batched matmuls (scores and
    PV)."""
    cfg = _smoke("gemma2-2b", num_layers=4)
    cell = C.ShapeCell("smoke_train", 32, 4, "train")
    flops = {p: D.tally_cell("gemma2-2b", cell, cfg, remat=p).flops
             for p in remat.POLICIES}
    fwd, batched, _ = _groups_forward_flops(cfg, cell)
    assert batched > 0
    assert flops["dots"] == flops["none"]
    assert flops["full"] == flops["none"] + fwd
    assert flops["dots_nobatch"] == flops["none"] + batched


def test_full_recompute_stops_after_the_last_saved_tensor():
    """qwen1.5-4b's group ends in the MLP's down projection, whose output
    nothing saves for the backward: the recompute stops before it
    (``torch.utils.checkpoint``'s early stop; XLA drops the same dead
    recompute), so "full" adds the groups' forward less that matmul."""
    cfg = _smoke("qwen1.5-4b")
    cell = C.ShapeCell("smoke_train", 32, 4, "train")
    none = D.tally_cell("qwen1.5-4b", cell, cfg, remat="none").flops
    full = D.tally_cell("qwen1.5-4b", cell, cfg, remat="full").flops
    fwd, _, last = _groups_forward_flops(cfg, cell)
    d_ff, d = cfg.d_ff, cfg.d_model
    assert last == M.num_groups(cfg) * 2 * 4 * 32 * d_ff * d
    assert full == none + fwd - last


def test_live_bytes_tally_is_exact_on_a_toy_step():
    """Allocations rounded up to 512-byte blocks; views and in-place ops
    allocate nothing; a storage counts until its last tensor dies."""
    def step(x):
        a = x * 2                        # 4000 B -> 4096
        b = a.view(10, 100)              # a view: nothing
        b.add_(1)                        # in place: nothing
        c = torch.empty(100, device=x.device)  # 400 B -> 512
        del a                            # b keeps a's storage
        d = b.sum(0)                     # 400 -> 512: 5120 alive
        del b, c                         # 512 alive
        e = torch.ones(2000, device=x.device)  # 8000 -> 8192: 8704 alive
        del e                            # 512 alive
        return d, x
    for device in ("meta", "cpu"):
        x = torch.ones(1000, device=device)
        t = D.count(step, x)
        assert t.peak_bytes == 512 + 8192, device
        assert t.output_bytes == 512, device      # d; x is an argument
    with D.LocalTally() as lt:
        y = torch.ones(1000, device="meta")
        assert lt.live == lt.peak == 4096
        del y
        assert lt.live == 0 and lt.peak == 4096


def test_train_cells_keep_less_in_order(monkeypatch):
    """The dry-run's temporaries of a train cell (gemma2-2b smoke at 8
    layers) follow the policies' order, "remat" is in every result, and
    ``over_hbm`` reads the arguments plus the peak."""
    cfg = _smoke("gemma2-2b", num_layers=8)
    cell = C.ShapeCell("smoke_train", 128, 2, "train")
    mesh = MeshShape(("data", "model"), (1, 1))
    res = {p: D.count_cell("gemma2-2b", cell, mesh, cfg=cfg, remat=p,
                           verbose=False) for p in remat.POLICIES}
    temp = {p: r["memory"]["temp_bytes"] for p, r in res.items()}
    assert temp["none"] > temp["dots"] > temp["dots_nobatch"] > \
        temp["full"] > 0, temp
    for p, r in res.items():
        assert r["remat"] == p
        assert r["memory"]["output_bytes"] > 0
        assert D.peak_bytes(r) == temp[p] + r["memory"]["output_bytes"]
        assert not r["over_hbm"]
    assert "code_bytes" not in res["none"]["memory"]
    cfg, cell = _smoke("gemma2-2b"), C.ShapeCell("smoke_train", 32, 4,
                                                 "train")
    r = D.count_cell("gemma2-2b", cell, mesh, cfg=cfg, verbose=False)
    arg, peak = r["memory"]["argument_bytes"], D.peak_bytes(r)
    outcomes = set()
    # the last card holds the arguments exactly, not the step's peak
    for hbm in (arg + 2 * peak, arg + peak // 2, arg):
        monkeypatch.setattr(D, "HBM_BYTES", hbm)
        r = D.count_cell("gemma2-2b", cell, mesh, cfg=cfg, verbose=False)
        assert r["over_hbm"] is (r["memory"]["argument_bytes"]
                                 + D.peak_bytes(r) > hbm)
        outcomes.add(r["over_hbm"])
    assert r["over_hbm"] and outcomes == {False, True}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_cells_run_without_remat(kind):
    cfg = _smoke("gemma2-2b")
    cell = C.ShapeCell(f"smoke_{kind}", 32, 4, kind)
    res = D.count_cell("gemma2-2b", cell, MeshShape(("data", "model"),
                                                    (1, 1)),
                       cfg=cfg, remat="full", verbose=False)
    assert res["remat"] == "none"
    # the logits are the output: [B, S or 1, V] float32
    rows = 32 if kind == "prefill" else 1
    assert res["memory"]["output_bytes"] == D._alloc_bytes(
        4 * rows * cfg.vocab_size * 4)
    assert res["memory"]["temp_bytes"] > 0
