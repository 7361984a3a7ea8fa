"""The mesh train step as a CUDA graph: ``graphs.GraphedTrainStep`` on a
state of DTensors, as ``Trainer(mesh=...)`` runs its step on the card (the
counterpart of ``jax.jit(train_step)`` on a mesh).

On the CPU, under a one-rank gloo group over a ``HashStore``:

* the step on a batch rebuilt from its local shards with
  ``DTensor.from_local`` (as the graph's static batch is rebuilt inside the
  capture) equals the step on the ``distribute_tensor`` batch bit for bit,
  with the state placed by ``rules_for`` and placed ``Shard`` by hand;
* the graph's key of a DTensor state holds its local shards' ``data_ptr``s;
* a DTensor state on the CPU runs the eager step and captures nothing.

On the card (marked ``cuda``, skipped with "no CUDA" without one), under a
one-rank NCCL group over a ``HashStore``: the graphed mesh step equals the
eager mesh step bit for bit over four steps (two warm-up steps, a capture,
a replay) and a restored state captures again; a state placed ``Shard`` by
hand on the size-1 "model" axis graphs too; a captured NCCL ``all_reduce``
replays on new data.

The file imports neither JAX nor the JAX package, so the card tests run
without them:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_mesh_graph.py
"""
import contextlib
import dataclasses
import os

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

# cuBLAS is deterministic only with a fixed workspace, set before its first
# use: the graphed mesh step is held bit for bit to the eager one
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from repro_torch import graphs
from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.distributed import CheckpointManager, CompressionConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import rules_for
from repro_torch.models import model as M
from repro_torch.training import (OptimConfig, TrainConfig, build_train_step,
                                  init_train_state)
from repro_torch.training.train import Trainer, train_state_axes

#: the MoE smoke arch: its step runs the einsum dispatch's combine too
ARCH = "qwen3-moe-235b-a22b"
STEPS = 4


def _cfgs(arch=ARCH):
    cfg = dataclasses.replace(smoke_config(arch), vocab_size=128,
                              dtype="float32")
    return cfg, TrainConfig(optim=OptimConfig(learning_rate=1e-2,
                                              warmup_steps=2,
                                              total_steps=20),
                            accum=2, compression=CompressionConfig())


@contextlib.contextmanager
def _one_rank(device_type):
    """A (1, 1) ("data", "model") mesh on a one-rank process group (gloo on
    the CPU, NCCL on the card) over a ``HashStore``, destroyed on exit."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh(device_type, (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _by_hand(tree):
    """Every leaf of two dimensions or more ``Shard`` along its last on
    "model" (the others replicated), bypassing ``placements_for``, which
    places a size-1 axis ``Replicate()``."""
    if isinstance(tree, dict):
        return {k: _by_hand(v) for k, v in tree.items()}
    return [Replicate(),
            Shard(tree.ndim - 1) if tree.ndim >= 2 else Replicate()]


def _state(cfg, tcfg, mesh, hand=False, seed=0):
    device = mesh.device_type
    state = init_train_state(torch.Generator(device=device).manual_seed(seed),
                             cfg, tcfg, device)
    where = (_by_hand(state) if hand else shd.tree_placements(
        mesh, train_state_axes(cfg, tcfg), rules_for(cfg, mesh)))
    return shd.distribute_tree(state, mesh, where)


def _batches(cfg, mesh, n, hand=False, seed=3):
    """``n`` batches placed as ``Trainer._put`` places them (by hand:
    ``Shard(0)`` on "data")."""
    where = ([Shard(0), Replicate()] if hand else shd.placements_for(
        mesh, shd.spec_for(("batch", "act_seq"), rules_for(cfg, mesh))))
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=16,
                           global_batch=4, seed=seed)
    return [{k: distribute_tensor(torch.from_numpy(v).to(mesh.device_type),
                                  mesh, where)
             for k, v in data.batch(i).items()} for i in range(n)]


def _floats(metrics):
    return {k: float(v.full_tensor() if isinstance(v, DTensor) else v)
            for k, v in metrics.items()}


def _assert_equal_trees(a, b):
    for x, y in zip(M.tree_leaves(shd.full_tree(a)),
                    M.tree_leaves(shd.full_tree(b))):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hand", [False, True], ids=["rules", "by_hand"])
def test_batch_rebuilt_from_local_shards_steps_like_the_distributed_one(hand):
    """The graph's static batch is the batch DTensors' local shards, made
    DTensors again inside the capture (``graphs._like``): three steps on
    such batches equal the steps on the ``distribute_tensor`` batches bit
    for bit, metrics and state."""
    cfg, tcfg = _cfgs()
    with _one_rank("cpu") as mesh:
        step = build_train_step(cfg, tcfg, rules_for(cfg, mesh))
        states = [_state(cfg, tcfg, mesh, hand) for _ in range(2)]
        for b in _batches(cfg, mesh, 3, hand):
            rebuilt = {k: graphs._like(t.to_local().clone(), t)
                       for k, t in b.items()}
            for k, t in rebuilt.items():
                assert isinstance(t, DTensor)
                assert t.placements == b[k].placements
                assert t.shape == b[k].shape and t.stride() == b[k].stride()
            _, want = step(states[0], b)
            _, got = step(states[1], rebuilt)
            assert _floats(got) == _floats(want)
        _assert_equal_trees(states[1], states[0])


def test_key_of_a_dtensor_state_is_its_local_shards_addresses():
    """A DTensor wraps no storage of its own (its ``data_ptr`` says
    nothing of where its shard lies): the key is built from each leaf's
    local shard, and a restored state, whose shards lie elsewhere, keys
    apart."""
    cfg, tcfg = _cfgs()
    with _one_rank("cpu") as mesh:
        state = _state(cfg, tcfg, mesh)
        leaves = M.tree_leaves(state)
        assert all(isinstance(x, DTensor) for x in leaves)
        ptrs = graphs._ptrs(state)
        assert ptrs == tuple(x.to_local().data_ptr() for x in leaves)
        assert all(ptrs) and len(set(ptrs)) == len(ptrs)
        other = _state(cfg, tcfg, mesh)
        assert not set(graphs._ptrs(other)) & set(ptrs)


def test_cpu_dtensor_state_runs_eagerly_and_captures_nothing():
    """``GraphedTrainStep`` on a DTensor state on the CPU is the eager step:
    four steps equal the eager ones bit for bit, nothing is captured or
    warmed up, and the metrics are the eager step's DTensors; the mesh
    ``Trainer`` on the CPU keeps the plain step."""
    cfg, tcfg = _cfgs()
    with _one_rank("cpu") as mesh:
        rules = rules_for(cfg, mesh)
        eager = build_train_step(cfg, tcfg, rules)
        graphed = graphs.GraphedTrainStep(build_train_step(cfg, tcfg, rules))
        states = [_state(cfg, tcfg, mesh) for _ in range(2)]
        for b in _batches(cfg, mesh, STEPS):
            _, want = eager(states[0], b)
            s, got = graphed(states[1], b)
            assert s is states[1]
            assert all(isinstance(v, DTensor) for v in got.values())
            assert _floats(got) == _floats(want)
        assert graphed.graphs == {} and graphed._warm == {}
        _assert_equal_trees(states[1], states[0])
        t = Trainer(cfg=cfg, tcfg=tcfg, data=iter(()), mesh=mesh,
                    rules=rules, log_every=1000)
        assert t.device.type == "cpu"
        assert not isinstance(t._step_fn, graphs.GraphedTrainStep)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@contextlib.contextmanager
def _deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _graphed_against_eager(cfg, tcfg, mesh, batches, eager_state,
                           graphed_state, step):
    """Each batch through the eager step on ``eager_state`` and ``step`` on
    ``graphed_state``: equal metrics, and the graphed metrics replicated."""
    eager = build_train_step(cfg, tcfg, rules_for(cfg, mesh))
    for b in batches:
        _, want = eager(eager_state, b)
        _, got = step(graphed_state, b)
        for v in got.values():
            assert all(p == Replicate() for p in v.placements)
        assert _floats(got) == _floats(want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [ARCH, "gemma2-2b", "mamba2-130m"])
def test_graphed_mesh_step_equals_the_eager_mesh_step(cuda, arch, tmp_path):
    """On a one-rank NCCL mesh: four steps (two eager warm-up steps, the
    capture's replay, a replay) equal the eager mesh step's bit for bit,
    metrics and every state leaf, with one graph; the state restored from a
    checkpoint onto the mesh (new local shards) captures a second graph and
    goes on equal to the eager run."""
    cfg, tcfg = _cfgs(arch)
    with _one_rank("cuda") as mesh, _deterministic():
        rules = rules_for(cfg, mesh)
        step = graphs.GraphedTrainStep(build_train_step(cfg, tcfg, rules))
        want, state = _state(cfg, tcfg, mesh), _state(cfg, tcfg, mesh)
        batches = _batches(cfg, mesh, STEPS + graphs.WARMUP_CALLS + 1)
        _graphed_against_eager(cfg, tcfg, mesh, batches[:STEPS], want,
                               state, step)
        assert len(step.graphs) == 1
        _assert_equal_trees(state, want)
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(STEPS, state)
        _, restored, _ = mgr.restore(
            device="cuda", mesh=mesh, placements=shd.tree_placements(
                mesh, train_state_axes(cfg, tcfg), rules))
        _graphed_against_eager(cfg, tcfg, mesh, batches[STEPS:], want,
                               restored, step)
        assert len(step.graphs) == 2
        _assert_equal_trees(restored, want)


@pytest.mark.cuda
def test_trainer_on_a_cuda_mesh_replays_a_graph(cuda):
    """``Trainer(mesh=...)`` on the card graphs its step: five steps equal
    the mesh-less ``Trainer``'s bit for bit and launch the AdamW kernel
    once a params leaf a step, the replays through their capture's count."""
    from repro_torch.kernels import adamw as adamw_mod
    cfg, tcfg = _cfgs("qwen1.5-4b")
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=16,
                           global_batch=4, seed=3)
    batches = [data.batch(i) for i in range(5)]
    with _one_rank("cuda") as mesh, _deterministic():
        runs = []
        for m in (None, mesh):
            t = Trainer(cfg=cfg, tcfg=tcfg, data=iter(batches), mesh=m,
                        rules=rules_for(cfg, mesh) if m is not None else None,
                        log_every=1000, device="cuda")
            assert isinstance(t._step_fn, graphs.GraphedTrainStep)
            t.init_or_resume(resume="never")
            before = adamw_mod.launches
            runs.append((t.run(5), shd.full_tree(t.state),
                         adamw_mod.launches - before,
                         len(t._step_fn.graphs)))
    n_leaves = len(M.tree_leaves(runs[0][1]["params"]))
    assert runs[0][2] == runs[1][2] == 5 * n_leaves
    assert runs[0][3] == runs[1][3] == 1
    assert runs[0][0] == runs[1][0]
    _assert_equal_trees(runs[1][1], runs[0][1])


@pytest.mark.cuda
def test_hand_placed_shard_state_graphs_like_its_eager_step(cuda):
    """A state placed ``Shard(0)`` on the size-1 "model" axis by hand (its
    batch ``Shard(0)`` on "data"): the graphed step equals the eager one
    bit for bit over four steps."""
    cfg, tcfg = _cfgs()
    with _one_rank("cuda") as mesh, _deterministic():
        step = graphs.GraphedTrainStep(build_train_step(
            cfg, tcfg, rules_for(cfg, mesh)))
        want = _state(cfg, tcfg, mesh, hand=True)
        state = _state(cfg, tcfg, mesh, hand=True)
        _graphed_against_eager(cfg, tcfg, mesh,
                               _batches(cfg, mesh, STEPS, hand=True), want,
                               state, step)
        assert len(step.graphs) == 1
        _assert_equal_trees(state, want)


@pytest.mark.cuda
def test_captured_nccl_all_reduce_replays_on_new_data(cuda):
    """A one-rank NCCL ``all_reduce`` (AVG: over one rank the data itself),
    made eagerly once (the communicator) and then captured in
    ``capture_error_mode="global"``, as the train step is: each replay on
    new data gives that data back."""
    with _one_rank("cuda") as mesh:
        group = mesh.get_group(0)
        x = torch.zeros(1 << 16, device="cuda")
        dist.all_reduce(x, op=dist.ReduceOp.AVG, group=group)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.graph(g, stream=side, capture_error_mode="global"):
            dist.all_reduce(x, op=dist.ReduceOp.AVG, group=group)
        for seed in range(3):
            new = torch.randn(x.shape, device="cuda",
                              generator=torch.Generator(
                                  device="cuda").manual_seed(seed))
            x.copy_(new)
            g.replay()
            torch.cuda.synchronize()
            assert torch.equal(x, new)
