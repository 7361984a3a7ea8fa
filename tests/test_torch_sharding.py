"""The port's sharding layer against the JAX package's: logical axes, rule
tables and specs equal, live, on the same inputs; placements on a
``DeviceMesh``; the train step on a one-device mesh bit for bit equal to the
mesh-less step; a restore onto a mesh; and one float32 train step sharded
over two gloo processes on the CPU against the single-process step (3e-5).

Axes, rules, specs, shapes and dtypes compare exactly. Every test that
needs a process group makes a one-rank gloo group over a ``HashStore`` and
destroys it again, so nothing is left to the next test.
"""
import contextlib
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro.models import model as JM
from repro.training import optim as JO
from repro.training import train as JT
from repro.distributed.compression import CompressionConfig as JComp
from repro_torch import configs as tconfigs
from repro_torch.distributed import CheckpointManager, CompressionConfig
from repro_torch.distributed import sharding as tshd
from repro_torch.distributed.elastic import remesh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as TM
from repro_torch.training import optim as TO
from repro_torch.training import train as TT

import _torch_mesh_worker as W

ARCHS = list(tconfigs.ARCH_IDS)
#: (1, 1), the production meshes, and the degraded shapes of
#: test_sharding.py's test_best_mesh_shape_degraded_counts
MESH_SHAPES = [(1, 1), (16, 16), (2, 16, 16), (2, 4), (3, 2), (7, 1),
               (3, 4), (5, 1), (6, 16), (3, 3), (10, 1)]
SHARDED_TOL = 3e-5


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


class _JaxMesh:
    """The reference's rule functions read only these two attributes."""

    def __init__(self, shape):
        self.axis_names = _names(shape)
        self.devices = np.empty(shape)


def _both(arch):
    return jconfigs.get_config(arch), tconfigs.get_config(arch)


@contextlib.contextmanager
def _one_rank():
    """A one-rank gloo process group, destroyed on exit."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh11():
    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))


# ---------------------------------------------------------------------------
# logical axes: equal to the reference's trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_axes_equal_the_reference(arch):
    jcfg, tcfg = _both(arch)
    assert TM.param_axes(tcfg) == JM.param_axes(jcfg)
    assert TM.cache_axes(tcfg) == JM.cache_axes(jcfg)
    assert TO.state_axes(TM.param_axes(tcfg)) == \
        JO.state_axes(JM.param_axes(jcfg))


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_axes_equal_the_reference(arch, compress):
    jcfg, tcfg = _both(arch)
    jt = JT.TrainConfig(compression=JComp() if compress else None)
    tt = TT.TrainConfig(compression=CompressionConfig() if compress else None)
    assert TT.train_state_axes(tcfg, tt) == JT.train_state_axes(jcfg, jt)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_cover_params(arch):
    """Every param leaf of init_params at smoke width has an axes tuple of
    matching rank, and param_spec the shapes of init_params."""
    cfg = tconfigs.smoke_config(arch)
    params = _flat(TM.init_params(torch.Generator().manual_seed(0), cfg,
                                  "cpu"))
    axes = _flat(TM.param_axes(cfg))
    assert params.keys() == axes.keys()
    for k, p in params.items():
        assert len(axes[k]) == p.ndim, (arch, k)
    spec = _flat(TM.param_spec(cfg))
    assert {k: (tuple(v.shape), v.dtype) for k, v in spec.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
    assert all(v.is_meta for v in spec.values())


# ---------------------------------------------------------------------------
# rule tables and specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_equal_the_reference(arch):
    """rules_for_mesh and rules_for (without a cell and for every cell)
    are equal for every mesh shape."""
    jcfg, tcfg = _both(arch)
    for shape in MESH_SHAPES:
        jm, tm = _JaxMesh(shape), tmesh.MeshShape(_names(shape), shape)
        assert tmesh.rules_for_mesh(tm) == jmesh.rules_for_mesh(jm), shape
        assert tmesh.rules_for(tcfg, tm) == jmesh.rules_for(jcfg, jm), shape
        for name in tconfigs.SHAPES:
            assert tmesh.rules_for(tcfg, tm, tconfigs.SHAPES[name]) == \
                jmesh.rules_for(jcfg, jm, jconfigs.SHAPES[name]), (shape,
                                                                  name)


def test_rules_for_mesh_drops_missing_axes():
    rules = tmesh.rules_for_mesh(tmesh.MeshShape(("data", "model"), (1, 1)))
    assert rules["batch"] == "data" and rules["fsdp"] == "data"


def test_adapt_rules_degrades_indivisible_dims():
    rules = {"heads": "model", "kv_heads": "model"}
    out = tshd.adapt_rules_for(rules, tmesh.MeshShape(("data", "model"),
                                                      (2, 16)),
                               {"heads": 8, "kv_heads": 1})
    assert out["heads"] is None and out["kv_heads"] is None
    out = tshd.adapt_rules_for(rules, tmesh.MeshShape(("data", "model"),
                                                      (1, 1)),
                               {"heads": 8, "kv_heads": 1})
    assert out == rules


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-moe-235b-a22b",
                                  "zamba2-2.7b", "gemma-2b"])
def test_tree_specs_equal_the_reference_partition_specs(arch):
    jcfg, tcfg = _both(arch)
    for shape in [(16, 16), (2, 16, 16)]:
        jm, tm = _JaxMesh(shape), tmesh.MeshShape(_names(shape), shape)
        for name in tconfigs.SHAPES:
            jr = jmesh.rules_for(jcfg, jm, jconfigs.SHAPES[name])
            tr = tmesh.rules_for(tcfg, tm, tconfigs.SHAPES[name])
            for jt, tt in ((JM.param_axes(jcfg), TM.param_axes(tcfg)),
                           (JM.cache_axes(jcfg), TM.cache_axes(tcfg))):
                js, ts = _flat(jshd.tree_specs(jt, jr)), _flat(
                    tshd.tree_specs(tt, tr))
                assert js.keys() == ts.keys()
                for k in js:
                    assert isinstance(ts[k], tuple) and \
                        tuple(js[k]) == ts[k], (shape, name, k)


def test_spec_for_matches_the_partition_spec():
    rules = {"batch": ("pod", "data"), "heads": "model"}
    lg = ("batch", None, "heads", "embed")
    assert tshd.spec_for(lg, rules) == tuple(jshd.spec_for(lg, rules))
    assert tshd.spec_for(lg) == tuple(jshd.spec_for(lg))


def test_placements_for():
    m = tmesh.MeshShape(("pod", "data", "model"), (2, 4, 8))
    assert tshd.placements_for(m, (("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert tshd.placements_for(m, (None, "data")) == [
        Replicate(), Shard(1), Replicate()]
    assert tshd.placements_for(m, ()) == [Replicate()] * 3
    # a mesh axis of size 1 holds the dimension whole: Replicate
    m1 = tmesh.MeshShape(("data", "model"), (1, 2))
    assert tshd.placements_for(m1, ("data", "model")) == [Replicate(),
                                                           Shard(1)]
    with pytest.raises(ValueError, match="pod"):
        tshd.placements_for(m1, (("pod", "data"),))
    with pytest.raises(ValueError, match="twice"):
        tshd.placements_for(m1, ("model", "model"))


def test_constrain_outside_a_mesh_is_the_identity():
    x = torch.ones(4, 4)
    assert tshd.constrain(x, ("batch", "heads")) is x
    assert tshd.constrain(x, (None, None), {}) is x


def test_constrain_redistributes_a_dtensor():
    with _one_rank():
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                               "model"))
        x = DTensor.from_local(torch.arange(8.0).reshape(2, 4), mesh,
                               [Replicate(), Replicate()])
        y = tshd.constrain(x, ("batch", "heads"),
                           {"batch": "data", "heads": "model"})
        assert isinstance(y, DTensor)
        assert list(y.placements) == [Replicate(), Replicate()]
        assert torch.equal(y.full_tensor(), x.full_tensor())


def test_placement_helpers():
    """On plain tensors every helper is the identity; on a DTensor they
    join the mesh, replicate, and run an op on the whole tensor or on each
    shard with its gradient flowing back."""
    from repro_torch.placement import (on_mesh_of, on_whole, per_shard,
                                       replicated, whole)
    x = torch.arange(6.0).reshape(2, 3)
    assert on_mesh_of(x, x) is x and replicated(x) is x and whole(x, 0) is x
    assert torch.equal(on_whole(torch.cumsum, x, 1), x.cumsum(1))
    assert torch.equal(per_shard(lambda t: t.cumsum(1), (x, {"row": 0}),
                                 out={"row": 0}), x.cumsum(1))
    with _one_rank():
        mesh = _mesh11()
        d = DTensor.from_local(x.clone().requires_grad_(), mesh,
                               [Replicate(), Replicate()])
        m = on_mesh_of(d, torch.ones(3))
        assert isinstance(m, DTensor) and on_mesh_of(d, m) is m
        y = on_whole(lambda t: t.cumsum(1), d)
        assert isinstance(y, DTensor) and torch.equal(y.full_tensor(),
                                                      x.cumsum(1))
        (g,) = torch.autograd.grad(y.sum(), d)
        assert torch.equal(g.full_tensor(),
                           torch.tensor([[3.0, 2.0, 1.0]] * 2))
        y, i = per_shard(lambda t: torch.topk(t, 2, dim=-1), (d, {"row": 0}),
                         out=({"row": 0}, {"row": 0}))
        assert isinstance(y, DTensor) and torch.equal(
            i.full_tensor(), torch.tensor([[2, 1]] * 2))
        (g,) = torch.autograd.grad(y.sum(), d)
        assert torch.equal(g.full_tensor(),
                           torch.tensor([[0.0, 1.0, 1.0]] * 2))
        assert whole(d, -1) is d


def test_make_production_mesh_is_a_shape():
    assert tmesh.make_production_mesh() == tmesh.MeshShape(
        ("data", "model"), (16, 16))
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert multi == tmesh.MeshShape(("pod", "data", "model"), (2, 16, 16))


# ---------------------------------------------------------------------------
# meta specs: shapes and dtypes equal the reference's ShapeDtypeStructs
# ---------------------------------------------------------------------------


def _shape_dtype(tree):
    return {k: (tuple(v.shape), np.dtype(v.dtype).name if not
                isinstance(v, torch.Tensor) else str(v.dtype)[6:])
            for k, v in _flat(tree).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_equals_the_reference(arch):
    jcfg, tcfg = _both(arch)
    t = TM.cache_spec(tcfg, 2, 64)
    assert all(v.is_meta for v in _flat(t).values())
    assert _shape_dtype(t) == _shape_dtype(JM.cache_spec(jcfg, 2, 64))


# ---------------------------------------------------------------------------
# the mesh: remesh, a one-device mesh bit for bit, a restore onto a mesh
# ---------------------------------------------------------------------------


def test_remesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        remesh()
    with _one_rank():
        mesh = remesh(model_parallel=2)       # one rank: a 1x1 mesh
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"


def _trainer(cfg, mesh=None, rules=None, ckpt=None, data=None):
    from repro_torch.data import SyntheticLMData
    data = data or iter(SyntheticLMData(vocab_size=cfg.vocab_size,
                                        seq_len=16, global_batch=4, seed=1))
    return TT.Trainer(cfg=cfg, tcfg=W.tcfg(), data=data, ckpt_dir=ckpt,
                      ckpt_every=2, mesh=mesh, rules=rules, log_every=1000,
                      device="cpu")


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m",
                                  "qwen3-moe-235b-a22b", "zamba2-2.7b"])
def test_one_device_mesh_step_equals_the_meshless_step(arch):
    """On a (1, 1) mesh DTensor runs the mesh-less step's ops on whole
    tensors: metrics and state equal bit for bit over three steps."""
    cfg = W.smoke(arch)
    with _one_rank():
        mesh = _mesh11()
        runs = []
        for m in (None, mesh):
            t = _trainer(cfg, m, tmesh.rules_for(cfg, mesh) if m else None)
            t.init_or_resume(resume="never")
            runs.append((t.run(3), tshd.full_tree(t.state)))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(TM.tree_leaves(runs[0][1]), TM.tree_leaves(runs[1][1])):
        assert torch.equal(a, b)


def test_restore_onto_a_mesh_resumes_exactly(tmp_path):
    """A checkpoint written without a mesh, restored onto one through
    restore(mesh=..., placements=...) and resumed, gives the uninterrupted
    run's trajectory and final state bit for bit; the mesh run's own
    checkpoints are gathered to their global shapes."""
    cfg = W.smoke("mamba2-130m")
    ref = _trainer(cfg)
    ref.init_or_resume(resume="never")
    want = ref.run(4)
    first = _trainer(cfg, ckpt=str(tmp_path))
    first.init_or_resume(resume="never")
    first.run(2)
    with _one_rank():
        mesh = _mesh11()
        rules = tmesh.rules_for(cfg, mesh)
        placements = tshd.tree_placements(
            mesh, TT.train_state_axes(cfg, W.tcfg()), rules)
        step, state, _ = CheckpointManager(str(tmp_path)).restore(
            mesh=mesh, placements=placements)
        assert step == 2 and all(isinstance(x, DTensor)
                                 for x in TM.tree_leaves(state))
        from repro_torch.data import SyntheticLMData
        data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=16,
                               global_batch=4, seed=1)
        resumed = _trainer(cfg, mesh, rules, ckpt=str(tmp_path),
                           data=iter(data.batch(s) for s in range(2, 4)))
        resumed.init_or_resume(resume="must")
        assert resumed.step == 2
        got = resumed.run(4)
        final = tshd.full_tree(resumed.state)
    assert got == want[2:]
    for a, b in zip(TM.tree_leaves(final), TM.tree_leaves(ref.state)):
        assert torch.equal(a, b)
    step, saved, _ = CheckpointManager(str(tmp_path)).restore(device="cpu")
    assert step == 4
    for a, b in zip(TM.tree_leaves(saved), TM.tree_leaves(ref.state)):
        assert not isinstance(a, DTensor) and torch.equal(a, b)


@pytest.mark.parametrize("name", ["flash_attention", "ssd",
                                  "decode_attention", "gmm"])
def test_kernel_bindings_refuse_a_dtensor(name):
    import importlib
    from repro_torch.kernels.build import DTensorInputError
    binding = getattr(importlib.import_module(f"repro_torch.kernels.{name}"),
                      name)
    from test_torch_training import _kernel_inputs
    args, kw = _kernel_inputs(name)
    with _one_rank():
        mesh = _mesh11()
        first = DTensor.from_local(args[0], mesh, [Replicate(), Replicate()])
        with pytest.raises(DTensorInputError, match=name):
            binding(first, *args[1:], **kw)


# ---------------------------------------------------------------------------
# two gloo processes: a sharded float32 step against the unsharded one
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sharded_runs():
    """Both ranks of tests/_torch_mesh_worker.py, killed after 120 s: rank
    0's results, and each rank's counts (rank 1's under "rank1/")."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "tests", "_torch_mesh_worker.py")
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.npz")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK"))}
        procs = [subprocess.Popen(
            [sys.executable, script, str(r), os.path.join(d, "store"), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in (0, 1)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=120)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert [p.returncode for p in procs] == [0, 0], logs
        runs = {}
        for path, prefix in ((out, ""), (W.rank1_path(out), "rank1/")):
            with np.load(path) as z:
                runs.update({prefix + k: z[k] for k in z.files})
        return runs


@pytest.mark.parametrize("mesh", W.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", W.ARCHS)
def test_sharded_step_equals_the_unsharded_step(sharded_runs, arch, mesh):
    cfg = W.smoke(arch)
    state = W.mid_run_state(cfg)
    loss = W.step(cfg, state, W.batch())
    tag = f"{arch}@{mesh[0]}x{mesh[1]}"
    np.testing.assert_allclose(sharded_runs[f"{tag}/loss"], loss.numpy(),
                               rtol=0, atol=SHARDED_TOL)
    want = TM.tree_leaves(state["params"])
    for i, p in enumerate(want):
        np.testing.assert_allclose(sharded_runs[f"{tag}/p{i}"], p.numpy(),
                                   rtol=0, atol=SHARDED_TOL,
                                   err_msg=f"{tag} param {i}")


@pytest.mark.parametrize("mesh", W.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", W.ARCHS)
def test_sharded_checkpoint_restores_onto_the_other_mesh(sharded_runs, arch,
                                                         mesh):
    """The sharded state, saved (rank 0 gathering shards to its host) and
    restored onto the transposed mesh (each rank reading its own shard),
    gathers to the params it was saved from, bit for bit."""
    tag = f"{arch}@{mesh[0]}x{mesh[1]}"
    n = len(TM.tree_leaves(W.mid_run_state(W.smoke(arch))["params"]))
    for i in range(n):
        np.testing.assert_array_equal(sharded_runs[f"{tag}/r{i}"],
                                      sharded_runs[f"{tag}/p{i}"],
                                      err_msg=f"{tag} param {i}")


@pytest.mark.parametrize("mesh", W.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", W.ARCHS)
def test_sharded_compression_equals_the_unsharded(sharded_runs, arch, mesh):
    """int8 compression of sharded gradients, each rank quantising its own
    shard where the shard is whole blocks, equals the unsharded compression
    bit for bit; at block 8 some leaves take the shard path and at 256 some
    the whole-gradient one."""
    from repro_torch.distributed.compression import (CompressionConfig,
                                                     compress_with_feedback)
    tag = f"{arch}@{mesh[0]}x{mesh[1]}"
    n = len(TM.tree_leaves(W.grads_and_err(W.smoke(arch))[0]))
    assert 0 < sharded_runs[f"{tag}/b8/local"] <= n
    assert sharded_runs[f"{tag}/b256/local"] < n
    for block in W.BLOCKS:
        # fresh residuals each block, as the worker draws them: the call
        # writes the new error into ``err`` in place
        grads, err = W.grads_and_err(W.smoke(arch))
        q, e = compress_with_feedback(grads, err,
                                      CompressionConfig(block=block))
        for i, (a, c) in enumerate(zip(TM.tree_leaves(q),
                                       TM.tree_leaves(e))):
            np.testing.assert_array_equal(
                sharded_runs[f"{tag}/b{block}/q{i}"], a.numpy(),
                err_msg=f"{tag} block {block} leaf {i}")
            np.testing.assert_array_equal(
                sharded_runs[f"{tag}/b{block}/e{i}"], c.numpy(),
                err_msg=f"{tag} block {block} leaf {i}")


@pytest.mark.parametrize("mesh", W.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", W.ARCHS)
def test_fake_group_count_equals_a_real_rank(sharded_runs, arch, mesh):
    """The dry-run's count of the step as rank 0 of a fake group (a
    ``"cpu"`` mesh, whose all-to-all DTensor runs as gloo's all-gather)
    equals what each real gloo rank's step moved, family by family, and
    rank 0's FLOPs."""
    from repro_torch.launch import dryrun as D
    cfg = W.smoke(arch)
    with D.fake_mesh(tmesh.MeshShape(("data", "model"), mesh), "cpu") as m:
        fake = D.mesh_tally(cfg, W.train_cell(), m, tmesh.rules_for(cfg, m))
    tag = f"{arch}@{mesh[0]}x{mesh[1]}"
    assert fake.flops == sharded_runs[f"{tag}/flops"]
    for fam in D.FAMILIES:
        for rank in ("", "rank1/"):
            assert fake.collectives.get(fam, 0) == \
                sharded_runs[f"{rank}{tag}/coll/{fam}"], (fam, rank)
    assert sum(fake.collectives.values()) > 0


@pytest.mark.parametrize("mesh", W.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_decode_equals_the_unsharded(sharded_runs, mesh):
    """gemma-2b (one kv head) decodes one token on the mesh, its cache
    sequence-sharded over ``model`` on (1, 2) (each rank writing the rows
    whose position falls in its half) and batch-sharded on (2, 1): logits
    and every cache leaf equal the unsharded step's."""
    cfg = W.smoke(W.DECODE_ARCH)
    rules = tmesh.rules_for(cfg, tmesh.MeshShape(("data", "model"), mesh),
                            W.decode_cell())
    assert rules["kv_seq"] == ("model" if mesh[1] > 1 else None)
    params, cache, tokens, pos = W.decode_inputs(cfg)
    logits = W.decode(cfg, params, cache, tokens, pos)
    tag = f"{W.DECODE_ARCH}@{mesh[0]}x{mesh[1]}/decode"
    np.testing.assert_allclose(sharded_runs[f"{tag}/logits"], logits.numpy(),
                               rtol=0, atol=SHARDED_TOL)
    for i, c in enumerate(TM.tree_leaves(cache)):
        np.testing.assert_allclose(sharded_runs[f"{tag}/c{i}"], c.numpy(),
                                   rtol=0, atol=SHARDED_TOL,
                                   err_msg=f"{tag} cache leaf {i}")
