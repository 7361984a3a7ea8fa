"""The port's launch layer against the JAX package's: the shape cells, the
dry-run's input specs and model FLOPs (equal to a relative 1e-12 for all 33
cells), the meta-device count of one smoke cell of each kind (rank 0's own
count on a fake (2, 2) mesh with its collective term; the global FLOPs
equal to FlopCounterMode's count of the real step on the CPU), the op
profile, and the training launcher's --model-parallel at world size 1."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.launch import mesh as jmesh
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import dryrun as D
from repro_torch.launch import inspect_ops
from repro_torch.launch.mesh import MeshShape, make_production_mesh

# importing the reference's dry-run sets XLA_FLAGS for 512 host devices,
# which only its own process wants: put the flag back as it was
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as JD  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a in tconfigs.ARCH_IDS for s in tconfigs.SHAPES
         if tconfigs.cell_applicable(tconfigs.get_config(a), s)]
_JSPEC: dict = {}


def _jax_pspec(arch):
    if arch not in _JSPEC:
        _JSPEC[arch] = JD.params_spec(jconfigs.get_config(arch))
    return _JSPEC[arch]


def _sd(x):
    """(shape, dtype name) of a ShapeDtypeStruct or a tensor."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype)[len("torch."):]
    return tuple(x.shape), np.dtype(x.dtype).name


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def test_cell_applicability_matrix():
    """7 long_500k skips (pure full-attention), 33 runnable cells, as the
    reference counts them."""
    assert len(CELLS) == 33
    for a in tconfigs.ARCH_IDS:
        for s in tconfigs.SHAPES:
            assert tconfigs.cell_applicable(tconfigs.get_config(a), s) == \
                jconfigs.cell_applicable(jconfigs.get_config(a), s)


@pytest.mark.parametrize("shape", list(tconfigs.SHAPES))
def test_shape_cells_equal_the_reference(shape):
    assert dataclasses.asdict(tconfigs.SHAPES[shape]) == \
        dataclasses.asdict(jconfigs.SHAPES[shape])


def test_batch_spec_equals_the_reference():
    t, j = tpipe.batch_spec(8, 128), jpipe.batch_spec(8, 128)
    assert {k: _sd(v) for k, v in t.items()} == \
        {k: _sd(v) for k, v in j.items()}
    assert all(v.is_meta for v in t.values())


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_model_flops_equal_the_reference(arch, shape):
    ts = _flat(D.input_specs(arch, shape))
    js = _flat(JD.input_specs(arch, shape))
    assert {k: _sd(v) for k, v in ts.items()} == \
        {k: _sd(v) for k, v in js.items()}
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    got = D.model_flops(tcfg, tconfigs.SHAPES[shape], D.params_spec(tcfg))
    want = JD.model_flops(jcfg, jconfigs.SHAPES[shape], _jax_pspec(arch))
    assert got == pytest.approx(want, rel=1e-12)


def test_rules_for_mesh_single_vs_multipod():
    rs = jmesh.rules_for_mesh  # the reference, on its own mesh stand-ins

    class Single:
        axis_names = ("data", "model")
        devices = np.empty((16, 16))

    class Multi:
        axis_names = ("pod", "data", "model")
        devices = np.empty((2, 16, 16))

    from repro_torch.launch.mesh import rules_for_mesh
    single = rules_for_mesh(make_production_mesh())
    multi = rules_for_mesh(make_production_mesh(multi_pod=True))
    assert single == rs(Single()) and multi == rs(Multi())
    assert single["batch"] == "data" and multi["fsdp"] == ("pod", "data")


# ---------------------------------------------------------------------------
# count_cell on meta: one smoke cell of each kind
# ---------------------------------------------------------------------------


def _smoke(arch):
    return dataclasses.replace(tconfigs.smoke_config(arch), vocab_size=512)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m",
                                  "qwen3-moe-235b-a22b"])
def test_count_cell_on_meta(arch, kind):
    cfg = _smoke(arch)
    cell = tconfigs.ShapeCell(f"smoke_{kind}", 32, 4, kind)
    mesh = MeshShape(("data", "model"), (2, 2))
    res = D.count_cell(arch, cell, mesh, cfg=cfg, verbose=False)
    assert res["flops"] > 0 and res["bytes"] > 0
    # rank 0's own count of the partitioned step, not an even split
    assert 0 < res["flops_per_dev"] < res["flops"]
    assert res["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert res["terms_s"]["compute_s"] == res["flops_per_dev"] / D.PEAK_FLOPS
    coll = res["collective_bytes_per_dev"]["total"]
    assert coll > 0 and res["terms_s"]["collective_s"] == coll / D.LINK_BW
    assert not res["over_hbm"]
    # a (1, 1) mesh holds every input whole
    whole = D.count_cell(arch, cell, MeshShape(("data", "model"), (1, 1)),
                         cfg=cfg, verbose=False)
    inputs, _ = D._cell_inputs(cfg, cell)
    total = sum(t.numel() * t.element_size()
                for t in _flat(inputs).values())
    assert whole["memory"]["argument_bytes"] == total
    assert res["memory"]["argument_bytes"] < total


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m",
                                  "qwen3-moe-235b-a22b"])
def test_counted_flops_equal_the_real_step(arch):
    """The meta count of a train cell equals FlopCounterMode's count of
    the same step on real CPU tensors (under the dry-run's default remat,
    "dots", whose recompute of mamba2's depthwise conv counts), and the
    state bytes the state's."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import model as M
    from repro_torch.training import OptimConfig, TrainConfig, Trainer
    cfg = _smoke(arch)
    cell = tconfigs.ShapeCell("smoke_train", 32, 4, "train")
    res = D.count_cell(arch, cell, MeshShape(("data", "model"), (1, 1)),
                       cfg=cfg, verbose=False)
    assert res["remat"] == "dots"
    cfg = dataclasses.replace(cfg, remat=res["remat"])
    t = Trainer(cfg=cfg, tcfg=TrainConfig(optim=OptimConfig()),
                data=iter(SyntheticLMData(vocab_size=512, seq_len=32,
                                          global_batch=4)),
                log_every=100, device="cpu")
    t.init_or_resume(resume="never")
    with FlopCounterMode(display=False) as fc:
        t.run(1)
    assert res["flops"] == fc.get_total_flops()
    assert res["memory"]["state_bytes"] == sum(
        x.nbytes for x in M.tree_leaves(t.state))


def test_inspect_ops_groups_bytes(capsys):
    cfg = _smoke("gemma2-2b")
    tally = D.tally_cell("gemma2-2b",
                         tconfigs.ShapeCell("t", 32, 4, "train"), cfg)
    assert sum(tally.by_op.values()) == tally.bytes
    inspect_ops.analyze(tally, n_dev=4, top=3)
    out = capsys.readouterr().out
    assert "top ops by bytes touched" in out and "mm" in out


def test_dryrun_main_writes_one_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-130m", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "1/1 cells counted OK" in out.stdout
    res = json.loads((tmp_path / "single__mamba2-130m__decode_32k.json")
                     .read_text())
    assert res["status"] == "ok" and res["mesh"] == "16x16"
    assert res["n_devices"] == 256 and res["kind"] == "decode"


def test_train_launcher_model_parallel_at_world_size_one(tmp_path):
    """--model-parallel 2 on one rank runs without a mesh, as the
    reference's launcher does on one device."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma2-2b", "--smoke", "--steps", "2", "--batch", "2", "--seq",
         "16", "--model-parallel", "2", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[train] done: step=2" in out.stdout
