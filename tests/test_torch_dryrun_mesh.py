"""The dry-run's partitioned count (``repro_torch.launch.dryrun``): each
cell's DTensor step run as rank 0 of a fake process group, at smoke width.

* Every architecture's train step, prefill and decode step on a fake
  (2, 8) mesh. The model axis (8) is wider than the smoke widths' heads
  (4), so ``rules_for`` degrades them, and the step runs through the sites
  that stopped it: the q/k/v projection with heads that do not divide the
  model axis, the in-place cache write into a sequence-sharded cache, the
  SSM's head unflatten in the backward.
* On a (1, 1) mesh nothing moves between ranks, and rank 0's FLOPs are the
  unsharded step's.
* The all-to-all family, which only a ``"cuda"`` mesh shows (on a ``"cpu"``
  mesh DTensor gathers instead).
* Two full-width decode cells through the CLI, with the reference's keys.
* The AdamW update priced as the card runs it: one op a leaf, 28 bytes a
  float32 parameter.
* The MoE einsum dispatch's combine, a partial sum over the expert shards:
  no all-gather of the expert slots, one reduction of the [G, g, D]
  partial sums.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import functools

import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import configs as C
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAKE = MeshShape(("data", "model"), (2, 8))
KINDS = ("train", "prefill", "decode")
#: the keys of the reference's ``lower_cell`` result that the port fills
REF_KEYS = {"arch", "shape", "mesh", "mesh_axes", "n_devices", "kind",
            "flops_per_dev", "bytes_per_dev", "collective_bytes_per_dev",
            "memory", "terms_s", "dominant", "model_flops",
            "useful_flops_ratio"}


def _smoke(arch):
    return dataclasses.replace(C.smoke_config(arch), vocab_size=512)


def _cell(kind):
    return C.ShapeCell(f"smoke_{kind}", 32, 4, kind)


def _check_counts(res, axes):
    coll = res["collective_bytes_per_dev"]
    assert list(coll) == list(D.FAMILIES) + ["total"]
    assert all(math.isfinite(v) and v >= 0 for v in coll.values())
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    assert list(res["collective_bytes_by_axis"]) == list(axes)
    assert sum(res["collective_bytes_by_axis"].values()) == coll["total"]
    terms = res["terms_s"]
    assert set(terms) == {"compute_s", "memory_s", "collective_s"}
    assert terms["collective_s"] == coll["total"] / D.LINK_BW
    assert terms["compute_s"] == res["flops_per_dev"] / D.PEAK_FLOPS
    assert res["dominant"] == max(terms, key=terms.get)
    assert res["useful_flops_ratio"] == res["model_flops"] / (
        res["flops_per_dev"] * res["n_devices"])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", list(C.ARCH_IDS))
def test_sharded_step_runs_on_a_wide_model_axis(arch, kind):
    res = D.count_cell(arch, _cell(kind), FAKE, cfg=_smoke(arch),
                       verbose=False)
    _check_counts(res, FAKE.axis_names)
    assert res["n_devices"] == 16 and res["mesh"] == "2x8"
    assert 0 < res["flops_per_dev"] <= res["flops"]
    assert 0 < res["bytes_per_dev"]
    assert res["collective_bytes_per_dev"]["total"] > 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m",
                                  "qwen3-moe-235b-a22b"])
def test_one_device_mesh_moves_nothing(arch, kind):
    """On a (1, 1) mesh every placement is ``Replicate()``: no collective,
    and rank 0's FLOPs equal the global count of the unsharded step."""
    cfg = _smoke(arch)
    res = D.count_cell(arch, _cell(kind), MeshShape(("data", "model"),
                                                    (1, 1)),
                       cfg=cfg, verbose=False)
    _check_counts(res, ("data", "model"))
    assert res["collective_bytes_per_dev"]["total"] == 0
    assert res["flops_per_dev"] == res["flops"] == \
        D.tally_cell(arch, _cell(kind), cfg).flops


@pytest.mark.parametrize("device_type,family", [("cuda", "all-to-all"),
                                                ("cpu", "all-gather")])
def test_all_to_all_shows_on_a_cuda_mesh(device_type, family):
    """Moving a shard from one tensor dimension to another over the same
    mesh axis is an all-to-all on a ``"cuda"`` mesh (NCCL's); on a
    ``"cpu"`` mesh DTensor runs it as an all-gather and a chunk."""
    with D.fake_mesh(FAKE, device_type) as mesh:
        x = DTensor.from_local(torch.empty(16, 8, device="meta"), mesh,
                               [Replicate(), Shard(0)], run_check=False,
                               shape=(128, 8), stride=(8, 1))
        tally = D.count(lambda: x.redistribute(mesh,
                                               [Replicate(), Shard(1)]))
        model = mesh.get_group(1).group_name
    assert set(tally.collectives) == {family}
    out = 128 * 1 * 4 if family == "all-to-all" else 128 * 8 * 4
    assert tally.collectives[family] == out
    assert tally.by_group == {model: out}


def test_fake_mesh_refuses_a_second_group():
    with D.fake_mesh(FAKE):
        with pytest.raises(RuntimeError, match="default process group"):
            with D.fake_mesh(FAKE):
                pass
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch", ["mamba2-130m", "gemma2-2b"])
def test_cli_counts_a_full_width_decode_cell(arch, tmp_path):
    """mamba2-130m and gemma2-2b (whose sequence-sharded cache stopped the
    step before) at decode_32k on both production meshes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "2/2 cells counted OK" in out.stdout
    for name, shape in (("single", (16, 16)), ("multipod", (2, 16, 16))):
        res = json.loads((tmp_path / f"{name}__{arch}__decode_32k.json")
                         .read_text())
        assert res["status"] == "ok" and REF_KEYS <= set(res)
        assert res["mesh"] == "x".join(map(str, shape))
        assert res["n_devices"] == math.prod(shape)
        axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                           "model")
        _check_counts(res, axes)
        assert 0 < res["flops_per_dev"] < res["flops"]


def test_adamw_is_one_op_a_leaf():
    """The train step's update is one ``adamw`` op a params leaf, reading
    p, g, m and v and writing p, m and v (28 bytes a float32 parameter)
    and its four float32 scalars, globally and on rank 0's shards."""
    arch = "gemma2-2b"
    cfg, cell = _smoke(arch), _cell("train")
    leaves = M.tree_leaves(M.param_spec(cfg))
    tally = D.tally_cell(arch, cell, cfg)
    assert tally.count_op["adamw"] == len(leaves)
    assert tally.by_op["adamw"] == sum(28 * p.numel() + 4 * 4
                                       for p in leaves)
    from repro_torch.launch.mesh import rules_for
    with D.fake_mesh(FAKE) as mesh:
        rules = rules_for(cfg, mesh, cell)
        local = D.mesh_tally(cfg, cell, mesh, rules)
        shards = [t.to_local() for t in M.tree_leaves(D._on_mesh(
            M.param_spec(cfg), M.param_axes(cfg), rules, mesh))]
    assert local.count_op["adamw"] == len(leaves)
    assert local.by_op["adamw"] == sum(28 * p.numel() + 4 * 4
                                       for p in shards)
    assert sum(p.numel() for p in shards) < sum(p.numel() for p in leaves)


class _Collectives(D.LocalTally):
    """``LocalTally`` that also lists each collective as (op, output
    shape)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def _collective(self, func, args, kwargs):
        out = super()._collective(func, args, kwargs)
        name = func.overloadpacket.__name__
        if name not in D._NOT_COLLECTIVES:
            self.ops.append((name, tuple(out.shape)))
        return out


def test_moe_combine_is_a_partial_sum_over_the_expert_shards():
    """``moe_einsum``'s forward on the fake (2, 8) mesh, its experts split
    over ``model`` (one a rank) and its 8 groups over ``data``: each rank
    sums its own groups' pairs over its own expert's slots, so no expert
    slot is gathered (the all-gathers are the three weights' FSDP shards),
    and the next constraint reduces the partial sums, [4 groups, 16, 64]
    as [2, 32, 64], once."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import moe
    mcfg = moe.MoEConfig(d_model=64, d_ff=32, num_experts=8, top_k=2,
                         capacity_factor=2.0, group_size=16)
    cfg = dataclasses.replace(_smoke("qwen3-moe-235b-a22b"), num_experts=8)
    spec = M.tree_map(lambda t: torch.empty(t.shape, device="meta"),
                      moe.moe_init(torch.Generator().manual_seed(0), mcfg))
    with D.fake_mesh(FAKE) as mesh:
        rules = rules_for(cfg, mesh)
        assert rules["experts"] == rules["act_experts"] == "model"
        params = D._on_mesh(spec, moe.moe_axes(), rules, mesh)
        x = D._on_mesh(torch.empty(4, 32, 64, dtype=torch.bfloat16,
                                   device="meta"),
                       ("batch", "act_seq", "embed"), rules, mesh)
        constrain = functools.partial(shd.constrain, rules=rules)
        with _Collectives() as tally:
            y, _ = moe.moe_einsum(params, mcfg, x, constrain)
            y = constrain(y, ("batch", "act_seq", "embed"))
    cap = moe._capacity(mcfg, 16)
    gathers = [o for n, o in tally.ops if n.startswith("all_gather")]
    assert gathers == [(2, 32, 32)] * 3
    assert not any(o[-2:] == (cap, 64) for _, o in tally.ops)
    reductions = [(n, o) for n, o in tally.ops
                  if n.startswith(("all_reduce", "reduce_scatter"))
                  and math.prod(o) > mcfg.num_experts]
    assert reductions == [("all_reduce", (2, 32, 64))]
    assert y.shape == (4, 32, 64) and y.dtype == torch.bfloat16
