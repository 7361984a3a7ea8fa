"""One rank of the two-process sharded train step that
``tests/test_torch_sharding.py`` runs (gloo on the CPU, a ``FileStore``).

    python tests/_torch_mesh_worker.py RANK STORE_PATH OUT_PATH

Both ranks take one float32 train step of each of ``ARCHS`` at smoke width
on each of ``MESHES`` (a DeviceMesh over the two ranks, rules from
``rules_for``), from ``mid_run_state``, counted by the dry-run's
``LocalTally`` (each rank's collectives by family and the FLOPs of its own
ops), save the sharded state with ``CheckpointManager`` and restore it onto
the other mesh, and compress ``grads_and_err`` on the mesh at each of
``BLOCKS``; then one ``decode_step`` of ``DECODE_ARCH`` (MQA: its cache is
sequence-sharded over ``model``) from ``decode_inputs``. Rank 0 writes each
run's loss, its updated params, the restored params, the compressed
gradients and residuals, the decoded logits and cache, all gathered with
``full_tensor()``, how many leaves each rank quantised on its own shard, and
its counts to OUT_PATH (npz); rank 1 writes its counts to
``rank1_path(OUT_PATH)``.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

ARCHS = ("gemma2-2b", "mamba2-130m", "qwen3-moe-235b-a22b")
MESHES = ((1, 2), (2, 1))
SEQ, BATCH, VOCAB = 32, 4, 512
BLOCKS = (8, 256)
DECODE_ARCH = "gemma-2b"
#: each row's write position: rows in both halves of the sequence
DECODE_POS = (3, 17, 30, 8)


def rank1_path(out_path: str) -> str:
    return out_path[:-len(".npz")] + "-rank1.npz"


def train_cell():
    from repro_torch.configs import ShapeCell
    return ShapeCell("smoke_train", SEQ, BATCH, "train")


def decode_cell():
    from repro_torch.configs import ShapeCell
    return ShapeCell("smoke_decode", SEQ, BATCH, "decode")


def smoke(arch: str):
    from repro_torch.configs import smoke_config
    return dataclasses.replace(smoke_config(arch), vocab_size=VOCAB,
                               dtype="float32")


def tcfg():
    from repro_torch.training import OptimConfig, TrainConfig
    return TrainConfig(optim=OptimConfig(learning_rate=1e-2, warmup_steps=2,
                                         total_steps=20))


def mid_run_state(cfg) -> dict:
    """Params from seed 0 and an optimizer state in mid run (m, v and the
    step from seed 7): a first step from zeros makes Adam's update the sign
    of float noise where a gradient is zero in exact arithmetic."""
    from repro_torch.models import model as M
    from repro_torch.training import init_train_state
    state = init_train_state(torch.Generator().manual_seed(0), cfg, tcfg(),
                             "cpu")
    g = torch.Generator().manual_seed(7)
    state["opt"]["m"] = M.tree_map(
        lambda p: 1e-2 * torch.randn(p.shape, generator=g), state["params"])
    state["opt"]["v"] = M.tree_map(
        lambda p: 1e-5 + 9e-5 * torch.rand(p.shape, generator=g),
        state["params"])
    state["opt"]["step"] = torch.tensor(10, dtype=torch.int32)
    return state


def batch() -> dict:
    from repro_torch.data import SyntheticLMData
    b = SyntheticLMData(vocab_size=VOCAB, seq_len=SEQ, global_batch=BATCH,
                        seed=3).batch(0)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def grads_and_err(cfg) -> tuple[dict, dict]:
    """Gradients and residuals shaped like the params, from seed 11."""
    from repro_torch.models import model as M
    params = mid_run_state(cfg)["params"]
    g = torch.Generator().manual_seed(11)
    return (M.tree_map(lambda p: torch.randn(p.shape, generator=g), params),
            M.tree_map(lambda p: 1e-3 * torch.randn(p.shape, generator=g),
                       params))


def step(cfg, state, b, rules=None):
    """One train step of ``state`` (updated in place); returns the loss."""
    from repro_torch.training import build_train_step
    _, metrics = build_train_step(cfg, tcfg(), rules)(state, b)
    return metrics["loss"]


def decode_inputs(cfg) -> tuple[dict, dict, torch.Tensor, torch.Tensor]:
    """(params from seed 0, a float32 cache of ``SEQ`` positions filled from
    seed 5, tokens from seed 6, ``DECODE_POS``)."""
    from repro_torch.models import model as M
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    g = torch.Generator().manual_seed(5)
    cache = M.tree_map(lambda c: torch.randn(c.shape, generator=g),
                       M.init_cache(cfg, BATCH, SEQ, torch.float32, "cpu"))
    tokens = torch.randint(0, VOCAB, (BATCH, 1), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(6))
    return params, cache, tokens, torch.tensor(DECODE_POS, dtype=torch.int32)


def decode(cfg, params, cache, tokens, pos, rules=None):
    """One decode step on the torch path (``cache`` advanced in place);
    returns the logits."""
    import functools
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as M
    return M.decode_step(params, cfg, tokens, cache, pos, attn_impl="torch",
                         moe_impl="einsum", constrain=functools.partial(
                             shd.constrain, rules=rules))[0]


def main(rank: int, store_path: str, out_path: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import CheckpointManager
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.compression import (
        CompressionConfig, _shards_hold_whole_blocks, compress_with_feedback)
    from repro_torch.launch.dryrun import FAMILIES, count
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import model as M
    from repro_torch.training.train import train_state_axes

    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2)
    out, counts = {}, {}
    try:
        for arch in ARCHS:
            cfg = smoke(arch)
            for shape in MESHES:
                mesh = init_device_mesh("cpu", shape,
                                        mesh_dim_names=("data", "model"))
                rules = rules_for(cfg, mesh)
                state = shd.distribute_tree(
                    mid_run_state(cfg), mesh,
                    shd.tree_placements(mesh, train_state_axes(cfg, tcfg()),
                                        rules))
                b = {k: distribute_tensor(v, mesh, shd.placements_for(
                    mesh, shd.spec_for(("batch", "act_seq"), rules)))
                    for k, v in batch().items()}
                ran = {}
                tally = count(lambda: ran.update(
                    loss=step(cfg, state, b, rules)))
                loss = ran["loss"].full_tensor()
                params = shd.full_tree(state["params"])
                tag = f"{arch}@{shape[0]}x{shape[1]}"
                counts[f"{tag}/flops"] = np.array(tally.flops)
                for fam in FAMILIES:
                    counts[f"{tag}/coll/{fam}"] = np.array(
                        tally.collectives.get(fam, 0))
                out[f"{tag}/loss"] = loss.numpy()
                for i, p in enumerate(M.tree_leaves(params)):
                    out[f"{tag}/p{i}"] = p.numpy()

                ckpt = CheckpointManager(os.path.join(
                    os.path.dirname(out_path), f"ckpt-{tag}"))
                ckpt.save(1, state)
                other = init_device_mesh("cpu", shape[::-1],
                                         mesh_dim_names=("data", "model"))
                orules = rules_for(cfg, other)
                _, restored, _ = ckpt.restore(
                    mesh=other, placements=shd.tree_placements(
                        other, train_state_axes(cfg, tcfg()), orules))
                for i, p in enumerate(M.tree_leaves(
                        shd.full_tree(restored["params"]))):
                    out[f"{tag}/r{i}"] = p.numpy()

                where = shd.tree_placements(
                    mesh, train_state_axes(cfg, tcfg())["params"], rules)
                for block in BLOCKS:
                    grads, err = (shd.distribute_tree(t, mesh, where)
                                  for t in grads_and_err(cfg))
                    q, e = compress_with_feedback(
                        grads, err, CompressionConfig(block=block))
                    out[f"{tag}/b{block}/local"] = np.array(sum(
                        _shards_hold_whole_blocks(g.float() + r, block)
                        for g, r in zip(M.tree_leaves(grads),
                                        M.tree_leaves(err))))
                    for i, (a, c) in enumerate(zip(
                            M.tree_leaves(shd.full_tree(q)),
                            M.tree_leaves(shd.full_tree(e)))):
                        out[f"{tag}/b{block}/q{i}"] = a.numpy()
                        out[f"{tag}/b{block}/e{i}"] = c.numpy()

        cfg = smoke(DECODE_ARCH)
        for shape in MESHES:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            rules = rules_for(cfg, mesh, decode_cell())
            params, cache, tokens, pos = decode_inputs(cfg)
            params = shd.distribute_tree(params, mesh, shd.tree_placements(
                mesh, M.param_axes(cfg), rules))
            cache = shd.distribute_tree(cache, mesh, shd.tree_placements(
                mesh, M.cache_axes(cfg), rules))
            tokens, pos = (distribute_tensor(t, mesh, shd.placements_for(
                mesh, shd.spec_for(lg, rules)))
                for t, lg in ((tokens, ("batch", None)), (pos, ("batch",))))
            logits = decode(cfg, params, cache, tokens, pos, rules)
            tag = f"{DECODE_ARCH}@{shape[0]}x{shape[1]}/decode"
            out[f"{tag}/logits"] = logits.full_tensor().numpy()
            for i, c in enumerate(M.tree_leaves(shd.full_tree(cache))):
                out[f"{tag}/c{i}"] = c.numpy()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(out_path, **out, **counts)
    else:
        np.savez(rank1_path(out_path), **counts)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
