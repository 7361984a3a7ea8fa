"""The port's checkpoint format and fault-tolerant Trainer against the JAX
package's: a checkpoint either trainer writes resumes in the other, a
bfloat16 tree crosses bit for bit, retention and atomicity, crash -> restart
-> the same trajectory, the straggler watermark and the training CLI.

Everything runs on the CPU in float32. Trajectories across the packages are
held at the tolerances of tests/test_torch_training.py (metrics rtol 1e-5;
params, m and v atol 1e-5, rtol 1e-4) on gemma-2b's smoke config: a config
without qkv biases, since the key bias's gradient is zero in exact
arithmetic (the softmax cancels it) and Adam turns its float noise into
updates of +-lr in either package. The port's own crash-restart is exact.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import SyntheticLMData as JData
from repro.distributed import CheckpointManager as JCkpt
from repro.training import train as JT
from repro.training import optim as JO
from repro_torch import configs as tconfigs
from repro_torch.data import SyntheticLMData
from repro_torch.distributed import (CheckpointManager, FaultInjector,
                                     SimulatedPreemption, StragglerDetector)
from repro_torch.distributed import elastic
from repro_torch.models import model as TM
from repro_torch.training import optim as TO
from repro_torch.training import train as TT

ROOT = Path(__file__).resolve().parents[1]
METRIC_TOL = dict(rtol=1e-5)
STATE_TOL = dict(atol=1e-5, rtol=1e-4)
ARCH = "gemma-2b"
OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20)


def _cfgs(vocab=64):
    return (dataclasses.replace(jconfigs.smoke_config(ARCH), vocab_size=vocab,
                                dtype="float32"),
            dataclasses.replace(tconfigs.smoke_config(ARCH), vocab_size=vocab,
                                dtype="float32"))


def _data(seed=1):
    return SyntheticLMData(vocab_size=64, seq_len=32, global_batch=8,
                           seed=seed)


def _from(step, seed=1):
    """The data stream fast-forwarded to ``step``."""
    data = _data(seed)
    return iter(data.batch(s) for s in range(step, 10_000))


def _jax_trainer(ckpt):
    cfg, _ = _cfgs()
    return JT.Trainer(cfg=cfg, tcfg=JT.TrainConfig(optim=JO.OptimConfig(**OPT)),
                      data=iter(JData(vocab_size=64, seq_len=32,
                                      global_batch=8, seed=1)),
                      ckpt_dir=ckpt, ckpt_every=4, log_every=1000)


def _torch_trainer(ckpt, data=None, **kw):
    _, cfg = _cfgs()
    return TT.Trainer(cfg=cfg, tcfg=TT.TrainConfig(optim=TO.OptimConfig(**OPT)),
                      data=data if data is not None else iter(_data()),
                      ckpt_dir=ckpt, ckpt_every=4, log_every=1000,
                      device="cpu", **kw)


def _assert_history(got, want):
    assert [m["step"] for m in got] == [m["step"] for m in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], **METRIC_TOL, err_msg=k)


def _assert_state(got, want):
    want_leaves = jax.tree.leaves(want)
    got_leaves = TM.tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STATE_TOL)


def test_jax_checkpoint_resumes_in_the_port_trainer(tmp_path):
    ckpt = str(tmp_path / "run")
    jt = _jax_trainer(ckpt)
    jt.init_or_resume(resume="never")
    jt.run(4)
    tt = _torch_trainer(ckpt, data=_from(4))
    tt.init_or_resume(resume="must")
    assert tt.step == 4
    assert tt.state["opt"]["step"].dtype == torch.int32
    got = tt.run(8)
    want = jt.run(8)[4:]
    _assert_history(got, want)
    _assert_state(tt.state, jt.state)


def test_port_checkpoint_resumes_in_the_jax_trainer(tmp_path):
    ckpt = str(tmp_path / "run")
    tt = _torch_trainer(ckpt)
    tt.init_or_resume(resume="never")
    tt.run(4)
    jt = _jax_trainer(ckpt)
    jt.init_or_resume(resume="must")
    assert jt.step == 4
    jt.data = _from(4)
    want = jt.run(8)
    got = tt.run(8)[4:]
    _assert_history(got, want)
    _assert_state(tt.state, jt.state)


def test_bf16_tree_from_jax_restores_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16)
    tree = {"w": jnp.asarray(w), "b": {"x": jnp.arange(6, dtype=jnp.float32)},
            "step": jnp.asarray(3, jnp.int32)}
    JCkpt(str(tmp_path / "jax")).save(2, tree, extra={"note": "bf16"})
    step, got, extra = CheckpointManager(str(tmp_path / "jax")).restore(
        device="cpu")
    assert step == 2 and extra == {"note": "bf16"}
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                  w.view(np.int16))
    np.testing.assert_array_equal(got["b"]["x"].numpy(), np.arange(6))
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 3
    # the port writes the same manifest: shapes, dtypes and crc32s
    CheckpointManager(str(tmp_path / "port")).save(2, got, extra={"note": "bf16"})

    def manifest(d):
        return json.loads((tmp_path / d / "step_00000002" /
                           "MANIFEST.json").read_text())
    assert manifest("port") == manifest("jax")


def test_checkpoint_round_trip_and_checksum(tmp_path):
    _, cfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    state = TT.init_train_state(gen, cfg, TT.TrainConfig(), "cpu")
    state["params"]["embed"]["table"] = state["params"]["embed"]["table"].to(
        torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(7, state, extra={"note": "x"})
    step, restored, extra = mgr.restore(device="cpu")
    assert step == 7 and extra == {"note": "x"}
    for a, b in zip(TM.tree_leaves(state), TM.tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a flipped byte in the stored arrays is caught on load
    shard = os.path.join(path, "shard_00000.npz")
    with np.load(shard) as z:
        flat = {k: z[k] for k in z.files}
    flat["opt/step"] = np.asarray(flat["opt/step"] + 1)
    np.savez(shard, **flat)
    with pytest.raises(IOError, match="checksum mismatch for opt/step"):
        mgr.restore(device="cpu")


def test_checkpoint_retention_and_atomicity(tmp_path):
    """Mirrors tests/test_training.py's."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.ones((2,)) * s})
    assert mgr.all_steps() == [3, 4]
    # a stray tmp dir never shows up as a checkpoint, even with a manifest
    stray = tmp_path / "step_00000009.tmp-zz"
    os.makedirs(stray)
    (stray / "MANIFEST.json").write_text("{}")
    assert mgr.latest_step() == 4
    # an orphaned tmp dir is collected once it is an hour old
    os.utime(stray, (0, 0))
    mgr.save(5, {"x": torch.zeros((2,))})
    assert not stray.exists() and mgr.all_steps() == [4, 5]
    assert int(mgr.restore(device="cpu")[1]["x"].sum()) == 0


def test_crash_restart_resumes_trajectory(tmp_path):
    """Mirrors tests/test_training.py's: preemption at step 12 -> restart
    -> the same losses and final state as an uninterrupted run, exactly."""
    ref = _torch_trainer(None)
    ref.init_or_resume(resume="never")
    ref_hist = ref.run(20)

    ckpt = str(tmp_path / "run")
    t1 = _torch_trainer(ckpt, fault_injector=FaultInjector(fail_at_steps=(12,)))
    t1.init_or_resume(resume="never")
    with pytest.raises(SimulatedPreemption, match="step 12"):
        t1.run(20)
    t2 = _torch_trainer(ckpt, data=_from(12))
    t2.init_or_resume(resume="must")
    assert t2.step == 12
    hist2 = t2.run(20)
    assert [m["loss"] for m in hist2] == [m["loss"] for m in ref_hist[12:]]
    for a, b in zip(TM.tree_leaves(t2.state), TM.tree_leaves(ref.state)):
        assert torch.equal(a, b)


def test_resume_must_without_checkpoint_raises(tmp_path):
    t = _torch_trainer(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="resume='must'"):
        t.init_or_resume(resume="must")


def test_straggler_detector_flags_slow_steps(monkeypatch):
    """The reference's test on a clock the test sets, not on time.sleep."""
    now = [0.0]
    monkeypatch.setattr(elastic.time, "monotonic", lambda: now[0])
    det = StragglerDetector(min_samples=4, threshold=2.0)
    for i, dt in enumerate((0.010, 0.011, 0.009, 0.010, 0.012, 0.010)):
        det.start()
        now[0] += dt
        assert det.stop(i) is None
    det.start()
    now[0] += 0.021                     # just above 2x the median 0.010
    factor = det.stop(99)
    assert factor == pytest.approx(0.021 / 0.010)
    assert det.events == [(99, factor)]
    det.start()
    now[0] += 0.020                     # not above 2x the median
    assert det.stop(100) is None and len(det.events) == 1


def test_best_mesh_shape_matches_the_reference():
    from repro.distributed.elastic import best_mesh_shape as jbest
    for n in (1, 3, 4, 6, 8, 12, 16, 256):
        for mp in (1, 2, 4, 8, 16):
            assert elastic.best_mesh_shape(n, mp) == jbest(n, mp)


def test_launch_train_fails_and_resumes(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
           "--steps", "4", "--seq", "32", "--device", "cpu", "--ckpt-dir",
           str(tmp_path / "ckpt"), "--ckpt-every", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    first = subprocess.run(cmd + ["--fail-at", "2"], capture_output=True,
                           text=True, env=env, timeout=300)
    assert first.returncode != 0
    assert "simulated preemption at step 2" in first.stderr
    again = subprocess.run(cmd + ["--resume", "auto"], capture_output=True,
                           text=True, env=env, timeout=300)
    assert again.returncode == 0, again.stderr
    assert "[trainer] resumed from step 2" in again.stdout
    assert "[train] done: step=4" in again.stdout
