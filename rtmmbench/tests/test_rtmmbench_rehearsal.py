"""Whole runs of the harness on the CPU at tiny width: the engine's report
against the harness's own accounting, and ``correct`` coming out false
when the timed path is broken underneath, once for each fault a cell can
have, and for the control (the float8 reference in the program's place):
over every cell in ``BENCHMARK.json``, each fault in the cells whose models
can have it."""
from __future__ import annotations

import json
import time

import pytest
import torch

from rtmmbench import harness
from rtmmbench.tests import tiny

torch.set_num_threads(1)

BENCH = harness.load_benchmark()
CELLS = {w["name"]: w["config"] for w in BENCH["workloads"]}
SEED = 2**31 + 101


def _cells_with(key: str) -> list[str]:
    """The cells in which some served model's entry sets ``key``."""
    def has(config: str) -> bool:
        c = json.loads(harness.config_file(BENCH, config).read_text())
        return any(c[r]["config"].get(key) for r in c["serves"])
    return [w for w, config in CELLS.items() if has(config)]


def _run(workload: str, trace: bool = False, seconds: float = 1.0):
    name = CELLS[workload]
    return harness.run_cell(workload, SEED, seconds, trace,
                            torch.device("cpu"), time.perf_counter(),
                            config=tiny.config(name),
                            mix=tiny.mix(name, seq=32, fps=25.0))


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct_and_accounts_every_frame(workload):
    out = _run(workload)
    line = out.line
    assert line["correct"], line["checks"]
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"frame_p95_ms", "goodput_fps",
                                    "setup_s"}
    assert line["attempted"] > 20
    assert line["checks"]["accounting_mismatch"]["value"] == 0
    names = {n for n in line["checks"] if n.startswith("logit_")}
    # every served model compared; a routed one (vision's verifier) by its
    # share of positions over a gap
    c = tiny.config(CELLS[workload])
    assert {("logit_share." if c[r]["config"].get("num_experts")
             else "logit_err.") + r for r in c["serves"]} <= names


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_traced_run_reports_the_per_layer_metrics(workload):
    out = _run(workload, trace=True)
    line = out.line
    assert line["correct"]
    assert {"mfu"} <= set(line["metrics"])
    assert "frame_p95_ms" not in line["metrics"]
    assert line["device"]["window_s"] == pytest.approx(1.0, abs=0.1)
    assert {"device_ops", "idle_gaps"} == set(line["breakdown"])
    assert list(line)[-1] == "checks"


def _alter_one_answer(monkeypatch):
    from repro_torch.models import model as M
    logits = M._logits

    def altered(params, cfg, x):
        out = logits(params, cfg, x).clone()
        out[:, -1] = -out[:, -1]
        return out
    monkeypatch.setattr(M, "_logits", altered)


def _drop_half_the_frame(monkeypatch):
    from repro_torch.models import model as M
    forward = M.forward

    def half(params, cfg, tokens, *a, **k):
        s = tokens.shape[1]
        out, aux = forward(params, cfg, tokens[:, : s // 2], *a, **k)
        return torch.cat([out, out[:, : s - s // 2]], dim=1), aux
    monkeypatch.setattr(M, "forward", half)


def _state_not_carried(monkeypatch):
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref

    def ssd(x, dt, A, B, C, D, *, chunk=64):
        ys, fin = [], None
        for i in range(0, x.shape[1], chunk):
            sl = slice(i, i + chunk)
            y, fin = kref.ssd(x[:, sl], dt[:, sl], A, B[:, sl], C[:, sl], D)
            ys.append(y)
        return torch.cat(ys, dim=1), fin
    monkeypatch.setattr(ops, "ssd", ssd)


def _wrong_expert(monkeypatch):
    """Rows routed to expert 0 computed by expert 1: a minority of rows."""
    from repro_torch.models import moe
    route = moe.route

    def wrong(params, cfg, x):
        w, idx, aux = route(params, cfg, x)
        return w, torch.where(idx == 0, torch.ones_like(idx), idx), aux
    monkeypatch.setattr(moe, "route", wrong)


def _miscount_frames(monkeypatch):
    from repro_torch.serving import engine as E
    finish = E.ServingEngine._finish_stats

    def skip_some(self, req):
        if req.rid % 7:
            finish(self, req)
    monkeypatch.setattr(E.ServingEngine, "_finish_stats", skip_some)


def _control(monkeypatch, workload):
    """The reference in float8 put in the program's place."""
    from repro_torch.models import model as M
    config = tiny.config(CELLS[workload])
    models, _ = harness.served_models(config)
    refs = harness.references(config)

    def fp8(params, cfg, tokens, *a, **k):
        out = refs[cfg.name].forward(params, models[cfg.name], tokens,
                                     quant="fp8")
        return out[None], torch.zeros(())
    monkeypatch.setattr(M, "forward", fp8)


FAULTS = {
    "answer_altered": (_alter_one_answer, list(CELLS)),
    "half_the_frame_left_out": (_drop_half_the_frame, list(CELLS)),
    "state_not_carried": (_state_not_carried, _cells_with("ssm_state")),
    "wrong_expert": (_wrong_expert, _cells_with("num_experts")),
    "frames_miscounted": (_miscount_frames, list(CELLS)),
}


@pytest.mark.parametrize("fault,workload", [
    (f, w) for f, (_, cells) in FAULTS.items() for w in cells])
def test_broken_timed_path_is_not_correct(monkeypatch, fault, workload):
    FAULTS[fault][0](monkeypatch)
    out = _run(workload)
    assert not out.line["correct"], out.line["checks"]


@pytest.mark.parametrize("workload", _cells_with("num_experts"))
def test_a_wrong_expert_fails_the_share_of_positions(monkeypatch, workload):
    _wrong_expert(monkeypatch)
    checks = _run(workload).line["checks"]
    shares = {n: c for n, c in checks.items()
              if n.startswith("logit_share.")}
    assert any(c["value"] > c["limit"] for c in shares.values()), shares


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_is_not_correct(monkeypatch, workload):
    _control(monkeypatch, workload)
    out = _run(workload)
    assert not out.line["correct"], out.line["checks"]


def test_knee_sweep_runs_and_reads_the_knee():
    from rtmmbench.sweep import sweep
    rows, knee = sweep(tiny.config("rtmm_audio"),
                       tiny.mix("rtmm_audio", fps=10.0), [1.0, 40.0], 0.6,
                       SEED, torch.device("cpu"))
    assert [r["factor"] for r in rows] == [1.0, 40.0]
    assert rows[0]["met_share"] >= 0.99 and knee == 1.0
    assert rows[1]["frames"] > 10 * rows[0]["frames"]


def test_limit_readings_separate_program_and_control():
    """The limits' readings at tiny width: the program under each limit of
    the tiny configuration, the control over it."""
    from rtmmbench.limits import readings
    summary = readings(tiny.config("rtmm_audio"),
                       tiny.mix("rtmm_audio", seq=32, fps=10.0),
                       [SEED, SEED + 1], [SEED + 2], 0.4, torch.device("cpu"))
    for name, r in summary.items():
        assert len(r["program"]) == 2 and len(r["control"]) == 1
        assert r["lower"] < 0.05 < r["upper"], (name, r)
