"""On the card: each cell's command runs a short window and comes out
correct, its result line in the contract's shape. Skips without CUDA.

    python3 -m pytest -q -m cuda rtmmbench/tests/test_rtmmbench_cuda.py
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from rtmmbench import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload,trace", [
    ("vision.steady", 0), ("vision.steady", 1),
    ("audio.steady", 0), ("audio.steady", 1)])
def test_cell_runs_correct_on_the_card(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA")
    res = subprocess.run(
        [sys.executable, "-m", "rtmmbench.run", "--workload", workload,
         "--seed", str(2**31 + 77), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        for name, m in line["metrics"].items():
            if m["unit"] == "%" and name.endswith("_roofline"):
                assert 0 < m["value"] <= 100, (name, m)
    else:
        assert set(line["metrics"]) == {"frame_p95_ms", "goodput_fps",
                                        "setup_s"}
