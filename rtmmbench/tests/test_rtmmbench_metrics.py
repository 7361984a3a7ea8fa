"""The trace's reduction and the per-layer readers on synthetic timelines."""
from __future__ import annotations

import pytest

from rtmmbench import counts, harness
from rtmmbench.harness import RunData
from rtmmbench.reference import model as ref
from rtmmbench.trace import Timeline

MS = 1_000_000          # ns


def _timeline() -> Timeline:
    # a 100 ms window: two calls of model "m" at 10-20 and 50-70 ms, their
    # kernels (one flash, one ssd_out) and a copy; a poll at 0-2 ms
    device = [
        (11 * MS, 14 * MS, "void flash_wgmma_kernel<128>(Args)"),
        (13 * MS, 16 * MS, "Memcpy HtoD (Pageable -> Device)"),
        (52 * MS, 60 * MS, "void ssd_out_kernel<bf16>(...)"),
        (60 * MS, 62 * MS, "pytorch_flash::flash_fwd_kernel"),
    ]
    host = [(0, 2 * MS, "poll"), (10 * MS, 20 * MS, "call:m"),
            (50 * MS, 70 * MS, "call:m")]
    return Timeline(sorted(device), sorted(host),
                    {"window_start": 0, "window_end": 100 * MS})


def test_busy_union_kernel_time_and_top_ops():
    t = _timeline()
    assert t.busy_s() == pytest.approx(0.015)          # 11-16, 52-62
    # whole kernel names only: SDPA's flash kernel is not ours
    assert t.kernel_s(("flash_wgmma_kernel",)) == pytest.approx(0.003)
    assert t.kernel_s(("ssd_out_kernel", "ssd_cb_kernel")) == \
        pytest.approx(0.008)
    assert t.top_ops(1) == [["void ssd_out_kernel<bf16>(...)", 0.008]]


def test_idle_gaps_by_host_region():
    gaps = dict((n, s) for n, s in _timeline().idle_gaps())
    assert gaps["poll"] == pytest.approx(0.002)
    # call regions: 10-11, 16-20, 50-52, 62-70 ms idle
    assert gaps["call:m"] == pytest.approx(0.015)
    assert sum(gaps.values()) == pytest.approx(0.085)
    assert gaps["engine"] == pytest.approx(0.085 - 0.017)


def _run(timeline) -> RunData:
    cfg = {"family": "ssm", "num_layers": 2, "d_model": 64,
           "num_heads": 0, "num_kv_heads": 0, "d_ff": 0, "vocab_size": 100,
           "ssm_state": 16, "ssm_heads": 4, "ssm_chunk": 8,
           "layer_pattern": ["mamba"]}
    return RunData(timeline, {"m": cfg}, {"m": 32}, {"m": 2},
                   {"m": [0.010, 0.020]}, 2, {"m": ref})


def test_readers():
    run = _run(_timeline())
    read = lambda name: harness.reader(name)(run)
    assert read("call_host_share") == pytest.approx(100 * (1 - 0.015 / 0.03))
    assert read("device_ms_per_frame") == pytest.approx(7.5)
    assert read("idle_share") == pytest.approx(85.0)
    flops = counts.call_counts(run.models["m"], 32)["flops"]
    assert read("mfu") == pytest.approx(100 * 2 * flops
                                        / (0.03 * counts.PEAK_FLOPS))
    bound = counts.kernel_bound_s(run.models["m"], 32, "ssd")
    assert read("ssd_roofline") == pytest.approx(100 * 2 * bound / 0.008)
    # kernels the run launched none of: nothing to read, no zero
    assert read("gmm_roofline") is None
    assert read("flash_roofline") is None          # "m" runs no attention
    untraced = _run(None)
    for name in ("call_host_share", "device_ms_per_frame", "idle_share",
                 "ssd_roofline"):
        assert harness.reader(name)(untraced) is None


def test_every_metric_in_the_benchmark_has_a_reader():
    bench = harness.load_benchmark()
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"]))
