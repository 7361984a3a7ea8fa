"""What the benchmark loads and reads: no JAX and no JAX package by whole
top-level module name, nothing of ``benchmarks/``; its command without a
card; and a configuration with its own reference module, a traffic mix and
a per-layer metric added to a copy of it as files alone, found by name and
held to that module by ``reference_checks``, whose checks bound to
``reference.model`` fail there."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

from rtmmbench import ROOT, SRC
from rtmmbench.harness import FORBIDDEN, PKG

REHEARSE = textwrap.dedent("""
    import json, sys, time, torch
    torch.set_num_threads(1)
    import rtmmbench.run, rtmmbench.sweep, rtmmbench.limits
    from rtmmbench import harness
    from rtmmbench.tests import tiny
    wl, name, trace = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
    out = harness.run_cell(wl, 2**31 + 5, 0.6, trace, torch.device("cpu"),
                           time.perf_counter(), config=tiny.config(name),
                           mix=tiny.mix(name, fps=20.0))
    for m in json.loads(open("BENCHMARK.json").read())["per_layer"]:
        harness.reader(m["name"])
    top = sorted({m.split(".")[0] for m in sys.modules})
    print(json.dumps({"line": out.line, "modules": top}))
""")


def _python(args: list[str], cwd: Path, timeout: float = 240):
    env = dict(os.environ, PYTHONPATH=f"{cwd}{os.pathsep}{SRC}")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_a_run_loads_no_jax_and_no_jax_package():
    res = _python(["-c", REHEARSE, "audio.steady", "rtmm_audio", "1"], ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["line"]["correct"]
    assert "repro_torch" in out["modules"]
    assert not set(out["modules"]) & set(FORBIDDEN), out["modules"]


def test_nothing_reads_the_jax_packages_benchmarks():
    for path in PKG.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert "benchmarks" not in text, path
        assert "import jax" not in text and "from jax" not in text, path


def test_command_without_a_card_prints_no_result():
    res = _python(["-m", "rtmmbench.run", "--workload", "vision.steady",
                   "--seed", str(2**31 + 9), "--seconds", "1", "--trace",
                   "0"], ROOT, timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


RECORDED = textwrap.dedent("""
    \"""A reference module that serves as ``model`` does, recording each
    function of the contract it serves, with compute kinds, counts and
    tiny widths and depths of its own: its conv bias served in float32,
    one operation more a call.\"""
    from . import model

    SERVED = set()
    COMPUTE_KINDS = tuple(k for k in model.COMPUTE_KINDS if k != "conv_b")
    TINY = dict(d_model=32, num_heads=4, num_kv_heads=4, d_ff=64,
                vocab_size=96, ssm_state=8, ssm_heads=4, ssm_chunk=8,
                shared_attn_every=2, num_layers=6)
    TINY_VARIANT_LAYERS = 2


    def _serves(name):
        def fn(*args, **kwargs):
            SERVED.add(name)
            return getattr(model, name)(*args, **kwargs)
        return fn


    check_config = _serves("check_config")
    param_layout = _serves("param_layout")
    forward = _serves("forward")
    variant_tree = _serves("variant_tree")


    def call_counts(*args, **kwargs):
        SERVED.add("call_counts")
        out = dict(model.call_counts(*args, **kwargs))
        out["flops"] += 1
        return out
""")

#: the checks of ``reference_checks`` on the added configuration, as it is
#: committed and at tiny size, each model held to the module its entry
#: names (argument ``named``) or to ``reference.model`` (``model``)
CHECKS = textwrap.dedent("""
    import json, sys
    from rtmmbench import harness
    from rtmmbench.reference import model
    from rtmmbench.tests import reference_checks as rc, tiny
    bench = harness.load_benchmark()
    c = json.loads(harness.config_file(bench, "tiny_audio").read_text())
    mix = json.loads(harness.traffic_file("steady", "tiny_audio")
                     .read_text())
    module_of = {"named": rc.named_module,
                 "model": lambda entry: model}[sys.argv[1]]
    checks = {
        "resolves": lambda: rc.check_resolves(c, module_of),
        "plan": lambda: rc.check_plan(c, module_of),
        "plan_tiny": lambda: rc.check_plan(tiny.config("tiny_audio"),
                                           module_of),
        "counts": lambda: rc.check_counts(c, mix, module_of)}
    out = {}
    for name, check in checks.items():
        try:
            check()
            out[name] = "pass"
        except AssertionError:
            out[name] = "fail"
    print(json.dumps(out))
""")


def _add_files(tmp_path: Path) -> dict[Path, bytes]:
    """Copy the benchmark to ``tmp_path`` and add, as new files and new
    entries in BENCHMARK.json, a configuration (a tiny audio deployment
    whose speech model names the reference module ``recorded``), that
    module, its traffic, a cell and a per-layer metric; the copy's files
    as they were before the additions."""
    shutil.copytree(PKG, tmp_path / "rtmmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "rtmmbench").rglob("*")
              if p.is_file()}
    from rtmmbench.tests import tiny
    cfg = tiny.config("rtmm_audio")
    cfg["name"] = "tiny_audio"
    cfg["speech"]["reference"] = "recorded"
    (tmp_path / "rtmmbench/reference/recorded.py").write_text(RECORDED)
    (tmp_path / "rtmmbench/configs/tiny_audio.json").write_text(
        json.dumps(cfg))
    (tmp_path / "rtmmbench/traffic/steady/tiny_audio.json").write_text(
        json.dumps(tiny.mix("rtmm_audio", fps=20.0)))
    (tmp_path / "rtmmbench/metrics/frames_read.py").write_text(
        "def read(run):\n    return float(run.frames)\n")
    bench["configs"].append({"name": "tiny_audio", "source": "test",
                             "file": "rtmmbench/configs/tiny_audio.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.steady", "config": "tiny_audio",
                               "traffic": "steady", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        if "audio.steady" in m.get("workloads", []):
            m["workloads"].append("tiny.steady")
    bench["per_layer"].append({"name": "frames_read", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "frame_p95_ms",
                               "workloads": ["tiny.steady"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return before


def test_added_files_are_found_by_name(tmp_path):
    """A copy of the benchmark gains a configuration, its own reference
    module, its traffic and a per-layer metric (``_add_files``); a traced
    run of the new cell finds all four with no edit to any file the copy
    had: the speech model's layout, compute kinds, forward, variant cut
    and counts all come from the new module, whose tiny widths and depths
    ``tiny.config`` takes; and the benchmark's own checks of a
    configuration (``reference_checks``) pass on it through that
    module."""
    before = _add_files(tmp_path)
    script = textwrap.dedent("""
        import json, time, torch
        torch.set_num_threads(1)
        from rtmmbench import harness
        from rtmmbench.reference import recorded
        from rtmmbench.tests import tiny
        out = harness.run_cell("tiny.steady", 2**31 + 3, 0.6, True,
                               torch.device("cpu"), time.perf_counter())
        config = tiny.config("tiny_audio")
        refs = harness.references(config)
        models, _ = harness.served_models(config)
        print(json.dumps({
            "line": out.line, "served": sorted(recorded.SERVED),
            "refs": {m: r.__name__ for m, r in sorted(refs.items())},
            "tiny_vocab": {r: config[r]["config"]["vocab_size"]
                           for r in config["serves"]},
            "tiny_layers": {m: cfg["num_layers"]
                            for m, cfg in models.items()}}))
    """)
    res = _python(["-c", script], tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    line = out["line"]
    assert line["correct"], line["checks"]
    assert line["metrics"]["frames_read"]["value"] > 0
    assert line["metrics"]["mfu"]["value"] > 0
    assert {"logit_err.kws", "logit_err.speech"} <= set(line["checks"])
    assert out["served"] == ["call_counts", "check_config", "forward",
                             "param_layout", "variant_tree"]
    assert out["refs"] == {"kws": "rtmmbench.reference.model",
                           "speech": "rtmmbench.reference.recorded",
                           "speech@v1": "rtmmbench.reference.recorded"}
    assert out["tiny_vocab"] == {"kws": 128, "speech": 96}
    assert out["tiny_layers"] == {"kws": 2, "speech": 6, "speech@v1": 2}
    res = _python(["-c", CHECKS, "named"], tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "resolves": "pass", "plan": "pass", "plan_tiny": "pass",
        "counts": "pass"}
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_checks_bound_to_model_fail_on_the_added_configuration(tmp_path):
    """The same checks, with every model held to ``reference.model`` as
    they held every model before a configuration could name its module,
    fail on the added configuration: its speech model resolves elsewhere,
    serves its conv bias in float32 and counts one operation more."""
    _add_files(tmp_path)
    res = _python(["-c", CHECKS, "model"], tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "resolves": "fail", "plan": "fail", "plan_tiny": "fail",
        "counts": "fail"}
