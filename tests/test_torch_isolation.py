"""The port stands alone: no JAX and nothing of the JAX package, and its
entry points never carry on silently on the CPU."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_torch)|"
                       r"from repro\b(?!_torch)|import repro\.|from repro\.)",
                       re.M)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_every_module_loads_no_jax_and_no_repro():
    mods = _modules()
    assert {"repro_torch.kernels.ops", "repro_torch.launch.serve",
            "repro_torch.graphs", "repro_torch.kernels.adamw"} <= set(mods)
    assert {"repro_torch.scenarios.arrivals",
            "repro_torch.scenarios.trace"} <= set(mods)
    assert {"repro_torch.training.train", "repro_torch.distributed.checkpoint",
            "repro_torch.data.pipeline", "repro_torch.launch.train"} <= set(mods)
    assert {"repro_torch.obs", "repro_torch.obs.metrics",
            "repro_torch.obs.spans", "repro_torch.obs.profiler",
            "repro_torch.obs.report", "repro_torch.cluster.node",
            "repro_torch.cluster.router", "repro_torch.cluster.telemetry",
            "repro_torch.core.adaptivity",
            "repro_torch.launch.serve_fleet"} <= set(mods)
    assert {f"repro_torch.core.{m}" for m in (
        "types", "engine", "zoo", "costmodel", "mapscore", "workloads",
        "simulator", "scheduler", "baselines")} <= set(mods)
    assert {f"repro_torch.scenarios.{m}" for m in (
        "builder", "phases", "registry", "fuzzer")} <= set(mods)
    assert {f"repro_torch.cluster.{m}" for m in (
        "slo", "trace", "builder", "fleet")} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]", out.stdout


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_cluster_exports_equal_the_reference():
    """``repro_torch.cluster`` exports what ``repro.cluster`` does, and each
    export resolves."""
    import repro.cluster as ref_cluster
    import repro_torch.cluster as port_cluster
    assert port_cluster.__all__ == ref_cluster.__all__
    for name in port_cluster.__all__:
        obj = getattr(port_cluster, name)
        if isinstance(obj, type) or callable(obj):
            assert obj.__module__.startswith("repro_torch."), name


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import repro.core",
                 "from repro.models import model", "from repro import configs",
                 "  import repro"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.kernels import ops",
                 "# jax-free"):
        assert not FORBIDDEN.search(line), line


@pytest.mark.parametrize("entry", ["build_handle", "LM", "init_params",
                                   "from_jax_params", "Trainer", "restore",
                                   "serve_fleet"])
def test_entry_points_raise_without_cuda(entry, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.configs import smoke_config
    from repro_torch.convert import from_jax_params
    from repro_torch.distributed import CheckpointManager
    from repro_torch.launch import serve_fleet
    from repro_torch.launch.serve import build_handle
    from repro_torch.models import LM, init_params
    from repro_torch.training import TrainConfig, Trainer
    cfg = smoke_config("gemma-2b")
    calls = {
        "build_handle": lambda: build_handle("gemma-2b", "x", layers=1),
        "LM": lambda: LM(cfg),
        "init_params": lambda: init_params(torch.Generator(), cfg),
        "from_jax_params": lambda: from_jax_params({"a": [1.0]}),
        "Trainer": lambda: Trainer(cfg=cfg, tcfg=TrainConfig(), data=iter(())),
        "restore": lambda: CheckpointManager(str(tmp_path)).restore(),
        "serve_fleet": lambda: serve_fleet.main(["--epochs", "1",
                                                 "--duration", "0.1"]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
