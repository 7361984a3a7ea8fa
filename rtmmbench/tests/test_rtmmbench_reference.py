"""The plain reference against the program at float32 on the CPU, its
state-space form against the sequential scan, its parameter layout against
the program's, and its independence from the program: over every
configuration in ``BENCHMARK.json``, each model through its own reference
module."""
from __future__ import annotations

import ast
import json

import pytest
import torch

from rtmmbench import harness, weights
from rtmmbench.harness import PKG
from rtmmbench.reference import model as ref
from rtmmbench.tests import tiny

torch.set_num_threads(1)

BENCH = harness.load_benchmark()
CONFIGS = [c["name"] for c in BENCH["configs"]]


def _pairs():
    for name in CONFIGS:
        models, _ = harness.served_models(tiny.config(name))
        for m in models:
            yield name, m


@pytest.mark.parametrize("name,model", list(_pairs()))
def test_reference_equals_the_program_in_float32(name, model):
    from repro_torch.models import model as M
    c = tiny.config(name)
    models, _ = harness.served_models(c)
    cfg = models[model]
    refs = harness.references(c)
    w = weights.make({r: c[r]["config"] for r in c["serves"]}, refs, 17,
                     torch.device("cpu"), torch.float32)
    tree = harness.model_tree(c, w, model, refs)
    acfg = harness.arch_config(model, cfg, "float32")
    tokens = torch.randint(0, cfg["vocab_size"], (1, 24),
                           generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        got = M.forward(tree, acfg, tokens)[0]
    want = refs[model].forward(tree, cfg, tokens)
    assert float(harness.row_errors(got, want).max()) < 1e-4


def test_state_space_form_equals_the_sequential_scan():
    from repro_torch.kernels import ref as kref
    g = torch.Generator().manual_seed(0)
    s, h, p, n = 40, 3, 8, 5
    x = torch.randn(s, h, p, generator=g)
    dt = torch.rand(s, h, generator=g) * 0.5
    a = -torch.rand(h, generator=g) * 4
    b, c = torch.randn(s, n, generator=g), torch.randn(s, n, generator=g)
    d = torch.randn(h, generator=g)
    want, _ = kref.ssd(x[None], dt[None], a, b[None], c[None], d)
    got = ref.ssd(x, dt, a, b, c, d, heads_per_block=2)
    torch.testing.assert_close(got, want[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_layout_equals_the_programs_at_published_widths(name):
    c = json.loads(harness.config_file(BENCH, name).read_text())
    models, _ = harness.served_models(c)
    refs = harness.references(c)
    for model, cfg in models.items():
        harness.check_layout(model, cfg, harness.arch_config(
            model, cfg, c["dtype"]), refs[model])


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in ("torch", "contextlib", "typing",
                                           "__future__", "math"), (path, n)


def test_control_rounds_to_float8():
    t = torch.linspace(-3, 3, 101)
    q = ref.fp8_round(t)
    assert q.abs().max() == pytest.approx(3.0)
    rel = ((q - t).abs() / t.abs().clamp_min(1e-3))[t.abs() > 0.1]
    assert 0 < float(rel.max()) <= 2 ** -4
