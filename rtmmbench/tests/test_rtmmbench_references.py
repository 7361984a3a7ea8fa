"""Each model's reference module, as its configuration names it: the
committed configurations resolve to ``reference.model`` and lay out, draw
and count as that module does; an entry naming a missing module, or one
without the whole contract, fails at set-up before any weights are drawn,
naming the entry."""
from __future__ import annotations

import json
import math
import sys
import time
import types

import pytest
import torch

from rtmmbench import counts, harness, weights
from rtmmbench.reference import model as ref
from rtmmbench.tests import tiny

torch.set_num_threads(1)

BENCH = harness.load_benchmark()
CONFIGS = [c["name"] for c in BENCH["configs"]]
SEED = 2**31 + 211


def _published(name: str) -> dict:
    return json.loads(harness.config_file(BENCH, name).read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_committed_configurations_resolve_to_model(name):
    c = _published(name)
    refs = harness.references(c)
    models, _ = harness.served_models(c)
    assert set(refs) == set(models)
    assert all(r is ref for r in refs.values())


@pytest.mark.parametrize("width", ["tiny", "published"])
@pytest.mark.parametrize("name", CONFIGS)
def test_plan_is_the_model_layout_enumerated(name, width):
    """The same leaves in the same order at the same offsets as
    ``reference.model.param_layout`` gives them, leaf after leaf aligned to
    ``weights.ALIGN`` in its buffer: the buffers a seed fills are the same
    bytes."""
    c = tiny.config(name) if width == "tiny" else _published(name)
    models = {r: c[r]["config"] for r in c["serves"]}
    leaves, n_compute, n_fp32 = weights.plan(models, harness.references(c))
    want, ends = [], {True: 0, False: 0}
    for model, cfg in models.items():
        for path, shape, kind, fan_in in ref.param_layout(cfg):
            compute = kind in ref.COMPUTE_KINDS
            want.append((model, tuple(path), tuple(shape), kind, fan_in,
                         ends[compute], compute))
            end = ends[compute] + math.prod(shape)
            ends[compute] = -(-end // weights.ALIGN) * weights.ALIGN
    got = [(x.model, x.path, x.shape, x.kind, x.fan_in, x.offset, x.compute)
           for x in leaves]
    assert got == want
    assert (n_compute, n_fp32) == (ends[True], ends[False])


@pytest.mark.parametrize("name", CONFIGS)
def test_run_data_counts_are_the_counts_of_counts_py(name):
    """``RunData``'s operations and kernel bounds, each model's through its
    module, equal ``counts.py``'s at published widths and frame lengths."""
    c = _published(name)
    cell = next(w for w in BENCH["workloads"] if w["config"] == name)
    mix = json.loads(harness.traffic_file(cell["traffic"], name).read_text())
    models, _ = harness.served_models(c)
    seq = {m: harness.stream_seq(mix, c, m) for m in models}
    calls = {m: i + 3 for i, m in enumerate(models)}
    run = harness.RunData(None, models, seq, calls, {}, sum(calls.values()),
                          harness.references(c))
    assert run.call_flops() == sum(
        n * counts.call_counts(models[m], seq[m])["flops"]
        for m, n in calls.items())
    for kernel in ("flash", "gmm", "ssd"):
        want = 0.0      # added in turn, as the readers always summed
        for m, n in calls.items():
            want += n * (counts.kernel_bound_s(models[m], seq[m], kernel)
                         or 0.0)
        assert run.kernel_bound_s(kernel) == want


def _partial_module(monkeypatch) -> str:
    """A reference module with every function of the contract but
    ``forward``."""
    mod = types.ModuleType("rtmmbench.reference.partial")
    for fn in harness.CONTRACT:
        if fn != "forward":
            setattr(mod, fn, getattr(ref, fn))
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return "partial"


@pytest.mark.parametrize("case,message", [
    ("missing", r"speech: no reference module 'no_such_module'"),
    ("no_forward", r"speech: reference module 'partial' lacks forward")])
def test_a_bad_reference_fails_at_set_up_naming_the_entry(
        monkeypatch, case, message):
    c = tiny.config("rtmm_audio")
    c["speech"]["reference"] = (_partial_module(monkeypatch)
                                if case == "no_forward" else "no_such_module")

    def drawn(*args, **kwargs):
        raise AssertionError("weights drawn before the reference check")
    monkeypatch.setattr(weights, "make", drawn)
    with pytest.raises(ValueError, match=message):
        harness.run_cell("audio.steady", SEED, 0.5, False,
                         torch.device("cpu"), time.perf_counter(), config=c,
                         mix=tiny.mix("rtmm_audio"))
