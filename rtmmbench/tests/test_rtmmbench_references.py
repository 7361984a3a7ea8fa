"""Each model's reference module, as its configuration names it: the
committed configurations resolve to the modules their entries name
(``reference.model`` for each) and lay out, draw and count as those modules
do (``reference_checks``), with their weights, plans and tiny stand-ins
pinned byte for byte; an entry naming a missing module, or one without
the whole contract, fails at set-up before any weights are drawn, naming
the entry."""
from __future__ import annotations

import hashlib
import json
import sys
import time
import types

import pytest
import torch

from rtmmbench import counts, harness, weights
from rtmmbench.reference import model as ref
from rtmmbench.tests import reference_checks, tiny

torch.set_num_threads(1)

BENCH = harness.load_benchmark()
CONFIGS = [c["name"] for c in BENCH["configs"]]
SEED = 2**31 + 211

#: sha256 of each committed configuration's compute and float32 buffers at
#: tiny widths from ``SEED`` on the CPU, of its plan at published widths,
#: and of its tiny stand-ins (``tiny.config``, cut and ``keep_depth``):
#: none moves while the committed cells' weights and rehearsals stay as
#: they are (a configuration added later is held by the checks alone)
PINNED = {
    "rtmm_vision": dict(
        compute="bb066b7524d0ab0b7861448a56d6f7927ea51e6b886d66f4c7693bcebf31f72e",
        fp32="3fea222512d5ad43ac708bd517b844b532410be0ba2ad0c51461cd19b322c296",
        plan="8121e7b4367429b7767b937f0b7cf97bc0915eb9802f72e635e14a22ef3967fd",
        tiny="e4afd03bc94315e5069b5ad206b52e4c3e504504e08b3f3b23845f12cfe66236",
        tiny_keep_depth="f45cb5adf0910fba8ba8e169faf7f7b268a3c8c98c7301d802513f2cb40b8869"),
    "rtmm_audio": dict(
        compute="b7ca6b54a6e42ca0c9efde6c5c21683d1389767bc2d930ff93c555e803554805",
        fp32="1deb7fbc392efdc1b280bdc02c0af0088415c643dababd4f0d3c9f356dd5c93f",
        plan="9c2fe79799ba0812f4760639c9793845820d895dd1e8d48e28bcf9ea2680903d",
        tiny="f36f28120d39732fd5898f078cbd328714e33bc44229bf1f39ea68b5df350e16",
        tiny_keep_depth="69cece181cc2566479ff7763d2c3dbcfd512836ccfb4e090d055eef0e63c056a"),
}


def _published(name: str) -> dict:
    return json.loads(harness.config_file(BENCH, name).read_text())


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@pytest.mark.parametrize("name", CONFIGS)
def test_committed_configurations_resolve_to_model(name):
    """Each served model and variant resolves to the module its entry
    names; an entry that names none, as every committed one, to
    ``reference.model`` itself, whose counts are ``counts.py``'s."""
    c = _published(name)
    reference_checks.check_resolves(c)
    for role in c["serves"]:
        if "reference" not in c[role]:
            assert reference_checks.named_module(c[role]) is ref
    assert ref.call_counts is counts.call_counts


@pytest.mark.parametrize("width", ["tiny", "published"])
@pytest.mark.parametrize("name", CONFIGS)
def test_plan_is_the_model_layout_enumerated(name, width):
    """The same leaves in the same order at the same offsets as each
    model's module's ``param_layout`` and compute kinds give them."""
    reference_checks.check_plan(
        tiny.config(name) if width == "tiny" else _published(name))


@pytest.mark.parametrize("name", CONFIGS)
def test_run_data_counts_are_the_counts_of_counts_py(name):
    """``RunData``'s operations and kernel bounds, each model's through its
    module (``counts.py``'s for an entry naming none), at published widths
    and frame lengths."""
    cell = next(w for w in BENCH["workloads"] if w["config"] == name)
    mix = json.loads(harness.traffic_file(cell["traffic"], name).read_text())
    reference_checks.check_counts(_published(name), mix)


@pytest.mark.parametrize("name", list(PINNED))
def test_committed_weights_are_the_pinned_bytes(name):
    """Both buffers a seed fills at tiny widths, and the plan at published
    widths, are the pinned ones."""
    c = tiny.config(name)
    w = harness.make_weights(c, SEED, torch.device("cpu"),
                             harness.references(c))
    assert _sha(w.compute.view(torch.int16).numpy().tobytes()) \
        == PINNED[name]["compute"]
    assert _sha(w.fp32.numpy().tobytes()) == PINNED[name]["fp32"]
    pub = _published(name)
    leaves, n_compute, n_fp32 = weights.plan(
        {r: pub[r]["config"] for r in pub["serves"]},
        harness.references(pub))
    plan = json.dumps([[x.model, list(x.path), list(x.shape), x.kind,
                        x.fan_in, x.offset, x.compute] for x in leaves]
                      + [n_compute, n_fp32])
    assert _sha(plan.encode()) == PINNED[name]["plan"]


@pytest.mark.parametrize("keep_depth", [False, True])
@pytest.mark.parametrize("name", list(PINNED))
def test_committed_tiny_stand_ins_are_pinned(name, keep_depth):
    """The committed configurations' tiny stand-ins, key for key, are the
    pinned ones: their modules give no ``TINY`` depth, so the cut of each
    model's family holds."""
    c = tiny.config(name, keep_depth=keep_depth)
    key = "tiny_keep_depth" if keep_depth else "tiny"
    assert _sha(json.dumps(c, sort_keys=True).encode()) == PINNED[name][key]


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
