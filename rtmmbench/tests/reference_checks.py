"""What the benchmark takes from each model's reference module, checked
for a whole configuration: each model resolves to the module its entry
names, its weights' plan is that module's layout and compute kinds
enumerated, and ``RunData``'s counts are that module's ``call_counts``.

Each check takes the configuration dict, and ``module_of``, which gives
the module a model entry is held to: ``named_module`` unless a test binds
it to another (to ``reference.model``, which a configuration with a
module of its own has to fail). A failed check raises ``AssertionError``.
"""
from __future__ import annotations

import importlib
import math
from types import ModuleType
from typing import Callable

from rtmmbench import counts, harness, weights
from rtmmbench.reference import model as ref

ModuleOf = Callable[[dict], ModuleType]


def named_module(entry: dict) -> ModuleType:
    """The module model entry ``entry`` names, found apart from the harness:
    ``rtmmbench.reference.<entry["reference"]>``, ``reference.model`` where
    it names none."""
    return importlib.import_module(
        f"rtmmbench.reference.{entry.get('reference', 'model')}")


def _module_of_each(c: dict, module_of: ModuleOf) -> dict[str, ModuleType]:
    """{served model or variant: the module it is held to}, a variant its
    model's."""
    models, _ = harness.served_models(c)
    return {m: module_of(c[harness.base_of(c, m)]) for m in models}


def check_resolves(c: dict, module_of: ModuleOf = named_module) -> None:
    """``harness.references`` gives every served model and variant of ``c``
    the module it is held to, and no other name."""
    refs = harness.references(c)
    want = _module_of_each(c, module_of)
    assert set(refs) == set(want)
    for m, r in refs.items():
        assert r is want[m], (m, r.__name__, want[m].__name__)


def check_plan(c: dict, module_of: ModuleOf = named_module) -> None:
    """``weights.plan`` of ``c``'s served models gives the leaves of each
    model's module's ``param_layout`` in order, each in the buffer its
    module's compute kinds put it in (``reference.model``'s where the
    module defines none), at an offset aligned to ``weights.ALIGN`` after
    the buffer's previous leaf: the buffers a seed fills are the same
    bytes."""
    models = {r: c[r]["config"] for r in c["serves"]}
    leaves, n_compute, n_fp32 = weights.plan(models, harness.references(c))
    want, ends = [], {True: 0, False: 0}
    for model, cfg in models.items():
        mod = module_of(c[model])
        kinds = getattr(mod, "COMPUTE_KINDS", ref.COMPUTE_KINDS)
        for path, shape, kind, fan_in in mod.param_layout(cfg):
            compute = kind in kinds
            want.append((model, tuple(path), tuple(shape), kind, fan_in,
                         ends[compute], compute))
            end = ends[compute] + math.prod(shape)
            ends[compute] = -(-end // weights.ALIGN) * weights.ALIGN
    got = [(x.model, x.path, x.shape, x.kind, x.fan_in, x.offset, x.compute)
           for x in leaves]
    assert got == want
    assert (n_compute, n_fp32) == (ends[True], ends[False])


def check_counts(c: dict, mix: dict,
                 module_of: ModuleOf = named_module) -> None:
    """``RunData.call_flops`` and ``kernel_bound_s`` over some calls of each
    served model at ``mix``'s frame lengths equal the sums of each model's
    module's ``call_counts``, added in the order the readers add them."""
    models, _ = harness.served_models(c)
    mods = _module_of_each(c, module_of)
    seq = {m: harness.stream_seq(mix, c, m) for m in models}
    calls = {m: i + 3 for i, m in enumerate(models)}
    run = harness.RunData(None, models, seq, calls, {}, sum(calls.values()),
                          harness.references(c))
    assert run.call_flops() == sum(
        n * mods[m].call_counts(models[m], seq[m])["flops"]
        for m, n in calls.items())
    for kernel in ("flash", "gmm", "ssd"):
        want = 0.0
        for m, n in calls.items():
            want += n * (counts.kernel_bound_s(models[m], seq[m], kernel,
                                               mods[m].call_counts) or 0.0)
        assert run.kernel_bound_s(kernel) == want, kernel
