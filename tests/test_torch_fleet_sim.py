"""The port's fleet simulator (``repro_torch.cluster.fleet``) against the
JAX package's (``repro.cluster.fleet``), live, on the same inputs.

* the fast path, port against reference: the six scenario kinds of
  ``tests/test_vectorized_equiv.py`` at seeds 3 and 11, and the seven
  fuzzed split seeds at which the reference's scalar oracle disagrees with
  its own fast path: every field of the result, the final placements and
  the trace bytes;
* the scalar path (``EngineConfig("scalar")`` fleet-wide), port against
  port: equal to the port's fast path on all of those runs;
* the reference's stale scalar fleet clock, shown at split seed 38014;
* the seven golden traces of ``tests/golden/``, replayed through both;
* traces recorded by one package replayed in the other.

Every comparison is exact (``plain`` from ``tests/_torch_sim_parity.py``
keeps float bits and dict order). The scenarios are built by each
package's own ``FleetScenarioBuilder`` from ``test_vectorized_equiv``'s
constructions. Seeds are fixed: no ``hypothesis`` database is read or
written.
"""
import functools
import json
import os
import types

import pytest

import repro.cluster as ref_cluster
import repro.core.engine as ref_engine
import repro_torch.cluster as port_cluster
import repro_torch.core.engine as port_engine
import test_vectorized_equiv as equiv
from _torch_sim_parity import plain

PKGS = {"ref": (ref_cluster, ref_engine), "port": (port_cluster, port_engine)}
KINDS = equiv.KINDS
#: fuzzed ``kind="split"`` seeds at which the reference's scalar run
#: differs from its fast run (ROADMAP, reference facts)
SPLIT_SEEDS = (38014, 54810, 7747, 57168, 10165, 28128, 56747)
CASES = ([(k, s) for k in KINDS for s in (3, 11)]
         + [("split", s) for s in SPLIT_SEEDS])
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
with open(os.path.join(GOLDEN_DIR, "manifest.json")) as _f:
    MANIFEST = json.load(_f)

#: the names ``equiv.build_scenario`` reads from ``repro.cluster``
_BUILDER_NAMES = ("FleetScenarioBuilder", "FuzzSpec", "CascadeFuzz",
                  "SLOFuzz", "LifecycleFuzz", "GenAIFuzz", "TransferModel")


def build_scenario(pkg: str, kind: str, seed: int):
    """``test_vectorized_equiv.build_scenario`` with the builder names bound
    to package ``pkg``'s: (FleetScenario, FleetSimulator kwargs)."""
    cl, f = PKGS[pkg][0], equiv.build_scenario
    g = dict(f.__globals__)
    g.update({n: getattr(cl, n) for n in _BUILDER_NAMES})
    return types.FunctionType(f.__code__, g, f.__name__,
                              f.__defaults__)(kind, seed)


def placements(fs) -> dict:
    return {"stream_node": plain(dict(fs.stream_node)),
            "stage_node": plain(dict(fs.stage_node))}


def result_of(pkg: str, r, fs) -> dict:
    """Every field of a ``FleetResult`` (the trace as its bytes) and the
    final placement maps: ``run_fingerprint``'s fields and the rest."""
    out = {f: plain(getattr(r, f)) for f in r.__dataclass_fields__
           if f != "trace"}
    out["trace_bytes"] = PKGS[pkg][0].dumps(r.trace)
    out.update(placements(fs))
    return out


@functools.lru_cache(maxsize=None)
def live(pkg: str, kind: str, seed: int, engine: str = "soa") -> dict:
    """One recorded run of ``kind`` at ``seed`` in ``pkg`` on ``engine``."""
    cl, eng = PKGS[pkg]
    fscn, kw = build_scenario(pkg, kind, seed)
    policy = kw.pop("policy")
    fs = cl.FleetSimulator(fscn, policy, engine=eng.EngineConfig(engine),
                           **kw)
    return result_of(pkg, fs.run(), fs)


def replay(pkg: str, text: str) -> dict:
    """Replay trace ``text`` in ``pkg``: what a replay reproduces."""
    cl = PKGS[pkg][0]
    fs = cl.FleetSimulator(replay=cl.loads(text))
    r = fs.run()
    out = {f: plain(getattr(r, f)) for f in (
        "uxcost", "frames", "dlv_rate", "norm_energy", "stream_seconds",
        "pipeline_latency_s", "pipe_frames", "migrations", "departures",
        "jobs_purged", "swaps", "rejections", "tier_dlv", "weights",
        "drops", "xfer_energy_j")}
    out.update(placements(fs))
    return out


# ---------------------------------------------------------------------------
# fast path: port against reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,seed", CASES)
def test_fast_path_equals_reference(kind, seed):
    ref, port = live("ref", kind, seed), live("port", kind, seed)
    assert port["frames"] > 0
    assert port == ref


def test_scenarios_built_by_each_package_are_equal():
    for kind in KINDS:
        a, b = (build_scenario(p, kind, 3) for p in ("ref", "port"))
        assert a[0].to_config() == b[0].to_config()
        assert plain(a[1]) == plain(b[1])


# ---------------------------------------------------------------------------
# scalar path: port against port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,seed", CASES)
def test_scalar_engine_equals_fast_path(kind, seed):
    assert live("port", kind, seed, "scalar") == live("port", kind, seed)


def test_reference_scalar_clock_is_stale_at_split_seed_38014():
    """The reference's scan fleet clock (``lazy_peek=False``) steps nodes
    through ``sim.step()`` in ``_interleave_to_scan``
    (``src/repro/cluster/fleet.py:818``), then ``_advance_all_scan``
    (``:752``) calls ``FleetNode.advance_to(t)`` on every node, which pops
    nothing and so skips its refresh (``src/repro/cluster/node.py:128-134``):
    the router reads each stepped node's ``recent_dlv`` and telemetry memo
    as they stood at its last placement. The lazy arm refreshes the nodes
    it stepped. The port's scan clock refreshes them too, so its scalar run
    equals the fast path of both packages, and only the reference's scalar
    run differs (228 frames against 357)."""
    ref_fast = live("ref", "split", 38014)
    ref_scalar = live("ref", "split", 38014, "scalar")
    port_scalar = live("port", "split", 38014, "scalar")
    assert port_scalar == ref_fast
    assert ref_scalar != ref_fast
    assert (port_scalar["frames"], ref_scalar["frames"]) == \
        (plain(228), plain(357))


def test_lazy_peek_alone_carries_the_fault():
    """At seed 38014 the reference differs only through its fleet clock:
    with the clock's scan arm alone it differs, with every other scalar arm
    on it equals its fast path; the port equals it either way."""
    def run(pkg, **flags):
        cl, eng = PKGS[pkg]
        fscn, kw = build_scenario(pkg, "split", 38014)
        policy = kw.pop("policy")
        fs = cl.FleetSimulator(fscn, policy,
                               engine=eng.EngineConfig("soa", **flags), **kw)
        return result_of(pkg, fs.run(), fs)
    fast = live("ref", "split", 38014)
    assert run("ref", lazy_peek=False) != fast
    others = dict(soa_slab=False, fast_path=False, vectorized_router=False)
    assert run("ref", **others) == fast
    assert run("port", lazy_peek=False) == fast


# ---------------------------------------------------------------------------
# golden traces and traces across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_golden_trace_replays_equal(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.trace.json")) as f:
        text = f.read()
    ref, port = replay("ref", text), replay("port", text)
    assert port == ref
    assert port["frames"] == MANIFEST[name]["frames"]
    assert replay("port", text) == port                 # a second replay


@pytest.mark.parametrize("kind", KINDS)
def test_traces_cross_packages(kind):
    """A trace the reference recorded replays in the port with the live
    result, and the port's replays in the reference; both record the same
    bytes."""
    ref, port = live("ref", kind, 3), live("port", kind, 3)
    assert ref["trace_bytes"] == port["trace_bytes"]
    want = {k: ref[k] for k in replay("port", ref["trace_bytes"])}
    assert replay("port", ref["trace_bytes"]) == want
    assert replay("ref", port["trace_bytes"]) == want
