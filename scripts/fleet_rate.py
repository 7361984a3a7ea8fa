#!/usr/bin/env python3
"""Times the port's fleet simulator beside the JAX package's on one host.

    PYTHONPATH=src python3 scripts/fleet_rate.py

Runs ``chip_smoke.py``'s phase-14 headline fleet (16 nodes plus one joining
and one draining, 200 streams, 2.5 s simulated, ``score``) and its scale arm
(256 nodes, 10 000 streams, 0.6 s) through ``repro.cluster`` and
``repro_torch.cluster`` in turns (reference, port, port, reference), on
scenarios each package builds itself. Both packages are numpy on
the host; ``repro.cluster`` imports no JAX. Prints each run's wall seconds
and simulated stream-seconds per wall second beside the host's CPU model,
and fails unless the two packages' UXCost and frames are equal.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402


def run(cl, arm: str):
    if arm == "headline":
        h = cs.FLEET_HEADLINE
        scn = cs.build_fleet(cl, **h)
        kw = dict(duration_s=h["duration_s"], seed=h["seed"])
    else:
        sc = cs.SCALE_ARM
        scn = cs.build_scale_fleet(cl, **sc)
        kw = dict(duration_s=sc["duration_s"], seed=sc["seed"],
                  rebalance_every_s=10.0 * sc["duration_s"])
    fs = cl.FleetSimulator(scn, "score", **kw)
    w0 = time.perf_counter()
    r = fs.run()
    return r, time.perf_counter() - w0


def main() -> int:
    import repro.cluster as ref
    import repro_torch.cluster as port
    pkgs = {"reference": ref, "port": port}
    cpu = cs.host_cpu()
    for arm in ("headline", "scale"):
        seen = {}
        for name in ("reference", "port", "port", "reference"):
            r, wall = run(pkgs[name], arm)
            seen.setdefault(name, []).append((r.uxcost, r.frames))
            cs.log(f"[fleet_rate] {arm} {name}: wall={wall:.4f} s "
                   f"stream_s={r.stream_seconds} stream_s_per_wall_s="
                   f"{r.stream_seconds / wall:.1f} UXCost={r.uxcost} "
                   f"frames={r.frames} (host seconds on {cpu})")
        if len(set(seen["reference"] + seen["port"])) != 1:
            raise AssertionError(f"{arm}: the packages differ: {seen}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
