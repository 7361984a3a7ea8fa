"""Hot-loop profiler: per-event-kind wall-time and count accounting (copy of
``repro/obs/profiler.py``).

The simulator's hot path is ``Simulator.step`` → ``_process_event`` →
``_drain_schedule``; the fleet adds its own handler dispatch on top.
:class:`HotLoopProfiler` meters both with two ``time.perf_counter`` reads
per block — and costs *nothing* when disabled, because the instrumented
call sites guard with ``if profiler is not None`` (no wrapper objects, no
no-op calls on the disabled path).  This is the ROADMAP "raw speed"
measurement baseline: before vectorizing the fleet hot path one needs to
know where the wall-clock actually goes, and after, one needs
``streams_per_wall_s`` to prove the win.

Wall-clock readings are *host-side* observations: they never touch
simulated time, RNG, or any scheduling decision, so profiling preserves
bit-exact results by construction (asserted by the obs test-suite).

Keys are free-form strings; the convention is ``node.<event>`` for
per-node simulator events (``arrival``/``done``/``window``/``phase``/
``inject``/``drain``) and ``fleet.<event>`` for fleet-level handlers
(``stream``/``place``/``tune``/``slo``/...).
"""
from __future__ import annotations

import time
from typing import Optional


class HotLoopProfiler:
    """Accumulates wall seconds and call counts per key.

    Usage at an instrumented site (hot path — keep the guard inline)::

        if prof is not None:
            _w0 = prof.t0()
        handler(...)
        if prof is not None:
            prof.add("fleet.stream", _w0)
    """

    def __init__(self):
        self.wall_s: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._run_t0: Optional[float] = None
        self.total_wall_s = 0.0

    # ------------------------------------------------------------ metering
    @staticmethod
    def t0() -> float:
        return time.perf_counter()

    def add(self, key: str, t0: float) -> None:
        dt = time.perf_counter() - t0
        self.wall_s[key] = self.wall_s.get(key, 0.0) + dt
        self.counts[key] = self.counts.get(key, 0) + 1

    def start_run(self) -> None:
        """Mark the start of the overall run window (idempotent)."""
        if self._run_t0 is None:
            self._run_t0 = time.perf_counter()

    def stop_run(self) -> None:
        """Close the overall run window; accumulates across start/stop."""
        if self._run_t0 is not None:
            self.total_wall_s += time.perf_counter() - self._run_t0
            self._run_t0 = None

    # ------------------------------------------------------------ results
    def streams_per_wall_s(self, stream_seconds: float) -> float:
        """Simulated stream-seconds advanced per wall-clock second —
        the throughput figure of merit for the vectorization work
        (0.0 when no wall window was recorded)."""
        return stream_seconds / self.total_wall_s if self.total_wall_s \
            else 0.0

    def top(self, n: int = 10) -> list[tuple[str, float, int]]:
        """Top-``n`` keys by accumulated wall time:
        ``(key, wall_s, count)``."""
        rows = sorted(self.wall_s.items(), key=lambda kv: -kv[1])[:n]
        return [(k, w, self.counts.get(k, 0)) for k, w in rows]

    def table(self, n: int = 10) -> str:
        """Human-readable "where the wall-clock goes" table."""
        rows = self.top(n)
        if not rows:
            return "(no profile samples)"
        metered = sum(self.wall_s.values())
        lines = [f"{'key':<24} {'wall_s':>10} {'count':>9} "
                 f"{'us/call':>9} {'share':>7}"]
        for key, wall, count in rows:
            us = wall / count * 1e6 if count else 0.0
            share = wall / metered if metered else 0.0
            lines.append(f"{key:<24} {wall:>10.4f} {count:>9d} "
                         f"{us:>9.1f} {share:>6.1%}")
        lines.append(f"{'(metered total)':<24} {metered:>10.4f}"
                     + (f"   of {self.total_wall_s:.4f}s run wall"
                        if self.total_wall_s else ""))
        return "\n".join(lines)

    def snapshot(self) -> dict:
        """JSON-serializable dump for artifacts / ``scripts/report.py``."""
        return {
            "total_wall_s": self.total_wall_s,
            "keys": {k: {"wall_s": self.wall_s[k],
                         "count": self.counts.get(k, 0)}
                     for k in sorted(self.wall_s)},
        }
