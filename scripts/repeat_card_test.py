#!/usr/bin/env python3
"""Run one card test many times, alone and inside its whole file, and
count the failures (for a test that fails now and then).

    python3 scripts/repeat_card_test.py NODEID [--alone N] [--in-file M]

Each run is a fresh ``python -m pytest -q --noconftest -m cuda`` process
from the repo root (``PYTHONPATH=src``): ``--alone`` runs of NODEID by
itself, then ``--in-file`` runs of NODEID's whole file. A failing run's
output (the assertion and what it held) is printed in full; the last line
is one JSON object with the counts.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(target: str, keyword: str | None = None) -> tuple[int, str]:
    cmd = [sys.executable, "-m", "pytest", "-q", "--noconftest", "-m", "cuda",
           "-p", "no:cacheprovider", target]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=900)
    return out.returncode, out.stdout + out.stderr


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("nodeid")
    ap.add_argument("--alone", type=int, default=50)
    ap.add_argument("--in-file", type=int, default=3)
    args = ap.parse_args()
    file = args.nodeid.split("::")[0]
    counts = {"nodeid": args.nodeid, "alone_runs": 0, "alone_failed": 0,
              "file_runs": 0, "file_failed_runs": 0,
              "file_nodeid_failed": 0}
    t0 = time.perf_counter()
    for i in range(args.alone):
        rc, out = run(args.nodeid)
        counts["alone_runs"] += 1
        if rc != 0:
            counts["alone_failed"] += 1
            print(f"--- alone run {i}: exit {rc}\n{out}", flush=True)
    for i in range(args.in_file):
        rc, out = run(file)
        counts["file_runs"] += 1
        if rc != 0:
            counts["file_failed_runs"] += 1
            hit = args.nodeid.split("::", 1)[1] in out
            counts["file_nodeid_failed"] += int(hit)
            print(f"--- file run {i}: exit {rc}\n{out[-6000:]}", flush=True)
        else:
            print(f"--- file run {i}: {out.strip().splitlines()[-1]}",
                  flush=True)
    counts["seconds"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(counts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
