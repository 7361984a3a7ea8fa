"""The benchmark of the PyTorch/CUDA serving port (``repro_torch``): DREAM's
multi-model real-time serving engine driven by seeded frame traffic, with
every model at its published widths.

One command runs one cell (a configuration under a traffic mix, both named
in ``BENCHMARK.json`` at the root of the checkout):

    python3 -m rtmmbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by its name: ``configs/<config>.json``,
``traffic/<traffic>/<config>.json`` and ``metrics/<metric>.py``; so is a
served model's plain reference, ``reference/<module>.py``, which its entry
in the configuration names (``reference/model.py`` where it names none).
"""
from __future__ import annotations

import sys
from pathlib import Path

#: the root of the checkout, and the program's sources under it
ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))
