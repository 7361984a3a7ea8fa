"""Arrival processes and trace replay for the serving engine's request queue
(the part of ``repro.scenarios`` that ``serving.engine`` consumes)."""
from .arrivals import (ArrivalProcess, BurstyOnOff, Diurnal,  # noqa: F401
                       Periodic, PeriodicJitter, Poisson, Triggered,
                       arrival_from_config, arrival_kinds, legacy_phase)
from .trace import (Trace, TraceRecorder, dumps, load_trace,  # noqa: F401
                    loads)
