"""model: the served calls' model operations (``counts.call_counts``) over
their summed host walls at the bf16 peak (989 TFLOP/s), in %."""
from ..counts import PEAK_FLOPS


def read(run):
    wall = run.wall_s()
    if wall <= 0:
        return None
    return 100.0 * run.call_flops() / (wall * PEAK_FLOPS)
