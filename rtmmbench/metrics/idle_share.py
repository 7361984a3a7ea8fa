"""device: the share of the traced window (from the first poll to the
first poll past the arrivals' end) in which no device operation ran, in
%."""


def read(run):
    if run.timeline is None:
        return None
    lo, hi = run.timeline.window()
    return 100.0 * (1.0 - run.timeline.busy_s() * 1e9 / (hi - lo))
