"""graphs: the share of the engine's timed model calls (``lat_samples``:
host wall from the prompt's copy to the wait on the stream) in which no
device operation ran: copying in, launching the replay, cloning the logits
out and waiting, in %."""


def read(run):
    wall = run.wall_s()
    if run.timeline is None or wall <= 0:
        return None
    return 100.0 * (1.0 - run.timeline.busy_s() / wall)
