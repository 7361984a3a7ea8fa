"""model: device busy time (the union of every device operation's
interval over the traced run) per frame served, in ms."""


def read(run):
    if run.timeline is None or not run.frames:
        return None
    return 1e3 * run.timeline.busy_s() / run.frames
