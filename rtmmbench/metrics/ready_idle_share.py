"""engine: the share of the traced window in which no device operation
runs while at least one frame waits (the union of the frames' queue
segments from the engine's ``job`` spans, ``spans.EngineSpans``, against
the device's idle gaps), in %. The rest of ``idle_share`` is offered
load."""


def read(run):
    spans = getattr(run, "spans", None)
    if spans is None:
        return None
    return spans.ready_idle_share()
