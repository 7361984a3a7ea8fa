"""engine: the 95th percentile, over the frames dispatched in the traced
window, of their wait from arrival to dispatch (the engine's ``job``
spans, ``spans.EngineSpans``), in ms."""


def read(run):
    spans = getattr(run, "spans", None)
    if spans is None:
        return None
    return spans.queue_wait_p95_ms()
