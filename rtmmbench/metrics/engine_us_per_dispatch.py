"""engine: the engine's own time around its calls (the ``engine.decide``
and ``engine.after`` spans in the traced window: poll, hygiene, drop,
MapScore, the variant; re-dispatch check, accounting, cascade triggers)
per dispatch, in us."""


def read(run):
    spans = getattr(run, "spans", None)
    if spans is None:
        return None
    return spans.engine_us_per_dispatch()
