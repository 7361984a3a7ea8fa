"""Per-layer metrics, one reader a file, found by the metric's name in
``BENCHMARK.json``: ``<name>.py``'s ``read(run)`` takes the run's
``harness.RunData`` and returns the value in the metric's unit, or None
where the run holds nothing to read (the harness then leaves the metric
out of the result line)."""
