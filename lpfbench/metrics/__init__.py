"""One reader per per-layer metric, each in the file named after the
metric: ``read(view) -> float or None`` over a traced run
(``harness.TraceView``).  A reader that finds nothing to read returns
``None`` and the harness leaves the metric out."""
