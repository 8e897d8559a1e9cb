"""Per-layer metric readers, one module a metric, found by the metric's
name in BENCHMARK.json. Each defines ``read(run) -> float | None``: it takes
its number from the run's trace (``run["events"]``, `portbench.trace`),
counters (``run["counters"]``) or work (``run["bound_s"]``), and returns
None where it finds nothing to read, so the metric is left out of the
result line."""
