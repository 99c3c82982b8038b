"""Per-layer metric readers, one file a metric, loaded by the metric's
name (`<name>.py`).  Each has `read(ctx)` and returns the metric's value,
or None where it finds nothing to read (the harness then leaves it out)."""
