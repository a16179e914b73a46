"""Per-layer metric readers, one module each, found by the ``reader`` a
metric's file names.  ``read(ctx, spec)`` returns the metric's value, or
None where the run gave it nothing to read (the metric is then left out
of the result's line)."""
