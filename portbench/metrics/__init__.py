"""Per-layer metrics, one reader a file: ``read(ctx)`` returns the value
from what the traced run gathered (``portbench.run.Context``), or None
when it finds nothing to read, and the harness then leaves the metric out.
A share of a roofline or a peak is never made up as 0."""
