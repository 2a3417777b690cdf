"""The program's spans a traced step, for the metrics that read them.

The port keeps totals of its "qhbm.*" spans (`qhbmlib_tpu_torch.tracing`)
only while a torch profiler records, so in a run they cover the harness's
traced steps alone.  A program without those spans reads None, as does a
run without a trace."""

from __future__ import annotations

try:
  from qhbmlib_tpu_torch import tracing
except ImportError:  # a program that has no spans
  tracing = None

SYNC = "qhbm.sync."


def per_step(ctx, names=(), field: str = "self_ms", prefix=None):
  """The sum of `field` ("calls", "total_ms" or "self_ms") over the spans
  named in `names` or whose names start with `prefix`, over the traced
  steps; None without a trace or where those spans have no calls."""
  if ctx.trace is None or tracing is None:
    return None
  rows = [row for name, row in tracing.totals().items()
          if name in names or (prefix is not None and name.startswith(prefix))]
  if not sum(row["calls"] for row in rows):
    return None
  return sum(row[field] for row in rows) / ctx.trace["steps"]
