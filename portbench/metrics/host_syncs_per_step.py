"""Times a traced step at which the program's host waits for the device:
the calls of every "qhbm.sync.<site>" span."""

from portbench import spans


def read(ctx):
  return spans.per_step(ctx, field="calls", prefix=spans.SYNC)
