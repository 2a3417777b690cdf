"""Host ms a traced step spent waiting for the device: the inclusive time
of every "qhbm.sync.<site>" span (the host waiting on a busy card, not
the card's idle time)."""

from portbench import spans


def read(ctx):
  return spans.per_step(ctx, field="total_ms", prefix=spans.SYNC)
