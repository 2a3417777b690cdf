"""Host ms a traced step in the sampler: the self time of the span
"qhbm.ebm.sample" (the EBM's draws and their deduplication to the top
rows), without its wait for the unique count (`sync_wait_ms`)."""

from portbench import spans


def read(ctx):
  return spans.per_step(ctx, ("qhbm.ebm.sample",))
