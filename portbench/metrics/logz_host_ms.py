"""Host ms a traced step in the Monte Carlo log Z: the self time of the
span "qhbm.ebm.log_partition" (the uniform draws, their energies and the
log-sum-exp; energies with an exact log Z record nothing)."""

from portbench import spans


def read(ctx):
  return spans.per_step(ctx, ("qhbm.ebm.log_partition",))
