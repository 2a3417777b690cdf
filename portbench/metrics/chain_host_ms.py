"""Host ms a traced step in the GWG chains: the self time of the span
"qhbm.ebm.gwg_step" (one a chain step: the proposal's gradient, the
inverse-CDF draw, the acceptance test, all launched from the host)."""

from portbench import spans


def read(ctx):
  return spans.per_step(ctx, ("qhbm.ebm.gwg_step",))
