"""GWG chain steps a traced step: the calls of the span
"qhbm.ebm.gwg_step", ceil(draws / chains) where the train step threads
the chain; a burn-in run inside the step would add its steps."""

from portbench import spans


def read(ctx):
  return spans.per_step(ctx, ("qhbm.ebm.gwg_step",), field="calls")
