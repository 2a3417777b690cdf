"""Host ms a traced step in the batched forward: the self time of the
spans "qhbm.sv.prepare_segments" (the host folds of the operators, their
one copy, the rotation planes) and "qhbm.sv.stages" (the stages'
launches)."""

from portbench import spans


def read(ctx):
  return spans.per_step(ctx, ("qhbm.sv.prepare_segments", "qhbm.sv.stages"))
