"""Batched sweeps a traced step that stopped at their last reduction: the
calls of the span "qhbm.adjoint.trim_tail", one for each sweep whose
un-apply past that reduction (or whose stages past it) were dropped.  A
sweep ending on a flip gate with a symbol has nothing to drop, and a
program without the span reads None."""

from portbench import spans


def read(ctx):
  return spans.per_step(ctx, ("qhbm.adjoint.trim_tail",), field="calls")
