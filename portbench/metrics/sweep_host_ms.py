"""Host ms a traced step in the batched sweep: the self time of the spans
"qhbm.adjoint.prepare_backward" (the host folds of the inverse operators),
"qhbm.adjoint.sweep_stages" (the stages' launches) and
"qhbm.adjoint.assemble" (the gradient algebra on the reductions), without
the waits for the reductions and the gradient's copy."""

from portbench import spans


def read(ctx):
  return spans.per_step(ctx, ("qhbm.adjoint.prepare_backward",
                              "qhbm.adjoint.sweep_stages",
                              "qhbm.adjoint.assemble"))
