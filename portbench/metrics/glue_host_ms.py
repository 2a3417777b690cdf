"""Host ms a traced step in the QNN and batch glue: the self time of the
spans "qhbm.qnn.expectation" (the QNN's batched call), "qhbm.adjoint.plan"
(the chunk plan, `cudaMemGetInfo`), "qhbm.adjoint.forward" and
"qhbm.adjoint.backward" (the batched terms' autograd Function, chunk by
chunk), without the layers and waits inside them."""

from portbench import spans


def read(ctx):
  return spans.per_step(ctx, ("qhbm.qnn.expectation", "qhbm.adjoint.plan",
                              "qhbm.adjoint.forward",
                              "qhbm.adjoint.backward"))
