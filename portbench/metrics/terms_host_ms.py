"""Host ms a traced step in the expectation terms and lambda: the self
time of the spans "qhbm.sv.expectation_terms" and
"qhbm.sv.apply_pauli_sum"."""

from portbench import spans


def read(ctx):
  return spans.per_step(ctx, ("qhbm.sv.expectation_terms",
                              "qhbm.sv.apply_pauli_sum"))
