"""K5's `qubit_transitions`: the batch-summed 2 x 2 transitions of a 1q
segment's qubits."""

WRAPPER = ("qhbmlib_tpu_torch.ops.hopper_adjoint", "qubit_transitions")


def work(a):
  # conj(l) a per amplitude (8 flops with its sums) and, per qubit, two
  # complex multiply-adds per pair and the diagonal's add (10 an
  # amplitude); the four planes read once, Q x 8 floats written.
  amps = a["l_re"].numel()
  qubits = len(a["qubits"])
  return {"flops": (8 + 10 * qubits) * amps, "bytes": 16 * amps + 32 * qubits,
          "rate": "fp32"}
