"""Circuit-model helpers (numpy-only builders, copied from
`qhbmlib_tpu/models/circuit_utils.py` so the port needs no jax).

The reference's `bit_circuit` (X^b state injection, reference:
qhbmlib/models/circuit_utils.py:23-29) is unnecessary in the TPU-native
engine: basis initial states are written directly into the statevector
(ops.statevector.basis_state).  The builders here construct common ansatze in
the array-native IR.
"""

from __future__ import annotations


from qhbmlib_tpu_torch.ops import circuit_ir as ir


def bit_circuit(num_qubits: int, name: str = "bit_circuit") -> ir.Circuit:
  """X^b state-injection circuit with one exponent symbol per qubit.

  Provided for API parity with the reference; the engine's fast path uses
  `basis_state` instead of simulating these gates.
  """
  b = ir.CircuitBuilder(num_qubits)
  for q in range(num_qubits):
    b.xp(q, f"{name}_bit_{q}")
  return b.build()


def hardware_efficient_ansatz(num_qubits: int,
                              num_layers: int,
                              name: str = "p") -> ir.Circuit:
  """X^a Z^b rotation layers + brick-wall CZ^a entanglers.

  Mirrors the reference baseline ansatz (reference: baselines/pqc.py:21-63):
  each layer applies parameterized X- and Z-power rotations on every qubit,
  then parameterized CZ entanglers on even pairs then odd pairs.
  """
  b = ir.CircuitBuilder(num_qubits)
  for layer in range(num_layers):
    for q in range(num_qubits):
      b.xp(q, f"{name}_x_{layer}_{q}")
    for q in range(num_qubits):
      b.zp(q, f"{name}_z_{layer}_{q}")
    if num_qubits > 1:
      for q in range(0, num_qubits - 1, 2):
        b.cz(q, q + 1, f"{name}_cz_e_{layer}_{q}")
      for q in range(1, num_qubits - 1, 2):
        b.cz(q, q + 1, f"{name}_cz_o_{layer}_{q}")
  return b.build()


def rx_ansatz(num_qubits: int, name: str = "phi") -> ir.Circuit:
  """One RX rotation per qubit (the closed-form test fixture ansatz;
  reference: tests/inference/vqt_loss_test.py:154-160)."""
  b = ir.CircuitBuilder(num_qubits)
  for q in range(num_qubits):
    b.rx(q, f"{name}_{q}")
  return b.build()
