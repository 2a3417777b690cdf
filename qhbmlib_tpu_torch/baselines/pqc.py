"""The harness's hardware-efficient ansatz (port of `baselines/pqc.py`)."""

from __future__ import annotations

from qhbmlib_tpu_torch.models import circuit_utils
from qhbmlib_tpu_torch.ops import circuit_ir as ir


def get_hardware_efficient_model_unitary(num_qubits: int, num_layers: int,
                                         name: str) -> ir.Circuit:
  """X^a Z^b rotations on every qubit, then CZ^a entanglers on the even,
  then the odd pairs, `num_layers` times; symbols prefixed by `name`."""
  return circuit_utils.hardware_efficient_ansatz(num_qubits, num_layers,
                                                 name=name)
