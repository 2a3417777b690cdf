"""Metrics on QuantumCircuit models (port of
`qhbmlib_tpu/inference/qnn_utils.py`)."""

from __future__ import annotations

import torch

from qhbmlib_tpu_torch.models import circuit as circuit_model
from qhbmlib_tpu_torch.ops import statevector as sv


def unitary(input_circuit: circuit_model.QuantumCircuit) -> torch.Tensor:
  """Dense (2^n, 2^n) complex64 unitary of the circuit at its current
  parameters, on their device (`statevector.unitary`)."""
  return sv.unitary(input_circuit.pqc, input_circuit.resolved_values())
