"""Parameter-shift differentiation in the circuit IR (port of
`qhbmlib_tpu/ops/shift.py`).

Every gate of the IR is ``phase * exp(-i*phi/2 * G)`` with an involution
generator ``G`` and ``phi = angle_scale(kind) * param``, so the exact
two-point rule applies:

    dE/dphi = (E(phi + pi/2) - E(phi - pi/2)) / 2.

The plan is one static circuit and a batch of per-gate angle offsets, one
row a shifted evaluation; `hopper_sv.apply_circuit_shifted` evolves every
row of such a batch through the batched forward's kernels at once.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from qhbmlib_tpu_torch import device as device_lib
from qhbmlib_tpu_torch.ops import adjoint
from qhbmlib_tpu_torch.ops import circuit_ir as ir


def shift_plan(
    circuit: ir.Circuit) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Static plan for parameter-shift gradients of a circuit.

  Returns:
    offsets: [2*P, num_gates] float32; row r is the angle-offset vector of
      shifted evaluation r (P = parameterized gate occurrences; a gate of
      angle scale 0, GPHASE, has none).
    weights: [2*P] float32; dE/d(symbol) = sum_r weights[r] * E_r with the
      whole chain-rule factor folded in, the gate's coeff included
      (weights[r] = sign * scale / 2 * gate.coeff).
    slots: [2*P] int32; the symbol slot each evaluation contributes to.
  """
  num_gates = circuit.num_gates
  rows, weights, slots = [], [], []
  for g_idx in circuit.parameterized_gate_indices():
    gate = circuit.gates[g_idx]
    scale = gate.angle_scale  # dphi/dparam, phi the rotation angle
    if scale == 0.0:  # GPHASE: no expectation depends on it
      continue
    # Shift the resolved angle by +/- (pi/2)/scale: phi moves by +/- pi/2.
    delta = (np.pi / 2.0) / scale
    for sign in (+1.0, -1.0):
      row = np.zeros([num_gates], np.float32)
      row[g_idx] = sign * delta
      rows.append(row)
      weights.append(sign * 0.5 * scale * gate.coeff)
      slots.append(gate.slot)
  if not rows:
    return (np.zeros([0, num_gates], np.float32), np.zeros([0], np.float32),
            np.zeros([0], np.int32))
  return (np.stack(rows), np.asarray(weights, np.float32),
          np.asarray(slots, np.int32))


def row_chunk(n: int, rows: int, states_per_row: int, device) -> int:
  """Shifted rows a chunk: the states `adjoint.auto_chunk` gives a batch
  of rows * states_per_row n-qubit states (nothing kept between chunks)
  on `device`'s free memory, in whole rows; 1 to `rows`."""
  states = adjoint.auto_chunk(n, rows * states_per_row,
                              adjoint.free_bytes(device), False)
  return max(1, min(rows, states // states_per_row))


def shift_gradient(circuit: ir.Circuit,
                   eval_fn: Callable[[np.ndarray], torch.Tensor],
                   num_symbols: int, chunk: Optional[int] = None,
                   states_per_row: int = 1, device=None) -> torch.Tensor:
  """Parameter-shift gradient of a scalar-valued circuit evaluation.

  Args:
    circuit: static circuit IR.
    eval_fn: maps a chunk of offset rows [c, num_gates] (host float32) to
      the c scalar estimates [c] on `device`, row r evaluated with
      angle_offsets = rows[r].
    num_symbols: length of the gradient.
    chunk: rows a call of eval_fn; None sizes it from the free memory
      (`row_chunk`, `states_per_row` states a row).
    device: where the gradient lands (None means the CUDA card).

  Returns:
    [num_symbols] float32 gradient d(eval)/d(symbol values): the
    evaluations times their weights, scatter-added into their slots.
  """
  device = device_lib.resolve(device)
  offsets, weights, slots = shift_plan(circuit)
  grad = torch.zeros([num_symbols], dtype=torch.float32, device=device)
  total = offsets.shape[0]
  if total == 0:
    return grad
  if chunk is None:
    chunk = row_chunk(circuit.num_qubits, total, states_per_row, device)
  chunk = max(1, min(total, int(chunk)))
  w = torch.from_numpy(weights).to(device)
  s = torch.from_numpy(slots.astype(np.int64)).to(device)
  for lo in range(0, total, chunk):
    evals = eval_fn(offsets[lo:lo + chunk])
    grad.index_add_(0, s[lo:lo + chunk], evals.to(torch.float32) *
                    w[lo:lo + chunk])
  return grad
