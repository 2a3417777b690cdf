"""Adjoint-differentiated batched expectations.

Port of `qhbmlib_tpu/ops/adjoint.py::batched_expectations` along the branch
the grid-over-batch Pallas kernels take (`_bt_fwd` / `_bt_bwd` under
`_use_pallas_batched`, :380-454):

  forward:  psi_b = U |b> for every bitstring b (`hopper_sv`, K4), then
            the per-term expectations <psi_b|P_t|psi_b>; psi is the residual.
  backward: lambda_b = sum_t g_bt P_t psi_b (`apply_pauli_sum`), then one
            batched reverse sweep (`hopper_adjoint`, K5) gives the
            batch-summed symbol gradient.

The whole batch runs at once (no `batch_chunk`): at 20 qubits and 64 states
the residual planes take 512 MB of device memory.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from qhbmlib_tpu_torch.ops import circuit_ir as ir
from qhbmlib_tpu_torch.ops import hopper_adjoint
from qhbmlib_tpu_torch.ops import hopper_sv
from qhbmlib_tpu_torch.ops import paulis
from qhbmlib_tpu_torch.ops import statevector as sv


def bits_to_rowcol(bits: torch.Tensor, n: int) -> torch.Tensor:
  """[B, n] bitstrings -> [B, 2] (row, col) indices in the [R, C] layout."""
  m = sv.minor_bits(n)
  nr = n - m
  return torch.stack([sv.bits_to_index(bits[:, :nr], nr),
                      sv.bits_to_index(bits[:, nr:], m)], dim=1)


class _BatchedTerms(torch.autograd.Function):
  """[B, T] coefficient-free per-term expectations over a bitstring batch,
  differentiable w.r.t. the symbol values by the adjoint method."""

  @staticmethod
  def forward(ctx, symbol_values, rowcol, circuit, op):
    # One host copy of the values serves both passes: the backward folds
    # its operators from it without waiting on the device.
    values = hopper_sv.host_values(symbol_values)
    psi = hopper_sv.apply_circuit_batched(circuit, values, rowcol)
    terms = sv.expectation_terms(torch.complex(*psi), op)
    ctx.circuit = circuit
    ctx.op = op
    ctx.values = values
    ctx.save_for_backward(*psi)
    return terms

  @staticmethod
  def backward(ctx, g):
    psi_re, psi_im = ctx.saved_tensors
    ones = paulis.PauliSum(ctx.op.codes,
                           torch.ones_like(ctx.op.coeffs, dtype=torch.float32),
                           ctx.op.num_qubits)
    lam = sv.apply_pauli_sum(torch.complex(psi_re, psi_im), ones,
                             term_weights=g)
    grad = hopper_adjoint.adjoint_sweep_batched(
        ctx.circuit, ctx.values, (psi_re, psi_im),
        (lam.real.contiguous(), lam.imag.contiguous()))
    return grad, None, None, None


def batched_expectations(circuit: ir.Circuit, symbol_values: torch.Tensor,
                         init_bits: torch.Tensor,
                         ops: Sequence[paulis.PauliSum]) -> torch.Tensor:
  """Expectations of each op against U|b> for each bitstring b.

  All terms of all ops are concatenated into one PauliSum, so each batch
  costs one batched forward plus one batched reverse sweep however many
  observables are measured.

  Args:
    circuit: static circuit IR (1q dense and diagonal gates).
    symbol_values: [num_symbols] parameters on the device to run on.
    init_bits: [B, n] int bitstrings; each becomes a basis initial state.
    ops: PauliSums to measure.

  Returns:
    [B, len(ops)] float32 expectations, differentiable w.r.t.
    `symbol_values` (adjoint) and each op's coefficients (autograd).
  """
  n = circuit.num_qubits
  big, slices = paulis.concat_ops(tuple(ops), n)
  device = symbol_values.device
  rowcol = bits_to_rowcol(init_bits.to(device), n)
  terms = _BatchedTerms.apply(symbol_values, rowcol, circuit,
                              big.to(device))  # [B, T]
  weighted = terms * big.coeffs.to(device)[None, :]
  return torch.stack([weighted[:, a:b].sum(dim=1) for a, b in slices], dim=1)


def as_pauli_tuple(observables) -> Tuple[paulis.PauliSum, ...]:
  if isinstance(observables, paulis.PauliSum):
    return (observables,)
  return tuple(observables)
