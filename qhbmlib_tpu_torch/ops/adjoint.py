"""Adjoint-differentiated expectations.

Port of `qhbmlib_tpu/ops/adjoint.py`: `batched_expectations` along the
branch the grid-over-batch Pallas kernels take (`_bt_fwd` / `_bt_bwd` under
`_use_pallas_batched`, :380-454):

  forward:  psi_b = U |b> for every bitstring b (`hopper_sv`, K4 / K1),
            then the per-term expectations <psi_b|P_t|psi_b>; psi is the
            residual.
  backward: lambda_b = sum_t g_bt P_t psi_b (`apply_pauli_sum`), then one
            batched reverse sweep (`hopper_adjoint`, K5) gives the
            batch-summed symbol gradient.

The whole batch runs at once (no `batch_chunk`): at 20 qubits and 64 states
the residual planes take 512 MB of device memory.

`batched_probabilities` runs the same forward and sweep from given states
(not basis states) and measures the computational-basis probabilities
|psi_b|^2; `data/thermal_data.py` measures a Hamiltonian against rho's
eigenvectors with it.

`adjoint_term_expectations` / `expectation` are the per-state API
(:29-48, :308) for one state of any content: the forward is
`statevector.apply_circuit` (K3 on the card for 8 <= n <= 20), the backward
one reverse sweep (K2 there; `reverse_sweep`, the port of
`_xla_reverse_sweep`, is its plain version).
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
  def forward(ctx, symbol_values, rowcol, circuit, op, plain):
    # One host copy of the values serves both passes: the backward folds
    # its operators from it without waiting on the device.
    values = hopper_sv.host_values(symbol_values)
    psi = hopper_sv.apply_circuit_batched(circuit, values, rowcol, plain)
    terms = sv.expectation_terms(torch.complex(*psi), op)
    ctx.circuit = circuit
    ctx.op = op
    ctx.values = values
    ctx.plain = plain
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
        (lam.real.contiguous(), lam.imag.contiguous()), ctx.plain)
    return grad, None, None, None, None


def batched_expectations(circuit: ir.Circuit, symbol_values: torch.Tensor,
                         init_bits: torch.Tensor,
                         ops: Sequence[paulis.PauliSum],
                         plain: bool = False) -> torch.Tensor:
  """Expectations of each op against U|b> for each bitstring b.

  All terms of all ops are concatenated into one PauliSum, so each batch
  costs one batched forward plus one batched reverse sweep however many
  observables are measured.

  Args:
    circuit: static circuit IR (1q dense and diagonal gates).
    symbol_values: [num_symbols] parameters on the device to run on.
    init_bits: [B, n] int bitstrings; each becomes a basis initial state.
    ops: PauliSums to measure.
    plain: run the kernels' plain versions on any device (the precision
      gate's reference arm only).

  Returns:
    [B, len(ops)] float32 expectations, differentiable w.r.t.
    `symbol_values` (adjoint) and each op's coefficients (autograd).
  """
  n = circuit.num_qubits
  big, slices = paulis.concat_ops(tuple(ops), n)
  device = symbol_values.device
  rowcol = bits_to_rowcol(init_bits.to(device), n)
  terms = _BatchedTerms.apply(symbol_values, rowcol, circuit,
                              big.to(device), plain)  # [B, T]
  weighted = terms * big.coeffs.to(device)[None, :]
  return torch.stack([weighted[:, a:b].sum(dim=1) for a, b in slices], dim=1)


class _BatchedProbs(torch.autograd.Function):
  """[B, R, C] probabilities |psi_b|^2 of psi_b = U v_b for given states
  v_b, differentiable w.r.t. the symbol values by the adjoint method."""

  @staticmethod
  def forward(ctx, symbol_values, init_re, init_im, circuit, plain):
    values = hopper_sv.host_values(symbol_values)
    psi = hopper_sv.apply_circuit_batched(circuit, values, plain=plain,
                                          init_planes=(init_re, init_im))
    ctx.circuit = circuit
    ctx.values = values
    ctx.plain = plain
    ctx.save_for_backward(*psi)
    return psi[0] * psi[0] + psi[1] * psi[1]

  @staticmethod
  def backward(ctx, g):
    # d/dtheta sum_bx g_bx |psi_bx|^2 is the sweep of the diagonal
    # observable O_b = diag(g_b): lam_b = O_b psi_b = g_b * psi_b, as
    # lam = sum_t g_t P_t psi for Pauli terms.
    psi_re, psi_im = ctx.saved_tensors
    lam = (g * psi_re, g * psi_im)
    grad = hopper_adjoint.adjoint_sweep_batched(
        ctx.circuit, ctx.values, (psi_re, psi_im), lam, ctx.plain)
    return grad, None, None, None, None


def batched_probabilities(circuit: ir.Circuit, symbol_values: torch.Tensor,
                          init_planes, plain: bool = False) -> torch.Tensor:
  """Computational-basis probabilities of U v_b for B given states.

  Args:
    circuit: static circuit IR (1q dense and diagonal gates).
    symbol_values: [num_symbols] parameters on the states' device.
    init_planes: (re, im) float32 [B, R, C] planes of the states v_b (data:
      no gradient reaches them).
    plain: run the kernels' plain versions on any device (the precision
      gate's reference arm only).

  Returns:
    [B, R, C] float32 |<x|U|v_b>|^2, differentiable w.r.t. `symbol_values`
    (the forward through K4 / K1, the backward one batched sweep, K5, on
    the card).
  """
  return _BatchedProbs.apply(symbol_values, init_planes[0], init_planes[1],
                             circuit, plain)


# -- one state: adjoint_term_expectations / expectation ------------------------

def _bwd_diag_segment(seg_gates, seg_angles, a, lam):
  """Reverse step through a run of diagonal gates: ([(slot, dE)], a, lam).

  For U_g = exp(i angle_g m_g(x)), dE/dangle_g = -2 sum_x m_g(x)
  Im(conj(lam) a) with `a` after the whole segment; both states then take
  one shared phase multiply by exp(-i theta)."""
  n = sv.num_qubits_of(a)
  m = int(a.shape[1]).bit_length() - 1
  coeffs, rms, cms, owner = sv.diag_segment_triples(seg_gates, n - m, m)
  grads = []
  if any(gate.slot >= 0 for gate in seg_gates):
    w = (lam.conj() * a).imag
    keep = [k for k in range(len(owner)) if seg_gates[owner[k]].slot >= 0]
    per_factor = sv.parity_bilinear([rms[k] for k in keep],
                                    [cms[k] for k in keep], w).tolist()
    for g_idx, gate in enumerate(seg_gates):
      if gate.slot >= 0:
        dangle = -2.0 * sum(coeffs[keep[j]] * per_factor[j]
                            for j in range(len(keep))
                            if owner[keep[j]] == g_idx)
        grads.append((gate.slot, gate.coeff * dangle))
  total = sv.diag_segment_phase(seg_gates, seg_angles, a.shape, a.device)
  phase = torch.exp(-1j * total.to(sv.COMPLEX_DTYPE))
  return grads, a * phase, lam * phase


def _bwd_1q_segment(seg_gates, seg_angles, a, lam):
  """Reverse step through a run of 1-qubit dense gates: ([(slot, dE)], a,
  lam).  dE/dangle_g = 2 Re sum(mg_g * G_q), with G_q the 2x2 reduced
  transition of the gate's qubit from one block_transition per row block
  (or the minor cross_gram); then the per-qubit inverses un-apply both."""
  n = sv.num_qubits_of(a)
  m = int(a.shape[1]).bit_length() - 1
  nr = n - m
  inverses, mg_entries, grad_qubits = hopper_adjoint.one_qubit_algebra(
      seg_gates, seg_angles)
  g_mats = {}
  minor_grads = sorted(q for q in grad_qubits if q >= nr)
  if minor_grads:
    kmat = sv.cross_gram(lam, a).cpu()
    for q in minor_grads:
      g_mats[q] = sv.partial_trace_1q(kmat, m, q - nr)
  for start, k in sv._row_blocks(nr):
    block_grads = [q for q in grad_qubits if start <= q < start + k]
    if block_grads:
      g_block = sv.block_transition(lam, a, start, k).cpu()
      for q in block_grads:
        g_mats[q] = sv.partial_trace_1q(g_block, k, q - start)
  grads = [(slot, coeff * 2.0 * float(torch.sum(mg * g_mats[q]).real))
           for q, slot, coeff, mg in mg_entries]
  majors = {q: v for q, v in inverses.items() if q < nr}
  minor_inv = sv._fold_block({q - nr: v for q, v in inverses.items()
                              if q >= nr}, 0, m)
  return (grads, sv.apply_majors_and_minor(a, majors, minor_inv, plain=True),
          sv.apply_majors_and_minor(lam, majors, minor_inv, plain=True))


def reverse_sweep(circuit: ir.Circuit, symbol_values, psi: torch.Tensor,
                  lam: torch.Tensor) -> torch.Tensor:
  """The segment-fused reverse sweep of one [R, C] state (the reference's
  `_xla_reverse_sweep`): the symbol gradient [num_symbols] of
  <psi| sum_t g_t P_t |psi> given lam = sum_t g_t P_t psi.  It is the
  plain version of K2 (`hopper_adjoint.adjoint_sweep`), torch ops only on
  any device."""
  angles = sv.resolve_angles(circuit, hopper_sv.host_values(symbol_values))
  slots, contribs = [], []
  a = psi
  for cls, idxs in reversed(sv.segment_circuit(circuit.gates)):
    seg_gates = [circuit.gates[i] for i in idxs]
    seg_angles = angles[list(idxs)]
    if cls == "1q":
      grads, a, lam = _bwd_1q_segment(seg_gates, seg_angles, a, lam)
    elif cls == "diag":
      grads, a, lam = _bwd_diag_segment(seg_gates, seg_angles, a, lam)
    else:
      raise NotImplementedError(
          f"gate {seg_gates[0].kind!r} is neither a 1q dense nor a diagonal "
          "gate; the reverse sweep does not take it yet")
    slots.extend(s for s, _ in grads)
    contribs.extend(d for _, d in grads)
  grad = torch.zeros(circuit.num_symbols, dtype=torch.float64)
  if slots:
    grad.index_add_(0, torch.tensor(slots),
                    torch.tensor(contribs, dtype=torch.float64))
  return grad.to(torch.float32).to(psi.device)


class _TermExpectations(torch.autograd.Function):
  """[T] coefficient-free per-term expectations of U(values)|init_state>,
  differentiable w.r.t. the symbol values by the adjoint method."""

  @staticmethod
  def forward(ctx, symbol_values, init_state, circuit, op):
    values = hopper_sv.host_values(symbol_values)
    psi = sv.apply_circuit(circuit, values, init_state)
    ctx.circuit = circuit
    ctx.op = op
    ctx.values = values
    ctx.save_for_backward(psi)
    return sv.expectation_terms(psi, op)

  @staticmethod
  def backward(ctx, g):
    (psi,) = ctx.saved_tensors
    circuit = ctx.circuit
    ones = paulis.PauliSum(ctx.op.codes,
                           torch.ones_like(ctx.op.coeffs, dtype=torch.float32),
                           ctx.op.num_qubits)
    lam = sv.apply_pauli_sum(psi, ones, term_weights=g)
    planes = [(t.real.contiguous(), t.imag.contiguous()) for t in (psi, lam)]
    if (psi.device.type == "cuda" and
        not hopper_sv.single_admits(circuit.num_qubits)):
      # Outside K2's range: the batched sweep's kernels at B = 1.
      grad = hopper_adjoint.adjoint_sweep_batched(
          circuit, ctx.values, *[tuple(t[None] for t in p) for p in planes])
    else:
      grad = hopper_adjoint.adjoint_sweep(circuit, ctx.values, *planes)
    return grad, None, None, None


def adjoint_term_expectations(circuit: ir.Circuit,
                              symbol_values: torch.Tensor,
                              init_state: torch.Tensor,
                              op: paulis.PauliSum) -> torch.Tensor:
  """Per-term expectations <psi(values)|P_t|psi(values)>, shape [T], with
  psi = U(values)|init_state> for one [R, C] state of any content.

  Differentiable w.r.t. `symbol_values` by the adjoint method: the forward
  is K3 and the backward K2 on the card for 8 <= n <= 20 qubits (the
  segment kernels at B = 1 outside that range).  `init_state` is data."""
  return _TermExpectations.apply(symbol_values, init_state, circuit,
                                 op.to(init_state.device))


def expectation(circuit: ir.Circuit, symbol_values: torch.Tensor,
                init_state: torch.Tensor, op: paulis.PauliSum) -> torch.Tensor:
  """<psi(values)| op |psi(values)>, a real scalar with adjoint gradients
  w.r.t. the values and autograd ones w.r.t. op's coefficients."""
  terms = adjoint_term_expectations(circuit, symbol_values, init_state, op)
  return torch.sum(terms * op.coeffs.to(init_state.device).real)


def as_pauli_tuple(observables) -> Tuple[paulis.PauliSum, ...]:
  if isinstance(observables, paulis.PauliSum):
    return (observables,)
  return tuple(observables)
