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

The batch runs in chunks of `batch_chunk` states (`_bt_fwd` / `_bt_bwd`,
:338-484): each chunk's forward, then in the backward each chunk's lambda,
one batched sweep and its share of the gradient.  psi stays as the residual
only while the whole batch's states fit the residual budget (`_store_psi`,
:348-352); otherwise the backward recomputes each chunk's forward.  The
rules, sized for the card this runs on (the reference's ~128 MB of live
chunk state was tuned to a 16 GB v5e):

  free     = torch.cuda.mem_get_info's free bytes + the bytes the caching
             allocator holds unused (HOST_FREE_BYTES for a CPU batch);
  store    = B * S <= PSI_RESIDUAL_SHARE * free, S = 8 * 2^n bytes a state;
  chunk    = clamp((CHUNK_SHARE * free - (B * S if store else 0)
                    - FIXED_STATES * S) // (LIVE_STATES * S), 1, B).

LIVE_STATES counts the state-sized buffers live per chunk element beyond
the residual: the forward's planes and a pass's output, L3's complex copy,
|psi|^2, the copy of the state a gram contracts (`statevector._gram`),
the lambda build's temporaries (the diagonal tier's phase array, the
weighted state, the sum), lambda's planes and the sweep's pass outputs;
the sweep overwrites a recomputed psi and the fresh lambda in place (no
clones).  Measured on the card at 24q, B = 8
(`chip_smoke.phase_chunk_rule`: `torch.cuda.max_memory_allocated` over a
forward and backward at one chunk of 8 and at chunks of 2, less the
residual, in states S): 8.00 states live per chunk element (7.00 before
the grams went through `_gram`) and 2.01 that do not grow with the chunk,
for the TFIM and the Heisenberg chain alike (NVIDIA H100 80GB HBM3,
700.00 W); the constants keep a state of margin over each.  At the bench's 24q B = 8 and 20q B = 64 the rule gives one
chunk and keeps psi; at r5's 28q B = 4 (~78 GiB free) it keeps psi (8 GiB)
and runs one state a chunk (two would need 92 GiB free), whose step
peaked at 30.3 GiB.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from qhbmlib_tpu_torch import tracing
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


# Shares of the free device memory (`free_bytes`) one batched_expectations
# call may fill: the psi residual kept from the forward to the backward, and
# the residual plus the live chunk.
PSI_RESIDUAL_SHARE = 0.25
CHUNK_SHARE = 0.5
# State-sized buffers live per chunk element beyond the residual, and those
# a call holds whatever its chunk (8.00 and 2.01 measured at 24q: the
# module docstring).
LIVE_STATES = 9
FIXED_STATES = 3
# The free memory the rules assume for a batch on the host.
HOST_FREE_BYTES = 16 << 30

# The last call's plan: {"batch", "chunk", "store_psi", "free_bytes"}.
last_plan = {}


def state_bytes(n: int) -> int:
  """Bytes of one complex64 n-qubit state (its two float32 planes)."""
  return 8 * 2**n


def free_bytes(device) -> int:
  """Device memory a call can still fill: cudaMemGetInfo's free bytes plus
  what PyTorch's caching allocator holds unused; HOST_FREE_BYTES on the
  CPU."""
  device = torch.device(device)
  if device.type != "cuda":
    return HOST_FREE_BYTES
  free, _ = torch.cuda.mem_get_info(device)
  return int(free + torch.cuda.memory_reserved(device) -
             torch.cuda.memory_allocated(device))


def store_psi(n: int, batch: int, free: int) -> bool:
  """Keep psi from the forward while the batch's states fit the residual
  budget (the reference's `_store_psi`); else the backward recomputes."""
  return batch * state_bytes(n) <= PSI_RESIDUAL_SHARE * free


def auto_chunk(n: int, batch: int, free: int, store: bool) -> int:
  """States a chunk: what CHUNK_SHARE of `free` holds at LIVE_STATES
  state-sized buffers an element, after the residual and FIXED_STATES;
  1 to `batch`."""
  avail = (CHUNK_SHARE * free - (batch * state_bytes(n) if store else 0) -
           FIXED_STATES * state_bytes(n))
  return max(1, min(batch, int(avail // (LIVE_STATES * state_bytes(n)))))


class _BatchedTerms(torch.autograd.Function):
  """[B, T] coefficient-free per-term expectations over a bitstring batch,
  differentiable w.r.t. the symbol values by the adjoint method, chunk by
  chunk (`_bt_fwd` / `_bt_bwd`)."""

  @staticmethod
  @tracing.spanned("qhbm.adjoint.forward")
  def forward(ctx, symbol_values, rowcol, circuit, op, plain, chunk, store):
    # One host copy of the values serves both passes: the backward folds
    # its operators from it without waiting on the device.
    values = hopper_sv.host_values(symbol_values)
    terms, saved = [], []
    for lo in range(0, rowcol.shape[0], chunk):
      psi = hopper_sv.apply_circuit_batched(circuit, values,
                                            rowcol[lo:lo + chunk], plain)
      terms.append(sv.expectation_terms(torch.complex(*psi), op))
      if store:
        saved.extend(psi)
      del psi
    ctx.circuit = circuit
    ctx.op = op
    ctx.values = values
    ctx.plain = plain
    ctx.chunk = chunk
    ctx.store = store
    ctx.save_for_backward(rowcol, *saved)
    return terms[0] if len(terms) == 1 else torch.cat(terms)

  @staticmethod
  @tracing.spanned("qhbm.adjoint.backward")
  def backward(ctx, g):
    rowcol, *saved = ctx.saved_tensors
    ones = paulis.PauliSum(ctx.op.codes,
                           torch.ones_like(ctx.op.coeffs, dtype=torch.float32),
                           ctx.op.num_qubits)
    grad = None
    for i, lo in enumerate(range(0, g.shape[0], ctx.chunk)):
      if ctx.store:
        psi = saved[2 * i:2 * i + 2]
      else:  # recompute this chunk's forward; the sweep may overwrite it
        psi = hopper_sv.apply_circuit_batched(
            ctx.circuit, ctx.values, rowcol[lo:lo + ctx.chunk], ctx.plain)
      lam = sv.apply_pauli_sum(torch.complex(*psi), ones,
                               term_weights=g[lo:lo + ctx.chunk])
      lam = (lam.real.contiguous(), lam.imag.contiguous())
      part = hopper_adjoint.adjoint_sweep_batched(
          ctx.circuit, ctx.values, psi, lam, ctx.plain,
          overwrite=(not ctx.store, True))
      del psi, lam
      grad = part if grad is None else grad + part
    return grad, None, None, None, None, None, None


def batched_expectations(circuit: ir.Circuit, symbol_values: torch.Tensor,
                         init_bits: torch.Tensor,
                         ops: Sequence[paulis.PauliSum],
                         batch_chunk: Optional[int] = None,
                         plain: bool = False) -> torch.Tensor:
  """Expectations of each op against U|b> for each bitstring b.

  All terms of all ops are concatenated into one PauliSum, so each batch
  costs one batched forward plus one batched reverse sweep however many
  observables are measured.

  Args:
    circuit: static circuit IR (any gates).
    symbol_values: [num_symbols] parameters on the device to run on.
    init_bits: [B, n] int bitstrings; each becomes a basis initial state.
    ops: PauliSums to measure.
    batch_chunk: states a chunk; None sizes it from the free memory
      (`auto_chunk`).  Whether psi is kept for the backward follows
      `store_psi` either way; `last_plan` records the choice.
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
  batch = int(rowcol.shape[0])
  with tracing.span("qhbm.adjoint.plan"):
    free = free_bytes(device)
    store = store_psi(n, batch, free)
    chunk = (auto_chunk(n, batch, free, store) if batch_chunk is None else
             max(1, min(batch, int(batch_chunk))))
  last_plan.update(batch=batch, chunk=chunk, store_psi=store,
                   free_bytes=free)
  terms = _BatchedTerms.apply(symbol_values, rowcol, circuit,
                              big.to(device), plain, chunk, store)  # [B, T]
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
    circuit: static circuit IR (any gates).
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


def _bwd_single(gate, angle, a, lam):
  """Reverse step through one gate of the flip class, as the reference's
  XLA sweep (adjoint.py:246-254): a <- U^-1 a, then dE/dangle =
  2 Re sum conj(lam) dU a, then lam <- U^-1 lam; U^-1 = U(-angle)."""
  a = sv.apply_gate(gate, -angle, a)
  grads = []
  if gate.slot >= 0:
    d_psi = sv.apply_gate_dangle(gate, angle, a)
    dangle = 2.0 * float(torch.sum(lam.conj() * d_psi).real)
    grads.append((gate.slot, gate.coeff * dangle))
  return grads, a, sv.apply_gate(gate, -angle, lam)


def reverse_sweep(circuit: ir.Circuit, symbol_values, psi: torch.Tensor,
                  lam: torch.Tensor) -> torch.Tensor:
  """The segment-fused reverse sweep of one [R, C] state (the reference's
  `_xla_reverse_sweep`): the symbol gradient [num_symbols] of
  <psi| sum_t g_t P_t |psi> given lam = sum_t g_t P_t psi.  It is the
  plain version of K2 (`hopper_adjoint.adjoint_sweep`), torch ops only on
  any device; it takes every gate of the IR (flip-class gates one at a
  time, `_bwd_single`)."""
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
      grads, a, lam = _bwd_single(seg_gates[0], seg_angles[0], a, lam)
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
        not hopper_sv.single_supported(circuit)):
      # Outside K2's range (its qubit counts, no flip-class gate): the
      # batched sweep's kernels at B = 1.
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
  is K3 and the backward K2 on the card for circuits of 8 <= n <= 20
  qubits with no gate of the flip class (`hopper_sv.single_supported`);
  the segment kernels at B = 1 for the others.  `init_state` is data."""
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
