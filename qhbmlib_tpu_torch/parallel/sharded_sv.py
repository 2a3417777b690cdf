"""Amplitude-sharded statevector engine on `torch.distributed` (port of
`qhbmlib_tpu/parallel/sharded_sv.py`).

The 2^n amplitudes are split over the mesh's 'state' axis: the rank at
position s holds those whose first (most significant) k = log2(axis size)
qubit values are the bits of s, an (n - k)-qubit local block.  A rank holds
the local blocks of all B states of a batch as one [B, R, C] plane pair
(R * C = 2^(n - k), the batched engine's layout), where the reference maps
one state at a time (`lax.map`, :786, :804): one exchange carries the whole
batch, and the exchanges a call makes do not depend on B.

  * gates on local qubits (q >= k) are shifted down by k and run as an
    (n - k)-qubit sub-circuit through the batched engine's stages and
    kernels (`hopper_sv.prepare_segments` / `apply_stage`; backward
    `hopper_adjoint.prepare_backward` / `sweep_stages`);
  * a chain of 1q gates on a global qubit folds into one 2x2 and costs one
    exchange with the partner rank, then an elementwise combine of own and
    partner block (`_apply_dense_routed`, :71);
  * a diagonal segment that touches global qubits folds this rank's +-1
    signs into its Walsh weights and is one `diag_rotate` (backward: the
    fused `parity_bilinear` stage): no collective at all;
  * other gates on global qubits (2q gates, the flip class) take the routed
    dense path, up to three exchanges (:148-152), in elementwise torch;
  * expectations and lambda take one tiered local pass and one exchange per
    distinct global XOR mask of the observable's terms, and one stacked
    all-reduce.

The adjoint backward recomputes the forward, sweeps in reverse, and sums
every reduction (transitions, bilinears, flip g's) of every rank in ONE
all-reduce over the state axis (then one over the data axis when the batch
is split) before the host's per-gate algebra: each rank's share is placed
so that the sum is the unsharded reduction (a global chain's 2x2
transition gets this rank's own and cross inner products in its row; a
signed diagonal's bilinears their sign).

Collectives go through `parallel.comm` (counted there).  Tensors on the
CPU take the kernels' plain versions, as everywhere in the port.  The
reference's `QHBM_SHARDED_EXPECT=legacy` hatch is left out.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from qhbmlib_tpu_torch.ops import adjoint
from qhbmlib_tpu_torch.ops import circuit_ir as ir
from qhbmlib_tpu_torch.ops import hopper_adjoint
from qhbmlib_tpu_torch.ops import hopper_sv
from qhbmlib_tpu_torch.ops import paulis
from qhbmlib_tpu_torch.ops import statevector as sv
from qhbmlib_tpu_torch.parallel import comm
from qhbmlib_tpu_torch.parallel import mesh as mesh_lib

Planes = hopper_sv.Planes


# ---------------------------------------------------------------------------
# Rank bits and signs
# ---------------------------------------------------------------------------

def _bit(s: int, k: int, g: int) -> int:
  """Bit of global qubit g (< k) in state-axis position s."""
  return (s >> (k - 1 - g)) & 1


def _signs(s: int, masks: Sequence[int]) -> np.ndarray:
  """float32 (-1)^popcount(s & mask) for each mask."""
  return np.asarray([1.0 - 2.0 * (bin(s & int(m)).count("1") & 1)
                     for m in masks], np.float32)


def _to_planes(state: torch.Tensor) -> Planes:
  return state.real.contiguous(), state.imag.contiguous()


def _combine(keep: complex, ex: complex, x: Planes, y: Planes) -> Planes:
  """keep * x + ex * y on plane pairs, complex scalars."""
  (xr, xi), (yr, yi) = x, y
  return (keep.real * xr - keep.imag * xi + ex.real * yr - ex.imag * yi,
          keep.real * xi + keep.imag * xr + ex.real * yi + ex.imag * yr)


# ---------------------------------------------------------------------------
# The routed dense path (gates of the flip class on global qubits)
# ---------------------------------------------------------------------------

def _apply_dense_routed(mat: torch.Tensor, gate_qubits: Tuple[int, ...],
                        state: torch.Tensor, k: int, axis: mesh_lib.Axis,
                        diag: bool = False) -> torch.Tensor:
  """A dense 1- or 2-qubit gate that may touch global qubits, on complex
  [..., R, C] local blocks: the partner blocks arrive by exchange and the
  output is a combination of own and partner blocks with the gate matrix's
  rows picked by this rank's bits (one exchange per global qubit pair, up
  to three for two global qubits).  `diag` (ZP, RZ, CZP, ZZP) needs no
  exchange: a diagonal gate never mixes ranks."""
  s = axis.index
  mat = mat.to(state.device)
  global_qubits = [q for q in gate_qubits if q < k]
  if not global_qubits:
    return sv.apply_dense(mat, tuple(q - k for q in gate_qubits), state)
  if diag:
    if len(gate_qubits) == 1:
      b = _bit(s, k, gate_qubits[0])
      return mat[b, b] * state
    d = torch.diagonal(mat).reshape(2, 2)  # [q0_in, q1_in]
    if len(global_qubits) == 1:
      (g,) = global_qubits
      (u,) = [q for q in gate_qubits if q >= k]
      if gate_qubits[0] != g:  # normalize to [g_in, u_in]
        d = d.T
      return sv.apply_dense(torch.diag(d[_bit(s, k, g)]), (u - k,), state)
    g0, g1 = gate_qubits
    return d[_bit(s, k, g0), _bit(s, k, g1)] * state
  if len(gate_qubits) == 1:
    (g,) = gate_qubits
    b = _bit(s, k, g)
    (partner,) = comm.exchange_xor([state], 1 << (k - 1 - g), axis)
    return mat[b, b] * state + mat[b, 1 - b] * partner
  mt = mat.reshape(2, 2, 2, 2)  # (q0_out, q1_out, q0_in, q1_in)
  if len(global_qubits) == 1:
    (g,) = global_qubits
    (u,) = [q for q in gate_qubits if q >= k]
    if gate_qubits[0] != g:  # normalize to (g_out, u_out, g_in, u_in)
      mt = mt.permute(1, 0, 3, 2)
    b = _bit(s, k, g)
    m_b = mt[b]  # [u_out, g_in, u_in]
    (partner,) = comm.exchange_xor([state], 1 << (k - 1 - g), axis)
    return (sv.apply_dense(m_b[:, b, :].contiguous(), (u - k,), state) +
            sv.apply_dense(m_b[:, 1 - b, :].contiguous(), (u - k,), partner))
  g0, g1 = gate_qubits
  b0, b1 = _bit(s, k, g0), _bit(s, k, g1)
  m_row = mt[b0, b1]  # [g0_in, g1_in]
  mask0, mask1 = 1 << (k - 1 - g0), 1 << (k - 1 - g1)
  pieces = {(0, 0): state}
  for d0, d1, mask in ((1, 0, mask0), (0, 1, mask1), (1, 1, mask0 | mask1)):
    (pieces[(d0, d1)],) = comm.exchange_xor([state], mask, axis)
  out = torch.zeros_like(state)
  for (d0, d1), piece in pieces.items():
    out = out + m_row[b0 ^ d0, b1 ^ d1] * piece
  return out


def apply_pauli_string_local(state: torch.Tensor, codes: Sequence[int],
                             k: int, axis: mesh_lib.Axis) -> torch.Tensor:
  """P|psi> for a full-length Pauli code row on complex local blocks: the
  global X / Y flips are ONE exchange (position XOR), the global Z / Y
  phases this rank's scalar, the local codes the engine's
  `apply_pauli_string`; phases from the input rank's bits, applied before
  the exchange."""
  s = axis.index
  xor_mask = 0
  phase = 1.0 + 0.0j
  for g in range(k):
    c = codes[g]
    b = _bit(s, k, g)
    if c in (paulis.X, paulis.Y):
      xor_mask |= 1 << (k - 1 - g)
    if c == paulis.Y:
      phase *= 1j if b == 0 else -1j
    elif c == paulis.Z:
      phase *= 1.0 if b == 0 else -1.0
  out = sv.apply_pauli_string(state, list(codes)[k:]) * phase
  if xor_mask:
    (out,) = comm.exchange_xor([out], xor_mask, axis)
  return out


def apply_gate_local(gate: ir.Gate, angle, state: torch.Tensor, k: int,
                     axis: mesh_lib.Axis) -> torch.Tensor:
  """One gate at its resolved angle on complex local blocks (the sharded
  `statevector.apply_gate`)."""
  n = k + sv.num_qubits_of(state)
  a = torch.as_tensor(angle, dtype=torch.float32).to(sv.COMPLEX_DTYPE)
  if gate.kind == ir.PROT:
    p_state = apply_pauli_string_local(state, sv._prot_codes(gate, n), k,
                                       axis)
    return torch.cos(a) * state - 1j * torch.sin(a) * p_state
  if gate.kind == ir.GPHASE:
    return torch.exp(1j * a) * state
  return _apply_dense_routed(sv.gate_matrix(gate.kind, angle), gate.qubits,
                             state, k, axis, diag=gate.kind in sv._DIAG_KINDS)


def apply_gate_dangle_local(gate: ir.Gate, angle, state: torch.Tensor,
                            k: int, axis: mesh_lib.Axis) -> torch.Tensor:
  """(dU/dangle)|psi> on complex local blocks (the backward's routed
  gates)."""
  n = k + sv.num_qubits_of(state)
  a = torch.as_tensor(angle, dtype=torch.float32).to(sv.COMPLEX_DTYPE)
  if gate.kind == ir.PROT:
    p_state = apply_pauli_string_local(state, sv._prot_codes(gate, n), k,
                                       axis)
    return -torch.sin(a) * state - 1j * torch.cos(a) * p_state
  if gate.kind == ir.GPHASE:
    return 1j * torch.exp(1j * a) * state
  return _apply_dense_routed(sv.gate_matrix_dangle(gate.kind, angle),
                             gate.qubits, state, k, axis,
                             diag=gate.kind in sv._DIAG_KINDS)


# ---------------------------------------------------------------------------
# The static plan of a circuit on k global qubits
# ---------------------------------------------------------------------------

def _shift_gate(gate: ir.Gate, k: int) -> ir.Gate:
  return dataclasses.replace(gate, qubits=tuple(q - k for q in gate.qubits))


@functools.lru_cache(maxsize=64)
def shard_plan(circuit: ir.Circuit, k: int):
  """The circuit as parts, in order, each one of:

    ("local", sub-circuit)  consecutive gates on local qubits only,
        shifted down by k: an (n - k)-qubit circuit with the circuit's
        symbols, run by the batched engine;
    ("chain", qubit, gate indices)  one global qubit's gates of a 1q
        segment (after the segment's local gates, which commute with them);
    ("diag", gate indices, (coeffs, global masks, row masks, col masks,
        owner))  a diagonal segment touching global qubits, its Walsh
        triples on the [global | local rows | cols] index;
    ("gate", gate index)  any other gate on global qubits.

  Cached per (circuit, k): a step folds operators from its values, not the
  plan again."""
  gates = circuit.gates
  nl = circuit.num_qubits - k
  m = sv.minor_bits(nl)
  nr = nl - m
  parts, pending = [], []

  def flush():
    if pending:
      sub = ir.Circuit(nl, tuple(_shift_gate(gates[i], k) for i in pending),
                       circuit.symbol_names)
      parts.append(("local", sub))
      pending.clear()

  for cls, idxs in sv.segment_circuit(gates):
    if all(q >= k for i in idxs for q in gates[i].qubits):
      pending.extend(idxs)
    elif cls == "1q":
      pending.extend(i for i in idxs if gates[i].qubits[0] >= k)
      flush()
      chains = {}
      for i in idxs:
        if gates[i].qubits[0] < k:
          chains.setdefault(gates[i].qubits[0], []).append(i)
      parts.extend(("chain", q, tuple(chains[q])) for q in sorted(chains))
    elif cls == "diag":
      flush()
      coeffs, rms, cms, owner = sv.diag_segment_triples(
          [gates[i] for i in idxs], k + nr, m)
      triples = (tuple(coeffs), tuple(rm >> nr for rm in rms),
                 tuple(rm & ((1 << nr) - 1) for rm in rms), tuple(cms),
                 tuple(owner))
      parts.append(("diag", tuple(idxs), triples))
    else:
      flush()
      parts.append(("gate", idxs[0]))
  flush()
  return tuple(parts)


def _chain_matrix(gates, angles) -> torch.Tensor:
  """The product of a chain's 2x2s in gate order (complex64, host)."""
  mats = sv.segment_matrices(gates, angles)
  mat = mats[0]
  for nxt in mats[1:]:
    mat = nxt @ mat
  return mat


def _signed_weights(triples, angles, s: int) -> np.ndarray:
  """float32 [K] Walsh weights of a diagonal part at this rank: coeff_j *
  (-1)^popcount(s & global_mask_j) * angle of the owning gate."""
  coeffs, gms, _, _, owner = triples
  return (np.asarray(coeffs, np.float32) * _signs(s, gms) *
          np.asarray(angles, np.float32)[np.asarray(owner, np.int64)])


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def basis_state_local(n: int, k: int, bits: torch.Tensor, s: int,
                      device=None) -> Planes:
  """[B, R, C] planes of this rank's local blocks of |bits> ([B, n]): a
  block is nonzero only on the rank whose position holds the bits' first
  k values."""
  device = bits.device if device is None else torch.device(device)
  bits = bits.to(device)
  own = (sv.bits_to_index(bits[:, :k], k) == s).to(torch.float32)
  re, im = hopper_sv.basis_planes(adjoint.bits_to_rowcol(bits[:, k:], n - k),
                                  sv.state_shape(n - k))
  return re * own[:, None, None], im


def apply_circuit_local(circuit: ir.Circuit, symbol_values, planes: Planes,
                        k: int, axis: mesh_lib.Axis) -> Planes:
  """U(values) on [B, R, C] local blocks of n-qubit states whose first k
  qubits are global (`shard_plan`'s parts in order); returns new planes
  (the given ones may be overwritten)."""
  values = hopper_sv.host_values(symbol_values)
  angles = sv.resolve_angles(circuit, values)
  device = planes[0].device
  s = axis.index
  shape_rc = tuple(planes[0].shape[1:])
  for part in shard_plan(circuit, k):
    kind = part[0]
    if kind == "local":
      for stage in hopper_sv.prepare_segments(part[1], values, device):
        planes = hopper_sv.apply_stage(stage, [planes])[0]
    elif kind == "chain":
      q, idxs = part[1], list(part[2])
      mat = _chain_matrix([circuit.gates[i] for i in idxs], angles[idxs])
      b = _bit(s, k, q)
      partner = comm.exchange_xor(list(planes), 1 << (k - 1 - q), axis)
      planes = _combine(complex(mat[b, b]), complex(mat[b, 1 - b]), planes,
                        partner)
    elif kind == "diag":
      triples = part[2]
      (w,) = hopper_sv.to_device([torch.from_numpy(_signed_weights(
          triples, angles[list(part[1])], s))], device)
      cos_t, sin_t = hopper_sv.rotation_planes(w, triples[2], triples[3],
                                               shape_rc)
      planes = tuple(t.contiguous() for t in planes)
      hopper_sv.diag_rotate([planes], cos_t, sin_t, +1)
    else:
      i = part[1]
      planes = _to_planes(apply_gate_local(
          circuit.gates[i], angles[i], torch.complex(*planes), k, axis))
  return planes


# ---------------------------------------------------------------------------
# Expectations and lambda
# ---------------------------------------------------------------------------

def _global_masks(codes_row, k: int) -> Tuple[int, int, int]:
  """(xor_mask, phase_mask, num_Y) of a code row's global (qubit < k) part:
  the global phase at position e is (1j)^num_Y (-1)^popcount(e &
  phase_mask), as `apply_pauli_string_local`'s convention."""
  xm = pm = ny = 0
  for g in range(k):
    c = codes_row[g]
    bit = 1 << (k - 1 - g)
    if c == paulis.X:
      xm |= bit
    elif c == paulis.Y:
      xm |= bit
      pm |= bit
      ny += 1
    elif c == paulis.Z:
      pm |= bit
  return xm, pm, ny


def _phase_combine(ny: int, sign, re_part, im_part):
  """Re((1j)^ny * sign * (re_part + 1j*im_part)) with static ny."""
  r = ny % 4
  if r == 0:
    return sign * re_part
  if r == 1:
    return -sign * im_part
  if r == 2:
    return -sign * re_part
  return sign * im_part


def _term_groups(rows, k: int):
  """(infos [(xor, phase, num_Y)] a term, {xor mask: [terms]} in first
  appearance order)."""
  infos = [_global_masks(codes, k) for codes in rows]
  groups = {}
  for t, info in enumerate(infos):
    groups.setdefault(info[0], []).append(t)
  return infos, groups


def _local_op(rows, ts, k: int, nl: int, device) -> paulis.PauliSum:
  """The local parts of terms `ts` as a coefficient-1 PauliSum."""
  codes = torch.tensor([list(rows[t])[k:] for t in ts],
                       dtype=torch.int8).reshape(len(ts), nl)
  return paulis.PauliSum(codes, torch.ones(len(ts), device=device), nl)


@sv.fp32_matmuls
def expectation_terms_local(planes: Planes, op: paulis.PauliSum, k: int,
                            axis: mesh_lib.Axis) -> torch.Tensor:
  """[B, T] coefficient-free <psi_b|P_t|psi_b> of the states whose local
  blocks are `planes`, summed over the state axis (one all-reduce).

  Terms whose global part is diagonal (I / Z) take ONE tiered local pass
  (`statevector.expectation_terms`) times this rank's sign; terms with
  global X / Y group by their XOR mask, one exchange a mask, the group's
  diagonal local parts in one parity bilinear against conj(psi) *
  partner."""
  state = torch.complex(*planes)
  nl = sv.num_qubits_of(state)
  m = sv.minor_bits(nl)
  nr = nl - m
  s = axis.index
  rows = op.code_rows()
  infos, groups = _term_groups(rows, k)
  vals = [None] * len(rows)
  ts0 = groups.pop(0, [])
  if ts0:
    local_vals = sv.expectation_terms(state, _local_op(rows, ts0, k, nl,
                                                       state.device))
    signs = _signs(s, [infos[t][1] for t in ts0])
    for j, t in enumerate(ts0):
      vals[t] = float(signs[j]) * local_vals[..., j]
  for xm, ts in groups.items():
    (partner,) = comm.exchange_xor([state], xm, axis)
    src = s ^ xm  # the phase is the SOURCE rank's
    diag_ts = [t for t in ts if sv._is_diag_codes(rows[t][k:])]
    rest_ts = [t for t in ts if t not in diag_ts]
    if diag_ts:
      w = state.conj() * partner
      masks = [sv.pauli_z_masks(rows[t][k:], nr, m) for t in diag_ts]
      rms, cms = [rm for rm, _ in masks], [cm for _, cm in masks]
      br = sv.parity_bilinear(rms, cms, w.real.contiguous())
      bi = sv.parity_bilinear(rms, cms, w.imag.contiguous())
      signs = _signs(src, [infos[t][1] for t in diag_ts])
      for j, t in enumerate(diag_ts):
        vals[t] = _phase_combine(infos[t][2], float(signs[j]), br[..., j],
                                 bi[..., j])
    if rest_ts:
      conj = state.conj()
      signs = _signs(src, [infos[t][1] for t in rest_ts])
      for j, t in enumerate(rest_ts):
        z = torch.sum(conj * sv.apply_pauli_string(partner, rows[t][k:]),
                      dim=(-2, -1))
        vals[t] = _phase_combine(infos[t][2], float(signs[j]), z.real,
                                 z.imag)
  return comm.all_reduce_sum(torch.stack(vals, dim=-1), axis)


@sv.fp32_matmuls
def build_lambda_local(planes: Planes, op: paulis.PauliSum,
                       term_weights: torch.Tensor, k: int,
                       axis: mesh_lib.Axis) -> Planes:
  """Local blocks of lambda_b = sum_t w_bt P_t |psi_b> (`term_weights`
  [B, T]): terms group by global XOR mask, each group ONE tiered local
  apply (`statevector.apply_pauli_sum`, this rank's phases folded into the
  weights) and one exchange."""
  state = torch.complex(*planes)
  nl = sv.num_qubits_of(state)
  s = axis.index
  rows = op.code_rows()
  infos, groups = _term_groups(rows, k)
  lam = None
  for xm, ts in groups.items():
    phase = torch.tensor([complex(_signs(s, [infos[t][1]])[0]) *
                          (1j)**(infos[t][2] % 4) for t in ts],
                         dtype=sv.COMPLEX_DTYPE, device=state.device)
    idx = torch.tensor(ts, device=state.device)
    w = term_weights[..., idx].to(sv.COMPLEX_DTYPE) * phase
    contrib = sv.apply_pauli_sum(state, _local_op(rows, ts, k, nl,
                                                  state.device),
                                 term_weights=w)
    if xm:
      (contrib,) = comm.exchange_xor([contrib], xm, axis)
    lam = contrib if lam is None else lam + contrib
  if lam is None:
    lam = torch.zeros_like(state)
  return _to_planes(lam)


# ---------------------------------------------------------------------------
# Adjoint backward
# ---------------------------------------------------------------------------

def _dot(x: Planes, y: Planes):
  """(re, im) of sum conj(x) * y over every element (device scalars)."""
  (xr, xi), (yr, yi) = x, y
  return (torch.sum(xr * yr + xi * yi), torch.sum(xr * yi - xi * yr))


def reverse_sweep_local(circuit: ir.Circuit, symbol_values, psi: Planes,
                        lam: Planes, k: int, axis: mesh_lib.Axis,
                        data_axis: Optional[mesh_lib.Axis] = None
                        ) -> torch.Tensor:
  """The symbol gradient [num_symbols] of sum_b <psi_b| sum_t g_bt P_t
  |psi_b> over the whole mesh, from this rank's local blocks of psi (the
  forward's states) and lam = sum_t g_bt P_t psi, both overwritten.

  Every part in reverse: a local part's reverse stages
  (`hopper_adjoint.prepare_backward` on its sub-circuit); a global chain
  ONE exchange of a and lambda stacked, this rank's row of the qubit's 2x2
  transition (own and cross inner products), the folded inverse from own
  and partner blocks; a diagonal part the fused `parity_bilinear` stage at
  the sign-folded weights, its bilinears times this rank's signs; a routed
  gate U^-1 a, 2 Re <lam| dU |a>, U^-1 lam.  Then ONE all-reduce of every
  reduction over `axis` (and one over `data_axis`), one host copy, and the
  per-gate algebra of `hopper_adjoint._assemble_grads`."""
  values = hopper_sv.host_values(symbol_values)
  angles = sv.resolve_angles(circuit, values)
  device = psi[0].device
  s = axis.index
  shape_rc = tuple(psi[0].shape[1:])
  a, lm = psi, lam
  reductions, plan = [], []
  for part in reversed(shard_plan(circuit, k)):
    kind = part[0]
    if kind == "local":
      stages, sub_plan = hopper_adjoint.prepare_backward(part[1], values,
                                                         device)
      a, lm, sub_red = hopper_adjoint.sweep_stages(stages, a, lm)
      reductions.extend(sub_red)
      plan.extend(sub_plan)
    elif kind == "chain":
      q, idxs = part[1], list(part[2])
      chain = [circuit.gates[i] for i in idxs]
      inverses, mg_entries, grad_qubits = hopper_adjoint.one_qubit_algebra(
          chain, angles[idxs])
      b = _bit(s, k, q)
      p_ar, p_ai, p_lr, p_li = comm.exchange_xor(list(a) + list(lm),
                                                 1 << (k - 1 - q), axis)
      if grad_qubits:
        t = torch.zeros((1, 2, 2, 2), dtype=torch.float32, device=device)
        own, cross = _dot(lm, a), _dot(lm, (p_ar, p_ai))
        for ri in (0, 1):
          t[0, ri, b, b] = own[ri]
          t[0, ri, b, 1 - b] = cross[ri]
        reductions.append(t)
        plan.append(("1q", {"qubits": (q,), "mg_entries": mg_entries}))
      inv = inverses[q]
      keep, ex = complex(inv[b, b]), complex(inv[b, 1 - b])
      a = _combine(keep, ex, a, (p_ar, p_ai))
      lm = _combine(keep, ex, lm, (p_lr, p_li))
    elif kind == "diag":
      idxs, triples = list(part[1]), part[2]
      coeffs, gms, rl, cms, owner = triples
      (w, sg) = hopper_sv.to_device(
          [torch.from_numpy(_signed_weights(triples, angles[idxs], s)),
           torch.from_numpy(_signs(s, gms))], device)
      planes = hopper_sv.rotation_planes(w, rl, cms, shape_rc)
      a = tuple(t.contiguous() for t in a)
      lm = tuple(t.contiguous() for t in lm)
      reductions.append(
          hopper_adjoint.parity_bilinear(*lm, *a, rl, cms, planes) * sg)
      seg = [circuit.gates[i] for i in idxs]
      plan.append(("diag", {
          "coeffs": tuple(float(x) for x in coeffs), "owner": tuple(owner),
          "grad_gates": tuple((g_idx, g.slot, g.coeff)
                              for g_idx, g in enumerate(seg) if g.slot >= 0),
      }))
    else:
      i = part[1]
      gate, angle = circuit.gates[i], angles[i]
      a_c = apply_gate_local(gate, -angle, torch.complex(*a), k, axis)
      if gate.slot >= 0:
        d = apply_gate_dangle_local(gate, angle, a_c, k, axis)
        lm_c = torch.complex(*lm)
        reductions.append((2.0 * torch.sum(lm_c.conj() * d).real).reshape(1))
        plan.append(("dense", {"slot": gate.slot, "coeff": gate.coeff}))
      a = _to_planes(a_c)
      lm = _to_planes(apply_gate_local(gate, -angle, torch.complex(*lm), k,
                                       axis))
  outputs = []
  if reductions:
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in reductions])
    flat = comm.all_reduce_sum(flat, axis)
    if data_axis is not None:
      flat = comm.all_reduce_sum(flat, data_axis)
    outputs = hopper_adjoint._grads_from_flat(
        flat.cpu(), [tuple(t.shape) for t in reductions])
  return hopper_adjoint._assemble_grads(plan, outputs,
                                        circuit.num_symbols).to(device)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def simulate_sharded(circuit: ir.Circuit, symbol_values: torch.Tensor,
                     mesh: mesh_lib.Mesh,
                     init_bits: Optional[torch.Tensor] = None,
                     axis_name: str = mesh_lib.STATE_AXIS,
                     gather: bool = False) -> torch.Tensor:
  """|psi> = U(values)|bits or 0> on the values' device: this rank's
  local block as a complex [2^(n - k)] vector (amplitudes [s 2^(n-k),
  (s+1) 2^(n-k)) of the state), or with `gather` the whole [2^n] vector on
  every rank.  Metrics / debugging entry point."""
  axis = mesh.axis(axis_name)
  k = mesh_lib.num_global_qubits(mesh, axis_name)
  n = circuit.num_qubits
  device = symbol_values.device
  if init_bits is None:
    init_bits = torch.zeros([n], dtype=torch.int8)
  planes = basis_state_local(n, k, init_bits.reshape(1, n), axis.index,
                             device)
  planes = apply_circuit_local(circuit, symbol_values, planes, k, axis)
  local = torch.complex(*planes).reshape(-1)
  if not gather:
    return local
  return comm.all_gather(local, axis).reshape(-1)


class _ShardedTerms(torch.autograd.Function):
  """[B, T] coefficient-free per-term expectations over the mesh: this
  rank's rows of the batch (split over the data axis) on its local blocks,
  summed over the state axis and gathered over the data axis; the adjoint
  backward recomputes the forward (memory O(2^(n-k)) a state)."""

  @staticmethod
  def forward(ctx, symbol_values, bits, circuit, op, k, axis, data_axis):
    values = hopper_sv.host_values(symbol_values)
    n = circuit.num_qubits
    rows = bits
    if data_axis is not None:
      per = bits.shape[0] // data_axis.size
      rows = bits[data_axis.index * per:(data_axis.index + 1) * per]
    psi = apply_circuit_local(
        circuit, values,
        basis_state_local(n, k, rows, axis.index, symbol_values.device), k,
        axis)
    terms = expectation_terms_local(psi, op, k, axis)  # [Bl, T]
    if data_axis is not None:
      terms = comm.all_gather(terms, data_axis).reshape(-1, op.num_terms)
    ctx.args = (values, rows, circuit, op, k, axis, data_axis)
    ctx.device = symbol_values.device
    return terms

  @staticmethod
  def backward(ctx, g):
    values, rows, circuit, op, k, axis, data_axis = ctx.args
    if data_axis is not None:
      per = rows.shape[0]
      g = g[data_axis.index * per:(data_axis.index + 1) * per]
    psi = apply_circuit_local(
        circuit, values,
        basis_state_local(circuit.num_qubits, k, rows, axis.index,
                          ctx.device), k, axis)
    lam = build_lambda_local(psi, op, g, k, axis)
    grad = reverse_sweep_local(circuit, values, psi, lam, k, axis,
                               data_axis)
    return grad, None, None, None, None, None, None


def batched_term_expectations(circuit: ir.Circuit, values: torch.Tensor,
                              init_bits: torch.Tensor,
                              big_op: paulis.PauliSum, mesh: mesh_lib.Mesh,
                              axis_name: str = mesh_lib.STATE_AXIS,
                              data_axis: Optional[str] = None
                              ) -> torch.Tensor:
  """Per-term expectations [B, T] of `big_op` against U|b_i> for each row
  (coefficient-free), adjoint-differentiable w.r.t. `values`; with
  `data_axis` the batch, a multiple of that axis's size, splits over it.
  Every rank gets the whole [B, T]."""
  axis = mesh.axis(axis_name)
  k = mesh_lib.num_global_qubits(mesh, axis_name)
  d_axis = mesh.axis(data_axis) if data_axis is not None else None
  if d_axis is not None and d_axis.size == 1:
    d_axis = None
  if d_axis is not None and init_bits.shape[0] % d_axis.size:
    raise ValueError(f"batch {init_bits.shape[0]} is not a multiple of the "
                     f"{data_axis!r} axis size {d_axis.size}")
  ones = paulis.PauliSum(big_op.codes, torch.ones(big_op.num_terms),
                         big_op.num_qubits)
  return _ShardedTerms.apply(values, init_bits.to(values.device), circuit,
                             ones, k, axis, d_axis)


def batched_expectations(circuit: ir.Circuit, symbol_values: torch.Tensor,
                         init_bits: torch.Tensor,
                         ops: Sequence[paulis.PauliSum],
                         mesh: mesh_lib.Mesh,
                         axis_name: str = mesh_lib.STATE_AXIS,
                         data_axis: Optional[str] = None) -> torch.Tensor:
  """The sharded `ops.adjoint.batched_expectations`: [B, len(ops)]
  expectations of each op against U|b> for each bitstring, with adjoint
  gradients for `symbol_values` and autograd ones for the ops'
  coefficients.  With `data_axis` the batch pads to a multiple of that
  axis's size (padding rows are the zero bitstring, dropped after) and
  splits over it.  A mesh of one rank runs the dense engine, as the
  reference does (:837-845)."""
  n = circuit.num_qubits
  if mesh.shape[axis_name] == 1 and (data_axis is None or
                                     mesh.shape.get(data_axis, 1) == 1):
    return adjoint.batched_expectations(circuit, symbol_values, init_bits,
                                        ops)
  big, slices = paulis.concat_ops(tuple(ops), n)
  b = init_bits.shape[0]
  if data_axis is not None:
    pad = (-b) % mesh.shape[data_axis]
    if pad:
      init_bits = torch.cat([init_bits, init_bits.new_zeros((pad, n))])
  terms = batched_term_expectations(circuit, symbol_values, init_bits, big,
                                    mesh, axis_name, data_axis)[:b]
  weighted = terms * big.coeffs.to(terms.device)[None, :]
  return torch.stack([weighted[:, lo:hi].sum(dim=1) for lo, hi in slices],
                     dim=1)


# ---------------------------------------------------------------------------
# The collectives a call makes, from the circuit and the observable
# ---------------------------------------------------------------------------

def _routed_exchanges(gate: ir.Gate, k: int, n: int) -> int:
  """Exchanges of one `apply_gate_local` of `gate`."""
  if gate.kind == ir.PROT:
    return int(_global_masks(sv._prot_codes(gate, n), k)[0] != 0)
  if gate.kind == ir.GPHASE or gate.kind in sv._DIAG_KINDS:
    return 0
  glob = [q for q in gate.qubits if q < k]
  return {0: 0, 1: 1, 2: 3}[len(glob)]


def collective_counts(circuit: ir.Circuit, op: paulis.PauliSum, k: int,
                      data_split: bool = False, grad: bool = True) -> dict:
  """The exchanges, all-reduces and all-gathers of one
  `batched_expectations` call (value, and with `grad` its backward) on k
  global qubits, predicted from the plan: the forward pays one exchange a
  global chain and the routed gates' exchanges, the expectation one a
  distinct nonzero global XOR mask of the terms; the backward the forward
  again, lambda's masks, one stacked exchange a chain and each routed
  gate's inverse on a and lambda (and dU a for a gate with a symbol)."""
  n = circuit.num_qubits
  plan = shard_plan(circuit, k)
  chains = sum(1 for p in plan if p[0] == "chain")
  routed = [circuit.gates[p[1]] for p in plan if p[0] == "gate"]
  fwd = chains + sum(_routed_exchanges(g, k, n) for g in routed)
  masks = len({_global_masks(codes, k)[0] for codes in op.code_rows()} - {0})
  out = {"exchanges": fwd + masks, "all_reduces": int(k > 0),
         "all_gathers": int(data_split)}
  if grad:
    out["exchanges"] += fwd + masks + chains + sum(
        (2 + (g.slot >= 0)) * _routed_exchanges(g, k, n) for g in routed)
    out["all_reduces"] += int(k > 0) + int(data_split)
  return out
