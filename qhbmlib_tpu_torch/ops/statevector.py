"""Statevector engine: the main-path subset of `qhbmlib_tpu/ops/statevector.py`
as PyTorch ops.

State layout (kept from the reference so every intermediate compares
elementwise): a state is a ``[R, C]`` complex64 array with ``C = 2^m``,
``m = min(n, 7)``, ``R = 2^(n-m)``.  Qubit ``q < nr = n - m`` is row bit
``1 << (nr-1-q)``; a minor qubit is column bit ``1 << (m-1-(q-nr))``.
Flattening row-major gives the standard (cirq, qubit 0 most significant)
basis order.  Functions that take states also accept leading batch
dimensions, ``[..., R, C]``.

Operator folds (the 2x2 / [C, C] products) run in full float32 on the host,
as in the reference (`statevector.py:1203-1210`).  State-sized products use
torch matmuls; the caller pins float32 precision on the card
(`torch.backends.cuda.matmul.allow_tf32 = False`).

Pauli tiers: only the tiers the TFIM target needs are ported -- diagonal
(I/Z) terms, minor-only terms and terms inside one row block.  Spanning and
mixed terms raise NotImplementedError.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from qhbmlib_tpu_torch import device as device_lib
from qhbmlib_tpu_torch.ops import circuit_ir as ir
from qhbmlib_tpu_torch.ops import paulis

COMPLEX_DTYPE = torch.complex64

# Qubits kept in the minor (column) dimension: C = 128.
MINOR_MAX = 7

# Row qubits are processed in contiguous blocks of up to this many bits.
_ROW_BLOCK_BITS = 7


def minor_bits(n: int) -> int:
  return min(n, MINOR_MAX)


def state_shape(n: int) -> Tuple[int, int]:
  m = minor_bits(n)
  return (2**(n - m), 2**m)


def num_qubits_of(state: torch.Tensor) -> int:
  size = int(state.shape[-2]) * int(state.shape[-1])
  return size.bit_length() - 1


def bits_to_index(bits: torch.Tensor, num_qubits: int) -> torch.Tensor:
  """Big-endian bitstrings [..., num_qubits] -> flat basis index (int64)."""
  if num_qubits == 0:
    return torch.zeros(bits.shape[:-1], dtype=torch.int64, device=bits.device)
  weights = 2**torch.arange(num_qubits - 1, -1, -1, device=bits.device)
  return torch.sum(bits.to(torch.int64) * weights, dim=-1)


def basis_state(num_qubits: int, bits: torch.Tensor) -> torch.Tensor:
  """|b> for a bitstring `bits` of shape [num_qubits], as [R, C]."""
  m = minor_bits(num_qubits)
  nr = num_qubits - m
  r, c = state_shape(num_qubits)
  state = torch.zeros((r, c), dtype=COMPLEX_DTYPE, device=bits.device)
  state[bits_to_index(bits[:nr], nr), bits_to_index(bits[nr:], m)] = 1.0
  return state


# ---------------------------------------------------------------------------
# Gate matrices (host-side, complex64)
# ---------------------------------------------------------------------------

_H = np.array([[1, 1], [1, -1]], dtype=np.complex64) / np.sqrt(2.0)
# Generator G of each one-qubit dense kind (U = phase * exp(-i*phi/2*G)).
_GENERATOR = {
    ir.XP: paulis.PAULI_MATS[1], ir.YP: paulis.PAULI_MATS[2], ir.HP: _H,
    ir.RX: paulis.PAULI_MATS[1], ir.RY: paulis.PAULI_MATS[2],
    ir.RZ: paulis.PAULI_MATS[3],
}


def _c(x: torch.Tensor) -> torch.Tensor:
  return x.to(COMPLEX_DTYPE)


def _mat2(a, b, c, d) -> torch.Tensor:
  """[[a, b], [c, d]] over the trailing axes of same-shape [...] tensors."""
  return torch.stack([torch.stack([a, b], -1), torch.stack([c, d], -1)], -2)


def _one_qubit_rot(angle: torch.Tensor, axis: str) -> torch.Tensor:
  """exp(-i*angle/2 * P) for P in {X, Y, Z}."""
  c = _c(torch.cos(angle / 2))
  s = _c(torch.sin(angle / 2))
  if axis == "x":
    return _mat2(c, -1j * s, -1j * s, c)
  if axis == "y":
    return _mat2(c, -s, s, c)
  zero = torch.zeros_like(c)
  return _mat2(torch.exp(-1j * _c(angle) / 2), zero, zero,
               torch.exp(1j * _c(angle) / 2))


def _involution_power(angle: torch.Tensor, mat: np.ndarray) -> torch.Tensor:
  """cirq-convention G**t for involution G: exp(i*phi/2)*exp(-i*phi/2*G),
  with `angle` already phi = pi * t."""
  angle = _c(angle)[..., None, None]
  phase = torch.exp(1j * angle / 2)
  eye = torch.eye(mat.shape[0], dtype=COMPLEX_DTYPE, device=angle.device)
  g = torch.as_tensor(mat, dtype=COMPLEX_DTYPE, device=angle.device)
  return phase * (torch.cos(angle / 2) * eye - 1j * torch.sin(angle / 2) * g)


def gate_matrix(kind: str, angle) -> torch.Tensor:
  """Dense matrix of a gate given its resolved float32 angle parameter
  (cirq exponent t for power gates, rotation angle for rotations).  Angles
  of shape [...] give matrices [..., d, d]."""
  angle = torch.as_tensor(angle, dtype=torch.float32)
  if kind == ir.RX:
    return _one_qubit_rot(angle, "x")
  if kind == ir.RY:
    return _one_qubit_rot(angle, "y")
  if kind == ir.RZ:
    return _one_qubit_rot(angle, "z")
  if kind in (ir.XP, ir.YP, ir.HP):
    return _involution_power(math.pi * angle, _GENERATOR[kind])
  ph = torch.exp(1j * math.pi * _c(angle))
  one = torch.ones_like(ph)
  if kind == ir.ZP:
    return _mat2(one, torch.zeros_like(ph), torch.zeros_like(ph), ph)
  if kind == ir.CZP:
    return torch.diag_embed(torch.stack([one, one, one, ph], -1))
  raise NotImplementedError(f"no dense matrix for gate kind {kind!r} in the "
                            "port yet")


def gate_matrix_dangle(kind: str, angle) -> torch.Tensor:
  """d gate_matrix / d angle for the one-qubit dense kinds.

  Rotations: U = exp(-i*theta/2*G) => dU = (-i/2) G U.  Power gates:
  U = exp(i*phi/2) exp(-i*phi/2*G), phi = pi*t => dU = pi*(i/2)(I - G) U.
  """
  mat = gate_matrix(kind, angle)
  g = torch.as_tensor(_GENERATOR[kind], dtype=COMPLEX_DTYPE)
  if kind in (ir.RX, ir.RY, ir.RZ):
    return -0.5j * (g @ mat)
  if kind in (ir.XP, ir.YP, ir.HP):
    eye = torch.eye(2, dtype=COMPLEX_DTYPE)
    return (0.5j * math.pi) * ((eye - g) @ mat)
  raise NotImplementedError(f"no dense derivative for gate kind {kind!r}")


def segment_matrices(gates, angles: np.ndarray, fn=None):
  """[fn(gate.kind, angle)] for each gate, batched over the gates of one
  kind (fn defaults to gate_matrix); `angles` are the gates' host angles."""
  fn = fn or gate_matrix
  angles = torch.as_tensor(np.asarray(angles, np.float32))
  out = [None] * len(gates)
  for kind in sorted(set(g.kind for g in gates)):
    idx = [i for i, g in enumerate(gates) if g.kind == kind]
    mats = fn(kind, angles[idx])
    for j, i in enumerate(idx):
      out[i] = mats[j]
  return out


def resolve_angles(circuit: ir.Circuit, symbol_values) -> np.ndarray:
  """[num_gates] float32 host angles: coeff * values[slot] + shift, or shift
  alone for constant gates, in float32 arithmetic as the reference."""
  vals = np.asarray(symbol_values, np.float32)
  gates = circuit.gates
  slots = np.asarray([g.slot for g in gates], np.int64)
  coeff = np.asarray([g.coeff for g in gates], np.float32)
  shift = np.asarray([g.shift for g in gates], np.float32)
  if not len(vals):
    return shift
  return np.where(slots >= 0, coeff * vals[np.maximum(slots, 0)] + shift,
                  shift).astype(np.float32)


# ---------------------------------------------------------------------------
# Segmentation and static parity structure (pure Python, as the reference)
# ---------------------------------------------------------------------------

_ONEQ_DENSE_KINDS = frozenset({ir.XP, ir.YP, ir.HP, ir.RX, ir.RY})
_DIAG_KINDS = frozenset({ir.ZP, ir.RZ, ir.CZP, ir.ZZP, ir.GPHASE})


def _gate_class(gate: ir.Gate) -> str:
  if gate.kind in _ONEQ_DENSE_KINDS:
    return "1q"
  if gate.kind in _DIAG_KINDS:
    return "diag"
  if gate.kind == ir.PROT and all(p == paulis.Z for p in gate.paulis):
    return "diag"
  return "single"


@functools.lru_cache(maxsize=None)
def segment_circuit(gates: Tuple[ir.Gate, ...]):
  """Greedy segmentation into fusable runs: [(cls, (gate_indices...)), ...]
  with cls '1q' (1-qubit dense gates), 'diag' (diagonal gates) or 'single'."""
  segments = []
  i = 0
  while i < len(gates):
    cls = _gate_class(gates[i])
    j = i + 1
    while j < len(gates) and cls != "single" and _gate_class(gates[j]) == cls:
      j += 1
    segments.append((cls, tuple(range(i, j))))
    i = j
  return tuple(segments)


def _row_mask(q: int, nr: int) -> int:
  return 1 << (nr - 1 - q)


def _col_mask(q: int, nr: int, m: int) -> int:
  return 1 << (m - 1 - (q - nr))


def _bit_masks(q: int, nr: int, m: int) -> Tuple[int, int]:
  return ((_row_mask(q, nr), 0) if q < nr else (0, _col_mask(q, nr, m)))


def diag_parity_triples(gate: ir.Gate, nr: int, m: int):
  """Walsh decomposition of d(phase angle)/d(resolved angle) of a diagonal
  gate: [(coeff, row_mask, col_mask), ...] with
  m(x) = sum_k coeff_k * s(row & row_mask_k) * s(col & col_mask_k),
  s(y) = (-1)^popcount(y)."""

  def bit_triples(q, scale):
    rm, cm = _bit_masks(q, nr, m)
    return [(scale * 0.5, 0, 0), (-scale * 0.5, rm, cm)]

  def pair_triples(q0, q1, scale):
    rm0, cm0 = _bit_masks(q0, nr, m)
    rm1, cm1 = _bit_masks(q1, nr, m)
    s = scale * 0.25
    return [(s, 0, 0), (-s, rm0, cm0), (-s, rm1, cm1),
            (s, rm0 | rm1, cm0 | cm1)]

  if gate.kind == ir.ZP:
    return bit_triples(gate.qubits[0], np.pi)
  if gate.kind == ir.RZ:
    return bit_triples(gate.qubits[0], 1.0)[1:]
  if gate.kind == ir.CZP:
    return pair_triples(gate.qubits[0], gate.qubits[1], np.pi)
  if gate.kind == ir.ZZP:
    rm0, cm0 = _bit_masks(gate.qubits[0], nr, m)
    rm1, cm1 = _bit_masks(gate.qubits[1], nr, m)
    return [(np.pi / 2, 0, 0), (-np.pi / 2, rm0 | rm1, cm0 | cm1)]
  if gate.kind == ir.GPHASE:
    return [(1.0, 0, 0)]
  rm, cm = 0, 0  # PROT all-Z: -s(full mask)
  for q in gate.qubits:
    brm, bcm = _bit_masks(q, nr, m)
    rm |= brm
    cm |= bcm
  return [(-1.0, rm, cm)]


def diag_segment_triples(gates, nr: int, m: int):
  """Concatenated parity triples of a diagonal segment with gate ownership:
  (coeffs, row_masks, col_masks, owner)."""
  coeffs, rms, cms, owner = [], [], [], []
  for g_idx, gate in enumerate(gates):
    for coeff, rm, cm in diag_parity_triples(gate, nr, m):
      coeffs.append(coeff)
      rms.append(rm)
      cms.append(cm)
      owner.append(g_idx)
  return coeffs, rms, cms, owner


def pauli_z_masks(codes, nr: int, m: int):
  """(row_mask, col_mask) of a purely-diagonal (I/Z) Pauli string."""
  rm, cm = 0, 0
  for q, code in enumerate(codes):
    if code == paulis.Z:
      brm, bcm = _bit_masks(q, nr, m)
      rm |= brm
      cm |= bcm
  return rm, cm


@functools.lru_cache(maxsize=64)
def _parity_signs(masks: Tuple[int, ...], size: int,
                  device: str) -> torch.Tensor:
  idx = torch.arange(size, dtype=torch.int64)
  v = idx[None, :] & torch.tensor(masks, dtype=torch.int64)[:, None]
  for shift in (32, 16, 8, 4, 2, 1):
    v = v ^ (v >> shift)
  return (1 - 2 * (v & 1)).to(torch.float32).to(device)


def parity_signs(masks: Sequence[int], size: int, device=None) -> torch.Tensor:
  """[K, size] float32 parity signs s(i & mask_k) for i in [0, size).

  Cached per (masks, size, device): the masks are static circuit and
  observable structure, so each sign matrix crosses to the device once.
  The result is shared; do not write to it.  `device` None means the CUDA
  card (`device.resolve`)."""
  return _parity_signs(tuple(int(x) for x in masks), int(size),
                       str(device_lib.resolve(device)))


def parity_outer_sum(weights: torch.Tensor, row_masks, col_masks,
                     shape_rc) -> torch.Tensor:
  """sum_k w_k * s(row & rm_k) (x) s(col & cm_k) as one matmul.

  `weights` is [..., K] (real or complex); returns [..., R, C] in the
  weights' dtype, summed in it.  The reference chunks the factors for
  memory at 28 qubits; K = 116 factors of a 20-qubit segment fit in one
  [R, K] x [K, C] product.
  """
  r, c = shape_rc
  dev = weights.device
  s_r = parity_signs(row_masks, r, dev).to(weights.dtype)
  s_c = parity_signs(col_masks, c, dev).to(weights.dtype)
  return torch.matmul((weights[..., :, None] * s_r).transpose(-1, -2), s_c)


def parity_bilinear(row_masks, col_masks, p: torch.Tensor) -> torch.Tensor:
  """[..., K] vector of s_r_k^T P s_c_k for P [..., R, C]."""
  r, c = p.shape[-2:]
  s_r = parity_signs(row_masks, r, p.device)
  s_c = parity_signs(col_masks, c, p.device)
  w = torch.matmul(p, s_c.T)  # [..., R, K]
  return torch.einsum("kr,...rk->...k", s_r, w)


def diag_segment_weights(gates, angles, nr: int, m: int):
  """(weights [K] float32 host array, row_masks, col_masks) of a diagonal
  segment: weight_k = coeff_k * angle of the gate owning factor k, in
  float32 as the reference."""
  coeffs, rms, cms, owner = diag_segment_triples(gates, nr, m)
  owned = np.asarray(angles, np.float32)[np.asarray(owner, np.int64)]
  return np.asarray(coeffs, np.float32) * owned, rms, cms


def diag_segment_phase(gates, angles, shape_rc, device=None) -> torch.Tensor:
  """float32 total phase angle [R, C] of a run of diagonal gates with host
  angles `angles`, on `device` (None means the CUDA card); summed in
  float64, as the single-state kernels sum each amplitude's phase."""
  r, c = shape_rc
  n = (int(r) * int(c)).bit_length() - 1
  m = int(c).bit_length() - 1
  weights, rms, cms = diag_segment_weights(gates, angles, n - m, m)
  return parity_outer_sum(torch.tensor(weights, dtype=torch.float64,
                                       device=device_lib.resolve(device)),
                          rms, cms, shape_rc).to(torch.float32)


# ---------------------------------------------------------------------------
# Operator folds and state-sized contractions
# ---------------------------------------------------------------------------

def _row_blocks(nr: int):
  """Partition of the nr row qubits into <=7-bit contiguous blocks."""
  blocks = []
  pos = 0
  while pos < nr:
    k = min(_ROW_BLOCK_BITS, nr - pos)
    blocks.append((pos, k))
    pos += k
  return blocks


def _fold_block(mats_by_qubit, start: int, k: int):
  """kron over qubits [start, start+k): per-qubit matrix or identity.
  Returns None when no qubit in the block has a matrix."""
  if not any(start <= q < start + k for q in mats_by_qubit):
    return None
  mat = None
  eye = torch.eye(2, dtype=COMPLEX_DTYPE)
  for q in range(start, start + k):
    f = mats_by_qubit.get(q, eye)
    mat = f if mat is None else torch.kron(mat, f)
  return mat


@functools.lru_cache(maxsize=None)
def _embed_perm(positions: Tuple[int, ...], m: int) -> np.ndarray:
  """Static permutation taking the desired column-bit order to the kron
  layout (gate bits as MSBs in `positions` order, identity bits after)."""
  others = [p for p in range(m) if p not in positions]
  perm = np.zeros(2**m, np.int64)
  for j in range(2**m):
    bits = [(j >> (m - 1 - t)) & 1 for t in range(m)]
    idx = 0
    for p in list(positions) + others:
      idx = (idx << 1) | bits[p]
    perm[j] = idx
  return perm


def apply_row_block(mat_k: torch.Tensor, start: int, k: int,
                    state: torch.Tensor) -> torch.Tensor:
  """Contracts a [2^k, 2^k] operator (or a [..., 2^k, 2^k] batch matching
  the state's batch) against row qubits [start, start+k)."""
  shape = state.shape
  r, c = shape[-2:]
  v = state.reshape(shape[:-2] + (2**start, 2**k, (r * c) >> (start + k)))
  if mat_k.dim() == 2:
    out = torch.einsum("MN,...aNb->...aMb", mat_k, v)
  else:
    out = torch.einsum("...MN,...aNb->...aMb", mat_k, v)
  return out.reshape(shape)


def apply_minor_mat(state: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
  """state @ mat^T against a [C, C] (or batched [..., C, C]) operator."""
  return torch.matmul(state, mat.transpose(-1, -2))


def apply_majors_and_minor(state: torch.Tensor, major_by_qubit,
                           minor_combined, plain: bool = False) -> torch.Tensor:
  """Folded row-block operators and the combined minor operator, shared by
  the forward 1q segment and the adjoint un-applies.  Dispatches K1: the
  operators pair into `axis2_apply` passes (hopper_sv.plan_passes), each
  one pass over the state; on the CPU (or with `plain`) the passes run
  their plain versions."""
  from qhbmlib_tpu_torch.ops import hopper_sv  # hopper_sv imports this
  n = num_qubits_of(state)
  r, c = state.shape[-2:]
  m = int(c).bit_length() - 1
  ops = hopper_sv.segment_ops(major_by_qubit, minor_combined, n - m, m)
  if not ops:
    return state
  flat = state.reshape(-1, r, c)
  planes = (flat.real.contiguous(), flat.imag.contiguous())
  passes = hopper_sv.device_passes(ops, n - m, state.device)
  re, im = hopper_sv.apply_passes(passes, [planes], n, plain)[0]
  return torch.complex(re, im).reshape(state.shape)


# ---------------------------------------------------------------------------
# Single-state circuit application
# ---------------------------------------------------------------------------

def zero_state(num_qubits: int, device=None) -> torch.Tensor:
  """|0...0> as an [R, C] complex64 state on `device` (None means the CUDA
  card, `device.resolve`)."""
  state = torch.zeros(state_shape(num_qubits), dtype=COMPLEX_DTYPE,
                      device=device_lib.resolve(device))
  state[0, 0] = 1.0
  return state


def to_vector(state: torch.Tensor) -> torch.Tensor:
  """[..., R, C] -> [..., 2^n] in the standard basis order."""
  return state.reshape(state.shape[:-2] + (-1,))


def from_vector(vec: torch.Tensor, num_qubits: int) -> torch.Tensor:
  """[..., 2^n] -> [..., R, C]."""
  return vec.reshape(vec.shape[:-1] + state_shape(num_qubits))


def _planes_of(state: torch.Tensor):
  return (state.real.contiguous(), state.imag.contiguous())


def _apply_1q_segment(gates, angles, state: torch.Tensor) -> torch.Tensor:
  """A run of 1-qubit dense gates: per-qubit products, kron-folded into
  <= 7-bit row-block operators and one [C, C] minor operator."""
  from qhbmlib_tpu_torch.ops import hopper_sv  # hopper_sv imports this
  m = int(state.shape[-1]).bit_length() - 1
  nr = num_qubits_of(state) - m
  return apply_majors_and_minor(state,
                                *hopper_sv.fold_1q(gates, angles, nr, m))


def _apply_diag_segment(gates, angles, state: torch.Tensor) -> torch.Tensor:
  """A run of diagonal gates: one rotation by the materialized total phase
  (`diag_rotate`, at B = 1)."""
  from qhbmlib_tpu_torch.ops import hopper_sv  # hopper_sv imports this
  r, c = state.shape
  nr = num_qubits_of(state) - (int(c).bit_length() - 1)
  weights, rms, cms = diag_segment_weights(gates, angles, nr,
                                           int(c).bit_length() - 1)
  (w,) = hopper_sv.to_device([torch.from_numpy(weights)], state.device)
  cos_t, sin_t = hopper_sv.rotation_planes(w, rms, cms, (r, c))
  re, im = (t.reshape(1, r, c) for t in _planes_of(state))
  hopper_sv.diag_rotate([(re, im)], cos_t, sin_t, +1)
  return torch.complex(re, im).reshape(r, c)


def _apply_circuit_torch(circuit: ir.Circuit, symbol_values,
                         state: torch.Tensor) -> torch.Tensor:
  """Segment by segment: K1 / `axis_apply` passes for 1q segments and
  `diag_rotate` for diagonal ones, at B = 1."""
  from qhbmlib_tpu_torch.ops import hopper_sv  # hopper_sv imports this
  angles = resolve_angles(circuit, hopper_sv.host_values(symbol_values))
  for cls, idxs in segment_circuit(circuit.gates):
    seg_gates = [circuit.gates[i] for i in idxs]
    if cls == "1q":
      state = _apply_1q_segment(seg_gates, angles[list(idxs)], state)
    elif cls == "diag":
      state = _apply_diag_segment(seg_gates, angles[list(idxs)], state)
    else:
      raise NotImplementedError(
          f"gate {seg_gates[0].kind!r} is neither a 1q dense nor a diagonal "
          "gate; the port's engine does not take it yet")
  return state


def apply_circuit(circuit: ir.Circuit, symbol_values,
                  state: torch.Tensor) -> torch.Tensor:
  """U(values) applied to one [R, C] complex64 state of any content.

  8 <= n <= 20 qubits: K3 (`hopper_sv.circuit_forward`), the whole circuit
  in one cooperative launch on the card (its plain version on the CPU), as
  the reference admits its VMEM-resident kernel.  Otherwise segment by
  segment (`_apply_circuit_torch`).  `symbol_values` is a tensor on any
  device or a host array: operators are folded on the host."""
  from qhbmlib_tpu_torch.ops import hopper_sv  # hopper_sv imports this
  if hopper_sv.single_admits(circuit.num_qubits):
    return torch.complex(*hopper_sv.circuit_forward(
        circuit, symbol_values, _planes_of(state)))
  return _apply_circuit_torch(circuit, symbol_values, state)


def cross_gram(lam: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
  """[..., C, C] sum_r conj(lam)[r, c] * a[r, d]."""
  return torch.einsum("...rc,...rd->...cd", lam.conj(), a)


def block_transition(lam: torch.Tensor, a: torch.Tensor, start: int,
                     k: int) -> torch.Tensor:
  """G[..., I, J] = sum_rest conj(lam)[..I..] a[..J..] over a row block."""
  shape = a.shape
  r, c = shape[-2:]
  view = shape[:-2] + (2**start, 2**k, (r * c) >> (start + k))
  return torch.einsum("...aIb,...aJb->...IJ", lam.reshape(view).conj(),
                      a.reshape(view))


def partial_trace_1q(g_block: torch.Tensor, k: int,
                     pos_in_block: int) -> torch.Tensor:
  """[2^k, 2^k] block transition -> the 2x2 single-qubit transition."""
  pre, post = 2**pos_in_block, 2**(k - pos_in_block - 1)
  gt = g_block.reshape(pre, 2, post, pre, 2, post)
  return torch.einsum("aibajb->ij", gt)


# ---------------------------------------------------------------------------
# Pauli sums: expectations and applies (diag / minor-only / row-block tiers)
# ---------------------------------------------------------------------------

def _is_diag_codes(codes) -> bool:
  return all(code in (paulis.I, paulis.Z) for code in codes)


def _term_factors(codes_row, nr: int):
  """([(q, code)] major factors, [(pos_in_minor, code)] minor factors)."""
  majors = [(q, code) for q, code in enumerate(codes_row)
            if code != paulis.I and q < nr]
  minors = [(q - nr, code) for q, code in enumerate(codes_row)
            if code != paulis.I and q >= nr]
  return majors, minors


def _minor_pauli_np(minor_factors, m: int) -> np.ndarray:
  """Static [C, C] complex64 matrix of a minor-only Pauli string."""
  positions = tuple(p for p, _ in minor_factors)
  mat = None
  for _, code in minor_factors:
    f = paulis.PAULI_MATS[code]
    mat = f if mat is None else np.kron(mat, f)
  if mat is None:
    return np.eye(2**m, dtype=np.complex64)
  big = np.kron(mat, np.eye(2**(m - len(positions)), dtype=np.complex64))
  perm = _embed_perm(positions, m)
  return np.ascontiguousarray(big[perm][:, perm]).astype(np.complex64)


def _embed_block_pauli_np(major_factors, start: int, k: int) -> np.ndarray:
  """Static [2^k, 2^k] kron of per-qubit Pauli factors over the row block
  [start, start+k), identity on untouched qubits."""
  by_qubit = dict(major_factors)
  mat = None
  for q in range(start, start + k):
    f = paulis.PAULI_MATS[by_qubit.get(q, paulis.I)]
    mat = f if mat is None else np.kron(mat, f)
  return mat.astype(np.complex64)


def _tier_terms(rows, nr: int):
  """(diag, minor_only, {block: [terms]}) term indices; raises for the tiers
  the port has not taken over yet."""
  diag, minor_only = [], []
  blocks = _row_blocks(nr)
  block_terms = {b: [] for b in blocks}
  for t, codes in enumerate(rows):
    if _is_diag_codes(codes):
      diag.append(t)
      continue
    majors, minors = _term_factors(codes, nr)
    if not majors:
      minor_only.append(t)
      continue
    mq = [q for q, _ in majors]
    home = [b for b in blocks if b[0] <= mq[0] and mq[-1] < b[0] + b[1]]
    if minors or not home:
      raise NotImplementedError(
          f"Pauli term {codes} spans row blocks or mixes row and column "
          "qubits; that tier is not ported yet")
    block_terms[home[0]].append(t)
  return diag, minor_only, block_terms


@functools.lru_cache(maxsize=256)
def _index(idx: Tuple[int, ...], device: str) -> torch.Tensor:
  """A static int64 index tensor on `device` (cached: indexing a device
  tensor with a Python list would copy the list over, waiting for the
  stream)."""
  return torch.tensor(idx, dtype=torch.int64).to(device)


@functools.lru_cache(maxsize=64)
def _pauli_stack(rows, terms: Tuple[int, ...], nr: int, m: int, block,
                 device: str) -> torch.Tensor:
  """[len(terms), N, N] complex64 static Pauli matrices of minor-only terms
  (block None, N = C) or of terms inside row block `block` (N = 2^k), on
  `device`; cached, so each crosses to the device once."""
  if block is None:
    mats = [_minor_pauli_np(_term_factors(rows[t], nr)[1], m) for t in terms]
  else:
    mats = [_embed_block_pauli_np(_term_factors(rows[t], nr)[0], *block)
            for t in terms]
  return torch.as_tensor(np.stack(mats)).to(device)


def expectation_terms(state: torch.Tensor,
                      op: paulis.PauliSum) -> torch.Tensor:
  """Per-term real expectations <psi|P_t|psi>, shape [..., num_terms].

  Coefficients are NOT applied (the caller dots with `op.coeffs`)."""
  if op.num_terms == 0:  # e.g. an empty concat_ops; torch.cat([]) raises
    return torch.zeros(state.shape[:-2] + (0,), dtype=torch.float32,
                       device=state.device)
  rows = op.code_rows()
  m = int(state.shape[-1]).bit_length() - 1
  nr = op.num_qubits - m
  diag, minor_only, block_terms = _tier_terms(rows, nr)
  dev = str(state.device)
  parts = []  # (term indices, values [..., len(indices)])
  if diag:
    masks = [pauli_z_masks(rows[t], nr, m) for t in diag]
    prob = (state.conj() * state).real
    parts.append((diag, parity_bilinear([rm for rm, _ in masks],
                                        [cm for _, cm in masks], prob)))
  if minor_only:
    stack = _pauli_stack(rows, tuple(minor_only), nr, m, None, dev)
    parts.append((minor_only, torch.einsum(
        "tij,...ij->...t", stack, cross_gram(state, state)).real))
  for (start, k), ts in block_terms.items():
    if ts:
      stack = _pauli_stack(rows, tuple(ts), nr, m, (start, k), dev)
      parts.append((ts, torch.einsum(
          "tij,...ij->...t", stack,
          block_transition(state, state, start, k)).real))
  vals = torch.cat([v for _, v in parts], dim=-1)
  return vals[..., _index(tuple(np.argsort([t for ts, _ in parts
                                            for t in ts])), dev)]


def apply_pauli_sum(state: torch.Tensor, op: paulis.PauliSum,
                    term_weights: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
  """(sum_t w_t * coeffs[t] * P_t)|psi>; `term_weights` is [..., T] and
  broadcasts against the state's batch dimensions."""
  rows = op.code_rows()
  n = op.num_qubits
  m = int(state.shape[-1]).bit_length() - 1
  nr = n - m
  diag, minor_only, block_terms = _tier_terms(rows, nr)
  w = op.coeffs.to(state.device, COMPLEX_DTYPE)
  if term_weights is not None:
    w = w * term_weights.to(COMPLEX_DTYPE)

  out = torch.zeros_like(state)
  if diag:
    masks = [pauli_z_masks(rows[t], nr, m) for t in diag]
    d = parity_outer_sum(w[..., _index(tuple(diag), str(state.device))],
                         [rm for rm, _ in masks],
                         [cm for _, cm in masks], state.shape[-2:])
    out = out + d * state

  def weighted_sum(ts, block):
    stack = _pauli_stack(rows, tuple(ts), nr, m, block, str(state.device))
    return torch.einsum("...t,tij->...ij",
                        w[..., _index(tuple(ts), str(state.device))], stack)

  if minor_only:
    out = out + apply_minor_mat(state, weighted_sum(minor_only, None))
  for (start, k), ts in block_terms.items():
    if ts:
      out = out + apply_row_block(weighted_sum(ts, (start, k)), start, k,
                                  state)
  return out
