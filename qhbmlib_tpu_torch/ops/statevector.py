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
torch matmuls in float32 whatever the caller's TF32 setting: the Pauli
tiers and the parity sums (`expectation_terms`, `apply_pauli_sum`,
`parity_outer_sum`) turn `torch.backends.cuda.matmul.allow_tf32` off while
they run and restore the caller's flag (`fp32_matmuls`).

Pauli tiers, as in the reference (`expectation_terms` :1454-1517,
`apply_pauli_sum` :526-584): diagonal (I/Z) terms in one parity
contraction, minor-only terms in one [C, C] product, terms inside one row
block in one block operator, terms spanning row blocks on <= 3 qubits in
kron bins (`_bin_by_support`, `major_transition`, `apply_dense`), terms
mixing row and column qubits on <= 3 row qubits in column-resolved bins
(expectations; the apply takes them term by term), and the rest term by
term (`apply_pauli_string`).  Every tier takes leading batch axes.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from qhbmlib_tpu_torch import device as device_lib
from qhbmlib_tpu_torch import tracing
from qhbmlib_tpu_torch import utils
from qhbmlib_tpu_torch.ops import circuit_ir as ir
from qhbmlib_tpu_torch.ops import paulis

COMPLEX_DTYPE = torch.complex64

# Qubits kept in the minor (column) dimension: C = 128.
MINOR_MAX = 7

# Row qubits are processed in contiguous blocks of up to this many bits.
_ROW_BLOCK_BITS = 7


def fp32_matmuls(fn):
  """`fn` with TF32 matmuls off on the card, the caller's
  `torch.backends.cuda.matmul.allow_tf32` restored after it."""

  @functools.wraps(fn)
  def pinned(*args, **kwargs):
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
      return fn(*args, **kwargs)
    finally:
      torch.backends.cuda.matmul.allow_tf32 = flag

  return pinned


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


def index_to_bits(idx: torch.Tensor, num_qubits: int) -> torch.Tensor:
  """Flat basis index -> big-endian int8 bitstring, last dim num_qubits."""
  shifts = torch.arange(num_qubits - 1, -1, -1, device=idx.device)
  return ((idx.to(torch.int64)[..., None] >> shifts) & 1).to(torch.int8)


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
# Generator G of each dense kind (U = phase * exp(-i*phi/2*G)).
_GENERATOR = {
    ir.XP: paulis.PAULI_MATS[1], ir.YP: paulis.PAULI_MATS[2], ir.HP: _H,
    ir.RX: paulis.PAULI_MATS[1], ir.RY: paulis.PAULI_MATS[2],
    ir.RZ: paulis.PAULI_MATS[3],
    ir.XXP: np.kron(paulis.PAULI_MATS[1], paulis.PAULI_MATS[1]),
    ir.YYP: np.kron(paulis.PAULI_MATS[2], paulis.PAULI_MATS[2]),
    ir.ZZP: np.kron(paulis.PAULI_MATS[3], paulis.PAULI_MATS[3]),
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


def _pauli_string_mat(paulis_codes) -> np.ndarray:
  """kron of the one-qubit Paulis of `paulis_codes`, the first most
  significant."""
  mat = np.ones((1, 1), np.complex64)
  for code in paulis_codes:
    mat = np.kron(mat, paulis.PAULI_MATS[code])
  return mat


def gate_matrix(kind: str, angle, paulis_codes=()) -> torch.Tensor:
  """Dense matrix of a gate given its resolved float32 angle parameter
  (cirq exponent t for power gates, rotation angle for rotations, theta of
  exp(-i*theta*P) for PROT with the Pauli codes `paulis_codes`), its axes
  in the order of the gate's qubits (reference `gate_matrix`,
  statevector.py:116-155).  Angles of shape [...] give matrices
  [..., d, d]."""
  angle = torch.as_tensor(angle, dtype=torch.float32)
  if kind == ir.RX:
    return _one_qubit_rot(angle, "x")
  if kind == ir.RY:
    return _one_qubit_rot(angle, "y")
  if kind == ir.RZ:
    return _one_qubit_rot(angle, "z")
  if kind in _GENERATOR:
    return _involution_power(math.pi * angle, _GENERATOR[kind])
  if kind == ir.PROT:
    a = _c(angle)[..., None, None]
    p = torch.as_tensor(_pauli_string_mat(paulis_codes))
    return torch.cos(a) * torch.eye(p.shape[0], dtype=COMPLEX_DTYPE) - \
        1j * torch.sin(a) * p
  ph = torch.exp(1j * math.pi * _c(angle))
  one = torch.ones_like(ph)
  if kind == ir.ZP:
    return _mat2(one, torch.zeros_like(ph), torch.zeros_like(ph), ph)
  if kind == ir.CZP:
    return torch.diag_embed(torch.stack([one, one, one, ph], -1))
  if kind == ir.CXP:
    out = torch.zeros(angle.shape + (4, 4), dtype=COMPLEX_DTYPE)
    out[..., 0, 0] = 1.0
    out[..., 1, 1] = 1.0
    out[..., 2:, 2:] = _involution_power(math.pi * angle,
                                         paulis.PAULI_MATS[1])
    return out
  raise ValueError(f"no dense matrix for gate kind {kind!r}")


def gate_matrix_dangle(kind: str, angle, paulis_codes=()) -> torch.Tensor:
  """d gate_matrix / d angle.

  Rotations: U = exp(-i*theta/2*G) => dU = (-i/2) G U.  PROT: U =
  exp(-i*theta*P) => dU = -i P U.  Power gates: U = exp(i*phi/2)
  exp(-i*phi/2*G), phi = pi*t => dU = pi*(i/2)(I - G) U (CXP on its
  control-1 block, zero on the other)."""
  mat = gate_matrix(kind, angle, paulis_codes)
  if kind in (ir.RX, ir.RY, ir.RZ):
    return -0.5j * (torch.as_tensor(_GENERATOR[kind], dtype=COMPLEX_DTYPE)
                    @ mat)
  if kind == ir.PROT:
    return -1j * (torch.as_tensor(_pauli_string_mat(paulis_codes),
                                  dtype=COMPLEX_DTYPE) @ mat)
  if kind == ir.CXP:
    out = torch.zeros_like(mat)
    out[..., 2:, 2:] = gate_matrix_dangle(ir.XP, angle)
    return out
  if kind in (ir.ZP, ir.CZP):
    g = np.diag(np.where(np.arange(mat.shape[-1]) == mat.shape[-1] - 1, -1,
                         1)).astype(np.complex64)
  else:
    g = _GENERATOR[kind]
  eye = torch.eye(mat.shape[-1], dtype=COMPLEX_DTYPE)
  return (0.5j * math.pi) * ((eye - torch.as_tensor(g, dtype=COMPLEX_DTYPE))
                             @ mat)


def segment_matrices(gates, angles: np.ndarray, fn=None):
  """[fn(gate.kind, angle, gate.paulis)] for each gate, batched over the
  gates of one (kind, paulis) (fn defaults to gate_matrix); `angles` are
  the gates' host angles."""
  fn = fn or gate_matrix
  angles = torch.as_tensor(np.asarray(angles, np.float32))
  out = [None] * len(gates)
  for key in sorted(set((g.kind, g.paulis) for g in gates)):
    idx = [i for i, g in enumerate(gates) if (g.kind, g.paulis) == key]
    mats = fn(key[0], angles[idx], key[1])
    for j, i in enumerate(idx):
      out[i] = mats[j]
  return out


def resolve_angles(circuit: ir.Circuit, symbol_values,
                   angle_offsets=None) -> np.ndarray:
  """[num_gates] float32 host angles: coeff * values[slot] + shift, or shift
  alone for constant gates, in float32 arithmetic as the reference, plus
  `angle_offsets[g]` for gate g where given ([num_gates], the parameter
  shift's hook; reference statevector.py:1386-1390)."""
  vals = np.asarray(symbol_values, np.float32)
  gates = circuit.gates
  slots = np.asarray([g.slot for g in gates], np.int64)
  coeff = np.asarray([g.coeff for g in gates], np.float32)
  shift = np.asarray([g.shift for g in gates], np.float32)
  angles = shift if not len(vals) else np.where(
      slots >= 0, coeff * vals[np.maximum(slots, 0)] + shift,
      shift).astype(np.float32)
  if angle_offsets is None:
    return angles
  return angles + np.asarray(angle_offsets, np.float32)


# ---------------------------------------------------------------------------
# Segmentation and static parity structure (pure Python, as the reference)
# ---------------------------------------------------------------------------

_ONEQ_DENSE_KINDS = frozenset({ir.XP, ir.YP, ir.HP, ir.RX, ir.RY})
_DIAG_KINDS = frozenset({ir.ZP, ir.RZ, ir.CZP, ir.ZZP, ir.GPHASE})


def _gate_class(gate: ir.Gate) -> str:
  """'1q', 'diag' or 'single', as the reference's `_gate_class`, except
  that a one-qubit PROT on X or Y is '1q': exp(-i*a*P) is then a 2x2 dense
  gate, so a layer of X-field PROTs folds into one segment instead of a
  flip pass a gate."""
  if gate.kind in _ONEQ_DENSE_KINDS:
    return "1q"
  if gate.kind in _DIAG_KINDS:
    return "diag"
  if gate.kind == ir.PROT and all(p == paulis.Z for p in gate.paulis):
    return "diag"
  if gate.kind == ir.PROT and len(gate.qubits) == 1:
    return "1q"
  return "single"


@functools.lru_cache(maxsize=None)
def segment_circuit(gates: Tuple[ir.Gate, ...]):
  """Greedy segmentation into fusable runs: [(cls, (gate_indices...)), ...]
  with cls '1q' (1-qubit dense gates), 'diag' (diagonal gates) or 'single'
  (one gate of the flip class: CXP, XXP, YYP, a PROT with X or Y factors
  on two or more qubits)."""
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


def _rows_matmul(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """s [M, N] times every [N, C] matrix of x [..., N, C] as ONE 2-D matmul
  over [N, (...)*C] (a batched matmul would expand s over the batch)."""
  lead, (n, c) = x.shape[:-2], x.shape[-2:]
  flat = x.reshape(-1, n, c).transpose(0, 1).reshape(n, -1)
  out = torch.matmul(s, flat).reshape(s.shape[0], -1, c).transpose(0, 1)
  return out.reshape(lead + (s.shape[0], c))


@fp32_matmuls
def parity_outer_sum(weights: torch.Tensor, row_masks, col_masks,
                     shape_rc) -> torch.Tensor:
  """sum_k w_k * s(row & rm_k) (x) s(col & cm_k) as one matmul.

  `weights` is [..., K] (real or complex); returns [..., R, C] in the
  weights' dtype, summed in it.  The weights scale the [K, C] column signs
  (each product is +-w_k, exact), then one [R, K] x [K, (...)*C] product:
  no [..., K, R] temporary, which grows with K (406 factors of a 28-qubit
  KOBE-2 observable) where the reference chunks the factors.
  """
  r, c = shape_rc
  dev = weights.device
  s_r = parity_signs(row_masks, r, dev).T
  s_c = parity_signs(col_masks, c, dev)
  real = weights.real if weights.is_complex() else weights
  w_c = weights[..., :, None] * s_c.to(real.dtype)  # [..., K, C]
  if not weights.is_complex():
    return _rows_matmul(s_r.to(weights.dtype), w_c)
  return torch.complex(_rows_matmul(s_r.to(real.dtype), w_c.real),
                       _rows_matmul(s_r.to(real.dtype), w_c.imag))


def parity_bilinear(row_masks, col_masks, p: torch.Tensor) -> torch.Tensor:
  """[..., K] vector of s_r_k^T P s_c_k for P [..., R, C]: the row-signed
  sums S_r P [..., K, C], then each factor's column signs."""
  r, c = p.shape[-2:]
  s_r = parity_signs(row_masks, r, p.device)
  s_c = parity_signs(col_masks, c, p.device)
  return torch.sum(_rows_matmul(s_r, p) * s_c, dim=-1)


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


def _embed_minor_mat(mat_k: torch.Tensor, positions: Tuple[int, ...],
                     m: int) -> torch.Tensor:
  """Embeds a k-qubit matrix [..., 2^k, 2^k] (axes in `positions` order,
  most significant first) into the [..., C, C] minor operator."""
  k = len(positions)
  if k == m and tuple(positions) == tuple(range(m)):
    return mat_k
  d, e = 2**k, 2**(m - k)
  eye = torch.eye(e, dtype=mat_k.dtype, device=mat_k.device)
  big = (mat_k[..., :, None, :, None] * eye.reshape(1, e, 1, e)).reshape(
      mat_k.shape[:-2] + (d * e, d * e))
  perm = _index(tuple(int(x) for x in _embed_perm(tuple(positions), m)),
                str(mat_k.device))
  return big[..., perm, :][..., :, perm]


def apply_dense(mat: torch.Tensor, qubits: Tuple[int, ...],
                state: torch.Tensor) -> torch.Tensor:
  """A dense operator on 1-3 major qubits, on minor qubits only, or on one
  major and one minor qubit, applied to [..., R, C] states (reference
  `apply_dense`, statevector.py:236-307).  `mat` is [2^k, 2^k] or batched
  [..., 2^k, 2^k] against the states' batch, its axes in the order of
  `qubits` (qubits[0] most significant); 3 major qubits come sorted."""
  shape = state.shape
  lead = shape[:-2]
  c = int(shape[-1])
  m = c.bit_length() - 1
  nr = num_qubits_of(state) - m
  majors = [q for q in qubits if q < nr]
  minors = [q for q in qubits if q >= nr]
  if not majors:
    return apply_minor_mat(state, _embed_minor_mat(
        mat, tuple(q - nr for q in qubits), m))
  mt = mat.reshape(mat.shape[:-2] + (2,) * (2 * len(qubits)))
  if not minors:
    if len(qubits) == 1:
      view = state.reshape(lead + (2**qubits[0], 2, -1))
      out = torch.einsum("...ij,...ajb->...aib", mat, view)
    elif len(qubits) == 2:
      s0, s1 = sorted(qubits)
      view = state.reshape(lead + (2**s0, 2, 2**(s1 - s0 - 1), 2, -1))
      prog = ("...XYxy,...axbyd->...aXbYd" if qubits[0] == s0 else
              "...XYxy,...aybxd->...aYbXd")
      out = torch.einsum(prog, mt, view)
    else:
      q0, q1, q2 = qubits
      if not q0 < q1 < q2:
        raise ValueError(f"apply_dense takes 3 major qubits sorted: {qubits}")
      view = state.reshape(lead + (2**q0, 2, 2**(q1 - q0 - 1), 2,
                                   2**(q2 - q1 - 1), 2, -1))
      out = torch.einsum("...XYZxyz,...axbydze->...aXbYdZe", mt, view)
    return out.reshape(shape)
  if len(majors) != 1 or len(minors) != 1:
    raise NotImplementedError(f"apply_dense on qubits {qubits}: a mixed "
                              "operator takes one major and one minor qubit")
  (maj,), (mnr,) = majors, minors
  view = state.reshape(lead + (2**maj, 2, -1, c))
  if qubits[0] != maj:  # axes (maj_out, mnr_out, maj_in, mnr_in)
    mt = mt.transpose(-4, -3).transpose(-2, -1)
  outs = []
  for i in (0, 1):
    acc = None
    for j in (0, 1):
      emb = _embed_minor_mat(mt[..., i, :, j, :], (mnr - nr,), m)
      contrib = torch.einsum("...cd,...abd->...abc", emb,
                             view.select(-3, j))
      acc = contrib if acc is None else acc + contrib
    outs.append(acc)
  return torch.stack(outs, dim=-3).reshape(shape)


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


def _apply_flip_gate(gate, angle, state: torch.Tensor) -> torch.Tensor:
  """One gate of the flip class: `flip_apply` at B = 1."""
  from qhbmlib_tpu_torch.ops import hopper_sv  # hopper_sv imports this
  r, c = state.shape
  re, im = (t.reshape(1, r, c) for t in _planes_of(state))
  hopper_sv.flip_apply([(re, im)], hopper_sv.flip_record(
      gate, angle, num_qubits_of(state)))
  return torch.complex(re, im).reshape(r, c)


def _apply_circuit_torch(circuit: ir.Circuit, symbol_values,
                         state: torch.Tensor,
                         angle_offsets=None) -> torch.Tensor:
  """Segment by segment: K1 / `axis_apply` passes for 1q segments,
  `diag_rotate` for diagonal ones and `flip_apply` for a gate of the flip
  class, at B = 1."""
  from qhbmlib_tpu_torch.ops import hopper_sv  # hopper_sv imports this
  angles = resolve_angles(circuit, hopper_sv.host_values(symbol_values),
                          angle_offsets)
  for cls, idxs in segment_circuit(circuit.gates):
    seg_gates = [circuit.gates[i] for i in idxs]
    if cls == "1q":
      state = _apply_1q_segment(seg_gates, angles[list(idxs)], state)
    elif cls == "diag":
      state = _apply_diag_segment(seg_gates, angles[list(idxs)], state)
    else:
      state = _apply_flip_gate(seg_gates[0], angles[idxs[0]], state)
  return state


def apply_circuit(circuit: ir.Circuit, symbol_values, state: torch.Tensor,
                  angle_offsets=None) -> torch.Tensor:
  """U(values) applied to one [R, C] complex64 state of any content.

  A circuit of 8 <= n <= 20 qubits with no gate of the flip class
  (`hopper_sv.single_supported`): K3 (`hopper_sv.circuit_forward`), the
  whole circuit in one cooperative launch on the card (its plain version
  on the CPU), as the reference admits its VMEM-resident kernel
  (`pallas_sv.supported`).  Otherwise segment by segment
  (`_apply_circuit_torch`), as the reference's XLA path.  `symbol_values`
  is a tensor on any device or a host array: operators are folded on the
  host.  `angle_offsets` ([num_gates], optional) is added to each gate's
  resolved angle on the host (`resolve_angles`)."""
  from qhbmlib_tpu_torch.ops import hopper_sv  # hopper_sv imports this
  if hopper_sv.single_supported(circuit):
    return torch.complex(*hopper_sv.circuit_forward(
        circuit, symbol_values, _planes_of(state),
        angle_offsets=angle_offsets))
  return _apply_circuit_torch(circuit, symbol_values, state, angle_offsets)


def _prot_codes(gate: ir.Gate, n: int):
  codes = [0] * n
  for q, p in zip(gate.qubits, gate.paulis):
    codes[q] = p
  return codes


def apply_gate(gate: ir.Gate, angle, state: torch.Tensor) -> torch.Tensor:
  """One gate at its resolved angle on [..., R, C] states, with torch ops
  (reference `apply_gate`, statevector.py:604-615): PROT as
  cos(a) s - i sin(a) P s through `apply_pauli_string`, a global phase as
  a multiply, the rest through `apply_dense`."""
  a = _c(torch.as_tensor(angle, dtype=torch.float32))
  if gate.kind == ir.PROT:
    p_state = apply_pauli_string(state, _prot_codes(gate,
                                                    num_qubits_of(state)))
    return torch.cos(a) * state - 1j * torch.sin(a) * p_state
  if gate.kind == ir.GPHASE:
    return torch.exp(1j * a) * state
  return apply_dense(gate_matrix(gate.kind, angle).to(state.device),
                     gate.qubits, state)


def apply_gate_dangle(gate: ir.Gate, angle,
                      state: torch.Tensor) -> torch.Tensor:
  """(dU/dangle)|psi> on [..., R, C] states (reference
  `apply_gate_dangle`, statevector.py:618-630)."""
  a = _c(torch.as_tensor(angle, dtype=torch.float32))
  if gate.kind == ir.PROT:
    p_state = apply_pauli_string(state, _prot_codes(gate,
                                                    num_qubits_of(state)))
    return -torch.sin(a) * state - 1j * torch.cos(a) * p_state
  if gate.kind == ir.GPHASE:
    return 1j * torch.exp(1j * a) * state
  return apply_dense(gate_matrix_dangle(gate.kind, angle).to(state.device),
                     gate.qubits, state)


# Products one GEMM entry of a state-sized gram sums (`_gram`).  A whole
# contraction in one complex64 GEMM lost up to 5e-4 (absolute, on
# normalized states) on the card where it spans 2^21 products (row block
# (14,3) of a 24q batch), and took 88 ms there; partial grams of 2^12
# products, summed by torch.sum, lost 5e-8 in 5.3 ms (NVIDIA H100 80GB
# HBM3, 700.00 W).
GRAM_CHUNK = 1 << 12


def _gram(lam: torch.Tensor, a: torch.Tensor, view) -> torch.Tensor:
  """G[..., I, J] = sum_{p, q} conj(lam)[..., p, I, q] a[..., p, J, q] of
  two states read as [..., P, N, Q] views (powers of two): GEMMs of at most
  GRAM_CHUNK products an entry (a split of Q, or groups of P), whose
  partial grams are then summed."""
  lead = tuple(view[:-3])
  p, n, q = (int(x) for x in view[-3:])
  if q >= GRAM_CHUNK:
    shape = lead + (p, n, q // GRAM_CHUNK, GRAM_CHUNK)
    prog, dims = "...pIxy,...pJxy->...pxIJ", (-4, -3)
  else:
    g = max(1, min(p, GRAM_CHUNK // q))
    shape = lead + (p // g, g, n, q)
    prog, dims = "...xyIq,...xyJq->...xIJ", (-3,)
  return torch.einsum(prog, lam.reshape(shape).conj(),
                      a.reshape(shape)).sum(dim=dims)


def cross_gram(lam: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
  """[..., C, C] sum_r conj(lam)[r, c] * a[r, d]."""
  r, c = lam.shape[-2:]
  return _gram(lam, a, lam.shape[:-2] + (r, c, 1))


def block_transition(lam: torch.Tensor, a: torch.Tensor, start: int,
                     k: int) -> torch.Tensor:
  """G[..., I, J] = sum_rest conj(lam)[..I..] a[..J..] over a row block."""
  shape = a.shape
  r, c = shape[-2:]
  return _gram(lam, a, shape[:-2] + (2**start, 2**k,
                                     (r * c) >> (start + k)))


def partial_trace_1q(g_block: torch.Tensor, k: int,
                     pos_in_block: int) -> torch.Tensor:
  """[2^k, 2^k] block transition -> the 2x2 single-qubit transition."""
  pre, post = 2**pos_in_block, 2**(k - pos_in_block - 1)
  gt = g_block.reshape(pre, 2, post, pre, 2, post)
  return torch.einsum("aibajb->ij", gt)


# ---------------------------------------------------------------------------
# Pauli sums: expectations and applies, tiered as the reference
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


def _major_kron_np(bin_qubits, factor_by_qubit) -> np.ndarray:
  """Static [2^k, 2^k] kron of per-qubit Pauli factors over the (sorted)
  major qubits of a bin; identity on bin qubits the term does not touch."""
  mat = None
  for q in bin_qubits:
    f = paulis.PAULI_MATS[factor_by_qubit.get(q, paulis.I)]
    mat = f if mat is None else np.kron(mat, f)
  return mat.astype(np.complex64)


def _embed_block_pauli_np(major_factors, start: int, k: int) -> np.ndarray:
  """Static [2^k, 2^k] kron of per-qubit Pauli factors over the row block
  [start, start+k), identity on untouched qubits."""
  return _major_kron_np(range(start, start + k), dict(major_factors))


def _interleave_kron_np(p_np: np.ndarray, k: int) -> np.ndarray:
  """[2^k, 2^k] kron matrix -> (2,)*2k tensor with per-qubit (conj, value)
  index pairs interleaved, matching the transition tensor's axis order."""
  t = p_np.reshape((2,) * (2 * k))
  perm = []
  for i in range(k):
    perm += [i, k + i]
  return np.ascontiguousarray(np.transpose(t, perm))


def _bin_by_support(items, max_k: int = 3):
  """Greedy first-fit binning of (payload, support_tuple) items into bins
  whose union support stays within `max_k` qubits, in the reference's
  order; one state pass then serves every term of a bin.  Returns
  [(sorted_support_tuple, [payload])]."""
  bins = []
  for payload, sup in items:
    s = set(sup)
    for b in bins:
      if len(b[0] | s) <= max_k:
        b[0] |= s
        b[1].append(payload)
        break
    else:
      bins.append([set(s), [payload]])
  return [(tuple(sorted(b[0])), b[1]) for b in bins]


def _major_view(state: torch.Tensor, bin_qubits, keep_cols: bool):
  """[..., R, C] reshaped to expose each bin qubit as its own size-2 axis
  (the columns kept as the last axis with `keep_cols`)."""
  c = state.shape[-1]
  shape = []
  prev = -1
  for q in bin_qubits:
    shape += [2**(q - prev - 1), 2]
    prev = q
  tail = (-1, c) if keep_cols else (-1,)
  return state.reshape(state.shape[:-2] + tuple(shape) + tail)


def major_transition(state: torch.Tensor, bin_qubits,
                     keep_cols: bool = False) -> torch.Tensor:
  """Joint transition tensor over k <= 3 major qubits in one state pass:
  G[..., i1, x1, ...] = sum_rest conj(psi)[..i..] psi[..x..], each qubit's
  conj-side index directly before its value-side one (the reference's
  einsum programs); with `keep_cols` the column axes stay separate
  (G[..., C, D]) so minor factors can contract afterwards.  The kept axes
  move to the front of one copy of the state, which `_gram` contracts."""
  view = _major_view(state, bin_qubits, keep_cols)
  nl, k, c = state.dim() - 2, len(bin_qubits), int(keep_cols)
  kept = [nl + 2 * i + 1 for i in range(k)] + ([view.dim() - 1] * c)
  summed = [ax for ax in range(nl, view.dim()) if ax not in kept]
  lead = tuple(state.shape[:-2])
  cols = (int(state.shape[-1]),) * c
  flat = view.permute(list(range(nl)) + kept + summed).reshape(
      lead + (1, 2**k * (cols[0] if c else 1), -1))
  g = _gram(flat, flat, flat.shape).reshape(lead + (2,) * k + cols +
                                            (2,) * k + cols)
  order = list(range(nl))
  for i in range(k):
    order += [nl + i, nl + k + c + i]
  order += [nl + k, nl + 2 * k + 1] if c else []
  return g.permute(order)


@functools.lru_cache(maxsize=256)
def _tier_terms(rows, nr: int):
  """Static split of a PauliSum's terms (cached per (rows, nr)): (diag,
  minor_only, ((block, terms), ...) for the row blocks, spanning, mixed,
  fallback), with spanning and mixed [(t, major qubits)] of <= 3 major
  qubits and fallback the terms on more major qubits than one block or
  bin holds, as in the reference's `expectation_terms`."""
  diag, minor_only, spanning, mixed, fallback = [], [], [], [], []
  blocks = _row_blocks(nr)
  block_terms = {b: [] for b in blocks}
  for t, codes in enumerate(rows):
    if _is_diag_codes(codes):
      diag.append(t)
      continue
    majors, minors = _term_factors(codes, nr)
    mq = tuple(q for q, _ in majors)
    if not majors:
      minor_only.append(t)
    elif minors:
      (mixed if len(mq) <= 3 else fallback).append((t, mq))
    else:
      home = [b for b in blocks if b[0] <= mq[0] and mq[-1] < b[0] + b[1]]
      if home:
        block_terms[home[0]].append(t)
      else:
        (spanning if len(mq) <= 3 else fallback).append((t, mq))
  return (tuple(diag), tuple(minor_only),
          tuple((b, tuple(ts)) for b, ts in block_terms.items() if ts),
          tuple(spanning), tuple(mixed), tuple(t for t, _ in fallback))


@functools.lru_cache(maxsize=256)
def _index(idx: Tuple[int, ...], device: str) -> torch.Tensor:
  """A static int64 index tensor on `device` (cached: indexing a device
  tensor with a Python list would copy the list over, waiting for the
  stream)."""
  return torch.tensor(idx, dtype=torch.int64).to(device)


@functools.lru_cache(maxsize=64)
def _pauli_stack(rows, terms: Tuple[int, ...], nr: int, m: int, kind: str,
                 arg, device: str) -> torch.Tensor:
  """Static complex64 Pauli matrices of `terms`, one a term, on `device`;
  cached, so each crosses to the device once.  `kind`:
    "minor"  [T, C, C]     minor-only strings (or a mixed term's minor part);
    "block"  [T, N, N]     strings inside row block arg = (start, k);
    "kron"   [T, N, N]     major factors over bin arg (N = 2^len(arg));
    "trans"  [T, 4^k]      "kron" with (conj, value) axes interleaved, to
                           contract against `major_transition`."""
  mats = []
  for t in terms:
    majors, minors = _term_factors(rows[t], nr)
    if kind == "minor":
      mats.append(_minor_pauli_np(minors, m))
    elif kind == "block":
      mats.append(_embed_block_pauli_np(majors, *arg))
    elif kind == "kron":
      mats.append(_major_kron_np(arg, dict(majors)))
    else:
      mats.append(_interleave_kron_np(_major_kron_np(arg, dict(majors)),
                                      len(arg)).reshape(-1))
  return torch.as_tensor(np.stack(mats)).to(device)


@tracing.spanned("qhbm.sv.expectation_terms")
@fp32_matmuls
def expectation_terms(state: torch.Tensor,
                      op: paulis.PauliSum) -> torch.Tensor:
  """Per-term real expectations <psi|P_t|psi>, shape [..., num_terms].

  Coefficients are NOT applied (the caller dots with `op.coeffs`).  Tiers:
  all diagonal terms in one parity bilinear of |psi|^2; minor-only terms
  from one [C, C] cross gram; terms inside a row block from that block's
  transition; spanning and mixed terms from one joint transition a bin of
  <= 3 major qubits (mixed: column-resolved, then each term's [C, C] minor
  Pauli); the rest term by term."""
  if op.num_terms == 0:  # e.g. an empty concat_ops; torch.cat([]) raises
    return torch.zeros(state.shape[:-2] + (0,), dtype=torch.float32,
                       device=state.device)
  rows = op.code_rows()
  m = int(state.shape[-1]).bit_length() - 1
  nr = op.num_qubits - m
  diag, minor_only, blocks, spanning, mixed, fallback = _tier_terms(rows, nr)
  dev = str(state.device)
  lead = state.shape[:-2]
  parts = []  # (term indices, values [..., len(indices)])
  if diag:
    masks = [pauli_z_masks(rows[t], nr, m) for t in diag]
    prob = (state.conj() * state).real
    parts.append((diag, parity_bilinear([rm for rm, _ in masks],
                                        [cm for _, cm in masks], prob)))
  if minor_only:
    stack = _pauli_stack(rows, minor_only, nr, m, "minor", None, dev)
    parts.append((minor_only, torch.einsum(
        "tij,...ij->...t", stack, cross_gram(state, state)).real))
  for (start, k), ts in blocks:
    stack = _pauli_stack(rows, ts, nr, m, "block", (start, k), dev)
    parts.append((ts, torch.einsum(
        "tij,...ij->...t", stack,
        block_transition(state, state, start, k)).real))
  for bin_qubits, ts in _bin_by_support(spanning):
    ts = tuple(ts)
    g = major_transition(state, bin_qubits).reshape(lead + (-1,))
    stack = _pauli_stack(rows, ts, nr, m, "trans", bin_qubits, dev)
    parts.append((ts, torch.einsum("...x,tx->...t", g, stack).real))
  for bin_qubits, ts in _bin_by_support(mixed):
    ts = tuple(ts)
    g = major_transition(state, bin_qubits, keep_cols=True)
    g = g.reshape(lead + (4**len(bin_qubits),) + g.shape[-2:])
    pmaj = _pauli_stack(rows, ts, nr, m, "trans", bin_qubits, dev)
    pmin = _pauli_stack(rows, ts, nr, m, "minor", None, dev)
    gm = torch.einsum("...xcd,tcd->...tx", g, pmin)
    parts.append((ts, torch.einsum("...tx,tx->...t", gm, pmaj).real))
  if fallback:
    conj = state.conj()
    parts.append((fallback, torch.stack([
        torch.sum(conj * apply_pauli_string(state, rows[t]),
                  dim=(-2, -1)).real for t in fallback], dim=-1)))
  vals = torch.cat([v for _, v in parts], dim=-1)
  return vals[..., _index(tuple(np.argsort([t for ts, _ in parts
                                            for t in ts])), dev)]


@tracing.spanned("qhbm.sv.apply_pauli_sum")
@fp32_matmuls
def apply_pauli_sum(state: torch.Tensor, op: paulis.PauliSum,
                    term_weights: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
  """(sum_t w_t * coeffs[t] * P_t)|psi>; `term_weights` is [..., T] and
  broadcasts against the state's batch dimensions.  Tiers: diagonal terms
  in one parity-weighted multiply, minor-only terms in one [C, C] product,
  one operator a row block, one `apply_dense` a kron bin of spanning terms,
  and the mixed and > 3-major terms term by term, as the reference."""
  rows = op.code_rows()
  n = op.num_qubits
  m = int(state.shape[-1]).bit_length() - 1
  nr = n - m
  diag, minor_only, blocks, spanning, mixed, fallback = _tier_terms(rows, nr)
  dev = str(state.device)
  w = op.coeffs.to(state.device, COMPLEX_DTYPE)
  if term_weights is not None:
    w = w * term_weights.to(COMPLEX_DTYPE)

  def weighted_sum(ts, kind, arg):
    stack = _pauli_stack(rows, ts, nr, m, kind, arg, dev)
    return torch.einsum("...t,tij->...ij", w[..., _index(ts, dev)], stack)

  def parts():  # each made only when the sum takes it: one alive at once
    if diag:
      masks = [pauli_z_masks(rows[t], nr, m) for t in diag]
      yield parity_outer_sum(w[..., _index(diag, dev)],
                             [rm for rm, _ in masks],
                             [cm for _, cm in masks], state.shape[-2:]) * state
    if minor_only:
      yield apply_minor_mat(state, weighted_sum(minor_only, "minor", None))
    for (start, k), ts in blocks:
      yield apply_row_block(weighted_sum(ts, "block", (start, k)), start, k,
                            state)
    for bin_qubits, ts in _bin_by_support(spanning):
      yield apply_dense(weighted_sum(tuple(ts), "kron", bin_qubits),
                        bin_qubits, state)
    for t in sorted([t for t, _ in mixed] + list(fallback)):
      yield w[..., t, None, None] * apply_pauli_string(state, rows[t])

  out = None
  for part in parts():  # every part is a fresh tensor: sum in place
    if out is None:
      out = part
    else:
      out += part
    del part
  return torch.zeros_like(state) if out is None else out


def apply_pauli_string(state: torch.Tensor, codes: Sequence[int]
                       ) -> torch.Tensor:
  """P|psi> for a static Pauli code row (0=I, 1=X, 2=Y, 3=Z) on [..., R, C]
  states: (P psi)[x] = (-i)^#Y (-1)^popcount(x & zy) psi[x ^ xy], with zy
  the Z/Y qubits' index bits and xy the X/Y ones."""
  n = len(codes)
  zy = xy = 0
  for q, code in enumerate(codes):
    bit = 1 << (n - 1 - q)
    if code in (paulis.Z, paulis.Y):
      zy |= bit
    if code in (paulis.X, paulis.Y):
      xy |= bit
  num_y = sum(1 for code in codes if code == paulis.Y)
  flat = to_vector(state)
  idx = torch.arange(flat.shape[-1], device=state.device)
  sign = parity_signs([zy], flat.shape[-1], state.device)[0]
  out = flat[..., idx ^ xy] * (sign * (-1j)**num_y).to(state.dtype)
  return out.reshape(state.shape)


def probabilities(state: torch.Tensor) -> torch.Tensor:
  """|psi|^2 over the standard basis, [..., 2^n] float32."""
  return to_vector(state).abs()**2


def sample_indices(state: torch.Tensor, num_samples: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
  """Basis-state indices drawn from |psi|^2 of one [R, C] state by
  inverse-CDF search with `generator` (on the state's device), int64
  [num_samples] (reference `sample_indices`, statevector.py:1529)."""
  return utils.categorical_indices_from_weights(probabilities(state),
                                                num_samples, generator)


def sample_bitstrings(state: torch.Tensor, num_samples: int,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
  """Measurement bitstrings [num_samples, n] int8 from |psi|^2 (reference
  `sample_bitstrings`, statevector.py:1536)."""
  return index_to_bits(sample_indices(state, num_samples, generator),
                       num_qubits_of(state))


def simulate(circuit: ir.Circuit, symbol_values: torch.Tensor
             ) -> torch.Tensor:
  """U(values)|0...0> as an [R, C] state on the values' device (reference
  `simulate`, statevector.py:1566)."""
  return apply_circuit(circuit, symbol_values,
                       zero_state(circuit.num_qubits, symbol_values.device))


def simulate_from_bits(circuit: ir.Circuit, symbol_values: torch.Tensor,
                       bits: torch.Tensor) -> torch.Tensor:
  """U(values)|bits>: [R, C] for bits [n], [B, R, C] for bits [B, n]
  (reference `simulate_from_bits`, statevector.py:1573), on the values'
  device; a batch runs through the batched engine at once."""
  from qhbmlib_tpu_torch.ops import hopper_sv  # hopper_sv imports this
  n = circuit.num_qubits
  bits = bits.to(symbol_values.device)
  if bits.dim() == 1:
    return apply_circuit(circuit, symbol_values, basis_state(n, bits))
  m = minor_bits(n)
  rowcol = torch.stack([bits_to_index(bits[:, :n - m], n - m),
                        bits_to_index(bits[:, n - m:], m)], dim=1)
  return torch.complex(*hopper_sv.apply_circuit_batched(circuit,
                                                        symbol_values,
                                                        rowcol))


def unitary(circuit: ir.Circuit, symbol_values: torch.Tensor) -> torch.Tensor:
  """Dense (2^n, 2^n) complex64 unitary on the values' device, forward
  only (metrics, small n): column j is U|j>, the 2^n basis states evolved
  at once by the batched forward (`hopper_sv.apply_circuit_batched`: K4 /
  K1 on the card)."""
  from qhbmlib_tpu_torch.ops import hopper_sv  # hopper_sv imports this
  n = circuit.num_qubits
  m = minor_bits(n)
  idx = torch.arange(2**n, device=symbol_values.device)
  rowcol = torch.stack([idx >> m, idx & (2**m - 1)], dim=1)
  with torch.no_grad():
    re, im = hopper_sv.apply_circuit_batched(circuit, symbol_values, rowcol)
  return torch.complex(re, im).reshape(2**n, 2**n).T
