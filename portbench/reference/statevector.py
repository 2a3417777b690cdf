"""Plain statevector simulation: basis states, layers of one-qubit
operators, diagonal phases and Pauli-sum expectations.

A layer of one-qubit operators is applied in blocks of at most BLOCK
neighbouring qubits: the block's operator is the Kronecker product of its
qubits' 2 x 2 matrices, applied to the state as one real GEMM on the
stacked (re, im) planes.  So every product of the simulation is a matrix
product, and the precision of matrix products (float64, or float32 with or
without TF32) is the precision of the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

BLOCK = 7

LETTERS = ("X", "Y", "Z")


def complex_of(dtype: torch.dtype) -> torch.dtype:
  return torch.complex128 if dtype == torch.float64 else torch.complex64


class Space:
  """The 2^n amplitude indices of n qubits on a device, in one float
  dtype: bit and spin vectors of each qubit (qubit q is bit n-1-q)."""

  def __init__(self, n: int, dtype: torch.dtype, device):
    self.n = n
    self.dtype = dtype
    self.cdtype = complex_of(dtype)
    self.device = torch.device(device)
    self._index = torch.arange(2**n, device=self.device)

  def bit(self, q: int) -> torch.Tensor:
    return ((self._index >> (self.n - 1 - q)) & 1).to(self.dtype)

  def z(self, q: int) -> torch.Tensor:
    """The eigenvalue of Z_q at each index: +1 for bit 0, -1 for bit 1."""
    return 1.0 - 2.0 * self.bit(q)

  def matrix(self, rows) -> torch.Tensor:
    """A constant 2 x 2 complex matrix in this space's precision."""
    return torch.tensor(rows, dtype=self.cdtype, device=self.device)

  def basis_states(self, bits: np.ndarray) -> torch.Tensor:
    """[S, 2, 2^n] states |b> of the bit rows [S, n]."""
    bits = np.asarray(bits, dtype=np.int64)
    weights = 1 << np.arange(self.n - 1, -1, -1, dtype=np.int64)
    index = torch.as_tensor(bits @ weights, device=self.device)
    psi = torch.zeros((len(bits), 2, 2**self.n), dtype=self.dtype,
                      device=self.device)
    psi[torch.arange(len(bits), device=self.device), 0, index] = 1.0
    return psi


def hadamard(space: Space) -> torch.Tensor:
  r = 1.0 / math.sqrt(2.0)
  return space.matrix([[r, r], [r, -r]])


def basis_change(space: Space, letter: str) -> torch.Tensor:
  """B with B P B^dagger = Z for the Pauli `letter`: H for X, H S^dagger
  for Y, the identity for Z."""
  if letter == "X":
    return hadamard(space)
  if letter == "Y":
    return hadamard(space) @ space.matrix([[1, 0], [0, -1j]])
  return space.matrix([[1, 0], [0, 1]])


def apply_block(psi: torch.Tensor, op: torch.Tensor, start: int, k: int,
                n: int) -> torch.Tensor:
  """The complex [2^k, 2^k] `op` on qubits [start, start + k) of [S, 2, N]
  states: one GEMM of the real form [[Re, -Im], [Im, Re]] (2^(k+1) square)
  against the stacked planes."""
  s = psi.shape[0]
  kk, a, c = 2**k, 2**start, 2**(n - start - k)
  real = torch.cat([torch.cat([op.real, -op.imag], 1),
                    torch.cat([op.imag, op.real], 1)], 0)
  x = psi.reshape(s, 2, a, kk, c).permute(0, 2, 4, 1, 3).reshape(-1, 2 * kk)
  y = x @ real.T
  return y.reshape(s, a, c, 2, kk).permute(0, 3, 1, 4, 2).reshape(s, 2, -1)


def apply_layer(psi: torch.Tensor, mats: Mapping[int, torch.Tensor],
                space: Space) -> torch.Tensor:
  """One-qubit matrices {qubit: [2, 2]} on every named qubit, BLOCK
  neighbouring qubits a GEMM (identity on the others)."""
  eye = space.matrix([[1, 0], [0, 1]])
  n = space.n
  for start in range(0, n, BLOCK):
    qs = range(start, min(start + BLOCK, n))
    if not any(q in mats for q in qs):
      continue
    op = None
    for q in qs:
      m = mats.get(q, eye)
      op = m if op is None else torch.kron(op, m)
    psi = apply_block(psi, op, start, len(qs), n)
  return psi


def apply_phase(psi: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
  """Each amplitude x multiplied by exp(i phi[x])."""
  c, s = torch.cos(phi), torch.sin(phi)
  re, im = psi[:, 0], psi[:, 1]
  return torch.stack([re * c - im * s, re * s + im * c], dim=1)


def run(psi: torch.Tensor, ops, space: Space) -> torch.Tensor:
  """A circuit as a list of ("layer", {q: [2, 2]}) and ("phase", phi [N])
  steps; neighbouring layers are multiplied together before they touch
  the state."""
  pending: Dict[int, torch.Tensor] = {}
  for kind, body in ops:
    if kind == "layer":
      for q, m in body.items():
        pending[q] = m @ pending[q] if q in pending else m
      continue
    if pending:
      psi = apply_layer(psi, pending, space)
      pending = {}
    psi = apply_phase(psi, body)
  if pending:
    psi = apply_layer(psi, pending, space)
  return psi


def z_string(space: Space, qubits: Sequence[int]) -> torch.Tensor:
  """prod_q z_q(x) over `qubits`, at every index x."""
  out = space.z(qubits[0])
  for q in qubits[1:]:
    out = out * space.z(q)
  return out


def commuting_group(space: Space, terms) -> Tuple[Dict[int, torch.Tensor],
                                                  torch.Tensor]:
  """(basis changes {q: B}, weights w [N]) of Pauli terms [(coeff, {q:
  letter})] that agree on the letter of every qubit they share: the sum
  of the terms is B^dagger diag(w) B, B the product of the changes."""
  letters: Dict[int, str] = {}
  for _, qmap in terms:
    for q, p in qmap.items():
      if letters.setdefault(q, p) != p:
        raise ValueError(f"terms disagree on qubit {q}: {letters[q]} and {p}")
  mats = {q: basis_change(space, p) for q, p in letters.items() if p != "Z"}
  w = torch.zeros(2**space.n, dtype=space.dtype, device=space.device)
  for coeff, qmap in terms:
    w = w + coeff * z_string(space, sorted(qmap))
  return mats, w


def letter_groups(terms) -> List[list]:
  """Terms of one Pauli letter each, grouped by letter (X, Y, Z), and each
  term of several letters alone."""
  groups = {p: [] for p in LETTERS}
  mixed = []
  for coeff, qmap in terms:
    kinds = set(qmap.values())
    if len(kinds) == 1:
      groups[kinds.pop()].append((coeff, qmap))
    else:
      mixed.append([(coeff, qmap)])
  return [g for g in groups.values() if g] + mixed


class Observable:
  """A Pauli sum [(coeff, {q: letter})], measured group by group: each
  group's basis change on a copy of the state, then its weights against
  the probabilities."""

  def __init__(self, space: Space, terms):
    self.space = space
    self.groups = [commuting_group(space, g) for g in letter_groups(terms)]

  def expectation(self, psi: torch.Tensor) -> torch.Tensor:
    """[S] expectations of [S, 2, N] states."""
    total = 0.0
    for mats, w in self.groups:
      rotated = apply_layer(psi, mats, self.space) if mats else psi
      probs = rotated[:, 0]**2 + rotated[:, 1]**2
      total = total + probs @ w
    return total


def pauli_exponential(space: Space, terms, angle: torch.Tensor):
  """exp(-i angle sum_t c_t P_t) of commuting terms that agree on every
  shared qubit's letter, as circuit steps: the basis change, the phase
  -angle w, the change undone."""
  mats, w = commuting_group(space, terms)
  ops = [("layer", mats)] if mats else []
  ops.append(("phase", -angle * w))
  if mats:
    ops.append(("layer", {q: m.conj().T for q, m in mats.items()}))
  return ops
