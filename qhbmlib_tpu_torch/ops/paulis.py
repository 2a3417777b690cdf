"""Pauli-string sums for the PyTorch statevector engine.

Port of `qhbmlib_tpu/ops/paulis.py`: a PauliSum is an int8 code matrix
``codes[t, q] in {0:I, 1:X, 2:Y, 3:Z}`` (static structure, kept on the host)
plus a float coefficient vector.  The engine tiers terms by their codes at
call time, so the codes never need to live on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from qhbmlib_tpu_torch import device as device_lib

I, X, Y, Z = 0, 1, 2, 3

_CHAR_TO_CODE = {"I": I, "X": X, "Y": Y, "Z": Z}
_CODE_TO_CHAR = "IXYZ"

# Dense 2x2 matrices (host numpy), used to build the static operator folds.
PAULI_MATS = (
    np.eye(2, dtype=np.complex64),
    np.array([[0, 1], [1, 0]], dtype=np.complex64),
    np.array([[0, -1j], [1j, 0]], dtype=np.complex64),
    np.array([[1, 0], [0, -1]], dtype=np.complex64),
)


@dataclasses.dataclass(eq=False)
class PauliSum:
  """Sum of Pauli strings: sum_t coeffs[t] * prod_q P(codes[t, q]) on qubit q.

  ``codes`` is an int8 [num_terms, num_qubits] CPU tensor; ``coeffs`` is a
  float32 [num_terms] tensor on any device, and may require grad.
  """

  codes: torch.Tensor
  coeffs: torch.Tensor
  num_qubits: int

  @property
  def num_terms(self) -> int:
    return int(self.codes.shape[0])

  def code_rows(self) -> Tuple[Tuple[int, ...], ...]:
    """The codes as nested Python tuples (static term structure)."""
    return tuple(tuple(int(c) for c in row) for row in self.codes.tolist())

  def to(self, device) -> "PauliSum":
    return PauliSum(self.codes, self.coeffs.to(device), self.num_qubits)

  def __add__(self, other: "PauliSum") -> "PauliSum":
    if self.num_qubits != other.num_qubits:
      raise ValueError("PauliSums must act on the same number of qubits.")
    return PauliSum(torch.cat([self.codes, other.codes]),
                    torch.cat([self.coeffs,
                               other.coeffs.to(self.coeffs.device)]),
                    self.num_qubits)

  def __mul__(self, scalar) -> "PauliSum":
    return PauliSum(self.codes, self.coeffs * scalar, self.num_qubits)

  __rmul__ = __mul__

  def __neg__(self) -> "PauliSum":
    return self * -1.0

  def __sub__(self, other: "PauliSum") -> "PauliSum":
    return self + (-other)

  def dense(self) -> np.ndarray:
    """Dense (2^n, 2^n) complex64 matrix on the host; small n only."""
    dim = 2**self.num_qubits
    out = np.zeros((dim, dim), dtype=np.complex64)
    coeffs = self.coeffs.detach().cpu().numpy()
    for coeff, row in zip(coeffs, self.code_rows()):
      mat = np.eye(1, dtype=np.complex64)
      for code in row:
        mat = np.kron(mat, PAULI_MATS[code])
      out = out + coeff * mat
    return out

  def __repr__(self):
    terms = []
    for row in self.code_rows():
      ops = "".join(f"{_CODE_TO_CHAR[c]}{q}"
                    for q, c in enumerate(row) if c != I) or "I"
      terms.append(f"({ops})")
    return f"PauliSum(n={self.num_qubits}, terms={'+'.join(terms)})"


def _codes_tensor(rows: Sequence[Sequence[int]], num_qubits: int):
  return torch.tensor(np.asarray(rows, np.int8).reshape(-1, num_qubits),
                      dtype=torch.int8)


def pauli_sum_from_strings(
    num_qubits: int,
    terms: Iterable[Tuple[float, Mapping[int, Union[str, int]]]],
    device=None) -> PauliSum:
  """Builds a PauliSum from (coeff, {qubit: pauli}) pairs, its coeffs on
  `device` (None means the CUDA card, `device.resolve`)."""
  codes = []
  coeffs = []
  for coeff, qmap in terms:
    row = [I] * num_qubits
    for q, p in qmap.items():
      if not 0 <= q < num_qubits:
        raise ValueError(f"qubit {q} out of range for {num_qubits} qubits")
      row[q] = _CHAR_TO_CODE[p] if isinstance(p, str) else int(p)
    codes.append(row)
    coeffs.append(coeff)
  return PauliSum(codes=_codes_tensor(codes, num_qubits),
                  coeffs=torch.tensor(coeffs, dtype=torch.float32,
                                      device=device_lib.resolve(device)),
                  num_qubits=num_qubits)


def from_arrays(codes, coeffs, num_qubits: int, device=None) -> PauliSum:
  """A PauliSum from host arrays: codes [num_terms, num_qubits] in
  {0:I, 1:X, 2:Y, 3:Z} and coeffs [num_terms] (e.g. the `codes` and
  `coeffs` of a reference PauliSum, read through numpy), its coeffs on
  `device` (None means the CUDA card, `device.resolve`)."""
  return PauliSum(codes=_codes_tensor(np.asarray(codes), num_qubits),
                  coeffs=torch.tensor(np.asarray(coeffs, np.float32),
                                      device=device_lib.resolve(device)),
                  num_qubits=num_qubits)


def pauli_string(num_qubits: int, qubit_paulis: Mapping[int, Union[str, int]],
                 coeff: float = 1.0, device=None) -> PauliSum:
  """Single Pauli string, e.g. pauli_string(3, {0: 'Z', 2: 'Z'}, -1.0)."""
  return pauli_sum_from_strings(num_qubits, [(coeff, qubit_paulis)], device)


def tfim_1d(num_qubits: int, h: float = 1.0, j: float = 1.0,
            periodic: bool = False, device=None) -> PauliSum:
  """H = -h*sum_q X_q - j*sum_q Z_q Z_{q+1}: open chain by default, ring
  with `periodic=True` (same term order as the reference builder)."""
  terms = [(-h, {q: "X"}) for q in range(num_qubits)]
  last = num_qubits if (periodic and num_qubits > 2) else num_qubits - 1
  terms += [(-j, {q: "Z", (q + 1) % num_qubits: "Z"}) for q in range(last)]
  return pauli_sum_from_strings(num_qubits, terms, device)


def op_slices(ops: Sequence[PauliSum]):
  """Static [(start, end)] row ranges of each op inside the concatenation of
  all their terms."""
  slices = []
  start = 0
  for op in ops:
    slices.append((start, start + op.num_terms))
    start += op.num_terms
  return slices


def concat_ops(ops: Sequence[PauliSum], num_qubits: int):
  """All terms of all ops as ONE PauliSum, plus the per-op row slices."""
  codes = torch.cat([op.codes.reshape(-1, num_qubits) for op in ops])
  coeffs = torch.cat([op.coeffs.reshape(-1) for op in ops])
  return PauliSum(codes, coeffs, num_qubits), op_slices(ops)


def z_strings_from_masks(masks: Sequence[Sequence[int]], num_qubits: int,
                         device=None) -> Tuple[PauliSum, ...]:
  """One single-term Z-string PauliSum of coefficient 1 per mask row (the
  operator shards of an energy), coeffs on `device` (None means the CUDA
  card, `device.resolve`)."""
  return tuple(pauli_sum_from_strings(
      num_qubits, [(1.0, {q: Z for q, bit in enumerate(mask) if bit})],
      device) for mask in masks)


def stack_single_term(paulisums: Sequence[PauliSum]) -> PauliSum:
  """Stacks single-term PauliSums into one multi-term PauliSum (every
  shard measured in one pass)."""
  if any(p.num_terms != 1 for p in paulisums):
    raise ValueError("stack_single_term requires single-term PauliSums.")
  return concat_ops(paulisums, paulisums[0].num_qubits)[0]
