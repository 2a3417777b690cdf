"""ctypes bindings for the optimized native CPU simulator (numpy only).

The port's copy of `qhbmlib_tpu/ops/native_fast.py`, which loads jax with
its package.  `native/fast_sim.cc` (read in place) is a single-core
AVX-512 float32 statevector simulator of the forward, the PauliSum
expectation and the adjoint gradient, written without reference to either
engine: the bench's independent CPU anchor (`--independent`).  It builds
with `-march=native` into `build/qhbmlib_tpu_torch/`, keyed on the source,
the flags and the host's CPU features.

`vqt_step(circuit, values, pauli_zz, pauli_x, bits)` returns
(energies[B], symbol_grads[B, S], gate_grads[B, G]); `step_seconds(...)`
times it.
"""

from __future__ import annotations

import ctypes
import time
from typing import Sequence, Tuple

import numpy as np

from qhbmlib_tpu_torch.ops import circuit_ir as ir
from qhbmlib_tpu_torch.ops import native_oracle

_KIND_TO_ENUM = {
    ir.XP: 0, ir.YP: 1, ir.ZP: 2,
    ir.RX: 4, ir.RY: 5, ir.RZ: 6,
    ir.CZP: 7,
}
FLAGS = ("-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC")
SOURCE = native_oracle.NATIVE_DIR / "fast_sim.cc"

_LIB = None
_BUILD_ERROR = None


def artifact_key() -> str:
  """Key of the built library: source, flags and host CPU features."""
  return native_oracle.artifact_key(SOURCE, FLAGS, host=True)


def _load():
  global _LIB, _BUILD_ERROR
  if _LIB is not None or _BUILD_ERROR is not None:
    return _LIB
  try:
    lib = ctypes.CDLL(str(native_oracle.build_library(SOURCE, FLAGS,
                                                      artifact_key())))
    lib.vqt_adjoint_step.restype = ctypes.c_int
    _LIB = lib
  except Exception as e:  # noqa: BLE001 -- raised again by vqt_step
    _BUILD_ERROR = e
  return _LIB


def available() -> bool:
  return _load() is not None


def _marshal_circuit(circuit: ir.Circuit, symbol_values):
  values = np.asarray(symbol_values, np.float64)
  num_gates = circuit.num_gates
  kinds = np.zeros(num_gates, np.int32)
  q0 = np.full(num_gates, -1, np.int32)
  q1 = np.full(num_gates, -1, np.int32)
  angles = np.zeros(num_gates, np.float64)
  slots = np.full(num_gates, -1, np.int32)
  coeffs = np.zeros(num_gates, np.float64)
  for g, gate in enumerate(circuit.gates):
    if gate.kind not in _KIND_TO_ENUM:
      raise ValueError(f"fast_sim does not support gate kind {gate.kind}")
    kinds[g] = _KIND_TO_ENUM[gate.kind]
    if gate.qubits:
      q0[g] = gate.qubits[0]
    if len(gate.qubits) > 1:
      q1[g] = gate.qubits[1]
    angles[g] = gate.shift if gate.slot < 0 else (
        gate.coeff * float(values[gate.slot]) + gate.shift)
    slots[g] = gate.slot
    coeffs[g] = gate.coeff
  return kinds, q0, q1, angles, slots, coeffs


def _bits_to_indices(bits, n) -> np.ndarray:
  bits = np.asarray(bits)
  if bits.ndim == 1:
    bits = bits[None, :]
  if bits.shape[1] != n:
    raise ValueError(f"bits has {bits.shape[1]} columns for {n} qubits")
  if np.any((bits != 0) & (bits != 1)):
    raise ValueError("bits must be 0/1")
  weights = (1 << np.arange(n - 1, -1, -1)).astype(np.int64)
  return bits.astype(np.int64) @ weights


def split_pauli_terms(psum) -> Tuple[list, list]:
  """Splits a port PauliSum into (zz_pairs, x_singles) term lists for
  vqt_step: exactly the TFIM-shaped sums the bench uses, each term a ZZ
  pair or a single X.  Raises for anything else."""
  coeffs = psum.coeffs.detach().cpu().numpy().astype(np.float64)
  zz, xs = [], []
  for t, row in enumerate(psum.code_rows()):
    nz = [q for q, c in enumerate(row) if c]
    kinds = [row[q] for q in nz]
    if len(nz) == 2 and kinds == [3, 3]:
      zz.append((nz[0], nz[1], float(coeffs[t])))
    elif len(nz) == 1 and kinds == [1]:
      xs.append((nz[0], float(coeffs[t])))
    else:
      raise ValueError(f"term {t} is not a ZZ pair or single X: codes {row}")
  return zz, xs


def vqt_step(circuit: ir.Circuit, symbol_values,
             pauli_zz: Sequence[Tuple[int, int, float]],
             pauli_x: Sequence[Tuple[int, float]],
             bits) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Forward + <H> + adjoint per-symbol gradient for each bitstring row.

  Returns (energies[B], symbol_grads[B, num_symbols], gate_grads[B, G]).
  """
  lib = _load()
  if lib is None:
    raise RuntimeError(f"fast_sim unavailable: {_BUILD_ERROR}")
  n = circuit.num_qubits
  kinds, q0, q1, angles, slots, coeffs = _marshal_circuit(
      circuit, symbol_values)
  zz = np.asarray(list(pauli_zz) or np.zeros((0, 3)), np.float64).reshape(
      -1, 3)
  xs = np.asarray(list(pauli_x) or np.zeros((0, 2)), np.float64).reshape(
      -1, 2)
  zz_a = zz[:, 0].astype(np.int32)
  zz_b = zz[:, 1].astype(np.int32)
  zz_c = np.ascontiguousarray(zz[:, 2])
  x_q = xs[:, 0].astype(np.int32)
  x_c = np.ascontiguousarray(xs[:, 1])
  init = _bits_to_indices(bits, n)
  batch = init.shape[0]
  num_gates = circuit.num_gates
  energies = np.zeros(batch, np.float64)
  gate_grads = np.zeros((batch, num_gates), np.float64)

  def ptr(arr, typ):
    return arr.ctypes.data_as(ctypes.POINTER(typ))

  rc = lib.vqt_adjoint_step(
      ctypes.c_int(n), ctypes.c_int(num_gates),
      ptr(kinds, ctypes.c_int), ptr(q0, ctypes.c_int), ptr(q1, ctypes.c_int),
      ptr(angles, ctypes.c_double),
      ctypes.c_int(len(zz_a)), ptr(zz_a, ctypes.c_int),
      ptr(zz_b, ctypes.c_int), ptr(zz_c, ctypes.c_double),
      ctypes.c_int(len(x_q)), ptr(x_q, ctypes.c_int),
      ptr(x_c, ctypes.c_double),
      ctypes.c_int(batch), ptr(init, ctypes.c_int64),
      ptr(energies, ctypes.c_double),
      ptr(gate_grads, ctypes.c_double))
  if rc != 0:
    raise RuntimeError(f"fast_sim failed with code {rc}")

  # Chain rule gate angle -> symbol (angle = coeff * value + shift).
  symbol_grads = np.zeros((batch, circuit.num_symbols), np.float64)
  for g in range(num_gates):
    if slots[g] >= 0:
      symbol_grads[:, slots[g]] += coeffs[g] * gate_grads[:, g]
  return energies, symbol_grads, gate_grads


def step_seconds(circuit: ir.Circuit, symbol_values, pauli_zz, pauli_x,
                 bits, repeats: int = 1) -> float:
  """Minimum wall-clock seconds of `vqt_step` over `repeats` runs."""
  best = float("inf")
  for _ in range(repeats):
    t0 = time.perf_counter()
    vqt_step(circuit, symbol_values, pauli_zz, pauli_x, bits)
    best = min(best, time.perf_counter() - t0)
  return best
