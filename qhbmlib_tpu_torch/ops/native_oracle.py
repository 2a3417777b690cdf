"""ctypes bindings for the native C++ statevector oracle (numpy only).

The port's copy of `qhbmlib_tpu/ops/native_oracle.py`: importing that
module would load `qhbmlib_tpu/__init__.py` and with it jax.  It builds
`native/qsim_oracle.cc` (read in place, never edited) with g++ into the
port's build directory, `build/qhbmlib_tpu_torch/`, and exposes
`simulate(circuit, symbol_values, bits=None)`, a double-precision numpy
statevector, and `expectation_f64(psi, op)`.  The C++ derives its own gate
matrices from (kind, angle), so agreement with the port is an independent
check.  It takes the port's `circuit_ir.Circuit` and `paulis.PauliSum`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import Sequence

import numpy as np

from qhbmlib_tpu_torch.ops import _cuda
from qhbmlib_tpu_torch.ops import circuit_ir as ir

NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_FLAGS = ("-O2", "-shared", "-fPIC")

_KIND_TO_ENUM = {
    ir.XP: 0, ir.YP: 1, ir.ZP: 2, ir.HP: 3,
    ir.RX: 4, ir.RY: 5, ir.RZ: 6,
    ir.CZP: 7, ir.CXP: 8,
    ir.XXP: 9, ir.YYP: 10, ir.ZZP: 11,
    ir.PROT: 12, ir.GPHASE: 13,
}

_LIB = None
_BUILD_ERROR = None


def artifact_key(src: pathlib.Path, flags: Sequence[str],
                 host: bool = False) -> str:
  """Hash of the source, the flags and (with `host`, for -march=native
  builds) the host CPU's feature flags: a library built for another host's
  ISA is never loaded."""
  h = hashlib.sha256(src.read_bytes())
  h.update(" ".join(flags).encode())
  if host:
    try:
      with open("/proc/cpuinfo") as f:
        h.update(next((line for line in f if line.startswith("flags")),
                      "").encode())
    except OSError:
      import platform
      h.update(platform.processor().encode())
  return h.hexdigest()[:12]


def build_library(src: pathlib.Path, flags: Sequence[str], key: str,
                  timeout: int = 240) -> pathlib.Path:
  """g++ `src` into build/qhbmlib_tpu_torch/lib<stem>.<key>.so unless it
  exists; compiled to a temporary name and renamed, so concurrent builders
  never load half a file.  Raises with g++'s diagnostics on failure."""
  out = _cuda.BUILD_DIR / f"lib{src.stem}.{key}.so"
  if out.exists():
    return out
  _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=_cuda.BUILD_DIR)
  os.close(fd)
  try:
    proc = subprocess.run(["g++", *flags, "-o", tmp, str(src)],
                          capture_output=True, text=True, timeout=timeout,
                          check=False)
    if proc.returncode != 0:
      raise RuntimeError(f"g++ failed ({proc.returncode}) on {src}:\n"
                         f"{proc.stderr}")
    os.replace(tmp, out)
  finally:
    if os.path.exists(tmp):
      os.remove(tmp)
  return out


def _load():
  global _LIB, _BUILD_ERROR
  if _LIB is not None or _BUILD_ERROR is not None:
    return _LIB
  src = NATIVE_DIR / "qsim_oracle.cc"
  try:
    lib = ctypes.CDLL(str(build_library(src, _FLAGS,
                                        artifact_key(src, _FLAGS))))
    lib.simulate_circuit.restype = ctypes.c_int
    _LIB = lib
  except Exception as e:  # noqa: BLE001 -- raised again by simulate
    _BUILD_ERROR = e
  return _LIB


def available() -> bool:
  return _load() is not None


def simulate(circuit: ir.Circuit, symbol_values, bits=None) -> np.ndarray:
  """U(values)|bits or 0> as a [2^n] complex128 numpy statevector."""
  lib = _load()
  if lib is None:
    raise RuntimeError(f"native oracle unavailable: {_BUILD_ERROR}")
  n = circuit.num_qubits
  values = np.asarray(symbol_values, np.float64)
  num_gates = circuit.num_gates
  kinds = np.zeros(num_gates, np.int32)
  q0 = np.full(num_gates, -1, np.int32)
  q1 = np.full(num_gates, -1, np.int32)
  angles = np.zeros(num_gates, np.float64)
  prot_offsets = np.zeros(num_gates + 1, np.int32)
  prot_qubits = []
  prot_codes = []
  for g, gate in enumerate(circuit.gates):
    kinds[g] = _KIND_TO_ENUM[gate.kind]
    if gate.qubits:
      q0[g] = gate.qubits[0]
    if len(gate.qubits) > 1:
      q1[g] = gate.qubits[1]
    angles[g] = gate.shift if gate.slot < 0 else (
        gate.coeff * float(values[gate.slot]) + gate.shift)
    prot_offsets[g + 1] = prot_offsets[g]
    if gate.kind == ir.PROT:
      prot_qubits.extend(gate.qubits)
      prot_codes.extend(gate.paulis)
      prot_offsets[g + 1] += len(gate.qubits)
  pq = np.asarray(prot_qubits or [0], np.int32)
  pc = np.asarray(prot_codes or [0], np.int32)
  init = 0
  if bits is not None:
    bits = np.asarray(bits).reshape(-1)
    # Validated before crossing into C: a bad initial index is an
    # out-of-bounds write in simulate_circuit.
    if bits.shape[0] != n:
      raise ValueError(f"bits has {bits.shape[0]} entries for {n} qubits")
    if np.any((bits != 0) & (bits != 1)):
      raise ValueError(f"bits must be 0/1: {bits}")
    for b in bits:
      init = (init << 1) | int(b)
  out_re = np.zeros(2**n, np.float64)
  out_im = np.zeros(2**n, np.float64)

  def ptr(arr, typ):
    return arr.ctypes.data_as(ctypes.POINTER(typ))

  rc = lib.simulate_circuit(
      ctypes.c_int(n), ctypes.c_int(num_gates),
      ptr(kinds, ctypes.c_int), ptr(q0, ctypes.c_int), ptr(q1, ctypes.c_int),
      ptr(angles, ctypes.c_double), ptr(prot_offsets, ctypes.c_int),
      ptr(pq, ctypes.c_int), ptr(pc, ctypes.c_int),
      ctypes.c_int64(init),
      ptr(out_re, ctypes.c_double), ptr(out_im, ctypes.c_double))
  if rc != 0:
    raise RuntimeError(f"native oracle failed with code {rc}")
  return out_re + 1j * out_im


def _parity(x: np.ndarray) -> np.ndarray:
  """Parity of each int64 entry's set bits, by xor-folding (six passes
  whatever the width; the reference counts bits one at a time)."""
  for shift in (32, 16, 8, 4, 2, 1):
    x = x ^ (x >> shift)
  return x & 1


def expectation_f64(psi: np.ndarray, op) -> float:
  """<psi|op|psi> in float64 numpy on a flat [2^n] statevector, for a port
  PauliSum.  Bit convention of the engine: qubit 0 is the most significant
  index bit, phases are taken at the input index."""
  psi = np.asarray(psi, np.complex128).reshape(-1)
  n = op.num_qubits
  if psi.size != 2**n:
    raise ValueError(f"psi has {psi.size} amplitudes for {n} qubits")
  idx = np.arange(psi.size, dtype=np.int64)
  conj = np.conj(psi)
  coeffs = op.coeffs.detach().cpu().numpy().astype(np.complex128)
  total = 0.0
  for t, row in enumerate(op.code_rows()):
    flip = pm = ny = 0
    for q, c in enumerate(row):
      bit = 1 << (n - 1 - q)
      if c == 1:  # X
        flip |= bit
      elif c == 2:  # Y
        flip |= bit
        pm |= bit
        ny += 1
      elif c == 3:  # Z
        pm |= bit
    src = idx ^ flip
    val = conj * psi[src]
    if pm:
      val = val * (1.0 - 2.0 * _parity(src & pm))
    total += float(np.real(coeffs[t] * (1j)**(ny % 4) * np.sum(val)))
  return total
