"""Builds and loads the package's CUDA kernels (nvcc + ctypes).

The sources under `qhbmlib_tpu_torch/csrc/` have a plain C interface, so
they compile in seconds with nvcc alone -- no PyTorch headers:

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
       -Xcompiler -fPIC -o build/qhbmlib_tpu_torch/libqhbm_kernels-<hash>.so

The library is built at first use into `build/` beside the package (the
hash covers the sources and flags, so an edited source rebuilds) and loaded
with ctypes: every pointer and the stream are `c_void_p`, every int is
`c_int`, and every entry point returns `cudaGetLastError()`.  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import torch

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "qhbmlib_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every entry point returns an int (a cudaError_t).
_SIGNATURES = {
    "qhbm_axis_apply": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "qhbm_axis_gram": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _P],
    "qhbm_parity_bilinear": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                             _I, _P],
    "qhbm_diag_rotate": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _P],
    "qhbm_axis2_apply": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _P],
    "qhbm_sweep_blocks": [_I],
    "qhbm_circuit_forward": [_P, _I, _I, _P, _I, _P, _P, _I, _P],
    "qhbm_adjoint_sweep": [_P, _P, _I, _I, _P, _I, _P, _P, _P, _I, _P, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
last_build_log = ""


def find_nvcc() -> str:
  """nvcc from PyTorch's CUDA_HOME, else from PATH."""
  from torch.utils import cpp_extension  # lazy: slow import, CUDA probing
  home = cpp_extension.CUDA_HOME
  if home:
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
      return cand
  found = shutil.which("nvcc")
  if not found:
    raise RuntimeError("nvcc not found (no CUDA_HOME/bin/nvcc, none on PATH)")
  return found


def sources():
  return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> pathlib.Path:
  h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
  for src in sources():
    h.update(src.name.encode())
    h.update(src.read_bytes())
  return BUILD_DIR / f"libqhbm_kernels-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> pathlib.Path:
  """Compiles the sources unless the hashed library exists.  With
  `verbose`, adds `-Xptxas -v` and keeps the compiler's output in
  `last_build_log` (registers, shared memory and spills per kernel)."""
  global last_build_log
  out = library_path()
  if out.exists() and not verbose:
    return out
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
  os.close(fd)
  cmd = [find_nvcc(), *NVCC_FLAGS]
  if verbose:
    cmd += ["-Xptxas", "-v"]
  cmd += ["-o", tmp, *map(str, sources())]
  try:
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    last_build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
      raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{last_build_log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
  finally:
    if os.path.exists(tmp):
      os.remove(tmp)
  return out


def library() -> ctypes.CDLL:
  """The loaded kernel library (built on first call)."""
  global _lib
  with _lock:
    if _lib is None:
      lib = ctypes.CDLL(str(build()))
      for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
      _lib = lib
  return _lib


def check(status: int, what: str) -> None:
  """Raises if a C entry point reported a CUDA error."""
  if status != 0:
    raise RuntimeError(f"{what}: CUDA error {status}")


def stream_of(t: torch.Tensor) -> int:
  return torch.cuda.current_stream(t.device).cuda_stream


def sm_count(device: torch.device) -> int:
  return torch.cuda.get_device_properties(device).multi_processor_count


def require(tensors, device: torch.device, shapes=None) -> None:
  """Validates kernel operands: float32, contiguous, on `device`, and (where
  given) of the expected shapes."""
  for i, t in enumerate(tensors):
    if t.device != device:
      raise ValueError(f"operand {i} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
      raise ValueError(f"operand {i} has dtype {t.dtype}, expected float32")
    if not t.is_contiguous():
      raise ValueError(f"operand {i} is not contiguous")
    if shapes is not None and tuple(t.shape) != tuple(shapes[i]):
      raise ValueError(f"operand {i} has shape {tuple(t.shape)}, expected "
                       f"{tuple(shapes[i])}")
