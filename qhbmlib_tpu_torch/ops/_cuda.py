"""Builds and loads the package's CUDA kernels (nvcc + ctypes).

The sources under `qhbmlib_tpu_torch/csrc/` have a plain C interface, so
they compile in seconds with nvcc alone -- no PyTorch headers.  Each source
compiles to an object in its own nvcc process, all started together, and
one more nvcc links them:

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
       -Xcompiler -fPIC -c -o <stem>.o csrc/<stem>.cu        (each source)
  nvcc -gencode arch=compute_90a,code=sm_90a -shared
       -o build/qhbmlib_tpu_torch/libqhbm_kernels-<hash>.so *.o

The library is built at first use into `build/` beside the package (the
hash covers the sources and flags, so an edited source rebuilds) and loaded
with ctypes: every pointer and the stream are `c_void_p`, every int is
`c_int`, and every entry point returns `cudaGetLastError()`.  Nothing here
runs at import time.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

import torch

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "qhbmlib_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every entry point returns an int (a cudaError_t).
_SIGNATURES = {
    "qhbm_axis_apply": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "qhbm_transitions_scratch": [],
    "qhbm_qubit_transitions": [_P, _P, _P, _P, _I, _I, _P, _I, _P, _I, _P,
                               _P],
    "qhbm_diag_blocks": [_I, _I],
    "qhbm_parity_bilinear": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                             _P, _I, _P, _P],
    "qhbm_diag_rotate": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _P],
    "qhbm_axis2_apply": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _P],
    "qhbm_sweep_blocks": [_I],
    "qhbm_circuit_forward": [_P, _I, _I, _P, _I, _P, _P, _I, _P],
    "qhbm_adjoint_sweep": [_P, _P, _I, _I, _P, _I, _P, _P, _P, _I, _P, _P],
    "qhbm_stream_scale": [_P, _P, _P, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
last_build_log = ""
build_seconds: dict = {}


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
  """Compiles the sources unless the hashed library exists: one nvcc
  process per source, all at once, then one link, so the build takes the
  slowest source's time rather than the sum.  With `verbose`, adds
  `-Xptxas -v` and keeps the compilers' output in `last_build_log`
  (registers, shared memory and spills per kernel).  `build_seconds`
  holds each source's compile time and the link's."""
  global last_build_log
  out = library_path()
  if out.exists() and not verbose:
    return out
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  nvcc = find_nvcc()
  ptxas = ["-Xptxas", "-v"] if verbose else []

  def run(name, cmd):
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    build_seconds[name] = time.perf_counter() - t0
    return proc

  with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
    objs = {src.name: os.path.join(tmp, src.stem + ".o") for src in sources()}
    with concurrent.futures.ThreadPoolExecutor(len(objs)) as pool:
      procs = list(pool.map(
          lambda src: run(src.name, [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o",
                                     objs[src.name], str(src)]), sources()))
    lib = os.path.join(tmp, out.name)
    if not any(p.returncode for p in procs):
      procs.append(run("link", [nvcc, *ARCH_FLAGS, "-shared", "-o", lib,
                                *objs.values()]))
    last_build_log = "".join(p.stdout + p.stderr for p in procs)
    failed = [p.returncode for p in procs if p.returncode != 0]
    if failed:
      raise RuntimeError(f"nvcc failed ({failed}):\n{last_build_log}")
    os.replace(lib, out)  # atomic: concurrent builders never see half a file
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
