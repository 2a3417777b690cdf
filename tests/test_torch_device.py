"""The port's entry points build on the CUDA card unless told otherwise.

`device.resolve`: a given device is kept; no device means CUDA, and
without a CUDA device that raises instead of falling back to the CPU (where
the kernels' plain versions would run).  Each entry point is tried with no
device in a subprocess that sees no card (`CUDA_VISIBLE_DEVICES=""`), and
with `device="cpu"` here.
"""

import os
import subprocess
import sys

import pytest
import torch

from qhbmlib_tpu_torch import device
from qhbmlib_tpu_torch import models
from qhbmlib_tpu_torch.ops import paulis
from qhbmlib_tpu_torch.ops import statevector

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESSAGE = "no CUDA device; pass device='cpu' to run the plain versions"

# Each entry point as a call with "{dev}" where a device argument goes.
CALLS = {
    "BernoulliEnergy": "models.BernoulliEnergy([0, 1, 2]{dev})",
    "DirectQuantumCircuit": ("models.DirectQuantumCircuit("
                             "models.hardware_efficient_ansatz(3, 1){dev})"),
    "tfim_1d": "paulis.tfim_1d(3{dev})",
    "zero_state": "statevector.zero_state(3{dev})",
}


def _tensors(obj):
  if isinstance(obj, torch.Tensor):
    return [obj]
  if isinstance(obj, paulis.PauliSum):
    return [obj.coeffs]
  return list(obj.parameters()) + list(obj.buffers())


@pytest.mark.parametrize("name", sorted(CALLS))
def test_no_device_without_a_card_raises(name):
  code = "\n".join([
      "import torch",
      "from qhbmlib_tpu_torch import models",
      "from qhbmlib_tpu_torch.ops import paulis, statevector",
      "assert not torch.cuda.is_available()",
      "try:",
      f"  {CALLS[name].format(dev='')}",
      "except RuntimeError as e:",
      "  print(e)",
      "else:",
      "  raise SystemExit('built without a device and without a card')",
  ])
  out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=120,
                       check=False)
  assert out.returncode == 0, out.stdout + out.stderr
  assert MESSAGE in out.stdout


@pytest.mark.parametrize("name", sorted(CALLS))
def test_cpu_device_builds_on_the_cpu(name):
  obj = eval(CALLS[name].format(dev=", device='cpu'"))  # noqa: S307
  tensors = _tensors(obj)
  assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_resolve_keeps_a_given_device_and_refuses_none_without_a_card(
    monkeypatch):
  assert device.resolve("cpu") == torch.device("cpu")
  assert device.resolve(torch.device("cuda", 1)) == torch.device("cuda", 1)
  monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
  assert device.resolve() == torch.device("cuda")
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="pass device='cpu'"):
    device.resolve(None)
