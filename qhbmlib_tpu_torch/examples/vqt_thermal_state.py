"""Learn the thermal state of a transverse-field Ising chain with VQT (port
of `examples/vqt_thermal_state.py`).

A QHBM (a Bernoulli EBM under exact inference and a 3-layer
hardware-efficient ansatz) is trained with Adam 5e-2 for 150 steps to
minimize the VQT free energy beta<H> - S against a 4-qubit open TFIM at
beta 1.0; its fidelity to the exact thermal state exp(-beta H)/Z is
reported.

    python -m qhbmlib_tpu_torch.examples.vqt_thermal_state [--steps 150]
        [--device cpu]

The CUDA card runs the kernels; `--device cpu` runs their plain versions.
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional

import torch

from qhbmlib_tpu_torch import device as device_lib
from qhbmlib_tpu_torch import models
from qhbmlib_tpu_torch import nn
from qhbmlib_tpu_torch.baselines import utils as baselines_utils
from qhbmlib_tpu_torch.inference import ebm, qhbm, qhbm_utils, qnn, vqt_loss
from qhbmlib_tpu_torch.ops import paulis

N, BETA, LAYERS, STEPS, LR = 4, 1.0, 3, 150, 5e-2


def thermal_state(ham: paulis.PauliSum, beta: float):
  """exp(-beta H) / Z as a complex128 host matrix."""
  return baselines_utils.get_thermal_state(beta, ham.dense())


def build(device=None):
  """(model, loss, target) on `device` (None means the CUDA card), from
  the example's seeds: the energy's 7, the EBM's 7, the circuit's 8.
  loss() is the VQT loss at BETA against the open TFIM
  H = -sum X_i - sum Z_i Z_{i+1}."""
  device = device_lib.resolve(device)
  energy = models.BernoulliEnergy(
      list(range(N)), initializer=nn.RandomUniform(-1, 1, seed=7),
      device=device)
  e_inf = ebm.AnalyticEnergyInference(energy, 500, initial_seed=7,
                                      exact=True, device=device)
  circuit = models.DirectQuantumCircuit(
      models.hardware_efficient_ansatz(N, LAYERS),
      initializer=nn.RandomUniform(-0.5, 0.5, seed=8), device=device)
  model = qhbm.QHBM(e_inf, qnn.AnalyticQuantumInference(circuit))
  target = paulis.tfim_1d(N, device=device)
  loss_fn = vqt_loss.make_vqt(model, target)
  return model, lambda: loss_fn(BETA), target


def make_step(model: qhbm.QHBM, loss: Callable[[], torch.Tensor]):
  """step() -> (loss, flat gradient [theta, phi]) from before one Adam
  step (LR, every example's) on the model's parameters; loss() is the loss
  at them."""
  opt = torch.optim.Adam(model.parameters(), lr=LR)

  def step():
    opt.zero_grad(set_to_none=True)
    value = loss()
    value.backward()
    grads = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    opt.step()
    return value.detach(), grads

  return step


def train(step: Callable, steps: int, every: int = 25,
          before_step: Optional[Callable[[int], None]] = None,
          label: str = "vqt loss") -> List[float]:
  """Runs `steps` steps and returns their losses; prints step k's loss
  where k % every == 0 and at the last step.  `before_step(k)`, where
  given, runs before step k."""
  losses = []
  for k in range(steps):
    if before_step is not None:
      before_step(k)
    losses.append(step()[0])
    if k % every == 0 or k == steps - 1:
      print(f"step {k:4d}  {label} {float(losses[-1]):+.6f}", flush=True)
  return [float(x) for x in losses]


def fidelity(model: qhbm.QHBM, target: paulis.PauliSum,
             beta: float = BETA) -> float:
  """The model's fidelity to the exact thermal state of `target`."""
  return qhbm_utils.fidelity(model.modular_hamiltonian,
                             thermal_state(target, beta))


def main(steps: Optional[int] = None, device=None) -> float:
  """Trains for `steps` (default 150) and returns the fidelity."""
  model, loss, target = build(device)
  train(make_step(model, loss), STEPS if steps is None else steps)
  fid = fidelity(model, target)
  print(f"fidelity to exact thermal state: {fid:.4f}")
  return fid


def cli(description: str, run: Callable, argv=None):
  """Parses --steps and --device and calls run(steps, device)."""
  p = argparse.ArgumentParser(description=description)
  p.add_argument("--steps", type=int, default=None,
                 help="train steps (default: the example's own)")
  p.add_argument("--device", default=None,
                 help="torch device (default: the CUDA card)")
  args = p.parse_args(argv)
  return run(args.steps, args.device)


if __name__ == "__main__":
  cli(__doc__.splitlines()[0], main)
