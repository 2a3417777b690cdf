"""Learn a model of unknown quantum data with QMHL (port of
`examples/qmhl_modular_hamiltonian.py`).

Given quantum DATA -- here the exact thermal state of a 3-qubit Heisenberg
chain at beta 0.8, served by `ThermalStateData` -- a QHBM (a KOBE-2 energy
under exact inference and a 3-layer hardware-efficient ansatz) is trained
with Adam 5e-2 for 200 steps so its modular Hamiltonian matches the
data's: the quantum cross-entropy <K_model>_data + log Z_model is smallest
when rho_model == rho_data, where it equals the data's entropy.

    python -m qhbmlib_tpu_torch.examples.qmhl_modular_hamiltonian
        [--steps 200] [--device cpu]

The CUDA card runs the kernels; `--device cpu` runs their plain versions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from qhbmlib_tpu_torch import device as device_lib
from qhbmlib_tpu_torch import models
from qhbmlib_tpu_torch import nn
from qhbmlib_tpu_torch.data import thermal_data
from qhbmlib_tpu_torch.examples import vqt_thermal_state as vqt_example
from qhbmlib_tpu_torch.inference import ebm, qhbm, qhbm_utils, qmhl_loss, qnn
from qhbmlib_tpu_torch.ops import paulis

N, BETA, LAYERS, STEPS = 3, 0.8, 3, 200


def heisenberg_1d(n: int, j: float = 1.0, device=None) -> paulis.PauliSum:
  """sum_q j (X_q X_q+1 + Y_q Y_q+1 + Z_q Z_q+1) on an open chain."""
  terms = [(j, {q: p, q + 1: p}) for q in range(n - 1) for p in "XYZ"]
  return paulis.pauli_sum_from_strings(n, terms, device)


def build(device=None):
  """(model, loss, data) on `device` (None means the CUDA card), from
  the example's seeds: the energy's 3, the EBM's 4, the circuit's 5.
  loss() is `make_qmhl`'s."""
  device = device_lib.resolve(device)
  sigma = vqt_example.thermal_state(heisenberg_1d(N, device="cpu"), BETA)
  data = thermal_data.ThermalStateData(sigma, device)
  energy = models.KOBE(list(range(N)), 2,
                       initializer=nn.RandomUniform(-0.5, 0.5, seed=3),
                       device=device)
  e_inf = ebm.AnalyticEnergyInference(energy, 500, initial_seed=4,
                                      exact=True, device=device)
  circuit = models.DirectQuantumCircuit(
      models.hardware_efficient_ansatz(N, LAYERS),
      initializer=nn.RandomUniform(-0.5, 0.5, seed=5), device=device)
  model = qhbm.QHBM(e_inf, qnn.AnalyticQuantumInference(circuit))
  return model, qmhl_loss.make_qmhl(data, model), data


def data_entropy(data: thermal_data.ThermalStateData) -> float:
  """The data's von Neumann entropy: the optimum of the QMHL loss."""
  evals = np.linalg.eigvalsh(data.density_matrix.numpy())
  return float(-(evals * np.log(np.maximum(evals, 1e-12))).sum())


def fidelity(model: qhbm.QHBM, data: thermal_data.ThermalStateData) -> float:
  """The model's fidelity to the data's state."""
  return qhbm_utils.fidelity(model.modular_hamiltonian,
                             data.density_matrix.numpy())


def main(steps: Optional[int] = None, device=None) -> float:
  """Trains for `steps` (default 200) and returns the fidelity."""
  model, loss, data = build(device)
  vqt_example.train(vqt_example.make_step(model, loss),
                    STEPS if steps is None else steps, label="qmhl loss")
  print(f"data entropy (optimum loss): {data_entropy(data):+.6f}")
  fid = fidelity(model, data)
  print(f"fidelity to data state: {fid:.4f}")
  return fid


if __name__ == "__main__":
  vqt_example.cli(__doc__.splitlines()[0], main)
