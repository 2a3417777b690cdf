"""The JAX scale ladder's rungs in the port (`benchmarks/ladder.py`).

  r2_heis8_qmhl: the 8-qubit Heisenberg thermal state (beta 1.0), served
  exactly by ThermalStateData, learned by QMHL with a KOBE-2 energy, its
  exact categorical inference over 500 samples (seed 2), a 4-layer
  hardware-efficient ansatz and Adam 1e-2 (`benchmarks/ladder.py:123-136`).

The other rungs wait for modules still to port and raise
NotImplementedError naming them.  The weights are random, from seeds.
"""

from __future__ import annotations

import torch

from qhbmlib_tpu_torch import bench
from qhbmlib_tpu_torch import device as device_lib
from qhbmlib_tpu_torch import models
from qhbmlib_tpu_torch import nn
from qhbmlib_tpu_torch.baselines import utils as baselines_utils
from qhbmlib_tpu_torch.data import thermal_data
from qhbmlib_tpu_torch.inference import ebm, qhbm, qmhl_loss, qnn
from qhbmlib_tpu_torch.ops import paulis

RUNGS = ("r1_tfim2_vqt", "r2_heis8_qmhl", "r3_kobe16_vqt_shift",
         "r4_tfim24_sharded_vqt", "r5_gwg28_qmhl")
# The queue-1 item of ROADMAP.md each unported rung waits for.
WAITS_FOR = {
    "r1_tfim2_vqt": "queue 1 item 8 (the harness's ladder)",
    "r3_kobe16_vqt_shift": "queue 1 item 7 (parameter shift and sampling)",
    "r4_tfim24_sharded_vqt": "queue 1 item 9 (parallel/ on "
                             "torch.distributed)",
    "r5_gwg28_qmhl": "queue 1 item 5 (GWG)",
}
BETA = 1.0


def heisenberg(n: int, j: float = 1.0, device=None) -> paulis.PauliSum:
  """sum_q j (X_q X_q+1 + Y_q Y_q+1 + Z_q Z_q+1) on an open chain, in the
  reference's term order (`benchmarks/ladder.py:36-40`)."""
  terms = [(j, {q: p, q + 1: p}) for q in range(n - 1) for p in "XYZ"]
  return paulis.pauli_sum_from_strings(n, terms, device)


def build_rung(name: str, smoke: bool = False, qubits: int = None,
               exact: bool = False, device=None):
  """The train step of rung `name` on `device` (None means the CUDA card).

  `qubits` overrides the rung's qubit count and `smoke` shrinks it (r2: 4
  qubits, a 2-layer ansatz), as the reference's `build_rung`; `exact`
  gives the model's EBM its expected counts (no draw).  Returns (h, data,
  train_step), as `bench.build_qmhl_step`: train_step() takes one Adam
  step on the model's parameters and returns the loss and the model's flat
  gradient [theta, phi] from before the update."""
  if name in WAITS_FOR:
    raise NotImplementedError(f"rung {name} waits for {WAITS_FOR[name]}")
  if name != "r2_heis8_qmhl":
    raise ValueError(f"unknown rung {name!r}; rungs: {RUNGS}")
  device = device_lib.resolve(device)
  n = qubits if qubits is not None else (4 if smoke else 8)
  target = heisenberg(n, device="cpu")
  data = thermal_data.ThermalStateData(
      baselines_utils.get_thermal_state(BETA, target.dense()), device)
  energy = models.KOBE(list(range(n)), 2,
                       initializer=nn.RandomUniform(seed=2), device=device)
  e_inf = ebm.AnalyticEnergyInference(energy, 500, initial_seed=2,
                                      exact=exact, device=device)
  circuit = models.DirectQuantumCircuit(
      models.hardware_efficient_ansatz(n, 2 if smoke else 4),
      initializer=nn.RandomUniform(0, 2, seed=3), device=device)
  h = qhbm.QHBM(e_inf, qnn.AnalyticQuantumInference(circuit))
  loss_fn = qmhl_loss.make_qmhl(data, h)
  opt = torch.optim.Adam(h.parameters(), lr=1e-2)

  def train_step():
    opt.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    grads = bench.flat_grads(h)
    opt.step()
    return loss.detach(), grads

  return h, data, train_step
