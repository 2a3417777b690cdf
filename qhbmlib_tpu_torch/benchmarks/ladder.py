"""The JAX scale ladder's rungs in the port (`benchmarks/ladder.py`).

  r1_tfim2_vqt: the 2-qubit TFIM (beta 1.0) learned by VQT with a
  Bernoulli energy sampled 500 times (seed 1), a 2-layer
  hardware-efficient ansatz and Adam 1e-2 (`benchmarks/ladder.py:112-121`);
  `exact` gives its EBM the full support with expected counts.
  r2_heis8_qmhl: the 8-qubit Heisenberg thermal state (beta 1.0), served
  exactly by ThermalStateData, learned by QMHL with a KOBE-2 energy, its
  exact categorical inference over 500 samples (seed 2), a 4-layer
  hardware-efficient ansatz and Adam 1e-2 (`benchmarks/ladder.py:123-136`).
  r5_gwg28_qmhl: QMHL at 28 qubits on the data of a fixed random QHBM (a
  Bernoulli energy of RandomNormal(0, 0.3, seed 11) weights, 32 samples
  deduped to 4 (seed 6), a 1-layer "data_p" ansatz), learned by a KOBE-2
  energy sampled by 8 Gibbs-With-Gradients chains (32 samples, 4 unique,
  seed 5) and a 1-layer hardware-efficient ansatz, Adam 1e-2
  (`benchmarks/ladder.py:187-235`, on one device).  Its train step threads
  the chain state with no burn-in a step, as the reference's jitted step
  (its `ebm_state` starts at the chains' random initial bits).
  r3_kobe16_vqt_shift: the 16-qubit TFIM (beta 1.0) learned by VQT with a
  KOBE-2 energy under exact categorical inference (100 samples, seed 3,
  at most 4 unique states), a 2-layer hardware-efficient ansatz measured
  by `SampledQuantumInference` (1000 shots, seed 3; parameter-shift
  gradients) and Adam 1e-2 (`benchmarks/ladder.py:138-166`); `smoke`
  gives 6 qubits, 100 shots, 1 layer and no unique cap.
  r4_tfim24_sharded_vqt: the 24-qubit TFIM (beta 1.0) learned by VQT with
  a Bernoulli energy sampled 100 times (seed 4, at most 8 unique states),
  a 2-layer hardware-efficient ansatz measured by `ShardedQuantumInference`
  over a 'state' mesh of the largest power of two of ranks the world holds
  (no data axis), and Adam 1e-2 (`benchmarks/ladder.py:168-184`); `smoke`
  gives 8 qubits.

In a world of several ranks (`torch.distributed` initialized, e.g. under
`torch.distributed.run`), r3 splits its states and their shifted rows over
a 'data' mesh of every rank (`ShardedSampledQuantumInference`), r4 shards
each state over its 'state' mesh, and r5 shards the model's and the data's
states over a 'state' mesh of the largest power of two of ranks and
spreads its chains over it (`ShardedGibbsWithGradientsInference`), as the
reference does with several devices; r1 and r2 run whole on every rank.
In one process every rung runs on one device (r4 on the degenerate 1 x 1
mesh, which is the dense engine).  Each train_step's `meta` gives its
mesh's axis sizes.  The weights are random, from seeds.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from qhbmlib_tpu_torch import bench
from qhbmlib_tpu_torch import device as device_lib
from qhbmlib_tpu_torch import models
from qhbmlib_tpu_torch import nn
from qhbmlib_tpu_torch import parallel
from qhbmlib_tpu_torch.baselines import utils as baselines_utils
from qhbmlib_tpu_torch.data import qhbm_data
from qhbmlib_tpu_torch.data import thermal_data
from qhbmlib_tpu_torch.inference import ebm, qhbm, qmhl_loss, qnn, vqt_loss
from qhbmlib_tpu_torch.ops import paulis

RUNGS = ("r1_tfim2_vqt", "r2_heis8_qmhl", "r3_kobe16_vqt_shift",
         "r4_tfim24_sharded_vqt", "r5_gwg28_qmhl")
BETA = 1.0


def world_size() -> int:
  return dist.get_world_size() if dist.is_initialized() else 1


def state_shards() -> int:
  """The largest power of two of ranks the world holds (the reference's
  'state' axis over its devices)."""
  state = 1
  while state * 2 <= world_size():
    state *= 2
  return state


def heisenberg(n: int, j: float = 1.0, device=None) -> paulis.PauliSum:
  """sum_q j (X_q X_q+1 + Y_q Y_q+1 + Z_q Z_q+1) on an open chain, in the
  reference's term order (`benchmarks/ladder.py:36-40`)."""
  terms = [(j, {q: p, q + 1: p}) for q in range(n - 1) for p in "XYZ"]
  return paulis.pauli_sum_from_strings(n, terms, device)


def build_rung(name: str, smoke: bool = False, qubits: int = None,
               exact: bool = False, device=None, max_unique: int = None):
  """The train step of rung `name` on `device` (None means the CUDA card).

  `qubits` overrides the rung's qubit count (r1 has 2) and `smoke` shrinks
  it (r2: 4 qubits, a 2-layer ansatz; r3: 6 qubits, 100 shots, 1 layer, no
  unique cap; r5: 8 qubits, 4 burn-in steps), as the reference's
  `build_rung`; `max_unique` overrides r3's and r5's unique-sample caps;
  `exact` gives r1's and r2's model EBM its expected counts (no draw).
  Returns (h, data, train_step), as `bench.build_qmhl_step`, the target
  PauliSum in data's place for the VQT rungs (r1, r3), as
  `bench.build_train_step`: train_step() takes one Adam step on the
  model's parameters and returns the loss and the model's flat gradient
  [theta, phi] from before the update.  r5's train_step carries the chain
  state it threads in `train_step.ebm_state["model"]`; every train_step
  its mesh's axis sizes in `train_step.meta`."""
  if max_unique is not None and max_unique < 1:
    raise ValueError(f"max_unique must be >= 1, got {max_unique}")
  device = device_lib.resolve(device)
  if name == "r5_gwg28_qmhl":
    return _build_r5(smoke, qubits, device, max_unique or 4)
  if name == "r1_tfim2_vqt":
    return _build_r1(exact, device)
  if name == "r3_kobe16_vqt_shift":
    return _build_r3(smoke, qubits, device,
                     max_unique or (None if smoke else 4))
  if name == "r4_tfim24_sharded_vqt":
    return _build_r4(smoke, qubits, device, max_unique or 8)
  if name != "r2_heis8_qmhl":
    raise ValueError(f"unknown rung {name!r}; rungs: {RUNGS}")
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

  train_step.meta = {}
  return h, data, train_step


def _vqt_train_step(h, target):
  """One Adam 1e-2 step of the VQT loss against `target` at beta BETA
  (the reference's `_vqt_step`, `benchmarks/ladder.py:44-61`)."""
  loss_fn = vqt_loss.make_vqt(h, target)
  opt = torch.optim.Adam(h.parameters(), lr=1e-2)

  def train_step():
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(BETA)
    loss.backward()
    grads = bench.flat_grads(h)
    opt.step()
    return loss.detach(), grads

  train_step.meta = {}
  return train_step


def _build_r1(exact: bool, device):
  """r1_tfim2_vqt (reference `benchmarks/ladder.py:112-121`); its weights
  are seeded here, the reference's unseeded."""
  n = 2
  energy = models.BernoulliEnergy(list(range(n)),
                                  initializer=nn.RandomUniform(seed=1),
                                  device=device)
  e_inf = ebm.BernoulliEnergyInference(energy, 500, initial_seed=1,
                                       exact=exact, device=device)
  circuit = models.DirectQuantumCircuit(
      models.hardware_efficient_ansatz(n, 2),
      initializer=nn.RandomUniform(0, 2, seed=1), device=device)
  h = qhbm.QHBM(e_inf, qnn.AnalyticQuantumInference(circuit))
  target = paulis.tfim_1d(n, device=device)
  return h, target, _vqt_train_step(h, target)


def _build_r3(smoke: bool, qubits, device, unique_cap):
  """r3_kobe16_vqt_shift (reference `benchmarks/ladder.py:138-166`): on
  one device, or with several ranks its states over a 'data' mesh of all
  of them; its weights are seeded here, the reference's unseeded."""
  n = qubits if qubits is not None else (6 if smoke else 16)
  energy = models.KOBE(list(range(n)), 2,
                       initializer=nn.RandomUniform(seed=3), device=device)
  e_inf = ebm.AnalyticEnergyInference(energy, 100, initial_seed=3,
                                      max_unique_samples=unique_cap,
                                      device=device)
  circuit = models.DirectQuantumCircuit(
      models.hardware_efficient_ansatz(n, 1 if smoke else 2),
      initializer=nn.RandomUniform(0, 2, seed=4), device=device)
  shots = 100 if smoke else 1000
  world = world_size()
  if world > 1:
    q_inf = parallel.ShardedSampledQuantumInference(
        circuit, shots, parallel.make_mesh(data=world, state=1),
        initial_seed=3)
  else:
    q_inf = qnn.SampledQuantumInference(circuit, shots, initial_seed=3)
  h = qhbm.QHBM(e_inf, q_inf)
  target = paulis.tfim_1d(n, device=device)
  step = _vqt_train_step(h, target)
  step.meta = {"data_shards": world}
  return h, target, step


def _build_r4(smoke: bool, qubits, device, unique_cap: int):
  """r4_tfim24_sharded_vqt (reference `benchmarks/ladder.py:168-184`):
  each state over a 'state' mesh of `state_shards()` ranks, no data axis;
  its weights are seeded here, the reference's unseeded."""
  n = qubits if qubits is not None else (8 if smoke else 24)
  state = state_shards()
  mesh = parallel.make_mesh(data=1, state=state)
  energy = models.BernoulliEnergy(list(range(n)),
                                  initializer=nn.RandomUniform(seed=4),
                                  device=device)
  e_inf = ebm.BernoulliEnergyInference(energy, 100, initial_seed=4,
                                       max_unique_samples=unique_cap,
                                       device=device)
  circuit = models.DirectQuantumCircuit(
      models.hardware_efficient_ansatz(n, 2),
      initializer=nn.RandomUniform(0, 2, seed=5), device=device)
  q_inf = parallel.ShardedQuantumInference(circuit, mesh, data_axis=None)
  h = qhbm.QHBM(e_inf, q_inf)
  target = paulis.tfim_1d(n, device=device)
  step = _vqt_train_step(h, target)
  step.meta = {"state_shards": state}
  return h, target, step


def _build_r5(smoke: bool, qubits, device, unique_cap: int):
  """r5_gwg28_qmhl (reference `benchmarks/ladder.py:187-235`): on one
  device, or with several ranks every state over a 'state' mesh of
  `state_shards()` ranks and the chains spread over it; its weights are
  seeded here, the reference's unseeded."""
  n = qubits if qubits is not None else (8 if smoke else 28)
  energy = models.KOBE(list(range(n)), 2,
                       initializer=nn.RandomUniform(seed=5), device=device)
  circuit = models.DirectQuantumCircuit(
      models.hardware_efficient_ansatz(n, 1),
      initializer=nn.RandomUniform(0, 2, seed=7), device=device)
  state = state_shards()
  gwg = dict(num_chains=8, max_unique_samples=unique_cap, initial_seed=5,
             device=device)
  if state > 1:
    mesh = parallel.make_mesh(data=1, state=state)
    e_inf = parallel.ShardedGibbsWithGradientsInference(
        energy, 32, 4 if smoke else 32, mesh,
        chains_axis=parallel.mesh.STATE_AXIS, **gwg)
    q_inf = lambda c: parallel.ShardedQuantumInference(c, mesh,
                                                       data_axis=None)
  else:
    e_inf = ebm.GibbsWithGradientsInference(
        energy, 32, num_burnin_samples=4 if smoke else 32, **gwg)
    q_inf = qnn.AnalyticQuantumInference
  h = qhbm.QHBM(e_inf, q_inf(circuit))
  d_energy = models.BernoulliEnergy(
      list(range(n)), initializer=nn.RandomNormal(0.0, 0.3, seed=11),
      device=device)
  d_circuit = models.DirectQuantumCircuit(
      models.hardware_efficient_ansatz(n, 1, name="data_p"),
      initializer=nn.RandomUniform(0, 2, seed=12), device=device)
  d_e_inf = ebm.BernoulliEnergyInference(d_energy, 32, initial_seed=6,
                                         max_unique_samples=unique_cap,
                                         device=device)
  data = qhbm_data.QHBMData(qhbm.QHBM(d_e_inf, q_inf(d_circuit)))
  loss_fn = qmhl_loss.make_qmhl_with_state(data, h)
  opt = torch.optim.Adam(h.parameters(), lr=1e-2)
  ebm_state = {"model": e_inf.chain_state}

  def train_step():
    opt.zero_grad(set_to_none=True)
    loss, (_, ebm_state["model"]) = loss_fn(state=(None, ebm_state["model"]))
    loss.backward()
    grads = bench.flat_grads(h)
    opt.step()
    for p in data.qhbm.parameters():
      p.grad = None
    return loss.detach(), grads

  train_step.ebm_state = ebm_state
  train_step.meta = {"state_shards": state}
  return h, data, train_step
