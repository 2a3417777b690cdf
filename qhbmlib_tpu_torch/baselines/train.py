"""TFIM thermal-state experiment driver (port of `baselines/train.py`).

Two experiments on a transverse-field Ising model (1D ring or 2D torus):

  * "vqt": a beta sweep; at each beta the exact thermal state is the
    target and a QHBM learns it by the VQT loss.
  * "qvartz": the thermal state at `dataset.beta` (VQT), then
    `dataset.time_steps` Trotterized time steps, each learned by the QMHL
    loss from the data of the previous model followed by the constant
    Trotter channel circuit; the exact target is the channel-evolved
    state.

Each data point trains by one of three methods: "vanilla" (SGD or Adam on
the loss's gradient), "natural" (the gradient solved against the BKM
information matrix, `make_information_matrix`, `natural_solve`) or
"mirror" (each outer gradient followed by `num_inner_steps` proximal
steps against a VQT divergence from the anchor).  Metrics are the
reference's (loss, parameters, gradients and their norms every step, the
information matrix's spectrum and the natural gradient, the mirror inner
loop's terms under `train_inner`; fidelity and relative entropy to the
exact state every `expensive_downsample` steps), in its output layout
under `<output_dir>/results`, with kill-and-resume of finished data
points (`torch.save` checkpoints in place of orbax).  The model trains on
the CUDA card unless a device is given.

    python -m qhbmlib_tpu_torch.baselines.train --output_dir DIR \\
        [--config qhbmlib_tpu_torch/baselines/config.py] [--seed 42] \\
        [--device cuda|cpu] [--config.training.method=natural ...]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from qhbmlib_tpu_torch import device as device_lib
from qhbmlib_tpu_torch import models, nn
from qhbmlib_tpu_torch.baselines import pqc
from qhbmlib_tpu_torch.baselines import utils as baselines_utils
from qhbmlib_tpu_torch.data import qhbm_data
from qhbmlib_tpu_torch.inference import ebm, qhbm, qhbm_utils, qnn
from qhbmlib_tpu_torch.inference import qmhl_loss, vqt_loss
from qhbmlib_tpu_torch.ops import circuit_ir as ir
from qhbmlib_tpu_torch.ops import paulis
from qhbmlib_tpu_torch.ops import statevector as sv

METHODS = ("vanilla", "natural", "mirror")
LOSSES = ("vqt", "qvartz")
# A data point's parameters, under checkpoints/<label>/trial_<t>/.
CHECKPOINT_FILE = "params.pt"
# The information matrix's parameter shift and its scale (reference
# train.py:293-294).
INFO_SHIFT = 0.5
INFO_SCALE = np.pi / 2

_said_no_tensorboard = False


def _tensorboard_writer(log_dir: str):
  """A TensorBoard SummaryWriter on `log_dir`, or None (said once on
  stderr) when `torch.utils.tensorboard` does not import."""
  global _said_no_tensorboard
  try:
    from torch.utils.tensorboard import SummaryWriter
  except Exception as e:  # tensorboard missing or broken
    if not _said_no_tensorboard:
      print(f"MetricsWriter: torch.utils.tensorboard does not import ({e}); "
            "writing JSONL only", file=sys.stderr)
      _said_no_tensorboard = True
    return None
  return SummaryWriter(log_dir=log_dir)


class MetricsWriter:
  """Writes scalar, histogram and image metrics to `<log_dir>/metrics.jsonl`
  (images to TensorBoard only), and to TensorBoard when asked and
  available."""

  def __init__(self, log_dir: str, tensorboard: bool = True):
    os.makedirs(log_dir, exist_ok=True)
    self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
    self._tb = _tensorboard_writer(log_dir) if tensorboard else None

  def scalar(self, tag: str, value, step: int):
    value = float(value)
    self._jsonl.write(
        json.dumps({"tag": tag, "value": value, "step": int(step)}) + "\n")
    if self._tb:
      self._tb.add_scalar(tag, value, int(step))

  def histogram(self, tag: str, values, step: int):
    arr = np.asarray(values).reshape(-1)
    self._jsonl.write(
        json.dumps({
            "tag": tag + "/stats", "step": int(step),
            "mean": float(arr.mean()), "std": float(arr.std()),
            "min": float(arr.min()), "max": float(arr.max()),
        }) + "\n")
    if self._tb:
      self._tb.add_histogram(tag, arr, int(step))

  def image(self, tag: str, img, step: int):
    if self._tb:
      self._tb.add_image(tag, np.asarray(img)[0], int(step),
                         dataformats="HWC")

  def hparams(self, hparams: dict):
    self._jsonl.write(json.dumps({"hparams": hparams}) + "\n")
    if self._tb:
      self._tb.add_hparams(hparams, {})

  def flush(self):
    self._jsonl.flush()
    if self._tb:
      self._tb.flush()

  def close(self):
    self.flush()
    self._jsonl.close()
    if self._tb:
      self._tb.close()


# ---------------------------------------------------------------------------
# The TFIM data points
# ---------------------------------------------------------------------------

def get_tfim_hamiltonian(bias: float, config, device=None):
  """The TFIM on a 1D ring or a 2D torus of num_rows x num_cols sites as
  its (X shard, ZZ shard) PauliSums, coefficients -bias and -1 on `device`
  (None means the CUDA card)."""
  num_rows = config.dataset.num_rows
  num_cols = config.dataset.num_cols
  n = num_rows * num_cols
  if config.dataset.lattice_dim == 1:
    z_terms = [(-1.0, {q: "Z", (q + 1) % n: "Z"}) for q in range(n)]
  else:
    def qid(r, c):
      return (r % num_rows) * num_cols + (c % num_cols)
    z_terms = []
    for r in range(num_rows):
      for c in range(num_cols):
        z_terms.append((-1.0, {qid(r, c): "Z", qid(r, c + 1): "Z"}))
        z_terms.append((-1.0, {qid(r, c): "Z", qid(r + 1, c): "Z"}))
  x_terms = [(-bias, {q: "X"}) for q in range(n)]
  return (paulis.pauli_sum_from_strings(n, x_terms, device),
          paulis.pauli_sum_from_strings(n, z_terms, device))


def get_tfim_unitary(x_hamiltonian: paulis.PauliSum,
                     z_hamiltonian: paulis.PauliSum, config) -> ir.Circuit:
  """One time step of the TFIM's evolution as a constant circuit: for each
  of `trotter_steps` Trotter steps exp(-i dt X-shard), then exp(-i dt
  ZZ-shard), each term one PROT of angle dt * coefficient, with dt =
  total_time / (time_steps * trotter_steps) (reference train.py:131)."""
  dt = config.dataset.total_time / (config.dataset.time_steps *
                                    config.dataset.trotter_steps)
  builder = ir.CircuitBuilder(x_hamiltonian.num_qubits)
  for _ in range(config.dataset.trotter_steps):
    for shard in (x_hamiltonian, z_hamiltonian):
      # exp_pauli_sum reads the coefficients through numpy.
      ir.exp_pauli_sum(shard.to("cpu"), shift=dt, builder=builder)
  return builder.build()


def circuit_matrix(circuit: ir.Circuit, device=None) -> np.ndarray:
  """The dense unitary of a symbol-free circuit as complex128 host numpy,
  simulated on `device` (None means the CUDA card) by
  `statevector.unitary` (reference `_circuit_matrix`, train.py:814)."""
  values = torch.zeros([0], device=device_lib.resolve(device))
  return sv.unitary(circuit, values).cpu().numpy().astype(np.complex128)


def compute_data_point_metrics(beta=None,
                               target_hamiltonian_matrix=None,
                               prev_target_density_matrix=None,
                               channel_matrix=None):
  """The exact target state and its entropy, and log Z for a thermal point
  (host numpy, float64): (rho, S, log Z) given beta and the Hamiltonian's
  matrix, (U rho_prev U^dagger, S) given a channel matrix."""
  if beta is not None and target_hamiltonian_matrix is not None:
    target_dm = np.asarray(
        baselines_utils.get_thermal_state(beta, target_hamiltonian_matrix),
        np.complex128)
    target_log_z = float(baselines_utils.log_partition_function(
        beta, target_hamiltonian_matrix))
  else:
    channel = np.asarray(channel_matrix, np.complex128)
    target_dm = channel @ prev_target_density_matrix @ np.conj(channel.T)
    target_log_z = None
  evals = np.maximum(np.real(np.linalg.eigvalsh(target_dm)), 0.0)
  # 0 log 0 = 0: a zero eigenvalue's log is taken of 1, never of 0.
  target_entropy = -np.sum(evals * np.log(np.where(evals > 0, evals, 1.0)))
  if target_log_z is None:
    return target_dm, target_entropy
  return target_dm, target_entropy, target_log_z


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def get_initial_qhbm(hamiltonian_shards, config, name, seed=None,
                     device=None):
  """(modular Hamiltonian, QHBM) as the config asks, on `device` (None
  means the CUDA card).  `seed` seeds the energy's initializer, the
  circuit's (seed + 1), the EBM's sampler (seed + 2) and a sampled QNN's
  shots (seed + 3); None draws fresh seeds."""
  device = device_lib.resolve(device)
  num_sites = config.dataset.num_rows * config.dataset.num_cols
  num_layers = config.model.circuit_layers

  def offset(k):
    return None if seed is None else seed + k

  energy_initializer = nn.RandomNormal(config.model.energy_init_mean,
                                       config.model.energy_init_stddev,
                                       seed=seed)
  if config.model.energy == "kobe":
    energy = models.KOBE(list(range(num_sites)), config.model.kobe_order,
                         energy_initializer, device=device)
  elif config.model.energy == "bernoulli":
    energy = models.BernoulliEnergy(list(range(num_sites)),
                                    energy_initializer, device=device)
  else:
    raise ValueError(config.model.energy)

  num_samples = config.training.num_samples
  if config.model.ebm == "analytic":
    e_inf = ebm.AnalyticEnergyInference(energy, num_samples,
                                        initial_seed=offset(2), device=device,
                                        name=name)
  elif config.model.ebm == "bernoulli":
    e_inf = ebm.BernoulliEnergyInference(energy, num_samples,
                                         initial_seed=offset(2),
                                         device=device, name=name)
  elif config.model.ebm == "gwg":
    e_inf = ebm.GibbsWithGradientsInference(
        energy, num_samples, num_burnin_samples=config.model.gwg_burnin,
        name=name, num_chains=config.model.gwg_chains,
        initial_seed=offset(2), device=device)
  else:
    raise ValueError(config.model.ebm)

  circuit_initializer = nn.RandomNormal(config.model.circuit_init_mean,
                                        config.model.circuit_init_stddev,
                                        seed=offset(1))
  if config.model.circuit == "qhea":
    u = pqc.get_hardware_efficient_model_unitary(num_sites, num_layers, name)
    circuit = models.DirectQuantumCircuit(u, circuit_initializer,
                                          device=device)
  elif config.model.circuit == "qaia":
    circuit = models.QAIA(hamiltonian_shards,
                          energy.operator_shards(num_sites), num_layers,
                          circuit_initializer, device=device)
  else:
    raise ValueError(config.model.circuit)

  if config.model.qnn == "analytic":
    q_inf = qnn.AnalyticQuantumInference(circuit, name=name)
  elif config.model.qnn == "sampled":
    q_inf = qnn.SampledQuantumInference(circuit, num_samples, name=name,
                                        initial_seed=offset(3))
  else:
    raise ValueError(config.model.qnn)

  h = qhbm.QHBM(e_inf, q_inf)
  return h.modular_hamiltonian, h


def get_optimizer(optimizer: str, learning_rate: float, params):
  """torch.optim.SGD or Adam (its defaults, as optax's) over `params`."""
  if optimizer == "SGD":
    return torch.optim.SGD(params, lr=learning_rate)
  if optimizer == "Adam":
    return torch.optim.Adam(params, lr=learning_rate)
  raise ValueError(optimizer)


def check_config(config) -> None:
  """Raises ValueError for a training method or loss the harness does not
  have."""
  if config.training.method not in METHODS:
    raise ValueError(f"training.method={config.training.method!r}; the "
                     f"methods are {METHODS}")
  if config.training.loss not in LOSSES:
    raise ValueError(f"training.loss={config.training.loss!r}; the losses "
                     f"are {LOSSES}")


# ---------------------------------------------------------------------------
# The natural gradient
# ---------------------------------------------------------------------------

def _flat_cat(tensors) -> torch.Tensor:
  return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like):
  """`flat` cut into tensors of the shapes of `like`, in order."""
  out, at = [], 0
  for t in like:
    out.append(flat[at:at + t.numel()].reshape(t.shape))
    at += t.numel()
  return out


def energy_jacobian(energy: torch.nn.Module, theta, samples: torch.Tensor
                    ) -> torch.Tensor:
  """[N, Pt] gradients dE(x_i)/dtheta of each sample x_i of `samples` [N,
  n], the parameters `theta` (the energy's trainable ones) flattened in
  order: one reverse-mode Jacobian of the N energies (torch.func.jacrev),
  not N backward calls."""
  names = [name for name, p in energy.named_parameters() if p.requires_grad]

  def energies(*values):
    return torch.func.functional_call(energy, dict(zip(names, values)),
                                      (samples,))

  jac = torch.func.jacrev(energies, argnums=tuple(range(len(theta))))(
      *[t.detach() for t in theta])
  return torch.cat([j.reshape(samples.shape[0], -1) for j in jac], dim=1)


def make_information_matrix(qhbm_obj: qhbm.QHBM,
                            modular_hamiltonian_copy: models.Hamiltonian,
                            num_samples: int):
  """Returns info_matrix(generator=None, ebm_state=None) -> [P, P], P = Pt
  + Pp, estimating the Bogoliubov-Kubo-Mori metric tr[d_j rho d_k K] at
  the QHBM's current parameters in [theta; phi] block order (reference
  train.py:238-319):

    * the EBM block [Pt, Pt]: the covariance of the energy gradients of
      `num_samples` samples (not deduplicated) drawn from `ebm_state`;
    * the cross block [Pp, Pt] and the QNN block [Pp, Pp]: row i is pi/2
      times the gradient of <K_copy> at phi_i - 0.5 less that at phi_i +
      0.5, taken in the copy's energy or circuit parameters, the copy
      set to the QHBM's parameters.  Each <K_copy> is the QHBM's
      `expectation_with_state` at `ebm_state`, which it does not advance;
      a row's two evaluations share one draw, each row its own, from a
      generator seeded from one seed drawn from `generator` (the EBM's
      own if None): the cross rows first, then the QNN rows.

  The matrix is symmetrized, (M + M^T) / 2.  4 Pp evaluations of <K_copy>
  a call, each with a backward (the cross block's stops at the copy's
  energy and runs no adjoint sweep), row after row as the reference's
  `lax.map`."""
  e_inf = qhbm_obj.e_inference
  mh_copy = modular_hamiltonian_copy
  copy_energy = mh_copy.params["energy"]
  copy_circuit = mh_copy.params["circuit"]

  def info_matrix(generator: Optional[torch.Generator] = None,
                  ebm_state=None) -> torch.Tensor:
    gen = generator or e_inf.generator
    theta, phi = qhbm_obj.params["theta"], qhbm_obj.params["phi"]
    samples, _ = e_inf.sample_with_state(ebm_state, num_samples, gen)
    jac = energy_jacobian(e_inf.energy, theta, samples.to(torch.float32))
    centered = jac - jac.mean(dim=0)
    block_ebm = centered.T @ centered / num_samples

    mh_copy.set_params({"energy": tuple(t.detach() for t in theta),
                        "circuit": tuple(p.detach() for p in phi)})
    seed = int(torch.randint(2**62, (1,), generator=gen, device=gen.device))
    row_gen = torch.Generator(device=e_inf.device)
    # (parameter, flat offset) of each element of the flattened phi.
    slots = [(p, j) for p in phi for j in range(p.numel())]

    def shifted_grad(i, shift, wrt, row_seed):
      p, j = slots[i]
      base = p.detach().reshape(-1)[j].clone()
      with torch.no_grad():
        p.view(-1)[j] = base + shift
      try:
        row_gen.manual_seed(row_seed)
        value, _ = qhbm_obj.expectation_with_state(mh_copy, row_gen,
                                                   ebm_state)
        grads = torch.autograd.grad(value[0], wrt, allow_unused=True)
      finally:
        with torch.no_grad():
          p.view(-1)[j] = base
      return _flat_cat([torch.zeros_like(w) if g is None else g
                        for g, w in zip(grads, wrt)])

    def block(wrt, first_seed):
      rows = []
      for i in range(len(slots)):
        row_seed = (first_seed + i) % 2**63
        rows.append(INFO_SCALE * (shifted_grad(i, -INFO_SHIFT, wrt, row_seed)
                                  - shifted_grad(i, INFO_SHIFT, wrt,
                                                 row_seed)))
      return torch.stack(rows)

    block_cross = block(copy_energy, seed)  # [Pp, Pt]
    block_qnn = block(copy_circuit, seed + len(slots))  # [Pp, Pp]
    im = torch.cat([torch.cat([block_ebm, block_cross.T], dim=1),
                    torch.cat([block_cross, block_qnn], dim=1)], dim=0)
    return (im + im.T) / 2.0

  return info_matrix


def natural_solve(im: torch.Tensor, grads, training_config):
  """Solves reg(im) @ nat = grads in the information matrix's [theta; phi]
  block order; returns (nat_grads {'theta': [...], 'phi': [...]} shaped as
  `grads`, (reg_im, reg, nat_flat)) (reference train.py:322-356).

  The regularizer: with `info_matrix_eigval_reg`, info_matrix_reg + |min
  eigenvalue| where the least eigenvalue is at most info_matrix_reg (else
  0); without it, info_matrix_reg.  `lstsq_fast` solves the normal
  equations with the l2 regularizer `lstsq_l2_regularizer`; otherwise the
  minimum-norm least-squares solution by SVD with the reference's
  rcond = eps * max(M, N) (its `jnp.linalg.lstsq`; the l2 regularizer is
  ignored, as in TF)."""
  n = im.shape[0]
  eye = torch.eye(n, dtype=im.dtype, device=im.device)
  r = training_config.info_matrix_reg
  if training_config.info_matrix_eigval_reg:
    min_eig = torch.linalg.eigvalsh(im).min()
    reg = torch.where(min_eig <= r, r + torch.abs(torch.clamp(min_eig,
                                                              max=0.0)),
                      torch.zeros_like(min_eig))
  else:
    reg = torch.tensor(r, dtype=im.dtype, device=im.device)
  reg_im = im + reg * eye
  flat_grads = torch.cat([_flat_cat(grads["theta"]), _flat_cat(grads["phi"])])
  if training_config.get("lstsq_fast", False):
    lhs = reg_im.T @ reg_im + training_config.lstsq_l2_regularizer * eye
    nat_flat = torch.linalg.solve(lhs, reg_im.T @ flat_grads)
  else:
    rcond = torch.finfo(im.dtype).eps * max(im.shape)
    nat_flat = torch.linalg.pinv(reg_im, rtol=rcond) @ flat_grads
  nt = sum(g.numel() for g in grads["theta"])
  nat_grads = {"theta": _unflat(nat_flat[:nt], grads["theta"]),
               "phi": _unflat(nat_flat[nt:], grads["phi"])}
  return nat_grads, (reg_im, reg, nat_flat)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _flat(values) -> np.ndarray:
  return np.concatenate([v.detach().cpu().numpy().reshape(-1)
                         for v in values])


def make_train_step(qhbm_obj: qhbm.QHBM, optimizer, config,
                    generator: Optional[torch.Generator] = None,
                    target_hamiltonian: Optional[paulis.PauliSum] = None,
                    beta=None, evolved_qhbm_data=None,
                    target_hamiltonian_shards=None,
                    inner_log: Optional[Callable] = None):
  """One train step of `config.training.method` on the VQT loss at `beta`
  against `target_hamiltonian`, or with `evolved_qhbm_data` on the QMHL
  loss against those data (reference train.py:381-514).

  Returns step(state, index) -> (loss, grads {'theta': [...], 'phi':
  [...]} of the loss from before the update, new state, natural extras
  (im, reg_im, reg, nat_flat) or None).  `state` is the EBM sampler's
  state, threaded with no burn-in: for QMHL the (data, model) pair.
  `generator` draws every sample (None: the EBMs' own).

    * vanilla: `optimizer` steps on the gradient.
    * natural: the information matrix (`make_information_matrix`, at the
      sampler state the loss advanced) and `natural_solve`, then
      `optimizer` steps on the natural gradient.
    * mirror: the outer gradient g with no update, then
      `num_inner_steps` steps of `optimizer` on <v, g> + (1 /
      learning_rate) ((1 - a) div + a |v - anchor|^2 / 2), a =
      `euclidean_div_factor`, div the VQT loss at beta 1 against the
      modular Hamiltonian of a copy frozen at the anchor (the outer
      step's parameters); after each, inner_log(index * num_inner_steps
      + inner_step, inner loss, inner product, div, euclidean div, inner
      gradients) when given.

  The natural and mirror methods build the copy from
  `target_hamiltonian_shards` (`get_initial_qhbm`, name "qhbm_copy")."""
  check_config(config)
  training = config.training
  method = training.method
  is_qmhl = evolved_qhbm_data is not None
  params = qhbm_obj.params
  flat_params = params["theta"] + params["phi"]
  nt = len(params["theta"])

  if is_qmhl:
    qmhl_fn = qmhl_loss.make_qmhl_with_state(evolved_qhbm_data, qhbm_obj)

    def loss_fn(state):
      return qmhl_fn((generator, generator), state)
  else:
    vqt_fn = vqt_loss.make_vqt_with_state(qhbm_obj, target_hamiltonian)

    def loss_fn(state):
      return vqt_fn(beta, generator, state)

  def model_state(state):
    return state[1] if is_qmhl else state

  def with_model_state(state, new_model_state):
    return (state[0], new_model_state) if is_qmhl else new_model_state

  def gradients(value):
    grads = torch.autograd.grad(value, flat_params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, flat_params)]

  def update(grads):
    for p, g in zip(flat_params, grads):
      p.grad = g
    optimizer.step()

  def as_dict(grads):
    return {"theta": list(grads[:nt]), "phi": list(grads[nt:])}

  mh_copy = None
  if method in ("natural", "mirror"):
    mh_copy, _ = get_initial_qhbm(target_hamiltonian_shards, config,
                                  "qhbm_copy",
                                  device=qhbm_obj.e_inference.device)
  if method == "natural":
    info_matrix_fn = make_information_matrix(qhbm_obj, mh_copy,
                                             training.num_samples)
  if method == "mirror":
    div_fn = vqt_loss.make_vqt_with_state(qhbm_obj, mh_copy)

  def step(state, index: int):
    loss, state = loss_fn(state)
    grads = gradients(loss)
    loss = loss.detach()
    if method == "vanilla":
      update(grads)
      return loss, as_dict(grads), state, None
    if method == "natural":
      im = info_matrix_fn(generator, model_state(state))
      nat_grads, (reg_im, reg, nat_flat) = natural_solve(
          im, as_dict(grads), training)
      update(nat_grads["theta"] + nat_grads["phi"])
      return loss, as_dict(grads), state, (im, reg_im, reg, nat_flat)
    anchor = [p.detach().clone() for p in flat_params]
    outer = [g.detach() for g in grads]
    mh_copy.set_params({"energy": tuple(anchor[:nt]),
                        "circuit": tuple(anchor[nt:])})
    for inner_step in range(training.num_inner_steps):
      inner_prod = sum(torch.sum(v * g) for v, g in zip(flat_params, outer))
      div, new_model_state = div_fn(1.0, generator, model_state(state))
      euclid = 0.5 * sum(torch.sum((v - c)**2)
                         for v, c in zip(flat_params, anchor))
      alpha = training.euclidean_div_factor
      inner = inner_prod + 1.0 / training.learning_rate * (
          (1.0 - alpha) * div + alpha * euclid)
      igrads = gradients(inner)
      update(igrads)
      state = with_model_state(state, new_model_state)
      if inner_log is not None:
        inner_log(index * training.num_inner_steps + inner_step,
                  inner.detach(), inner_prod.detach(), div.detach(),
                  euclid.detach(), igrads)
    return loss, as_dict(grads), state, None

  return step


def log_step(metrics_writer: MetricsWriter, log, step: int, loss, params,
             grads) -> None:
  """A step's cheap metrics: the loss, histograms of the parameters (all,
  the energy's, the circuit's) and of the gradients, and the gradients'
  norms."""
  if log.loss:
    metrics_writer.scalar("loss", loss, step)
  if log.variables:
    metrics_writer.histogram("variables",
                             _flat(params["theta"] + params["phi"]), step)
    metrics_writer.histogram("energy_variables", _flat(params["theta"]), step)
    metrics_writer.histogram("circuit_variables", _flat(params["phi"]), step)
  if log.grads:
    fg = _flat(grads["theta"] + grads["phi"])
    metrics_writer.histogram("grads", fg, step)
    metrics_writer.scalar("grad_norm", np.linalg.norm(fg, ord=log.norm_ord),
                          step)
    metrics_writer.scalar(
        "energy_grad_norm",
        np.linalg.norm(_flat(grads["theta"]), ord=log.norm_ord), step)
    metrics_writer.scalar(
        "circuit_grad_norm",
        np.linalg.norm(_flat(grads["phi"]), ord=log.norm_ord), step)


def log_natural(metrics_writer: MetricsWriter, log, step: int,
                extra) -> None:
  """A natural step's metrics (reference train.py:594-610): the
  information matrix's eigenvalues (histogram, least, largest, condition
  number), the regularizer, the natural gradient and its norm."""
  im, _, reg, nat_flat = extra
  nat = nat_flat.detach().cpu().numpy()
  if log.info_matrix:
    eigvals = np.linalg.eigvalsh(im.detach().cpu().numpy())
    metrics_writer.histogram("info_matrix_eigvals", eigvals, step)
    metrics_writer.scalar("info_matrix_min_eigval", eigvals.min(), step)
    metrics_writer.scalar("info_matrix_max_eigval", eigvals.max(), step)
    metrics_writer.scalar(
        "info_matrix_cond_number",
        abs(eigvals.max()) / max(abs(eigvals.min()), 1e-30), step)
  if log.reg_info_matrix:
    metrics_writer.scalar("reg", reg, step)
  if log.natural_grads:
    metrics_writer.histogram("natural_grads", nat, step)
    metrics_writer.scalar("natural_grad_norm",
                          np.linalg.norm(nat, ord=log.norm_ord), step)


def train_model(qhbm_obj: qhbm.QHBM,
                modular_hamiltonian: models.Hamiltonian,
                optimizer,
                num_steps: int,
                target_hamiltonian_shards,
                target_density_matrix,
                metrics_dir: str,
                metrics_writer: MetricsWriter,
                config,
                generator: Optional[torch.Generator] = None,
                target_hamiltonian: Optional[paulis.PauliSum] = None,
                beta=None,
                evolved_qhbm_data=None,
                on_step: Optional[Callable[[int], None]] = None):
  """Trains the QHBM in place by `config.training.method`
  (`make_train_step`) for `num_steps` steps and returns its parameters:
  on the VQT loss at `beta`, or with `evolved_qhbm_data` on the QMHL loss.

  A GWG chain (for QMHL the model's and the data's) is burned in once
  before the loop and threaded through the steps.  Each step logs
  `log_step`'s metrics (and a natural step `log_natural`'s; the mirror
  inner loop's go to `<metrics_dir>/train_inner`); every
  `expensive_downsample` steps and at the last the fidelity, the relative
  entropy (D(model || target) for VQT, D(target || model) for QMHL) and
  optionally the density matrix as an image.  With
  `logging.profiler_steps` > 0 steps 1..profiler_steps run under
  torch.profiler (a Chrome trace in `<metrics_dir>/profile`).
  `generator` draws every sample (None: the EBMs' own); `on_step(step)` is
  called after each step's metrics."""
  is_qmhl = evolved_qhbm_data is not None
  e_inf = qhbm_obj.e_inference
  log = config.logging
  inner_writer = None

  def inner_log(index, inner, inner_prod, div, euclid, igrads):
    nonlocal inner_writer
    if inner_writer is None:
      inner_writer = MetricsWriter(os.path.join(metrics_dir, "train_inner"),
                                   tensorboard=bool(log.tensorboard))
    if log.inner_loss:
      inner_writer.scalar("inner_loss", inner, index)
    if log.inner_prod:
      inner_writer.scalar("inner_prod", inner_prod, index)
    if log.div:
      inner_writer.scalar("div", div, index)
      inner_writer.scalar("euclidean_div", euclid, index)
    if log.inner_loss_grads:
      inner_writer.histogram("inner_loss_grads", _flat(igrads), index)

  step_fn = make_train_step(
      qhbm_obj, optimizer, config, generator, target_hamiltonian, beta,
      evolved_qhbm_data, target_hamiltonian_shards, inner_log)
  ebm_state = getattr(e_inf, "chain_state", None)
  if ebm_state is not None:
    ebm_state = e_inf.burn_in(ebm_state, generator)
  if is_qmhl:
    data_e_inf = getattr(getattr(evolved_qhbm_data, "qhbm", None),
                         "e_inference", None)
    data_state = getattr(data_e_inf, "chain_state", None)
    if data_state is not None:
      data_state = data_e_inf.burn_in(data_state, generator)
    ebm_state = (data_state, ebm_state)

  profiler_steps = log.get("profiler_steps", 0)
  profiler = None
  params = qhbm_obj.params
  for step in range(num_steps):
    if profiler_steps > 0 and step == 1:
      activities = [torch.profiler.ProfilerActivity.CPU]
      if e_inf.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
      profiler = torch.profiler.profile(activities=activities)
      profiler.start()
    if profiler is not None and step == 1 + profiler_steps:
      _stop_profiler(profiler, metrics_dir)
      profiler = None
    loss, grads, ebm_state, extra = step_fn(ebm_state, step)
    if inner_writer is not None:
      # Each outer step's inner trajectory is on disk before the next.
      inner_writer.flush()
    log_step(metrics_writer, log, step, loss, params, grads)
    if extra is not None:
      log_natural(metrics_writer, log, step, extra)
    if step % log.expensive_downsample == 0 or step == num_steps - 1:
      if log.fidelity:
        fid = qhbm_utils.fidelity(modular_hamiltonian, target_density_matrix)
        metrics_writer.scalar("fidelity", fid, step)
      if log.relative_entropy:
        dm = qhbm_utils.density_matrix(modular_hamiltonian)
        metrics_writer.scalar(
            "relative_entropy",
            baselines_utils.relative_entropy(target_density_matrix, dm)
            if is_qmhl else
            baselines_utils.relative_entropy(dm, target_density_matrix),
            step)
      if log.density_matrix:
        img = baselines_utils.density_matrix_to_image(
            qhbm_utils.density_matrix(modular_hamiltonian))
        metrics_writer.image("density_matrix", img, step)
    if on_step is not None:
      on_step(step)

  if profiler is not None:
    _stop_profiler(profiler, metrics_dir)
  if inner_writer is not None:
    inner_writer.close()
  model_chain = ebm_state[1] if is_qmhl else ebm_state
  if model_chain is not None:
    e_inf._chain_state = model_chain
  metrics_writer.flush()
  return {k: [p.detach().clone() for p in v] for k, v in params.items()}


def _stop_profiler(profiler, metrics_dir: str) -> None:
  profiler.stop()
  os.makedirs(os.path.join(metrics_dir, "profile"), exist_ok=True)
  profiler.export_chrome_trace(
      os.path.join(metrics_dir, "profile", "trace.json"))


# ---------------------------------------------------------------------------
# The experiment
# ---------------------------------------------------------------------------

def _save_params(ckpt_dir: str, params) -> None:
  os.makedirs(ckpt_dir, exist_ok=True)
  path = os.path.join(ckpt_dir, CHECKPOINT_FILE)
  torch.save({k: tuple(p.cpu() for p in v) for k, v in params.items()},
             path + ".tmp")
  os.replace(path + ".tmp", path)


def load_params(ckpt_dir: str, device=None):
  """A data point's checkpointed parameters, for `QHBM.set_params`."""
  return torch.load(os.path.join(ckpt_dir, CHECKPOINT_FILE),
                    map_location=device_lib.resolve(device),
                    weights_only=True)


def evolved_data(prev_params, unitary: ir.Circuit, hamiltonian_shards,
                 config, device=None) -> qhbm_data.QHBMData:
  """QVARTZ's data for one time step (reference train.py:720-733): a
  fresh "prev_qhbm" (unseeded) carrying `prev_params`, its circuit
  followed by the constant channel `unitary`, its EBM unchanged."""
  _, prev_qhbm = get_initial_qhbm(hamiltonian_shards, config, "prev_qhbm",
                                  device=device)
  prev_qhbm.set_params(prev_params)
  channel = models.ConstantCircuit(unitary, name="channel", device=device)
  circuit = prev_qhbm.q_inference.circuit + channel
  if config.model.qnn == "analytic":
    q_inf = qnn.AnalyticQuantumInference(circuit)
  else:
    q_inf = qnn.SampledQuantumInference(circuit, config.training.num_samples)
  return qhbm_data.QHBMData(qhbm.QHBM(prev_qhbm.e_inference, q_inf))


def run_experiment(config, output_dir: str, seed: int = 42, device=None,
                   on_step: Optional[Callable[[str, int], None]] = None):
  """The experiment of `config` on `device` (None means the CUDA card);
  returns `<output_dir>/results`.  "vqt": the beta sweep, data points
  labelled `beta_0p5` and so on.  "qvartz": `dataset.beta` by VQT, then
  `time_steps` points `time_<t>` by QMHL from `evolved_data` (with
  `training.train` False only the exact targets are walked), each point
  starting from the last one's parameters (`seq_init` "prev") or from a
  fresh model ("random").  There: `config.json`; `metrics/<label>/
  data_point` (the target's entropy, and log Z of a thermal point) and
  `metrics/<label>/train_model_trial_<t>` (`train_model`'s metrics and the
  target loss: -log Z, or the target's entropy); `checkpoints/<label>/
  trial_<t>`; `hparams`.  A data point whose checkpoint exists is
  restored, not trained (`training.resume`), and seeds the next.
  `on_step(label, step)` is called after each train step."""
  check_config(config)
  device = device_lib.resolve(device)
  # Each data point's seed is drawn before its resume check, so a resumed
  # run trains the rest with the seeds of an uninterrupted one.
  seeds = torch.Generator().manual_seed(seed)
  results_dir = os.path.join(output_dir, "results")
  os.makedirs(results_dir, exist_ok=True)
  with open(os.path.join(results_dir, "config.json"), "w") as f:
    json.dump(config.to_dict(), f, default=str)

  bias = round(config.dataset.bias, config.dataset.digits)
  x_h, z_h = get_tfim_hamiltonian(bias, config, device)
  target_hamiltonian_shards = [x_h, z_h]
  target_hamiltonian = x_h + z_h
  target_matrix = np.asarray(target_hamiltonian.dense(), np.complex128)
  if config.training.loss == "vqt":
    betas = np.linspace(config.dataset.beta_min, config.dataset.beta_max,
                        config.dataset.beta_steps)
    iterates = [round(float(b), config.dataset.digits) for b in betas]
  else:
    unitary = get_tfim_unitary(x_h, z_h, config)
    iterates = ([round(float(config.dataset.beta), config.dataset.digits)] +
                [unitary] * config.dataset.time_steps)
  tensorboard = bool(config.logging.tensorboard)
  learning_rate = (config.training.inner_learning_rate
                   if config.training.method == "mirror" else
                   config.training.learning_rate)

  for trial in range(config.training.num_trials):
    modular_hamiltonian, qhbm_obj = get_initial_qhbm(
        target_hamiltonian_shards, config, "qhbm", seed=seed + trial,
        device=device)
    target_dm, prev_params = None, None
    for sequence_step, iterate in enumerate(iterates):
      is_vqt = config.training.loss == "vqt" or sequence_step == 0
      evolved = None
      if is_vqt:
        beta = iterate
        target_dm, target_entropy, target_log_z = compute_data_point_metrics(
            beta=beta, target_hamiltonian_matrix=target_matrix)
        label = f"beta_{str(beta).replace('.', 'p')}"
      else:
        evolution_time = round(
            sequence_step * config.dataset.total_time /
            config.dataset.time_steps, config.dataset.digits)
        target_dm, target_entropy = compute_data_point_metrics(
            prev_target_density_matrix=target_dm,
            channel_matrix=circuit_matrix(iterate, device))
        target_log_z = None
        label = f"time_{str(evolution_time).replace('.', 'p')}"
        if config.training.train:
          evolved = evolved_data(prev_params, iterate,
                                 target_hamiltonian_shards, config, device)
      if trial == 0:
        dp_writer = MetricsWriter(
            os.path.join(results_dir, "metrics", label, "data_point"),
            tensorboard=tensorboard)
        dp_writer.scalar("target_entropy", target_entropy, 0)
        if is_vqt:
          dp_writer.scalar("target_log_partition_function", target_log_z, 0)
        if config.logging.density_matrix:
          dp_writer.image("target_density_matrix",
                          baselines_utils.density_matrix_to_image(target_dm),
                          0)
        dp_writer.close()
      if not config.training.train:
        continue
      if sequence_step > 0 and config.training.seq_init == "random":
        modular_hamiltonian, qhbm_obj = get_initial_qhbm(
            target_hamiltonian_shards, config, "qhbm",
            seed=seed + trial + 1000 * sequence_step, device=device)
      point_seed = int(torch.randint(2**62, (1,), generator=seeds))
      ckpt_dir = os.path.join(os.path.abspath(results_dir), "checkpoints",
                              label, f"trial_{trial}")
      if (config.logging.checkpoint and config.training.get("resume", True)
          and os.path.isfile(os.path.join(ckpt_dir, CHECKPOINT_FILE))):
        prev_params = load_params(ckpt_dir, device)
        qhbm_obj.set_params(prev_params)
        print(f"[{label}] trial {trial}: restored checkpoint, skipping "
              "training")
        continue

      model_dir = os.path.join(results_dir, "metrics", label,
                               f"train_model_trial_{trial}")
      writer = MetricsWriter(model_dir, tensorboard=tensorboard)
      optimizer = get_optimizer(config.training.optimizer, learning_rate,
                                qhbm_obj.parameters())
      generator = torch.Generator(device=device).manual_seed(point_seed)
      num_steps = (config.training.init_steps if sequence_step == 0 else
                   config.training.num_steps)
      t0 = time.time()
      prev_params = train_model(
          qhbm_obj, modular_hamiltonian, optimizer, num_steps,
          target_hamiltonian_shards, target_dm, model_dir, writer, config,
          generator, target_hamiltonian=target_hamiltonian if is_vqt else None,
          beta=beta if is_vqt else None, evolved_qhbm_data=evolved,
          on_step=(None if on_step is None else
                   lambda step, label=label: on_step(label, step)))
      writer.scalar("target_loss", -target_log_z if is_vqt else target_entropy,
                    max(num_steps - 1, 0))
      writer.close()
      print(f"[{label}] trial {trial}: {num_steps} steps in "
            f"{(time.time() - t0) / 60.0:.2f} min")
      if config.logging.checkpoint:
        _save_params(ckpt_dir, prev_params)

  hparams_writer = MetricsWriter(os.path.join(results_dir, "hparams"),
                                 tensorboard=tensorboard)
  hparams_writer.hparams({
      "loss": config.training.loss,
      "method": config.training.method,
      "optimizer": config.training.optimizer,
      "seq_init": config.training.seq_init,
  })
  hparams_writer.close()
  return results_dir


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "config.py")


def load_config(path: str):
  """`get_config()` of the config module at `path`."""
  spec = importlib.util.spec_from_file_location("harness_config", path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module.get_config()


def _cast(text: str, default):
  """`text` as the type of `default` (bools: true/false, 1/0)."""
  if isinstance(default, bool):
    lowered = text.lower()
    if lowered not in ("true", "false", "1", "0"):
      raise ValueError(f"not a bool: {text!r}")
    return lowered in ("true", "1")
  return type(default)(text)


def apply_overrides(config, overrides) -> None:
  """Sets each `--config.a.b=value` of `overrides` on `config`, `value`
  cast to the type of the key's default."""
  for arg in overrides:
    if not arg.startswith("--config.") or "=" not in arg:
      raise ValueError(f"unknown argument {arg!r}; overrides take the form "
                       "--config.section.key=value")
    dotted, text = arg[len("--config."):].split("=", 1)
    *path, leaf = dotted.split(".")
    node = config
    for key in path:
      node = node[key]
    if leaf not in node:
      raise KeyError(f"config has no key {dotted!r}")
    node[leaf] = _cast(text, node[leaf])


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--config", default=DEFAULT_CONFIG,
                 help="path of a config module with get_config()")
  p.add_argument("--output_dir", default="/tmp/qhbm_logs/exp")
  p.add_argument("--seed", type=int, default=42)
  p.add_argument("--device", default=None,
                 help="torch device (default: the CUDA card)")
  args, overrides = p.parse_known_args(argv)
  config = load_config(args.config)
  apply_overrides(config, overrides)
  print(f"Saving results to: {args.output_dir}")
  run_experiment(config, args.output_dir, args.seed, args.device)


if __name__ == "__main__":
  main()
