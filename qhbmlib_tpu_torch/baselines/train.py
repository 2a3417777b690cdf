"""TFIM thermal-state experiment driver (port of `baselines/train.py`).

A VQT beta sweep: for each beta of the sweep, the exact thermal state of a
transverse-field Ising model (1D ring or 2D torus) is the target, and a
QHBM trains against it by the vanilla method (SGD or Adam on the VQT
loss), with the reference's metrics (loss, parameters, gradients and their
norms every step; fidelity and relative entropy to the exact state every
`expensive_downsample` steps), its output layout under `<output_dir>/results`
and its kill-and-resume of finished data points (`torch.save` checkpoints
in place of orbax).  The model trains on the CUDA card unless a device is
given.

    python -m qhbmlib_tpu_torch.baselines.train --output_dir DIR \\
        [--config qhbmlib_tpu_torch/baselines/config.py] [--seed 42] \\
        [--device cuda|cpu] [--config.dataset.num_rows=8 ...]

The natural-gradient and mirror-descent methods and the QVARTZ loss
(`training.method` "natural" / "mirror", `training.loss` "qvartz") wait for
ROADMAP.md queue 1 item 8b and raise NotImplementedError.
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
from qhbmlib_tpu_torch.inference import ebm, qhbm, qhbm_utils, qnn
from qhbmlib_tpu_torch.inference import vqt_loss
from qhbmlib_tpu_torch.ops import paulis

# What the methods and losses that are not ported yet wait for.
WAITS_FOR = "ROADMAP.md queue 1 item 8b"
# A data point's parameters, under checkpoints/<label>/trial_<t>/.
CHECKPOINT_FILE = "params.pt"

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


def check_ported(config) -> None:
  """Raises NotImplementedError for a method or loss not ported yet, and
  ValueError for an unknown one."""
  method, loss = config.training.method, config.training.loss
  if method in ("natural", "mirror"):
    raise NotImplementedError(
        f"training.method={method!r} (the natural gradient and mirror "
        f"descent) waits for {WAITS_FOR}; only 'vanilla' is ported")
  if method != "vanilla":
    raise ValueError(method)
  if loss == "qvartz":
    raise NotImplementedError(
        f"training.loss='qvartz' (QMHL re-learning along a Trotterized "
        f"evolution) waits for {WAITS_FOR}; only 'vqt' is ported")
  if loss != "vqt":
    raise ValueError(loss)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _flat(values) -> np.ndarray:
  return np.concatenate([v.detach().cpu().numpy().reshape(-1)
                         for v in values])


def make_vanilla_step(qhbm_obj: qhbm.QHBM, target_hamiltonian, beta,
                      optimizer, generator=None):
  """One vanilla step of the VQT loss at `beta`, the EBM's sampler state
  threaded: step(state) -> (loss, grads {'theta': [...], 'phi': [...]} from
  before the update, new state)."""
  loss_fn = vqt_loss.make_vqt_with_state(qhbm_obj, target_hamiltonian)
  params = qhbm_obj.params

  def step(state):
    optimizer.zero_grad(set_to_none=True)
    loss, state = loss_fn(beta, generator, state)
    loss.backward()
    grads = {k: [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                 for p in v] for k, v in params.items()}
    optimizer.step()
    return loss.detach(), grads, state

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
  """Trains the QHBM in place by `optimizer` (vanilla: the VQT loss's
  gradient) for `num_steps` steps and returns its parameters.

  A GWG chain is burned in once before the loop and threaded through the
  steps.  Each step logs `log_step`'s metrics; every
  `expensive_downsample` steps and at the last the fidelity, the relative
  entropy D(rho_model || target) and optionally the density matrix as an
  image.  With `logging.profiler_steps` > 0 steps 1..profiler_steps run
  under torch.profiler (a Chrome trace in `<metrics_dir>/profile`).
  `generator` draws the EBM's samples (None: the EBM's own); `on_step(step)`
  is called after each step's metrics."""
  del target_hamiltonian_shards  # the natural and mirror methods' copy
  check_ported(config)
  if evolved_qhbm_data is not None:
    raise NotImplementedError(f"QMHL training waits for {WAITS_FOR}")
  e_inf = qhbm_obj.e_inference
  step_fn = make_vanilla_step(qhbm_obj, target_hamiltonian, beta, optimizer,
                              generator)
  ebm_state = getattr(e_inf, "chain_state", None)
  if ebm_state is not None:
    ebm_state = e_inf.burn_in(ebm_state, generator)

  log = config.logging
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
    loss, grads, ebm_state = step_fn(ebm_state)
    log_step(metrics_writer, log, step, loss, params, grads)
    if step % log.expensive_downsample == 0 or step == num_steps - 1:
      if log.fidelity:
        fid = qhbm_utils.fidelity(modular_hamiltonian, target_density_matrix)
        metrics_writer.scalar("fidelity", fid, step)
      if log.relative_entropy:
        dm = qhbm_utils.density_matrix(modular_hamiltonian)
        metrics_writer.scalar(
            "relative_entropy",
            baselines_utils.relative_entropy(dm, target_density_matrix), step)
      if log.density_matrix:
        img = baselines_utils.density_matrix_to_image(
            qhbm_utils.density_matrix(modular_hamiltonian))
        metrics_writer.image("density_matrix", img, step)
    if on_step is not None:
      on_step(step)

  if profiler is not None:
    _stop_profiler(profiler, metrics_dir)
  if ebm_state is not None:
    e_inf._chain_state = ebm_state
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


def run_experiment(config, output_dir: str, seed: int = 42, device=None,
                   on_step: Optional[Callable[[str, int], None]] = None):
  """The VQT beta sweep of `config` on `device` (None means the CUDA card);
  returns `<output_dir>/results`.  There: `config.json`;
  `metrics/<label>/data_point` (the target's entropy and log Z) and
  `metrics/<label>/train_model_trial_<t>` (`train_model`'s metrics and
  the target loss -log Z) for each beta, labelled `beta_0p5` and so on;
  `checkpoints/<label>/trial_<t>`; `hparams`.  A data point whose
  checkpoint exists is restored, not trained (`training.resume`).
  `on_step(label, step)` is called after each train step."""
  check_ported(config)
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
  betas = np.linspace(config.dataset.beta_min, config.dataset.beta_max,
                      config.dataset.beta_steps)
  iterates = [round(float(b), config.dataset.digits) for b in betas]
  tensorboard = bool(config.logging.tensorboard)

  for trial in range(config.training.num_trials):
    modular_hamiltonian, qhbm_obj = get_initial_qhbm(
        target_hamiltonian_shards, config, "qhbm", seed=seed + trial,
        device=device)
    for sequence_step, beta in enumerate(iterates):
      target_dm, target_entropy, target_log_z = compute_data_point_metrics(
          beta=beta, target_hamiltonian_matrix=target_matrix)
      label = f"beta_{str(beta).replace('.', 'p')}"
      if trial == 0:
        dp_writer = MetricsWriter(
            os.path.join(results_dir, "metrics", label, "data_point"),
            tensorboard=tensorboard)
        dp_writer.scalar("target_entropy", target_entropy, 0)
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
        qhbm_obj.set_params(load_params(ckpt_dir, device))
        print(f"[{label}] trial {trial}: restored checkpoint, skipping "
              "training")
        continue

      model_dir = os.path.join(results_dir, "metrics", label,
                               f"train_model_trial_{trial}")
      writer = MetricsWriter(model_dir, tensorboard=tensorboard)
      optimizer = get_optimizer(config.training.optimizer,
                                config.training.learning_rate,
                                qhbm_obj.parameters())
      generator = torch.Generator(device=device).manual_seed(point_seed)
      num_steps = (config.training.init_steps if sequence_step == 0 else
                   config.training.num_steps)
      t0 = time.time()
      params = train_model(
          qhbm_obj, modular_hamiltonian, optimizer, num_steps,
          target_hamiltonian_shards, target_dm, model_dir, writer, config,
          generator, target_hamiltonian=target_hamiltonian, beta=beta,
          on_step=(None if on_step is None else
                   lambda step, label=label: on_step(label, step)))
      writer.scalar("target_loss", -target_log_z, max(num_steps - 1, 0))
      writer.close()
      print(f"[{label}] trial {trial}: {num_steps} steps in "
            f"{(time.time() - t0) / 60.0:.2f} min")
      if config.logging.checkpoint:
        _save_params(ckpt_dir, params)

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
