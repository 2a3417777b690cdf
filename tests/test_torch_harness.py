"""The port's experiment harness (`qhbmlib_tpu_torch/baselines/`) against
the JAX package's (`baselines/`), on the CPU at 2-4 qubits.

  * The TFIM shards' dense matrices, the exact metrics (thermal state,
    entropy, log Z, relative entropy, the trace product, the image) on
    seeded random PSD matrices within 1e-10, the config and the sweep, and
    the model factory's parameter shapes for every branch.
  * The trainer step for step: both QHBMs at 4q with the JAX initial
    parameters carried over (`convert.from_jax_params`) and their EBMs
    exact; 5 vanilla steps with Adam and with SGD give JAX's losses and
    final parameters within 1e-4 (`LOSS_ATOL`, as `test_torch_vqt.py`).
  * A 3q `run_experiment` writes the JAX run's directories and JSONL tags;
    the data points' target entropy and log Z agree within 1e-9.
  * The port alone: the reference's smoke and convergence tests
    (`tests/baselines/test_train.py`) for every method and both losses,
    kill-and-resume of a VQT sweep and of a QVARTZ sequence, GWG runs
    threading their chains, QVARTZ's dataset-only mode, the CLI and the
    ladder CLI in subprocesses, the launcher, and ValueError for an unknown
    method or loss.  (The natural, mirror and QVARTZ steps against the
    JAX trainer: `test_torch_harness_methods.py`.)
"""

import json
import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import optax
import pytest
import torch

from baselines import config as jconfig
from baselines import train as jtrain
from baselines import utils as jutils
from qhbmlib_tpu.inference import qmhl_loss as jqmhl
from qhbmlib_tpu.inference import vqt_loss as jvqt
from qhbmlib_tpu.ops import paulis as jp
from qhbmlib_tpu_torch import convert
from qhbmlib_tpu_torch.baselines import config as tconfig
from qhbmlib_tpu_torch.baselines import launch as tlaunch
from qhbmlib_tpu_torch.baselines import train as ttrain
from qhbmlib_tpu_torch.baselines import utils as tutils
from qhbmlib_tpu_torch.benchmarks import ladder as tladder
from qhbmlib_tpu_torch.data import qhbm_data as tqhbm_data
from qhbmlib_tpu_torch.inference import ebm as tebm
from qhbmlib_tpu_torch.inference import qmhl_loss as tqmhl
from qhbmlib_tpu_torch.inference import vqt_loss as tvqt
from qhbmlib_tpu_torch.ops import paulis as tp

torch.set_num_threads(1)

CPU = "cpu"  # the port builds on the CUDA card unless told otherwise
LOSS_ATOL = 1e-4  # as tests/test_torch_vqt.py
PARAM_ATOL = 1e-4
METRIC_ATOL = 1e-10
TARGET_ATOL = 1e-9
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _configs(**overrides):
  """(JAX config, port config) with the same overrides, dotted keys."""
  out = []
  for lib in (jconfig, tconfig):
    config = lib.get_config()
    for k, v in overrides.items():
      node = config
      *path, leaf = k.split(".")
      for p in path:
        node = getattr(node, p)
      setattr(node, leaf, v)
    out.append(config)
  return out


SMALL = {
    "dataset.num_rows": 2, "dataset.num_cols": 1, "dataset.beta_steps": 2,
    "model.circuit_layers": 1, "training.num_samples": 30,
    "training.init_steps": 2, "training.num_steps": 2,
    "logging.expensive_downsample": 2, "logging.tensorboard": False,
    "logging.checkpoint": False,
}


def _small_config(**overrides):
  return _configs(**{**SMALL, **overrides})[1]


def _records(path):
  with open(path) as f:
    return [json.loads(line) for line in f]


def _read_metrics(results_dir, label, tag):
  path = os.path.join(results_dir, "metrics", label, "train_model_trial_0",
                      "metrics.jsonl")
  return [r["value"] for r in _records(path) if r.get("tag") == tag]


def _psd(rng, dim, rank=None):
  a = rng.normal(size=(dim, rank or dim)) + 1j * rng.normal(
      size=(dim, rank or dim))
  m = a @ a.conj().T
  return m / np.trace(m)


# ---------------------------------------------------------------------------
# Pieces against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,cols,dim", [(4, 1, 1), (3, 1, 1), (2, 3, 2),
                                           (2, 2, 2)])
def test_tfim_hamiltonian_matches_jax(rows, cols, dim):
  jc, tc = _configs(**{"dataset.num_rows": rows, "dataset.num_cols": cols,
                       "dataset.lattice_dim": dim})
  jx, jz = jtrain.get_tfim_hamiltonian(0.7, jc)
  tx, tz = ttrain.get_tfim_hamiltonian(0.7, tc, device=CPU)
  np.testing.assert_array_equal(tx.dense(), np.asarray(jx.dense()))
  np.testing.assert_array_equal(tz.dense(), np.asarray(jz.dense()))
  joined = jp.PauliSum(jx.codes + jz.codes,
                       jp.concat_coeffs([jx.coeffs, jz.coeffs]),
                       jx.num_qubits)
  target = tp.PauliSum(torch.cat([tx.codes, tz.codes]),
                       tp.concat_coeffs([tx.coeffs, tz.coeffs]),
                       tx.num_qubits)
  np.testing.assert_array_equal(target.dense(), np.asarray(joined.dense()))
  np.testing.assert_array_equal((tx + tz).dense(), target.dense())


def test_concat_coeffs():
  got = tp.concat_coeffs([torch.tensor([1.0, 2.0]), np.float32(3.0), [4.0]])
  want = jp.concat_coeffs([np.array([1.0, 2.0]), np.float32(3.0), [4.0]])
  assert got.dtype == torch.float32
  np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
  leaf = torch.tensor([1.0, 2.0], requires_grad=True)
  tp.concat_coeffs([leaf, torch.tensor([5.0])]).sum().backward()
  np.testing.assert_array_equal(leaf.grad.numpy(), [1.0, 1.0])


def test_metrics_match_jax():
  rng = np.random.RandomState(7)
  for dim in (4, 8, 16):
    rho, sigma = _psd(rng, dim), _psd(rng, dim)
    assert abs(tutils.optimized_trace_matmul(rho, sigma) -
               jutils.optimized_trace_matmul(rho, sigma)) < METRIC_ATOL
    assert abs(tutils.relative_entropy(rho, sigma) -
               jutils.relative_entropy(rho, sigma)) < METRIC_ATOL
    np.testing.assert_allclose(tutils.density_matrix_to_image(rho),
                               jutils.density_matrix_to_image(rho),
                               atol=METRIC_ATOL)
    h = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    h = h + h.conj().T
    got = ttrain.compute_data_point_metrics(beta=1.3,
                                            target_hamiltonian_matrix=h)
    want = jtrain.compute_data_point_metrics(beta=1.3,
                                             target_hamiltonian_matrix=h)
    np.testing.assert_allclose(got[0], want[0], atol=METRIC_ATOL)
    assert abs(got[1] - want[1]) < METRIC_ATOL
    assert abs(got[2] - want[2]) < METRIC_ATOL
  # A 10q image renders at one pixel an entry.
  big = _psd(rng, 1024, rank=2)
  assert tutils.density_matrix_to_image(big).shape == (1, 1024, 1024, 3)


def test_data_point_entropy_of_a_pure_state_takes_no_log_of_zero():
  """A rank-1 target: the port's entropy takes no log of 0 (the JAX copy
  warns "divide by zero") and agrees with the JAX value."""
  pure = np.zeros((8, 8), np.complex128)
  pure[5, 5] = 1.0  # seven eigenvalues exactly 0
  q = np.eye(8)[::-1]
  with warnings.catch_warnings():
    warnings.simplefilter("error")
    got = ttrain.compute_data_point_metrics(prev_target_density_matrix=pure,
                                            channel_matrix=q)
  with np.errstate(divide="ignore", invalid="ignore"):
    want = jtrain.compute_data_point_metrics(
        prev_target_density_matrix=pure, channel_matrix=q)
  np.testing.assert_allclose(got[0], want[0], atol=METRIC_ATOL)
  assert abs(got[1] - want[1]) < METRIC_ATOL
  assert len(got) == 2


def test_config_and_sweep_match_jax():
  j = jconfig.get_config().to_dict()
  t = tconfig.get_config().to_dict()
  for d in (j, t):
    d.pop("experiment_name")
    d["args"].pop("experiment_name")
    d["args"].pop("output_dir")
  assert t == j
  assert tconfig.get_sweep() == jconfig.get_sweep()
  config = tconfig.get_config()
  assert config.dataset.num_rows == config["dataset"]["num_rows"] == 2
  assert config.training.get("resume", False) is True
  config.dataset.num_rows = 8
  assert config.to_dict()["dataset"]["num_rows"] == 8
  with pytest.raises(AttributeError):
    config.no_such_key


FACTORY = [(e, b, c, q) for e, b in (("kobe", "analytic"), ("kobe", "gwg"),
                                     ("bernoulli", "analytic"),
                                     ("bernoulli", "bernoulli"),
                                     ("bernoulli", "gwg"))
           for c in ("qhea", "qaia") for q in ("analytic", "sampled")]


@pytest.mark.parametrize("energy,ebm,circuit,qnn", FACTORY)
def test_initial_qhbm_shapes_match_jax(energy, ebm, circuit, qnn):
  jc, tc = _configs(**{"dataset.num_rows": 3, "dataset.num_cols": 1,
                       "model.circuit_layers": 2, "model.energy": energy,
                       "model.ebm": ebm, "model.circuit": circuit,
                       "model.qnn": qnn})
  jshards = jtrain.get_tfim_hamiltonian(1.0, jc)
  tshards = ttrain.get_tfim_hamiltonian(1.0, tc, device=CPU)
  _, jh = jtrain.get_initial_qhbm(jshards, jc, "qhbm", seed=1)
  _, th = ttrain.get_initial_qhbm(tshards, tc, "qhbm", seed=1, device=CPU)
  for key in ("theta", "phi"):
    assert ([tuple(p.shape) for p in th.params[key]] ==
            [tuple(np.shape(p)) for p in jh.params[key]])
  assert type(th.e_inference).__name__ == type(jh.e_inference).__name__
  assert type(th.q_inference).__name__ == type(jh.q_inference).__name__
  # Seeded: the same seed builds the same weights.
  _, again = ttrain.get_initial_qhbm(tshards, tc, "qhbm", seed=1, device=CPU)
  for a, b in zip(th.parameters(), again.parameters()):
    assert torch.equal(a, b)


def test_vqt_and_qmhl_wrappers_match_jax():
  jc, tc = _configs(**{"dataset.num_rows": 3, "dataset.num_cols": 1,
                       "model.circuit_layers": 2})
  jshards = jtrain.get_tfim_hamiltonian(1.0, jc)
  tshards = ttrain.get_tfim_hamiltonian(1.0, tc, device=CPU)
  _, jh = jtrain.get_initial_qhbm(jshards, jc, "qhbm", seed=4)
  _, th = ttrain.get_initial_qhbm(tshards, tc, "qhbm", seed=9, device=CPU)
  jh.e_inference.exact = th.e_inference.exact = True
  params = jax.tree_util.tree_map(np.asarray, jh.params)
  th.set_params(convert.from_jax_params(params, device=CPU))
  jtarget, ttarget = jshards[0] + jshards[1], tshards[0] + tshards[1]
  got = tvqt.vqt(th, ttarget, 0.8)
  assert not got.requires_grad
  np.testing.assert_allclose(float(got), float(jvqt.vqt(jh, jtarget, 0.8)),
                             atol=LOSS_ATOL)
  # QMHL of the model against the thermal state of a second QHBM.
  _, jdh = jtrain.get_initial_qhbm(jshards, jc, "data", seed=6)
  _, tdh = ttrain.get_initial_qhbm(tshards, tc, "data", seed=6, device=CPU)
  jdh.e_inference.exact = tdh.e_inference.exact = True
  tdh.set_params(convert.from_jax_params(
      jax.tree_util.tree_map(np.asarray, jdh.params), device=CPU))
  got = tqmhl.qmhl(tqhbm_data.QHBMData(tdh), th)
  assert not got.requires_grad
  want = jqmhl.qmhl(jtrain.data_module.QHBMData(jdh), jh)
  np.testing.assert_allclose(float(got), float(want), atol=LOSS_ATOL)


# ---------------------------------------------------------------------------
# The trainer against the JAX trainer
# ---------------------------------------------------------------------------

STEP_OVERRIDES = {"dataset.num_rows": 4, "dataset.num_cols": 1,
                  "model.circuit_layers": 3, "logging.tensorboard": False,
                  "logging.expensive_downsample": 2}


@pytest.mark.parametrize("optimizer", ["Adam", "SGD"])
def test_train_model_matches_jax_step_for_step(tmp_path, optimizer):
  steps, beta = 5, 0.9
  jc, tc = _configs(**STEP_OVERRIDES, **{"training.optimizer": optimizer})
  jshards = jtrain.get_tfim_hamiltonian(1.0, jc)
  tshards = ttrain.get_tfim_hamiltonian(1.0, tc, device=CPU)
  jmh, jh = jtrain.get_initial_qhbm(jshards, jc, "qhbm", seed=3)
  tmh, th = ttrain.get_initial_qhbm(tshards, tc, "qhbm", seed=8, device=CPU)
  jh.e_inference.exact = th.e_inference.exact = True
  params0 = jax.tree_util.tree_map(np.asarray, jh.params)
  th.set_params(convert.from_jax_params(params0, device=CPU))
  jtarget = jp.PauliSum(jshards[0].codes + jshards[1].codes,
                        jp.concat_coeffs([jshards[0].coeffs,
                                          jshards[1].coeffs]), 4)
  ttarget = tshards[0] + tshards[1]
  target_dm = ttrain.compute_data_point_metrics(
      beta=beta, target_hamiltonian_matrix=ttarget.dense())[0]

  jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
  jwriter = jtrain.MetricsWriter(jdir, tensorboard=False)
  jparams = jtrain.train_model(
      jh, jmh, jtrain.get_optimizer(optimizer, 0.1), steps, jshards,
      target_dm, jdir, jwriter, jc, jax.random.PRNGKey(0),
      target_hamiltonian=jtarget, beta=beta)
  jwriter.close()
  twriter = ttrain.MetricsWriter(tdir, tensorboard=False)
  tparams = ttrain.train_model(
      th, tmh, ttrain.get_optimizer(optimizer, 0.1, th.parameters()), steps,
      tshards, target_dm, tdir, twriter, tc,
      torch.Generator().manual_seed(0), target_hamiltonian=ttarget,
      beta=beta)
  twriter.close()

  jrec = _records(os.path.join(jdir, "metrics.jsonl"))
  trec = _records(os.path.join(tdir, "metrics.jsonl"))
  assert [r["tag"] for r in trec] == [r["tag"] for r in jrec]
  losses = lambda recs: [r["value"] for r in recs if r["tag"] == "loss"]
  assert len(losses(trec)) == steps
  np.testing.assert_allclose(losses(trec), losses(jrec), atol=LOSS_ATOL)
  assert losses(trec)[-1] < losses(trec)[0]
  for tag in ("fidelity", "relative_entropy"):
    np.testing.assert_allclose(
        [r["value"] for r in trec if r["tag"] == tag],
        [r["value"] for r in jrec if r["tag"] == tag], atol=LOSS_ATOL)
  for key in ("theta", "phi"):
    np.testing.assert_allclose(tparams[key][0].numpy(),
                               np.asarray(jparams[key][0]), atol=PARAM_ATOL)
    np.testing.assert_array_equal(tparams[key][0].numpy(),
                                  th.params[key][0].detach().numpy())


def _tree(results_dir):
  """Directories under results/ (not inside a checkpoint), and each
  metrics file's tags in order of first appearance."""
  dirs, tags = set(), {}
  for root, subdirs, files in os.walk(results_dir):
    rel = os.path.relpath(root, results_dir)
    parts = rel.split(os.sep)
    if parts[0] == "checkpoints" and len(parts) > 3:
      continue
    dirs.add(rel)
    if "metrics.jsonl" in files:
      seen = []
      for r in _records(os.path.join(root, "metrics.jsonl")):
        tag = r.get("tag", "hparams")
        if tag not in seen:
          seen.append(tag)
      tags[rel] = seen
  return dirs, tags


def test_run_experiment_writes_the_jax_layout(tmp_path):
  over = {**SMALL, "dataset.num_rows": 3, "logging.checkpoint": True}
  jc, tc = _configs(**over)
  jres = jtrain.run_experiment(jc, str(tmp_path / "jax"), seed=2)
  tres = ttrain.run_experiment(tc, str(tmp_path / "port"), seed=2,
                               device=CPU)
  jdirs, jtags = _tree(jres)
  tdirs, ttags = _tree(tres)
  assert tdirs == jdirs
  assert ttags == jtags
  assert "checkpoints/beta_2p25/trial_0" in tdirs
  for label in ("beta_0p5", "beta_2p25"):
    path = os.path.join("metrics", label, "data_point", "metrics.jsonl")
    got = {r["tag"]: r["value"] for r in _records(os.path.join(tres, path))}
    want = {r["tag"]: r["value"] for r in _records(os.path.join(jres, path))}
    assert set(got) == {"target_entropy", "target_log_partition_function"}
    for tag in got:
      assert abs(got[tag] - want[tag]) < TARGET_ATOL
  for name in ("config.json",):
    got, want = (json.load(open(os.path.join(r, name))) for r in (tres, jres))
    assert got["dataset"] == want["dataset"]
    assert got["training"] == want["training"]
  assert (_records(os.path.join(tres, "hparams", "metrics.jsonl")) ==
          _records(os.path.join(jres, "hparams", "metrics.jsonl")))


# ---------------------------------------------------------------------------
# The port's own runs (the reference's tests/baselines/test_train.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["SGD", "Adam"])
def test_vqt_vanilla_runs(tmp_path, optimizer):
  config = _small_config(**{"training.optimizer": optimizer})
  results = ttrain.run_experiment(config, str(tmp_path / optimizer), seed=2,
                                  device=CPU)
  losses = _read_metrics(results, "beta_0p5", "loss")
  assert len(losses) == 2
  assert all(np.isfinite(l) for l in losses)
  fid = _read_metrics(results, "beta_0p5", "fidelity")
  assert fid and 0.0 <= fid[-1] <= 1.0 + 1e-6


def test_vanilla_vqt_converges_toward_target(tmp_path):
  """The loss approaches -log Z from above and the fidelity rises."""
  config = _small_config(**{
      "dataset.beta_steps": 1, "dataset.beta_min": 1.0,
      "dataset.beta_max": 1.0, "model.circuit_layers": 2,
      "training.init_steps": 60, "training.learning_rate": 0.05,
      "logging.expensive_downsample": 59})
  results = ttrain.run_experiment(config, str(tmp_path / "conv"), seed=4,
                                  device=CPU)
  losses = _read_metrics(results, "beta_1p0", "loss")
  fid = _read_metrics(results, "beta_1p0", "fidelity")
  target = _read_metrics(results, "beta_1p0", "target_loss")[0]
  assert losses[-1] < losses[0]
  assert losses[-1] > target - 0.05
  assert fid[-1] > 0.9


def test_vqt_kill_and_resume(tmp_path, monkeypatch):
  """A finished beta point is restored, not retrained (its checkpoint
  untouched); the sweep goes on from its parameters."""
  out = str(tmp_path / "resume")
  config = _small_config(**{"logging.checkpoint": True,
                            "dataset.beta_steps": 3})
  calls = {"n": 0}
  orig = ttrain.train_model

  def preempted(*args, **kwargs):
    calls["n"] += 1
    if calls["n"] > 1:
      raise RuntimeError("simulated preemption")
    return orig(*args, **kwargs)

  monkeypatch.setattr(ttrain, "train_model", preempted)
  with pytest.raises(RuntimeError, match="simulated preemption"):
    ttrain.run_experiment(config, out, seed=5, device=CPU)
  monkeypatch.setattr(ttrain, "train_model", orig)
  ckpt_root = os.path.join(out, "results", "checkpoints")
  (first,) = os.listdir(ckpt_root)
  assert first == "beta_0p5"
  saved = os.path.join(ckpt_root, first, "trial_0")
  mtime = os.path.getmtime(saved)
  trained = ttrain.load_params(saved, CPU)

  seen = []
  orig_set = ttrain.qhbm.QHBM.set_params

  def spy(self, params):
    seen.append(params)
    return orig_set(self, params)

  monkeypatch.setattr(ttrain.qhbm.QHBM, "set_params", spy)
  results = ttrain.run_experiment(config, out, seed=5, device=CPU)
  assert os.path.getmtime(saved) == mtime
  assert len(seen) == 1 and torch.equal(seen[0]["phi"][0],
                                        trained["phi"][0])
  assert sorted(os.listdir(ckpt_root)) == ["beta_0p5", "beta_1p375",
                                           "beta_2p25"]
  # The restored point was not retrained: its metrics hold one run.
  assert len(_read_metrics(results, "beta_0p5", "loss")) == 2
  assert len(_read_metrics(results, "beta_1p375", "loss")) == 2
  mtimes = {l: os.path.getmtime(os.path.join(ckpt_root, l, "trial_0"))
            for l in os.listdir(ckpt_root)}
  ttrain.run_experiment(config, out, seed=5, device=CPU)
  for l, t in mtimes.items():
    assert os.path.getmtime(os.path.join(ckpt_root, l, "trial_0")) == t


def test_gwg_vanilla_threads_its_chain(tmp_path, monkeypatch):
  """GWG: one burn-in a data point before its loop, then the chain is
  threaded through the steps (no burn-in on parameter change) and stored
  back at the end."""
  config = _small_config(**{"model.ebm": "gwg", "model.gwg_burnin": 20,
                            "model.gwg_chains": 4})
  burns, states = [], []
  orig_burn = tebm.GibbsWithGradientsInference.burn_in
  orig_scs = tebm.GibbsWithGradientsInference.support_counts_state

  def burn_in(self, chain_state, generator=None):
    burns.append(chain_state.clone())
    return orig_burn(self, chain_state, generator)

  def support_counts_state(self, generator=None, state=None):
    out = orig_scs(self, generator, state)
    states.append((state, out[2]))
    return out

  def no_rebake(self):
    raise AssertionError("the train step burned in on a parameter change")

  cls = tebm.GibbsWithGradientsInference
  monkeypatch.setattr(cls, "burn_in", burn_in)
  monkeypatch.setattr(cls, "support_counts_state", support_counts_state)
  monkeypatch.setattr(cls, "_maybe_burn_in", no_rebake)
  results = ttrain.run_experiment(config, str(tmp_path / "gwg"), seed=6,
                                  device=CPU)
  losses = _read_metrics(results, "beta_0p5", "loss")
  assert len(losses) == 2 and all(np.isfinite(l) for l in losses)
  assert len(burns) == 2  # one a data point
  # Two draws a step (the loss's support, then log Z's), each continuing
  # the state the last one returned.
  assert len(states) == 2 * 2 * 2
  for point in (states[:4], states[4:]):
    for (_, prev_out), (nxt_in, _) in zip(point, point[1:]):
      assert nxt_in is prev_out
  # The second point burns in from the chain the first one stored.
  assert torch.equal(burns[1], states[3][1])


def test_cli_runs(tmp_path):
  out = str(tmp_path / "cli")
  cmd = [sys.executable, "-m", "qhbmlib_tpu_torch.baselines.train",
         "--device=cpu", f"--output_dir={out}", "--seed=3",
         "--config.dataset.num_rows=2", "--config.dataset.num_cols=1",
         "--config.dataset.beta_steps=1", "--config.model.circuit_layers=1",
         "--config.training.init_steps=2", "--config.training.num_samples=20",
         "--config.logging.tensorboard=false",
         "--config.logging.checkpoint=False"]
  env = {**os.environ, "OMP_NUM_THREADS": "1"}
  run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120, check=False)
  assert run.returncode == 0, run.stderr
  results = os.path.join(out, "results")
  assert len(_read_metrics(results, "beta_0p5", "loss")) == 2
  config = json.load(open(os.path.join(results, "config.json")))
  assert config["logging"]["tensorboard"] is False
  assert config["training"]["init_steps"] == 2
  assert not os.path.isdir(os.path.join(results, "checkpoints"))


def test_overrides_cast_to_the_default_type():
  config = tconfig.get_config()
  ttrain.apply_overrides(config, ["--config.training.learning_rate=0.25",
                                  "--config.dataset.num_rows=5",
                                  "--config.logging.checkpoint=0",
                                  "--config.training.method=vanilla"])
  assert config.training.learning_rate == 0.25
  assert config.dataset.num_rows == 5
  assert config.logging.checkpoint is False
  for bad in ("--config.dataset.nope=1", "--config.dataset.num_rows=x",
              "--config.logging.checkpoint=maybe", "--other=1"):
    with pytest.raises((KeyError, ValueError)):
      ttrain.apply_overrides(config, [bad])


@pytest.mark.parametrize("key,value", [("training.method", "adagrad"),
                                       ("training.method", "Natural"),
                                       ("training.loss", "qmhl")])
def test_unknown_method_or_loss_raises(tmp_path, key, value):
  """A method or loss the harness does not have raises ValueError before
  anything is written; every point of the sweep is known."""
  config = _small_config(**{key: value})
  with pytest.raises(ValueError, match=value):
    ttrain.run_experiment(config, str(tmp_path / "x"), device=CPU)
  assert not os.path.exists(tmp_path / "x")
  for point in tconfig.get_sweep():
    known = tconfig.get_config()
    ttrain.apply_overrides(known, [f"--{k}={v}" for k, v in point.items()])
    ttrain.check_config(known)


# ---------------------------------------------------------------------------
# The natural gradient, mirror descent and QVARTZ: the port's own runs (the
# rest of the reference's tests/baselines/test_train.py)
# ---------------------------------------------------------------------------

QVARTZ_SMALL = {"training.loss": "qvartz", "dataset.time_steps": 2,
                "training.num_inner_steps": 2}


@pytest.mark.parametrize("method", ["natural", "mirror"])
def test_vqt_methods_run(tmp_path, method):
  config = _small_config(**{"training.method": method,
                            "training.num_inner_steps": 2})
  results = ttrain.run_experiment(config, str(tmp_path / method), seed=2,
                                  device=CPU)
  losses = _read_metrics(results, "beta_0p5", "loss")
  assert len(losses) == 2
  assert all(np.isfinite(l) for l in losses)
  fid = _read_metrics(results, "beta_0p5", "fidelity")
  assert fid and 0.0 <= fid[-1] <= 1.0 + 1e-6
  model_dir = os.path.join(results, "metrics", "beta_0p5",
                           "train_model_trial_0")
  tags = {r.get("tag") for r in _records(os.path.join(model_dir,
                                                      "metrics.jsonl"))}
  if method == "natural":
    assert {"info_matrix_eigvals/stats", "info_matrix_min_eigval",
            "info_matrix_max_eigval", "info_matrix_cond_number", "reg",
            "natural_grads/stats", "natural_grad_norm"} <= tags
  else:
    inner = _records(os.path.join(model_dir, "train_inner",
                                  "metrics.jsonl"))
    assert {r["tag"] for r in inner} == {
        "inner_loss", "inner_prod", "div", "euclidean_div",
        "inner_loss_grads/stats"}
    # One writer: the global index step * num_inner_steps + inner_step.
    assert sorted({r["step"] for r in inner}) == [0, 1, 2, 3]


def test_qvartz_runs(tmp_path):
  config = _small_config(**QVARTZ_SMALL)
  results = ttrain.run_experiment(config, str(tmp_path / "qvartz"), seed=3,
                                  device=CPU)
  labels = sorted(os.listdir(os.path.join(results, "metrics")))
  assert labels == ["beta_1p0", "time_1p5", "time_3p0"]
  losses = _read_metrics(results, "time_1p5", "loss")
  assert len(losses) == 2 and all(np.isfinite(l) for l in losses)
  # QMHL's target loss is the evolved target's entropy.
  entropy = [r["value"] for r in _records(os.path.join(
      results, "metrics", "time_1p5", "data_point", "metrics.jsonl"))
             if r["tag"] == "target_entropy"]
  assert _read_metrics(results, "time_1p5", "target_loss") == entropy


@pytest.mark.parametrize("loss", ["vqt", "qvartz"])
def test_gwg_natural_runs(tmp_path, loss):
  """GWG with the natural method (and QVARTZ's QMHL): the information
  matrix's EBM block and its <K_copy> rows sample through the threaded
  chain; the QMHL step threads the data's chain too."""
  config = _small_config(**{**QVARTZ_SMALL, "training.loss": loss,
                            "training.method": "natural",
                            "model.ebm": "gwg", "model.gwg_burnin": 20})
  results = ttrain.run_experiment(config, str(tmp_path / "gwgnat"), seed=6,
                                  device=CPU)
  label = "beta_0p5" if loss == "vqt" else "time_1p5"
  losses = _read_metrics(results, label, "loss")
  assert len(losses) == 2 and all(np.isfinite(l) for l in losses)


def test_qvartz_gwg_runs(tmp_path, monkeypatch):
  """QVARTZ with a GWG EBM: the data's chain and the model's are burned in
  once a time step and threaded through the QMHL steps as a pair."""
  config = _small_config(**{**QVARTZ_SMALL, "model.ebm": "gwg",
                            "model.gwg_burnin": 20, "model.gwg_chains": 4})
  cls = tebm.GibbsWithGradientsInference
  burns, last, draws = [], {}, [0]
  orig_burn, orig_scs = cls.burn_in, cls.support_counts_state

  def burn_in(self, chain_state, generator=None):
    burns.append(self)
    last[self] = orig_burn(self, chain_state, generator)
    return last[self]

  def support_counts_state(self, generator=None, state=None):
    # Each draw continues the state its EBM's burn-in or last draw left.
    assert state is last[self]
    out = orig_scs(self, generator, state)
    last[self] = out[2]
    draws[0] += 1
    return out

  def no_rebake(self):
    raise AssertionError("a train step burned in on a parameter change")

  monkeypatch.setattr(cls, "burn_in", burn_in)
  monkeypatch.setattr(cls, "support_counts_state", support_counts_state)
  monkeypatch.setattr(cls, "_maybe_burn_in", no_rebake)
  results = ttrain.run_experiment(config, str(tmp_path / "qvartz_gwg"),
                                  seed=7, device=CPU)
  labels = sorted(os.listdir(os.path.join(results, "metrics")))
  assert sum(l.startswith("time_") for l in labels) == 2
  losses = _read_metrics(results, "time_1p5", "loss")
  assert len(losses) == 2 and all(np.isfinite(l) for l in losses)
  # The beta point burns in the model; each time point the data and the
  # model, two different EBMs.
  assert len(burns) == 1 + 2 * 2
  assert burns[1] is not burns[2]
  # A VQT step draws twice; a QMHL step once for the data, once for log Z.
  assert draws[0] == 2 * 2 + 2 * 2 * 2


def test_qvartz_dataset_only_mode(tmp_path):
  """training.train=False walks every time step with the exact targets'
  metrics and builds no data model."""
  config = _small_config(**{**QVARTZ_SMALL, "training.train": False})
  results = ttrain.run_experiment(config, str(tmp_path / "nodata"), seed=8,
                                  device=CPU)
  labels = sorted(os.listdir(os.path.join(results, "metrics")))
  assert sum(l.startswith("time_") for l in labels) == 2
  for label in labels:
    tags = [r["tag"] for r in _records(os.path.join(
        results, "metrics", label, "data_point", "metrics.jsonl"))]
    assert "target_entropy" in tags
    assert not os.path.isdir(os.path.join(results, "metrics", label,
                                          "train_model_trial_0"))


def test_qvartz_kill_and_resume(tmp_path, monkeypatch):
  """An interrupted QVARTZ sequence resumes: the finished beta point is
  restored (not retrained) and seeds the first time point's data."""
  out = str(tmp_path / "resume")
  config = _small_config(**{**QVARTZ_SMALL, "logging.checkpoint": True})
  calls = {"n": 0}
  orig = ttrain.train_model

  def preempted(*args, **kwargs):
    calls["n"] += 1
    if calls["n"] > 1:
      raise RuntimeError("simulated preemption")
    return orig(*args, **kwargs)

  monkeypatch.setattr(ttrain, "train_model", preempted)
  with pytest.raises(RuntimeError, match="simulated preemption"):
    ttrain.run_experiment(config, out, seed=5, device=CPU)
  monkeypatch.setattr(ttrain, "train_model", orig)
  ckpt_root = os.path.join(out, "results", "checkpoints")
  assert os.listdir(ckpt_root) == ["beta_1p0"]
  saved = os.path.join(ckpt_root, "beta_1p0", "trial_0")
  mtime = os.path.getmtime(saved)
  trained = ttrain.load_params(saved, CPU)

  seeded = []
  orig_evolved = ttrain.evolved_data

  def spy(prev_params, *args, **kwargs):
    seeded.append(prev_params)
    return orig_evolved(prev_params, *args, **kwargs)

  monkeypatch.setattr(ttrain, "evolved_data", spy)
  results = ttrain.run_experiment(config, out, seed=5, device=CPU)
  assert os.path.getmtime(saved) == mtime
  assert len(seeded) == 2
  assert torch.equal(seeded[0]["phi"][0], trained["phi"][0])
  assert len(_read_metrics(results, "beta_1p0", "loss")) == 2
  losses = _read_metrics(results, "time_1p5", "loss")
  assert len(losses) == 2 and all(np.isfinite(l) for l in losses)
  assert sorted(os.listdir(ckpt_root)) == ["beta_1p0", "time_1p5",
                                           "time_3p0"]
  mtimes = {l: os.path.getmtime(os.path.join(ckpt_root, l, "trial_0"))
            for l in os.listdir(ckpt_root)}
  ttrain.run_experiment(config, out, seed=5, device=CPU)
  for l, t in mtimes.items():
    assert os.path.getmtime(os.path.join(ckpt_root, l, "trial_0")) == t


@pytest.mark.slow
def test_natural_vqt_converges_toward_target(tmp_path):
  """The natural gradient trains (the reference's regression for a
  permuted flatten in the solve, which logged plausible metrics)."""
  config = _small_config(**{
      "training.method": "natural", "dataset.beta_steps": 1,
      "dataset.beta_min": 1.0, "dataset.beta_max": 1.0,
      "model.circuit_layers": 2, "training.init_steps": 40,
      "training.learning_rate": 0.05, "logging.expensive_downsample": 39})
  results = ttrain.run_experiment(config, str(tmp_path / "natconv"), seed=4,
                                  device=CPU)
  losses = _read_metrics(results, "beta_1p0", "loss")
  fid = _read_metrics(results, "beta_1p0", "fidelity")
  assert losses[-1] < losses[0]
  assert fid[-1] > 0.85


@pytest.mark.slow
def test_mirror_vqt_converges_toward_target(tmp_path):
  """Mirror descent trains end to end (10 inner steps: 5 plateau near
  fidelity 0.78 at this size in the reference)."""
  config = _small_config(**{
      "training.method": "mirror", "dataset.beta_steps": 1,
      "dataset.beta_min": 1.0, "dataset.beta_max": 1.0,
      "model.circuit_layers": 2, "training.init_steps": 60,
      "training.num_inner_steps": 10, "logging.expensive_downsample": 59})
  results = ttrain.run_experiment(config, str(tmp_path / "mirconv"), seed=5,
                                  device=CPU)
  losses = _read_metrics(results, "beta_1p0", "loss")
  fid = _read_metrics(results, "beta_1p0", "fidelity")
  assert losses[-1] < losses[0]
  assert fid[-1] > 0.8


def _run_ladder(*args):
  cmd = [sys.executable, "-m", "qhbmlib_tpu_torch.benchmarks.run_ladder",
         "--device", "cpu", *args]
  env = {**os.environ, "OMP_NUM_THREADS": "1"}
  run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=180, check=False)
  return run, [json.loads(line) for line in run.stdout.splitlines()
               if line.startswith("{")]


def test_run_ladder_cli(tmp_path):
  """The ladder CLI: one JSON line a rung, r4 (smoke, one process: a
  1 x 1 mesh) among them; a rung that raises (a unique cap of 0) prints
  its error and the process exits 1."""
  for rung, n in (("r1_tfim2_vqt", 2), ("r4_tfim24_sharded_vqt", 8)):
    run, lines = _run_ladder("--smoke", "--rung", rung, "--steps", "1")
    assert run.returncode == 0, run.stderr
    (line,) = lines
    assert line["rung"] == rung and line["n"] == n
    assert line["loss"] == "vqt" and line["steps"] == 1
    assert np.isfinite(line["steps_per_sec"]) and line["steps_per_sec"] > 0
    assert np.isfinite(line["final_loss"]) and line["warmup_s"] >= 0
  assert line["state_shards"] == 1
  run, lines = _run_ladder("--rung", "r4_tfim24_sharded_vqt",
                           "--max-unique", "0")
  assert run.returncode == 1
  assert lines == [{"rung": "r4_tfim24_sharded_vqt", "error": lines[0][
      "error"]}]
  assert "max_unique must be >= 1" in lines[0]["error"]


def test_run_ladder_cli_on_two_ranks(tmp_path):
  """Every rung at its smoke size under `torch.distributed.run` on two
  gloo ranks: rank 0 alone prints a line a rung, r3 splits its states over
  data 2, r4 and r5 shard over state 2 (r5's chains too), and each final
  loss equals the one-process run's (the same draws, the sums in another
  order)."""
  from tests.test_torch_parallel_workers import free_port
  run, one = _run_ladder("--smoke", "--steps", "1")
  assert run.returncode == 0, run.stderr
  cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
         f"--master_port={free_port()}", "-m",
         "qhbmlib_tpu_torch.benchmarks.run_ladder", "--device", "cpu",
         "--backend", "gloo", "--smoke", "--steps", "1"]
  env = {**os.environ, "OMP_NUM_THREADS": "1"}
  run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300, check=False)
  assert run.returncode == 0, run.stderr[-4000:]
  two = [json.loads(line) for line in run.stdout.splitlines()
         if line.startswith("{")]
  assert [x["rung"] for x in two] == list(tladder.RUNGS)
  shards = {"r3_kobe16_vqt_shift": {"data_shards": 2},
            "r4_tfim24_sharded_vqt": {"state_shards": 2},
            "r5_gwg28_qmhl": {"state_shards": 2}}
  for a, b in zip(one, two):
    assert b["ranks"] == 2 and "error" not in b, b
    assert {k: b[k] for k in shards.get(b["rung"], {})} == shards.get(
        b["rung"], {})
    np.testing.assert_allclose(b["final_loss"], a["final_loss"], rtol=1e-5)


def test_sweep_launcher_dry(tmp_path, capsys):
  sweep = tconfig.get_sweep()
  assert len(sweep) == 2 * 3 * 2 * 2
  config_path = "qhbmlib_tpu_torch/baselines/config.py"
  jobs = tlaunch.build_jobs(config_path, str(tmp_path), sweep[:3], seed=1)
  assert len(jobs) == 3
  for job_dir, cmd in jobs:
    assert cmd[1:3] == ["-m", "qhbmlib_tpu_torch.baselines.train"]
    assert f"--config={config_path}" in cmd
    assert any(a.startswith("--config.training.loss=") for a in cmd)
  tlaunch.main(["--config", ttrain.DEFAULT_CONFIG, "--output_dir",
                str(tmp_path / "sweep"), "--dry_run", "--device", "cpu",
                "--sweep_filter", "training.method=vanilla",
                "--sweep_filter", "training.loss=vqt"])
  assert "4 sweep points" in capsys.readouterr().out
  manifest = json.load(open(tmp_path / "sweep" / "sweep_manifest.json"))
  assert len(manifest) == 4
  assert all("--device=cpu" in job["cmd"] for job in manifest)
  assert all("--config.training.method=vanilla" in job["cmd"]
             for job in manifest)
