"""The port's natural gradient, mirror descent and QVARTZ
(`qhbmlib_tpu_torch/baselines/train.py`) against the JAX harness's
(`baselines/train.py`), on the CPU at 2-3 qubits.

  * `natural_solve` on seeded PSD matrices, both lstsq modes, the
    eigenvalue regularizer on and off, and a rank-deficient matrix with no
    regularizer (the minimum-norm solution), within 1e-4 relative; the
    [theta; phi] block order (`test_natural_solve_block_order`).
  * The BKM information matrix at 3q, both QHBMs' EBMs exact and JAX's
    parameters carried, the EBM block's samples pinned to one array on
    both sides (the instances' `sample_with_state`): within 1e-4.
  * `train_model` step for step: 3 natural steps (the samples pinned as
    above), 2 mirror outer steps of 3 inner steps, and 3 QMHL steps on a
    carried evolved QHBM (the QVARTZ data: the previous model followed by
    the Trotter channel); losses and final parameters within 1e-4
    (`LOSS_ATOL`, `PARAM_ATOL`, as `test_torch_harness.py`).
  * The Trotter step's matrix against JAX's `_circuit_matrix` within 1e-6,
    and the channel-evolved targets (`compute_data_point_metrics`) within
    1e-10.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch

from baselines import config as jconfig
from baselines import train as jtrain
from qhbmlib_tpu import data as jdata
from qhbmlib_tpu import models as jmodels
from qhbmlib_tpu.inference import qhbm as jqhbm
from qhbmlib_tpu.inference import qnn as jqnn
from qhbmlib_tpu_torch import convert
from qhbmlib_tpu_torch.baselines import config as tconfig
from qhbmlib_tpu_torch.baselines import train as ttrain

torch.set_num_threads(1)

CPU = "cpu"  # the port builds on the CUDA card unless told otherwise
LOSS_ATOL = 1e-4  # as tests/test_torch_harness.py
PARAM_ATOL = 1e-4
INFO_ATOL = 1e-4
SOLVE_RTOL = 1e-4
UNITARY_ATOL = 1e-6
TARGET_ATOL = 1e-10


def _configs(**overrides):
  """(JAX config, port config) with the same dotted overrides."""
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


STEP_OVERRIDES = {"dataset.num_rows": 3, "dataset.num_cols": 1,
                  "model.circuit_layers": 2, "logging.tensorboard": False,
                  "logging.expensive_downsample": 2,
                  "training.num_samples": 40}


def _pair(seed=3, **overrides):
  """(jc, tc, jshards, tshards, (jmh, jh), (tmh, th)): both QHBMs at 3q
  with exact EBMs, the port's carrying the JAX parameters."""
  jc, tc = _configs(**STEP_OVERRIDES, **overrides)
  jshards = jtrain.get_tfim_hamiltonian(1.0, jc)
  tshards = ttrain.get_tfim_hamiltonian(1.0, tc, device=CPU)
  jmh, jh = jtrain.get_initial_qhbm(jshards, jc, "qhbm", seed=seed)
  tmh, th = ttrain.get_initial_qhbm(tshards, tc, "qhbm", seed=seed + 5,
                                    device=CPU)
  jh.e_inference.exact = th.e_inference.exact = True
  th.set_params(convert.from_jax_params(
      jax.tree_util.tree_map(np.asarray, jh.params), device=CPU))
  return jc, tc, jshards, tshards, (jmh, jh), (tmh, th)


def _jtarget(jshards):
  return jtrain.paulis.PauliSum(
      jshards[0].codes + jshards[1].codes,
      jtrain.paulis.concat_coeffs([jshards[0].coeffs, jshards[1].coeffs]),
      jshards[0].num_qubits)


def _pin_samples(jh, th, num_samples, seed=11):
  """Both EBMs' `sample_with_state` return one seeded array (the
  information matrix's EBM block)."""
  n = th.e_inference.energy.num_bits
  samples = np.random.RandomState(seed).randint(
      0, 2, (num_samples, n)).astype(np.int8)
  jh.e_inference.sample_with_state = (
      lambda theta, key, state, num: (jnp.asarray(samples[:num]), state))
  th.e_inference.sample_with_state = (
      lambda state, num, generator=None: (torch.tensor(samples[:num]),
                                          state))


def _records(path):
  with open(path) as f:
    return [json.loads(line) for line in f]


def _values(recs, tag):
  return [r["value"] for r in recs if r.get("tag") == tag]


# ---------------------------------------------------------------------------
# natural_solve
# ---------------------------------------------------------------------------

def _training_config(fast, eigval_reg, reg=1.0):
  j = ml_collections.ConfigDict()
  j.info_matrix_eigval_reg = eigval_reg
  j.info_matrix_reg = reg
  j.lstsq_fast = fast
  j.lstsq_l2_regularizer = 1e-2
  t = tconfig.ConfigDict(j.to_dict())
  return j, t


def _grads(rng, pt, pp):
  return {"theta": [rng.normal(size=(pt,)).astype(np.float32)],
          "phi": [rng.normal(size=(pp,)).astype(np.float32)]}


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("eigval_reg,reg,offset", [
    (True, 1.0, -0.3), (False, 0.5, -0.3), (True, 0.1, -0.3),
    (True, 0.1, 0.5)])
def test_natural_solve_matches_jax(fast, eigval_reg, reg, offset):
  """A Gram matrix moved by `offset` (-0.3: its least eigenvalue negative,
  so the eigenvalue regularizer adds reg + its size; 0.5: all above 0.1,
  so it adds nothing), regularized to a condition number of at most ~50,
  where float32 solves agree to 1e-4."""
  rng = np.random.RandomState(5)
  pt, pp = 4, 9
  a = rng.normal(size=(pt + pp, pt + pp))
  im = (a @ a.T / (pt + pp) + offset * np.eye(pt + pp)).astype(np.float32)
  grads = _grads(rng, pt, pp)
  jc, tc = _training_config(fast, eigval_reg, reg)
  jnat, (jreg_im, jreg, jflat) = jtrain.natural_solve(
      jnp.asarray(im), jax.tree_util.tree_map(jnp.asarray, grads), jc)
  tnat, (treg_im, treg, tflat) = ttrain.natural_solve(
      torch.tensor(im), {k: [torch.tensor(g) for g in v]
                         for k, v in grads.items()}, tc)
  np.testing.assert_allclose(float(treg), float(jreg), rtol=SOLVE_RTOL)
  np.testing.assert_allclose(treg_im.numpy(), np.asarray(jreg_im),
                             atol=1e-6)
  scale = np.abs(np.asarray(jflat)).max()
  np.testing.assert_allclose(tflat.numpy(), np.asarray(jflat),
                             atol=SOLVE_RTOL * scale)
  for key in ("theta", "phi"):
    assert tnat[key][0].shape == tuple(np.shape(jnat[key][0]))
    np.testing.assert_allclose(tnat[key][0].numpy(),
                               np.asarray(jnat[key][0]),
                               atol=SOLVE_RTOL * scale)


def test_natural_solve_rank_deficient_is_minimum_norm():
  """A rank-3 matrix with no regularizer: the SVD solve's minimum-norm
  solution, as JAX's lstsq; the normal equations' l2 regularizer is
  ignored in this mode."""
  rng = np.random.RandomState(8)
  b = rng.normal(size=(7, 3))
  im = (b @ b.T).astype(np.float32)
  grads = _grads(rng, 2, 5)
  jc, tc = _training_config(False, False, reg=0.0)
  _, (_, _, jflat) = jtrain.natural_solve(
      jnp.asarray(im), jax.tree_util.tree_map(jnp.asarray, grads), jc)
  _, (_, _, tflat) = ttrain.natural_solve(
      torch.tensor(im), {k: [torch.tensor(g) for g in v]
                         for k, v in grads.items()}, tc)
  flat = np.concatenate([grads["theta"][0], grads["phi"][0]])
  # float64, cut at the solve's own rcond (float32 rounding leaves the
  # null space's singular values at ~1e-7, not 0).
  want = np.linalg.pinv(im.astype(np.float64),
                        rcond=np.finfo(np.float32).eps * 7) @ flat
  np.testing.assert_allclose(tflat.numpy(), np.asarray(jflat),
                             atol=SOLVE_RTOL * np.abs(want).max())
  np.testing.assert_allclose(tflat.numpy(), want,
                             atol=SOLVE_RTOL * np.abs(want).max())
  # In the row space of im: no component along its null space.
  null = np.linalg.svd(im.astype(np.float64))[2][3:]
  assert np.abs(null @ tflat.numpy()).max() < 1e-4 * np.abs(want).max()


def test_natural_solve_block_order():
  """The flatten order is [theta; phi], the information matrix's block
  order (the reference's regression: a sorted-key flatten pairs circuit
  gradients with EBM rows, silently)."""
  _, tc = _training_config(False, False, reg=0.0)
  im = torch.diag(torch.tensor([2.0, 2.0, 10.0, 10.0, 10.0]))
  grads = {"theta": [torch.tensor([2.0, 4.0])],
           "phi": [torch.tensor([10.0, 20.0, 30.0])]}
  nat, _ = ttrain.natural_solve(im, grads, tc)
  np.testing.assert_allclose(nat["theta"][0].numpy(), [1.0, 2.0], rtol=1e-5)
  np.testing.assert_allclose(nat["phi"][0].numpy(), [1.0, 2.0, 3.0],
                             rtol=1e-5)


# ---------------------------------------------------------------------------
# The information matrix and the steps against the JAX trainer
# ---------------------------------------------------------------------------

def test_information_matrix_matches_jax():
  jc, tc, jshards, tshards, (_, jh), (_, th) = _pair()
  n_samples = tc.training.num_samples
  _pin_samples(jh, th, n_samples)
  jcopy, _ = jtrain.get_initial_qhbm(jshards, jc, "qhbm_copy")
  tcopy, _ = ttrain.get_initial_qhbm(tshards, tc, "qhbm_copy", device=CPU)
  want = np.asarray(jtrain.make_information_matrix(jh, jcopy, n_samples)(
      jh.params, jax.random.PRNGKey(0)))
  got = ttrain.make_information_matrix(th, tcopy, n_samples)(
      torch.Generator().manual_seed(0)).numpy()
  pt = sum(p.numel() for p in th.params["theta"])
  pp = sum(p.numel() for p in th.params["phi"])
  assert got.shape == want.shape == (pt + pp, pt + pp)
  np.testing.assert_array_equal(got, got.T)
  np.testing.assert_allclose(got, want, atol=INFO_ATOL)
  # The EBM and QNN blocks are live.  The cross block vanishes at copy =
  # model whatever the draw (d/dphi <x|V^dagger Z V|x> = 0 at V = 1 for a
  # basis state x and a Z string), on both sides to float32 rounding.
  assert np.abs(want[:pt, :pt]).max() > 1e-2
  assert np.abs(want[pt:, pt:]).max() > 1e-2
  assert np.abs(got[pt:, :pt]).max() < 1e-5
  # The copy was set to the model's parameters; the model's are untouched.
  for a, b in zip(tcopy.parameters(), th.parameters()):
    assert torch.equal(a, b)
  np.testing.assert_array_equal(th.params["phi"][0].detach().numpy(),
                                np.asarray(jh.params["phi"][0]))


def _train_both(tmp_path, jc, tc, jshards, tshards, jpair, tpair, steps,
                target_dm, jkw, tkw):
  """`train_model` on both sides with Adam at the harness's rate for the
  method (`inner_learning_rate` for mirror descent)."""
  (jmh, jh), (tmh, th) = jpair, tpair
  lr = (tc.training.inner_learning_rate if tc.training.method == "mirror"
        else tc.training.learning_rate)
  jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
  jwriter = jtrain.MetricsWriter(jdir, tensorboard=False)
  jparams = jtrain.train_model(
      jh, jmh, jtrain.get_optimizer("Adam", lr), steps, jshards,
      target_dm, jdir, jwriter, jc, jax.random.PRNGKey(0), **jkw)
  jwriter.close()
  twriter = ttrain.MetricsWriter(tdir, tensorboard=False)
  tparams = ttrain.train_model(
      th, tmh, ttrain.get_optimizer("Adam", lr, th.parameters()), steps,
      tshards, target_dm, tdir, twriter, tc,
      torch.Generator().manual_seed(0), **tkw)
  twriter.close()
  return jdir, tdir, jparams, tparams


def _assert_same_run(jdir, tdir, jparams, tparams, steps):
  jrec = _records(os.path.join(jdir, "metrics.jsonl"))
  trec = _records(os.path.join(tdir, "metrics.jsonl"))
  assert [r["tag"] for r in trec] == [r["tag"] for r in jrec]
  assert len(_values(trec, "loss")) == steps
  for tag in ("loss", "fidelity", "relative_entropy"):
    np.testing.assert_allclose(_values(trec, tag), _values(jrec, tag),
                               atol=LOSS_ATOL, err_msg=tag)
  for key in ("theta", "phi"):
    np.testing.assert_allclose(tparams[key][0].numpy(),
                               np.asarray(jparams[key][0]), atol=PARAM_ATOL)
  return jrec, trec


def test_natural_steps_match_jax(tmp_path):
  steps, beta = 3, 0.8
  jc, tc, jshards, tshards, jpair, tpair = _pair(
      **{"training.method": "natural"})
  _pin_samples(jpair[1], tpair[1], tc.training.num_samples)
  ttarget = tshards[0] + tshards[1]
  target_dm = ttrain.compute_data_point_metrics(
      beta=beta, target_hamiltonian_matrix=ttarget.dense())[0]
  jdir, tdir, jparams, tparams = _train_both(
      tmp_path, jc, tc, jshards, tshards, jpair, tpair, steps, target_dm,
      {"target_hamiltonian": _jtarget(jshards), "beta": beta},
      {"target_hamiltonian": ttarget, "beta": beta})
  jrec, trec = _assert_same_run(jdir, tdir, jparams, tparams, steps)
  for tag in ("reg", "natural_grad_norm", "info_matrix_max_eigval"):
    got, want = _values(trec, tag), _values(jrec, tag)
    assert len(got) == steps
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=tag)
  losses = _values(trec, "loss")
  assert losses[-1] < losses[0]


def test_mirror_steps_match_jax(tmp_path):
  steps, beta = 2, 0.8
  jc, tc, jshards, tshards, jpair, tpair = _pair(
      **{"training.method": "mirror", "training.num_inner_steps": 3,
         "training.inner_learning_rate": 0.02})
  ttarget = tshards[0] + tshards[1]
  target_dm = ttrain.compute_data_point_metrics(
      beta=beta, target_hamiltonian_matrix=ttarget.dense())[0]
  jdir, tdir, jparams, tparams = _train_both(
      tmp_path, jc, tc, jshards, tshards, jpair, tpair, steps, target_dm,
      {"target_hamiltonian": _jtarget(jshards), "beta": beta},
      {"target_hamiltonian": ttarget, "beta": beta})
  _assert_same_run(jdir, tdir, jparams, tparams, steps)
  jin = _records(os.path.join(jdir, "train_inner", "metrics.jsonl"))
  tin = _records(os.path.join(tdir, "train_inner", "metrics.jsonl"))
  assert [(r["tag"], r["step"]) for r in tin] == [(r["tag"], r["step"])
                                                  for r in jin]
  assert sorted({r["step"] for r in tin}) == list(range(steps * 3))
  for tag in ("inner_loss", "inner_prod", "div", "euclidean_div"):
    np.testing.assert_allclose(_values(tin, tag), _values(jin, tag),
                               atol=LOSS_ATOL, err_msg=tag)
  # Inner step 0 of each outer step starts at the anchor: its divergence
  # is -log Z of the anchor's EBM, its euclidean part 0.
  divs, euclids = _values(tin, "div"), _values(tin, "euclidean_div")
  assert euclids[0] == euclids[3] == 0.0
  assert divs[0] < 0.0 and divs[3] < 0.0


def _evolved_pair(jc, tc, jshards, tshards, prev_seed=7):
  """The QVARTZ data of one time step on both sides: a previous model
  (JAX's parameters carried) followed by the Trotter channel, its EBM
  exact."""
  _, jprev = jtrain.get_initial_qhbm(jshards, jc, "prev_qhbm", seed=prev_seed)
  prev = jax.tree_util.tree_map(np.asarray, jprev.params)
  junitary = jtrain.get_tfim_unitary(*jshards, jc)
  channel = jmodels.QuantumCircuit(junitary, (), [], [], name="channel")
  jevolved = jqhbm.QHBM(jprev.e_inference, jqnn.AnalyticQuantumInference(
      jprev.q_inference.circuit + channel))
  jprev.e_inference.exact = True
  tdata = ttrain.evolved_data(convert.from_jax_params(prev, device=CPU),
                              ttrain.get_tfim_unitary(*tshards, tc), tshards,
                              tc, device=CPU)
  tdata.qhbm.e_inference.exact = True
  return jdata.QHBMData(jevolved), tdata, junitary


def test_qvartz_qmhl_steps_match_jax(tmp_path):
  steps = 3
  jc, tc, jshards, tshards, jpair, tpair = _pair(
      **{"training.loss": "qvartz"})
  jdata_, tdata_, _ = _evolved_pair(jc, tc, jshards, tshards)
  # The data's parameters are the previous model's, not trained here.
  data_before = [p.detach().clone() for p in tdata_.qhbm.parameters()]
  ttarget = tshards[0] + tshards[1]
  target_dm = ttrain.compute_data_point_metrics(
      beta=1.0, target_hamiltonian_matrix=ttarget.dense())[0]
  jdir, tdir, jparams, tparams = _train_both(
      tmp_path, jc, tc, jshards, tshards, jpair, tpair, steps, target_dm,
      {"evolved_qhbm_data": jdata_}, {"evolved_qhbm_data": tdata_})
  _assert_same_run(jdir, tdir, jparams, tparams, steps)
  for a, b in zip(tdata_.qhbm.parameters(), data_before):
    assert torch.equal(a, b) and a.grad is None


def test_tfim_unitary_and_evolved_targets_match_jax():
  jc, tc = _configs(**{"dataset.num_rows": 3, "dataset.num_cols": 1,
                       "dataset.trotter_steps": 2})
  jx, jz = jtrain.get_tfim_hamiltonian(0.8, jc)
  tx, tz = ttrain.get_tfim_hamiltonian(0.8, tc, device=CPU)
  jcircuit = jtrain.get_tfim_unitary(jx, jz, jc)
  tcircuit = ttrain.get_tfim_unitary(tx, tz, tc)
  assert tcircuit.num_symbols == 0
  assert [(g.kind, g.qubits, g.slot) for g in tcircuit.gates] == [
      (g.kind, g.qubits, g.slot) for g in jcircuit.gates]
  want = jtrain._circuit_matrix(jcircuit)
  got = ttrain.circuit_matrix(tcircuit, CPU)
  np.testing.assert_allclose(got, want, atol=UNITARY_ATOL)
  # exp(-i H dt) to second order in dt, Trotterized.
  np.testing.assert_allclose(got @ got.conj().T, np.eye(8), atol=1e-6)
  h = np.asarray((tx + tz).dense(), np.complex128)
  rho = ttrain.compute_data_point_metrics(
      beta=1.0, target_hamiltonian_matrix=h)[0]
  for _ in range(3):
    got_t = ttrain.compute_data_point_metrics(
        prev_target_density_matrix=rho, channel_matrix=got)
    want_t = jtrain.compute_data_point_metrics(
        prev_target_density_matrix=rho, channel_matrix=got)
    np.testing.assert_allclose(got_t[0], want_t[0], atol=TARGET_ATOL)
    assert abs(got_t[1] - want_t[1]) < TARGET_ATOL
    rho = got_t[0]
