"""The JAX ladder's r5 rung in the port (`benchmarks/ladder.py`,
`r5_gwg28_qmhl`) at its smoke size, 8 qubits, on the CPU.

The rung's structure (KOBE-2 model sampled by 8 GWG chains, 32 samples, 4
unique, 4 burn-in steps; the data a fixed Bernoulli QHBM with 32 samples,
4 unique; 1-layer ansatzes) and its QMHL loss and model gradient against
the JAX package's `make_qmhl` on the same structure with the port's
weights, at the same fixed supports and counts: the data's, the model's
chain support, and the uniform samples of the model's Monte Carlo log Z.
Tolerances as `tests/test_torch_qmhl.py`: loss atol 1e-4, gradients atol
2e-4.  Then two train steps thread the chain state with no burn-in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qhbmlib_tpu import data as jdata
from qhbmlib_tpu import models as jmodels
from qhbmlib_tpu.inference import ebm as jebm
from qhbmlib_tpu.inference import qhbm as jqhbm
from qhbmlib_tpu.inference import qmhl_loss as jqmhl
from qhbmlib_tpu.inference import qnn as jqnn
from qhbmlib_tpu_torch.benchmarks import ladder as tladder
from qhbmlib_tpu_torch.inference import ebm as tebm
from qhbmlib_tpu_torch.inference import qmhl_loss as tqmhl

torch.set_num_threads(1)

N = 8
CPU = "cpu"
LOSS_ATOL = 1e-4
GRAD_ATOL = 2e-4


def _fixed(n, rows, seed):
  rng = np.random.RandomState(seed)
  support = rng.randint(0, 2, (rows, n)).astype(np.float32)
  counts = rng.randint(1, 12, rows).astype(np.float32)
  return support, counts


def _np(params):
  return {k: [p.detach().numpy() for p in v] for k, v in params.items()}


def test_r5_smoke_structure():
  h, data, step = tladder.build_rung("r5_gwg28_qmhl", smoke=True, device=CPU)
  e_inf = h.e_inference
  assert isinstance(e_inf, tebm.GibbsWithGradientsInference)
  assert (e_inf.num_chains, e_inf.num_burnin_samples,
          e_inf.num_expectation_samples, e_inf.max_unique_samples) == (
              8, 4, 32, 4)
  assert e_inf.energy.num_terms == N + N * (N - 1) // 2
  assert h.q_inference.circuit.pqc.num_qubits == N
  d_inf = data.qhbm.e_inference
  assert (d_inf.num_expectation_samples, d_inf.max_unique_samples) == (32, 4)
  assert torch.equal(step.ebm_state["model"], e_inf.chain_state)
  h2, data2, _ = tladder.build_rung("r5_gwg28_qmhl", qubits=5, max_unique=2,
                                    device=CPU)
  assert h2.e_inference.max_unique_samples == 2
  assert data2.qhbm.e_inference.max_unique_samples == 2
  assert h2.e_inference.num_burnin_samples == 32
  with pytest.raises(ValueError, match="max_unique"):
    tladder.build_rung("r5_gwg28_qmhl", max_unique=0, device=CPU)


def test_r5_smoke_loss_and_gradient_match_jax():
  h, data, _ = tladder.build_rung("r5_gwg28_qmhl", smoke=True, device=CPU)
  d_support, d_counts = _fixed(N, 4, seed=1)
  m_support, m_counts = _fixed(N, 4, seed=2)
  uniform = np.random.RandomState(3).randint(0, 2, (32, N)).astype(np.int8)

  # The JAX rung on one device (benchmarks/ladder.py:214-233), the port's
  # weights, every draw pinned.
  j_model = jqhbm.QHBM(
      jebm.GibbsWithGradientsInference(
          jmodels.KOBE(list(range(N)), 2), 32, num_burnin_samples=4,
          num_chains=8, max_unique_samples=4, initial_seed=5),
      jqnn.AnalyticQuantumInference(jmodels.DirectQuantumCircuit(
          jmodels.hardware_efficient_ansatz(N, 1))))
  j_data_qhbm = jqhbm.QHBM(
      jebm.BernoulliEnergyInference(jmodels.BernoulliEnergy(list(range(N))),
                                    32, initial_seed=6, max_unique_samples=4),
      jqnn.AnalyticQuantumInference(jmodels.DirectQuantumCircuit(
          jmodels.hardware_efficient_ansatz(N, 1, name="data_p"))))
  j_model.set_params(_np(h.params))
  j_data_qhbm.set_params(_np(data.qhbm.params))
  j_e, j_d = j_model.e_inference, j_data_qhbm.e_inference
  j_d.support_and_counts = lambda theta, key: (jnp.asarray(d_support),
                                               jnp.asarray(d_counts))
  j_e.support_counts_state = lambda theta, key, state: (
      jnp.asarray(m_support), jnp.asarray(m_counts), state)

  def j_forward(theta, key):
    energies = j_e.energy_apply(theta, jnp.asarray(uniform))
    return (N * jnp.log(2.0) - jnp.log(32.0) +
            jax.scipy.special.logsumexp(-energies))

  j_e._log_partition_forward = j_forward
  loss_fn = jqmhl.make_qmhl(jdata.QHBMData(j_data_qhbm), j_model)
  (loss_j, _), grads_j = jax.value_and_grad(
      lambda p: loss_fn({"model": p, "data": j_data_qhbm.params},
                        jax.random.PRNGKey(0), (None, j_e.chain_state)),
      has_aux=True)(j_model.params)

  t_e, t_d = h.e_inference, data.qhbm.e_inference
  t_d.support_and_counts = lambda generator=None: (
      torch.tensor(d_support), torch.tensor(d_counts))
  t_e.support_counts_state = lambda generator=None, state=None: (
      torch.tensor(m_support), torch.tensor(m_counts), state)

  def t_forward(generator=None):
    with torch.no_grad():
      energies = t_e.energy(torch.tensor(uniform))
    return N * np.log(2.0) - np.log(32.0) + torch.logsumexp(-energies, 0)

  t_e.log_partition_forward = t_forward
  loss, (_, state) = tqmhl.make_qmhl_with_state(data, h)(
      state=(None, t_e.chain_state))
  loss.backward()
  assert torch.equal(state, t_e.chain_state)
  np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                             atol=LOSS_ATOL)
  for key in ("theta", "phi"):
    np.testing.assert_allclose(h.params[key][0].grad.numpy(),
                               np.asarray(grads_j[key][0]), atol=GRAD_ATOL)
    assert np.abs(np.asarray(grads_j[key][0])).max() > 1e-3


def test_r5_train_steps_thread_the_chain_without_burn_in():
  """The rung's step continues the chain it holds (as the reference's
  jitted step threads `ebm_state`) and never burns in, though every step
  changes the model's parameters."""
  h, _, step = tladder.build_rung("r5_gwg28_qmhl", smoke=True, device=CPU)
  e_inf = h.e_inference
  e_inf.burn_in = lambda *a, **k: pytest.fail("a train step burned in")
  stored = e_inf.chain_state.clone()
  states = [step.ebm_state["model"]]
  for _ in range(2):
    loss, grads = step()
    assert np.isfinite(float(loss)) and torch.isfinite(grads).all()
    states.append(step.ebm_state["model"])
  assert not torch.equal(states[0], states[2])
  assert torch.equal(e_inf.chain_state, stored)
