"""The port's VQT train step against the JAX package's, on the CPU.

n = 9, 2 layers, TFIM target, beta = 1.2, `BernoulliEnergyInference` with
`exact=True` on both sides (the full 2^9 support with expected counts, so
no random draw enters).  The JAX model's weights are carried into the port
with `convert.from_jax_params`; both then compute the same loss and
gradients, and 3 Adam steps (optax.adam(1e-2) vs torch.optim.Adam(lr=1e-2))
land on the same parameters.  Tolerance: 1e-5 on the O(10) loss scale
(atol 1e-4), 2e-4 on gradients (sums of 2^n float32 products, as the
reference's own sweep tests), 1e-5 on the parameters after Adam.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qhbmlib_tpu import models as jmodels
from qhbmlib_tpu import nn as jnn
from qhbmlib_tpu.inference import ebm as jebm
from qhbmlib_tpu.inference import qhbm as jqhbm
from qhbmlib_tpu.inference import qnn as jqnn
from qhbmlib_tpu.inference import vqt_loss as jvqt
from qhbmlib_tpu.ops import paulis as jp
from qhbmlib_tpu_torch import convert
from qhbmlib_tpu_torch import models as tmodels
from qhbmlib_tpu_torch import nn as tnn
from qhbmlib_tpu_torch.inference import ebm as tebm
from qhbmlib_tpu_torch.inference import estimators as testimators
from qhbmlib_tpu_torch.inference import qhbm as tqhbm
from qhbmlib_tpu_torch.inference import qnn as tqnn
from qhbmlib_tpu_torch.inference import vqt_loss as tvqt
from qhbmlib_tpu_torch.ops import paulis as tp

torch.set_num_threads(1)

N, LAYERS, BETA, SAMPLES, STEPS, LR = 9, 2, 1.2, 500, 3, 1e-2
LOSS_ATOL = 1e-4
GRAD_ATOL = 2e-4
PARAM_ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_run():
  """The JAX side once: initial params, loss and grads, and the params after
  STEPS Adam steps."""
  energy = jmodels.BernoulliEnergy(list(range(N)),
                                   initializer=jnn.RandomUniform(-0.5, 0.5,
                                                                 seed=3))
  e_inf = jebm.BernoulliEnergyInference(energy, SAMPLES, initial_seed=11,
                                        exact=True)
  circuit = jmodels.DirectQuantumCircuit(
      jmodels.hardware_efficient_ansatz(N, LAYERS),
      initializer=jnn.RandomUniform(0, 2, seed=4))
  h = jqhbm.QHBM(e_inf, jqnn.AnalyticQuantumInference(circuit))
  loss_fn = jvqt.make_vqt(h, jp.tfim_1d(N))
  key = jax.random.PRNGKey(0)
  opt = optax.adam(LR)

  @jax.jit
  def step(params, opt_state):
    loss, grads = jax.value_and_grad(
        lambda p: loss_fn(p, key, np.float32(BETA))[0])(params)
    updates, opt_state = opt.update(grads, opt_state)
    return loss, grads, optax.apply_updates(params, updates), opt_state

  params0 = h.params
  params, opt_state = params0, opt.init(params0)
  losses, grads0 = [], None
  for i in range(STEPS):
    loss, grads, params, opt_state = step(params, opt_state)
    losses.append(float(loss))
    if i == 0:
      grads0 = jax.tree_util.tree_map(np.asarray, grads)
  return {"params0": jax.tree_util.tree_map(np.asarray, params0),
          "grads0": grads0, "losses": losses,
          "params": jax.tree_util.tree_map(np.asarray, params)}


def _port_model(params0, exact=True):
  energy = tmodels.BernoulliEnergy(list(range(N)))
  circuit = tmodels.DirectQuantumCircuit(
      tmodels.hardware_efficient_ansatz(N, LAYERS))
  h = tqhbm.QHBM(tebm.BernoulliEnergyInference(energy, SAMPLES,
                                               initial_seed=0, exact=exact),
                 tqnn.AnalyticQuantumInference(circuit))
  h.set_params(convert.from_jax_params(params0))
  return h, tvqt.make_vqt(h, tp.tfim_1d(N))


def test_vqt_loss_and_gradients_match_jax(jax_run):
  h, loss_fn = _port_model(jax_run["params0"])
  loss = loss_fn(BETA)
  loss.backward()
  np.testing.assert_allclose(float(loss.detach()), jax_run["losses"][0],
                             atol=LOSS_ATOL)
  theta, phi = h.params["theta"][0], h.params["phi"][0]
  np.testing.assert_allclose(theta.grad.numpy(),
                             jax_run["grads0"]["theta"][0], atol=GRAD_ATOL)
  np.testing.assert_allclose(phi.grad.numpy(), jax_run["grads0"]["phi"][0],
                             atol=GRAD_ATOL)
  assert np.abs(jax_run["grads0"]["phi"][0]).max() > 1e-2


def test_adam_steps_match_optax(jax_run):
  h, loss_fn = _port_model(jax_run["params0"])
  opt = torch.optim.Adam(h.parameters(), lr=LR)
  losses = []
  for _ in range(STEPS):
    opt.zero_grad()
    loss = loss_fn(BETA)
    loss.backward()
    opt.step()
    losses.append(float(loss.detach()))
  np.testing.assert_allclose(losses, jax_run["losses"], atol=LOSS_ATOL)
  np.testing.assert_allclose(h.params["theta"][0].detach().numpy(),
                             jax_run["params"]["theta"][0], atol=PARAM_ATOL)
  np.testing.assert_allclose(h.params["phi"][0].detach().numpy(),
                             jax_run["params"]["phi"][0], atol=PARAM_ATOL)


def test_from_jax_params_and_set_params(jax_run):
  converted = convert.from_jax_params(jax_run["params0"])
  assert set(converted) == {"theta", "phi"}
  assert converted["theta"].dtype == torch.float32
  h, _ = _port_model(jax_run["params0"])
  np.testing.assert_array_equal(h.params["phi"][0].detach().numpy(),
                                jax_run["params0"]["phi"][0])
  with pytest.raises(ValueError, match="exactly one"):
    convert.from_jax_params({"theta": [np.zeros(2), np.zeros(2)],
                             "phi": [np.zeros(3)]})


def test_log_partition_and_entropy_match_jax():
  kernel = np.random.RandomState(2).uniform(-1, 1, 6).astype(np.float32)
  j_energy = jmodels.BernoulliEnergy(list(range(6)))
  j_energy.set_trainable_variables([jnp.asarray(kernel)])
  j_inf = jebm.BernoulliEnergyInference(j_energy, 100, initial_seed=1)
  t_energy = tmodels.BernoulliEnergy(
      list(range(6)), initializer=tnn.Constant(0.0))
  with torch.no_grad():
    t_energy.kernel.copy_(torch.tensor(kernel))
  t_inf = tebm.BernoulliEnergyInference(t_energy, 100, initial_seed=1)
  np.testing.assert_allclose(
      float(t_inf.log_partition_forward().detach()),
      float(j_inf._log_partition_forward(j_inf.theta, None)), atol=1e-5)
  np.testing.assert_allclose(float(t_inf.entropy().detach()),
                             float(j_inf.entropy()), atol=1e-5)


def test_log_partition_gradient_is_minus_mean_energy_gradient():
  """eq. C2: d log Z / d theta = -<dE/dtheta>_p.  For E = sum theta_i s_i
  with the exact support, <s_i> = -tanh(theta_i), so the gradient is
  tanh(theta), the derivative of log Z = sum log(2 cosh theta_i)."""
  energy = tmodels.BernoulliEnergy(list(range(5)),
                                   initializer=tnn.RandomUniform(-1, 1,
                                                                 seed=7))
  e_inf = tebm.BernoulliEnergyInference(energy, 100, exact=True,
                                        initial_seed=0)
  e_inf.log_partition().backward()
  expected = np.tanh(energy.kernel.detach().numpy())
  np.testing.assert_allclose(energy.kernel.grad.numpy(), expected, atol=1e-5)


def test_sampled_expectation_score_gradient_matches_jax():
  """The eq. A5 estimator's gradient on a fixed (support, counts) against
  the reference's `sampled_expectation` custom VJP."""
  from qhbmlib_tpu.inference import estimators as jestimators
  rng = np.random.RandomState(4)
  kernel = rng.uniform(-1, 1, 4).astype(np.float32)
  support = rng.randint(0, 2, (7, 4)).astype(np.float32)
  counts = rng.randint(1, 9, 7).astype(np.float32)
  f_w = rng.normal(size=4).astype(np.float32)

  j_energy = jmodels.BernoulliEnergy(list(range(4)))

  def j_loss(theta, w):
    return jestimators.sampled_expectation(
        j_energy.apply_flat, lambda fw, bits: jnp.sin(
            bits.astype(jnp.float32) @ fw), theta, w, jnp.asarray(support),
        jnp.asarray(counts))

  val_j, (g_theta_j, g_w_j) = jax.value_and_grad(j_loss, argnums=(0, 1))(
      [jnp.asarray(kernel)], jnp.asarray(f_w))
  t_energy = tmodels.BernoulliEnergy(list(range(4)),
                                     initializer=tnn.Constant(0.0))
  with torch.no_grad():
    t_energy.kernel.copy_(torch.tensor(kernel))
  w = torch.tensor(f_w, requires_grad=True)
  values = torch.sin(torch.tensor(support) @ w)
  val_t = testimators.sampled_expectation(t_energy, [t_energy.kernel], values,
                                          torch.tensor(support),
                                          torch.tensor(counts))
  val_t.backward()
  np.testing.assert_allclose(float(val_t.detach()), float(val_j), atol=1e-6)
  np.testing.assert_allclose(t_energy.kernel.grad.numpy(),
                             np.asarray(g_theta_j[0]), atol=1e-5)
  np.testing.assert_allclose(w.grad.numpy(), np.asarray(g_w_j), atol=1e-5)


def test_bernoulli_sampler_marginals():
  """Marginal frequencies of 20000 draws match sigmoid(2*theta) within 5
  standard errors per bit; draws are reproducible from the seed."""
  kernel = np.array([-1.0, -0.3, 0.0, 0.4, 1.2], np.float32)
  energy = tmodels.BernoulliEnergy(list(range(5)),
                                   initializer=tnn.Constant(0.0))
  with torch.no_grad():
    energy.kernel.copy_(torch.tensor(kernel))
  e_inf = tebm.BernoulliEnergyInference(energy, 100, initial_seed=5)
  samples = e_inf.sample(20000)
  assert samples.dtype == torch.int8 and samples.shape == (20000, 5)
  p = 1.0 / (1.0 + np.exp(-2.0 * kernel))
  freq = samples.double().mean(dim=0).numpy()
  assert np.all(np.abs(freq - p) < 5 * np.sqrt(p * (1 - p) / 20000))
  again = tebm.BernoulliEnergyInference(energy, 100, initial_seed=5)
  assert torch.equal(again.sample(20000), samples)


def test_sampled_support_is_deduped_top_counts():
  """The sampled path: N draws reduced to `max_unique` rows by count, counts
  summing to the number of kept draws."""
  energy = tmodels.BernoulliEnergy(list(range(8)),
                                   initializer=tnn.RandomUniform(-0.2, 0.2,
                                                                 seed=1))
  e_inf = tebm.BernoulliEnergyInference(energy, 300, initial_seed=9,
                                        max_unique_samples=16)
  support, counts = e_inf.support_and_counts()
  assert support.shape == (16, 8) and counts.shape == (16,)
  assert torch.all(counts[:-1] >= counts[1:])  # top-by-count order
  assert 16 <= float(counts.sum()) <= 300
  assert len({tuple(r) for r in support.int().tolist()}) == 16
