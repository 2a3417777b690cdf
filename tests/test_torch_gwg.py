"""Gibbs-With-Gradients in the port (`inference/ebm.py`) against the JAX
package.

Proposal probabilities q(i | x) and the log-space MH acceptance at fixed
states and a fixed flip index, against JAX's `gwg_index_proposal_probs`
and the formula of its `gwg_one_step` (KOBE-2 energies at n = 6; also at
weights x 60, where the proposal probabilities underflow to the 1e-30
floors): within 1e-6 (rtol and atol, float32).  Chains can not match the
reference draw for draw, so the samplers are held by their histograms:
100 000 samples of 32 chains at n = 4 against softmax(-E) (atol 1e-2, as
`tests/inference/test_ebm.py::TestGibbsWithGradients::test_chain_histogram`).
Then the stateful API's burn-in on parameter change, a threaded chain
that never burns in, and `step_fn` swapping.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qhbmlib_tpu import models as jmodels
from qhbmlib_tpu import nn as jnn
from qhbmlib_tpu.inference import ebm as jebm
from qhbmlib_tpu_torch import models as tmodels
from qhbmlib_tpu_torch import nn as tnn
from qhbmlib_tpu_torch import utils as tutils
from qhbmlib_tpu_torch.inference import ebm as tebm

torch.set_num_threads(1)

CPU = "cpu"
TOL = 1e-6


def _kobe_pair(n, seed, scale=1.0):
  j = jmodels.KOBE(list(range(n)), 2,
                   initializer=jnn.RandomUniform(-scale, scale, seed=seed))
  t = tmodels.KOBE(list(range(n)), 2, device=CPU)
  with torch.no_grad():
    t.kernel.copy_(torch.tensor(np.asarray(j.trainable_variables[0])))
  return j, t


def _softmax_of(energy, n):
  bits = tutils.all_bitstrings(n, CPU)
  with torch.no_grad():
    return torch.softmax(-energy(bits), 0).numpy()


def _histogram(samples, n):
  idx = samples.numpy().astype(np.int64) @ (2**np.arange(n - 1, -1, -1))
  return np.bincount(idx, minlength=2**n) / idx.shape[0]


@pytest.mark.parametrize("scale", [1.0, 60.0])
def test_proposal_and_acceptance_match_jax(scale):
  n, chains = 6, 16
  j, t = _kobe_pair(n, seed=3, scale=scale)
  rng = np.random.RandomState(5)
  states = rng.randint(0, 2, (chains, n)).astype(np.int8)
  index = rng.randint(0, n, chains)
  theta = j.trainable_variables
  e_apply = lambda th, bits: j.apply_flat(th, bits)

  def want_one(state, i):
    """gwg_one_step's lines for a fixed flip index i."""
    state_f = state.astype(jnp.float32)
    probs = jebm.gwg_index_proposal_probs(e_apply, theta, state_f)
    x_prime = jnp.bitwise_xor(state, jax.nn.one_hot(i, n, dtype=jnp.int8))
    probs_prime = jebm.gwg_index_proposal_probs(
        e_apply, theta, x_prime.astype(jnp.float32))
    log_q_ratio = (jnp.log(jnp.maximum(probs_prime[i], 1e-30)) -
                   jnp.log(jnp.maximum(probs[i], 1e-30)))
    energies = e_apply(theta, jnp.stack([x_prime, state]))
    return probs, x_prime, jnp.minimum(
        energies[1] - energies[0] + log_q_ratio, 0.0)

  probs_j, x_prime_j, log_accept_j = jax.vmap(want_one)(
      jnp.asarray(states), jnp.asarray(index))
  probs = tebm.gwg_index_proposal_probs(t, torch.tensor(states).float())
  np.testing.assert_allclose(probs.numpy(), np.asarray(probs_j), rtol=TOL,
                             atol=TOL)
  x_prime, log_accept = tebm.gwg_log_accept(t, torch.tensor(states), probs,
                                            torch.tensor(index))
  np.testing.assert_array_equal(x_prime.numpy(), np.asarray(x_prime_j))
  assert np.isfinite(log_accept.numpy()).all()
  np.testing.assert_allclose(log_accept.numpy(), np.asarray(log_accept_j),
                             rtol=TOL, atol=TOL)
  if scale > 1:  # the floors are what keeps the rule finite here
    assert (np.asarray(probs_j) < 1e-30).any()


def test_chain_histogram():
  """100 000 samples of 32 chains after 500 burn-in steps reach every one
  of the 2^4 outcomes with the frequencies of softmax(-E)."""
  n = 4
  _, energy = _kobe_pair(n, seed=11)
  infer = tebm.GibbsWithGradientsInference(
      energy, 100_000, num_burnin_samples=500, num_chains=32,
      initial_seed=4)
  hist = _histogram(infer.sample(100_000), n)
  assert (hist > 0).all()
  np.testing.assert_allclose(hist, _softmax_of(energy, n), atol=1e-2)


def test_pluggable_step_fn():
  """A batched single-site Metropolis kernel converges to softmax(-E), and
  an identity kernel freezes the chains: the kernel given is the one that
  runs."""
  n = 3
  _, energy = _kobe_pair(n, seed=13)

  def metropolis_step(energy, state, generator):
    c = state.shape[0]
    i = torch.randint(0, n, (c,), generator=generator)
    x_prime = torch.bitwise_xor(
        state, torch.nn.functional.one_hot(i, n).to(state.dtype))
    e = energy(torch.cat([x_prime, state]))
    accept = torch.rand((c,), generator=generator) <= torch.exp(
        torch.clamp(e[c:] - e[:c], max=0.0))
    return torch.where(accept[:, None], x_prime, state)

  infer = tebm.GibbsWithGradientsInference(
      energy, 50_000, num_burnin_samples=500, num_chains=16, initial_seed=9,
      step_fn=metropolis_step)
  np.testing.assert_allclose(_histogram(infer.sample(50_000), n),
                             _softmax_of(energy, n), atol=2e-2)
  frozen = tebm.GibbsWithGradientsInference(
      energy, 64, num_burnin_samples=10, num_chains=1, initial_seed=9,
      step_fn=lambda energy, state, generator: state)
  s = frozen.sample(64).numpy()
  assert (s == s[0]).all()


def test_burn_in_on_parameter_change_only():
  """The stateful API burns in at its first call and after each parameter
  change, and continues the stored chain otherwise; theta = +-2 on
  independent spins puts nearly all mass on all ones / all zeros."""
  n = 8
  energy = tmodels.BernoulliEnergy(list(range(n)), tnn.Constant(2.0),
                                   device=CPU)
  infer = tebm.GibbsWithGradientsInference(
      energy, 100, num_burnin_samples=300, num_chains=4, initial_seed=6)
  assert infer.chain_state.shape == (4, n)
  assert infer.chain_state.dtype == torch.int8
  assert infer.max_unique_samples == 100
  burns = []
  orig = infer.burn_in
  infer.burn_in = lambda *a, **k: burns.append(1) or orig(*a, **k)
  assert infer.sample(400).float().mean() > 0.9
  assert len(burns) == 1
  support, counts = infer.support_and_counts()
  assert len(burns) == 1  # same parameters: the chain goes on
  assert support.shape == (100, n) and float(counts.sum()) == 100.0
  assert float(counts @ support.mean(-1)) / 100.0 > 0.9
  assert infer.chain_state.float().mean() > 0.9
  with torch.no_grad():
    energy.kernel.fill_(-2.0)
  assert np.isfinite(float(infer.entropy().detach()))
  assert len(burns) == 2
  assert infer.sample(400).float().mean() < 0.1


def test_threaded_chain_never_burns_in():
  """support_counts_state / log_partition_with_state (a train step's
  path) start from the state given and return the advanced state without
  burn-in, whatever the parameters; the stored chain is untouched."""
  n = 5
  _, energy = _kobe_pair(n, seed=2)
  infer = tebm.GibbsWithGradientsInference(
      energy, 32, num_burnin_samples=50, num_chains=8, initial_seed=5)
  infer.burn_in = lambda *a, **k: pytest.fail("burned in")
  stored = infer.chain_state.clone()
  state = stored
  for step in range(3):
    with torch.no_grad():
      energy.kernel.add_(0.1 * (step + 1))
    gen = torch.Generator().manual_seed(step)
    support, counts, state = infer.support_counts_state(gen, state)
    assert support.shape == (min(2**n, 32), n) and float(counts.sum()) == 32
    log_z, state2 = infer.log_partition_with_state(
        torch.Generator().manual_seed(step), state)
    log_z.backward()
    assert energy.kernel.grad is not None
    energy.kernel.grad = None
    # Four steps of eight chains from `state`, as support_counts_state's.
    replay = torch.Generator().manual_seed(step)
    _, expect = infer.sample_with_state(state, 32, replay)
    assert torch.equal(state2, expect)
  assert torch.equal(infer.chain_state, stored)
