"""The port's KOBE energy, `Parity`, `AnalyticEnergyInference`, the
categorical samplers and the wide bit codes against the JAX package, on
the CPU.

Inputs are made with numpy from seeds and handed to both packages; the JAX
weights are copied into the port's parameters.  Tolerances: energies,
parities and exact-mode estimates (expectation, log Z, entropy) and their
gradients 1e-5 (float32 sums over at most 2^6 rows).  The samplers cannot
match JAX's bits, so they are held statistically: the total variation
between 10^5 draws and the exact distribution at 4 qubits stays under 0.02
(its expectation is ~0.005 there), and the Monte Carlo log Z is compared at
the bitstrings it drew.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qhbmlib_tpu import models as jmodels
from qhbmlib_tpu import nn as jnn
from qhbmlib_tpu import utils as jutils
from qhbmlib_tpu.inference import ebm as jebm
from qhbmlib_tpu.models import energy_utils as jeu
from qhbmlib_tpu_torch import models as tmodels
from qhbmlib_tpu_torch import nn as tnn
from qhbmlib_tpu_torch import utils as tutils
from qhbmlib_tpu_torch.inference import ebm as tebm
from qhbmlib_tpu_torch.models import energy as tenergy
from qhbmlib_tpu_torch.models import energy_utils as teu

torch.set_num_threads(1)

CPU = "cpu"  # the port builds on the CUDA card unless told otherwise
ATOL = 1e-5
TV_BOUND = 0.02
DRAWS = 100_000


def _kobe_pair(n, order, seed=1):
  """A JAX KOBE and the port's, with the JAX weights."""
  j = jmodels.KOBE(list(range(n)), order,
                   initializer=jnn.RandomUniform(-1.0, 1.0, seed=seed))
  t = tmodels.KOBE(list(range(n)), order, device=CPU)
  with torch.no_grad():
    t.kernel.copy_(torch.tensor(np.asarray(j.trainable_variables[0])))
  return j, t


def _bits(n, rows, seed):
  return np.random.RandomState(seed).randint(0, 2, (rows, n)).astype(np.int8)


# -- Parity and KOBE ------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2, 3])
def test_parity_matches_jax(order):
  """Mask, term order, the masked product on float inputs (and its input
  gradient, which GWG needs) and the integer path on bits, at n = 5."""
  n = 5
  j = jeu.Parity(list(range(n)), order)
  t = teu.Parity(list(range(n)), order, device=CPU)
  assert t.indices == j.indices and t.num_terms == j.num_terms
  np.testing.assert_array_equal(t.mask.numpy(), j.mask)
  x = np.random.RandomState(order).uniform(-1.5, 1.5, (7, n)).astype(
      np.float32)
  got = t(torch.tensor(x))
  np.testing.assert_allclose(got.numpy(), np.asarray(j.apply([], x)),
                             atol=ATOL)
  w = np.random.RandomState(10 + order).normal(size=(7, t.num_terms))
  xt = torch.tensor(x, requires_grad=True)
  (t(xt) * torch.tensor(w, dtype=torch.float32)).sum().backward()
  want = jax.grad(lambda v: jnp.sum(j.apply([], v) * w))(jnp.asarray(x))
  np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=ATOL)
  bits = _bits(n, 32, order)
  np.testing.assert_array_equal(t.apply_to_bits(torch.tensor(bits)).numpy(),
                                np.asarray(j.apply_to_bits(bits)))
  spins = 1.0 - 2.0 * bits.astype(np.float32)
  np.testing.assert_array_equal(t(torch.tensor(spins)).numpy(),
                                t.apply_to_bits(torch.tensor(bits)).numpy())


@pytest.mark.parametrize("order", [1, 2, 3])
def test_kobe_energy_and_shards_match_jax(order):
  """Energies of every 5-bit string, their kernel gradient, the operator
  shards (Z strings of the combinations, in order) and the post-process."""
  n = 5
  j, t = _kobe_pair(n, order)
  assert t.num_terms == j._num_terms and t.indices == j._indices
  bits = tutils.all_bitstrings(n, CPU)
  e = t(bits)
  np.testing.assert_allclose(
      e.detach().numpy(), np.asarray(j(jutils.all_bitstrings(n))), atol=ATOL)
  w = np.random.RandomState(order).normal(size=2**n).astype(np.float32)
  (e * torch.tensor(w)).sum().backward()
  want = jax.grad(lambda th: jnp.sum(
      j.apply_flat([th], jutils.all_bitstrings(n)) * w))(
          j.trainable_variables[0])
  np.testing.assert_allclose(t.kernel.grad.numpy(), np.asarray(want),
                             atol=ATOL)
  t_shards, j_shards = t.operator_shards(n), j.operator_shards(n)
  assert len(t_shards) == len(j_shards) == t.num_terms
  for ts, js in zip(t_shards, j_shards):
    np.testing.assert_array_equal(ts.codes.numpy(), np.asarray(js.codes))
    np.testing.assert_allclose(ts.coeffs.numpy(), np.asarray(js.coeffs))
  x = np.random.RandomState(5).normal(size=(3, t.num_terms)).astype(
      np.float32)
  np.testing.assert_allclose(
      t.operator_expectation(torch.tensor(x)).detach().numpy(),
      np.asarray(j.operator_expectation(x)), atol=ATOL)


@pytest.mark.parametrize("order,err", [(0, ValueError), (-2, ValueError),
                                       (1.5, TypeError), ("2", TypeError)])
def test_check_order_rejects_what_the_reference_rejects(order, err):
  with pytest.raises(err):
    jeu.check_order(order)
  with pytest.raises(err):
    teu.check_order(order)
  with pytest.raises(err):
    tmodels.KOBE([0, 1, 2], order, device=CPU)


# -- AnalyticEnergyInference, exact mode ------------------------------------

def _values_table(n, seed=7):
  """A fixed value per bitstring (a lookup table f(x)), as numpy."""
  return np.random.RandomState(seed).normal(size=2**n).astype(np.float32)


def _index(bits):
  n = bits.shape[-1]
  return (bits.astype(np.int64) * (1 << np.arange(n - 1, -1, -1))).sum(-1)


class _DenseTanh(torch.nn.Module):
  """A trainable layer of two parameters (the counterpart of the JAX
  package's nn.Dense with a tanh), for the multi-parameter energy."""

  def __init__(self, n, units):
    super().__init__()
    self.weight = torch.nn.Parameter(torch.zeros(n, units))
    self.bias = torch.nn.Parameter(torch.zeros(units))

  def forward(self, x):
    return torch.tanh(x.to(torch.float32) @ self.weight + self.bias)


def _energy_pair(kind, n):
  """(JAX energy, port energy) with the same weights: a KOBE-2, or an
  energy of three parameters (spins, dense tanh layer, VariableDot)."""
  if kind == "kobe":
    return _kobe_pair(n, 2)
  dense = jnn.Dense(3, jnp.tanh,
                    kernel_initializer=jnn.RandomUniform(-1, 1, seed=2),
                    bias_initializer=jnn.RandomUniform(-1, 1, seed=3))
  j = jmodels.BitstringEnergy(
      list(range(n)), [jeu.SpinsFromBitstrings(), dense,
                       jeu.VariableDot(jnn.RandomUniform(-1, 1, seed=4))])
  t = tenergy.BitstringEnergy(
      list(range(n)), [teu.SpinsFromBitstrings(), _DenseTanh(n, 3),
                       teu.VariableDot(3, device=CPU)])
  with torch.no_grad():
    for p, v in zip(t.parameters(), j.trainable_variables):
      p.copy_(torch.tensor(np.asarray(v)))
  return j, t


def _grads(t_energy):
  return [p.grad.numpy().copy() for p in t_energy.parameters()]


def _zero(t_energy):
  for p in t_energy.parameters():
    p.grad = None


@pytest.mark.parametrize("kind", ["kobe", "three_params"])
def test_analytic_exact_estimates_match_jax(kind):
  """Expectation of a lookup-table f, log Z and the entropy, values and
  gradients w.r.t. every energy parameter, at n = 6 on the exact support
  (expected counts).  The three-parameter energy checks the estimators'
  eq. A5 / C2 gradients beyond one kernel; KOBE's Parity has no parameter
  in its pre-process."""
  n = 6
  j, t = _energy_pair(kind, n)
  j_inf = jebm.AnalyticEnergyInference(j, 100, initial_seed=3, exact=True)
  t_inf = tebm.AnalyticEnergyInference(t, 100, initial_seed=3, exact=True,
                                       device=CPU)
  table = _values_table(n)
  theta = j_inf.theta
  key = jax.random.PRNGKey(0)

  j_exp = lambda th: j_inf.expectation_pure(
      th, lambda _, bits: jnp.asarray(table)[_index_jnp(bits)], None, key)
  cases = {
      "expectation": (j_exp, lambda: t_inf.expectation(
          lambda bits: torch.tensor(table)[_index(bits.numpy())])),
      "log_partition": (lambda th: j_inf.log_partition_pure(th, key),
                        t_inf.log_partition),
      "entropy": (lambda th: j_inf.entropy_pure(th, key), t_inf.entropy),
  }
  for name, (j_fn, t_fn) in cases.items():
    j_val, j_grad = jax.value_and_grad(j_fn)(theta)
    _zero(t)
    t_val = t_fn()
    t_val.backward()
    np.testing.assert_allclose(float(t_val.detach()), float(j_val),
                               atol=ATOL, err_msg=name)
    for got, want in zip(_grads(t), j_grad):
      np.testing.assert_allclose(got, np.asarray(want), atol=ATOL,
                                 err_msg=name)
  np.testing.assert_allclose(t_inf.probabilities().detach().numpy(),
                             np.asarray(j_inf.probabilities_pure(theta)),
                             atol=ATOL)
  np.testing.assert_allclose(t_inf.all_energies.detach().numpy(),
                             np.asarray(j_inf.all_energies), atol=ATOL)


def _index_jnp(bits):
  n = bits.shape[-1]
  return jnp.sum(jnp.asarray(bits, jnp.int32) *
                 (1 << jnp.arange(n - 1, -1, -1)), axis=-1)


def test_default_entropy_and_mc_log_partition():
  """EnergyInference's defaults on an exact support: the Monte Carlo log Z
  (n log 2 - log Ns + LSE(-E(x_i))) equals the JAX estimator's formula at
  the bitstrings it drew and lands near the exact log Z at 10^5 draws
  (|error| < 0.02); the default entropy <E> + log Z has the JAX base
  class's gradient (the Monte Carlo value carries none)."""
  n = 4
  j, t = _kobe_pair(n, 2)
  t_inf = tebm.AnalyticEnergyInference(t, DRAWS, initial_seed=5, exact=True,
                                       device=CPU)
  gen = torch.Generator().manual_seed(8)
  state = gen.get_state()
  got = tebm.EnergyInference.log_partition_forward(t_inf, gen)
  gen.set_state(state)
  drawn = (torch.rand((DRAWS, n), generator=gen) < 0.5).to(torch.int8)
  energies = j(np.asarray(drawn.numpy()))
  want = (n * np.log(2.0) - np.log(DRAWS) +
          jax.scipy.special.logsumexp(-energies))
  np.testing.assert_allclose(float(got), float(want), atol=ATOL)
  assert abs(float(got) - float(t_inf.log_partition_forward())) < 0.02

  j_inf = jebm.AnalyticEnergyInference(j, DRAWS, initial_seed=5, exact=True)
  key = jax.random.PRNGKey(1)
  j_grad = jax.grad(lambda th: jebm.EnergyInference.entropy_pure(
      j_inf, th, key))(j_inf.theta)
  tebm.EnergyInference.entropy(t_inf).backward()
  np.testing.assert_allclose(t.kernel.grad.numpy(), np.asarray(j_grad[0]),
                             atol=ATOL)


# -- samplers -------------------------------------------------------------------

def _tv(counts, probs):
  return 0.5 * float(np.abs(counts / counts.sum() - probs).sum())


def test_samplers_follow_the_distribution():
  """At 4 qubits: `sample`, `categorical_counts` and the full-support
  counts branch each give a histogram within TV_BOUND of the exact
  probabilities over DRAWS draws."""
  n = 4
  _, t = _kobe_pair(n, 2)
  t_inf = tebm.AnalyticEnergyInference(t, DRAWS, initial_seed=4,
                                       device=CPU)
  probs = t_inf.probabilities().detach().numpy().astype(np.float64)
  samples = t_inf.sample(DRAWS).numpy()
  hist = np.bincount(_index(samples), minlength=2**n).astype(np.float64)
  assert _tv(hist, probs) < TV_BOUND
  counts = tebm.categorical_counts(t_inf.logits().detach(), DRAWS, 2**n,
                                   torch.Generator().manual_seed(2))
  assert counts.dtype == torch.float32 and float(counts.sum()) == DRAWS
  assert _tv(counts.numpy().astype(np.float64), probs) < TV_BOUND
  support, counts = t_inf.support_and_counts()
  np.testing.assert_array_equal(support.numpy(),
                                tutils.all_bitstrings(n, CPU).numpy())
  assert float(counts.sum()) == DRAWS
  assert _tv(counts.numpy().astype(np.float64), probs) < TV_BOUND


def test_categorical_indices_insert_right_and_clamp(monkeypatch):
  """Zero weights are never drawn (right-side insertion skips them), and a
  uniform that rounds up to the total is clamped to the last index as the
  reference clamps it."""
  gen = torch.Generator().manual_seed(0)
  w = torch.tensor([0.0, 2.0, 0.0, 1.0, 0.0])
  idx = tutils.categorical_indices_from_weights(w, 5000, gen)
  assert set(idx.tolist()) == {1, 3}
  frac = float((idx == 1).float().mean())
  assert abs(frac - 2.0 / 3.0) < 0.03
  logits = torch.log(torch.tensor([0.25, 0.75]))
  idx = tutils.categorical_indices(logits, 5000, gen)
  assert abs(float(idx.float().mean()) - 0.75) < 0.03
  monkeypatch.setattr(torch, "rand",
                      lambda shape, **kw: torch.ones(shape))
  idx = tutils.categorical_indices_from_weights(w, 3, None)
  assert idx.tolist() == [4, 4, 4]


def test_support_branches_and_defaults():
  """max_unique_samples: None up to 10 bits, min(2^12, N) above; the
  sample-and-dedup branch at 11 bits gives unique rows whose counts sum to
  N; above 22 bits the reference's error."""
  t10 = tmodels.KOBE(list(range(10)), 1, device=CPU)
  assert tebm.AnalyticEnergyInference(t10, 500, device=CPU
                                      ).max_unique_samples is None
  t11 = tmodels.KOBE(list(range(11)), 2, device=CPU)
  inf11 = tebm.AnalyticEnergyInference(t11, 500, initial_seed=1, device=CPU)
  assert inf11.max_unique_samples == 500
  assert tebm.AnalyticEnergyInference(t11, 10_000, device=CPU
                                      ).max_unique_samples == 4096
  support, counts = inf11.support_and_counts()
  assert support.shape == (500, 11) and float(counts.sum()) == 500
  kept = support[counts > 0].to(torch.int8)
  assert torch.unique(kept, dim=0).shape[0] == kept.shape[0]
  with pytest.raises(ValueError, match="enumerates all 2\\^n bitstrings"):
    tebm.AnalyticEnergyInference(
        tmodels.BernoulliEnergy(list(range(23)), device=CPU), 10)


# -- wide bit codes -----------------------------------------------------------

@pytest.mark.parametrize("n", [63, 100])
def test_bits_to_ints_round_trip_wide(n):
  """Past 62 bits the codes are words of 62 bits, big-endian, that
  round-trip and sort as the bitstrings do; the dedup takes them, with the
  reference's rows, inverse indices and counts in all three size modes."""
  bits = _bits(n, 40, n)
  bits = np.concatenate([bits, bits[:12], bits[3:5]])  # repeats
  words = tutils.bits_to_ints(torch.tensor(bits))
  assert words.shape == (bits.shape[0], -(-n // tutils.WORD_BITS))
  np.testing.assert_array_equal(
      tutils.ints_to_bits(words, n).numpy(), bits)
  order = sorted(range(len(bits)), key=lambda i: tuple(bits[i]))
  assert sorted(range(len(bits)), key=lambda i: tuple(words[i].tolist())
                ) == order
  for size in (None, 80, 20):
    got = tutils.unique_bitstrings_with_counts(torch.tensor(bits), size)
    want = jutils.unique_bitstrings_with_counts(jnp.asarray(bits), size)
    for g, w in zip(got, want):
      np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(-1)
                                    if g.dim() == 1 else np.asarray(w))
