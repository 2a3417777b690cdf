"""Inference on energy functions (port of `qhbmlib_tpu/inference/ebm.py`:
`EnergyInference`, `AnalyticEnergyInference`, `BernoulliEnergyInference`,
`GibbsWithGradientsInference`).

Randomness goes through an explicit `torch.Generator` on the inference's
device, seeded from `initial_seed`.  Unlike the JAX package, whose pinned
seed reuses one key verbatim, the generator advances with every draw (the
PyTorch convention); pass a generator to a call to control it exactly.

Samplers feed the estimators a (support, counts) pair: N samples deduped to
at most `max_unique_samples` rows, or with `exact=True` the full 2^n
enumeration with expected counts N * p(x).
"""

from __future__ import annotations

import abc
import math
from typing import Callable, Optional, Tuple

import torch

from qhbmlib_tpu_torch import tracing
from qhbmlib_tpu_torch import utils
from qhbmlib_tpu_torch.inference import estimators
from qhbmlib_tpu_torch.models import energy as energy_model

# Largest n for which the exhaustive 2^n support is built.
DEFAULT_ENUM_BITS = 16
# Most bits AnalyticEnergyInference enumerates (reference ebm.py:244).
ANALYTIC_MAX_BITS = 22


def categorical_counts(logits: torch.Tensor, num_samples: int, length: int,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
  """float32 [length] counts of `num_samples` draws from softmax(logits)
  (reference ebm.py:44-48)."""
  idx = utils.categorical_indices(logits, num_samples, generator)
  return torch.bincount(idx, minlength=length).to(torch.float32)


class EnergyInference(abc.ABC):
  """Estimators over a BitstringEnergy's distribution (reference
  ebm.py:134-222)."""

  def __init__(self, input_energy: energy_model.BitstringEnergy,
               num_expectation_samples: int, initial_seed: Optional[int] = None,
               device=None, name: Optional[str] = None):
    self._energy = input_energy
    self.num_expectation_samples = int(num_expectation_samples)
    self.device = torch.device(device) if device is not None else (
        next(input_energy.parameters()).device)
    self.generator = torch.Generator(device=self.device)
    if initial_seed is None:
      self.generator.seed()
    else:
      self.generator.manual_seed(initial_seed)
    self.name = name or type(self).__name__

  @property
  def energy(self) -> energy_model.BitstringEnergy:
    return self._energy

  @property
  def theta(self):
    """The energy's trainable parameters."""
    return [p for p in self._energy.parameters() if p.requires_grad]

  @abc.abstractmethod
  def sample(self, num_samples: int,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[num_samples, n] int8 samples."""

  @abc.abstractmethod
  def support_and_counts(self, generator: Optional[torch.Generator] = None):
    """([U, n] float support, [U] float counts), both without grad."""

  @tracing.spanned("qhbm.ebm.log_partition")
  def log_partition_forward(self, generator=None) -> torch.Tensor:
    """log Z (value only): the uniform-sampling Monte Carlo estimate n log 2
    - log Ns + LSE(-E(x_i)) over Ns uniform bitstrings (reference
    ebm.py:203-212).  Subclasses with an exact value override it."""
    n = self._energy.num_bits
    ns = self.num_expectation_samples
    samples = (torch.rand((ns, n), generator=generator or self.generator,
                          device=self.device) < 0.5).to(torch.int8)
    with torch.no_grad():
      energies = self._energy(samples)
    return (n * math.log(2.0) - math.log(float(ns)) +
            torch.logsumexp(-energies, 0))

  def entropy(self, generator=None) -> torch.Tensor:
    """<E>_p + log Z (reference ebm.py:188-192): the energy's average with
    its eq. A5 and pathwise gradients plus log Z with the eq. C2 one."""
    return (self.expectation(self._energy, generator) +
            self.log_partition(generator))

  def expectation(self, values_fn, generator=None) -> torch.Tensor:
    """<f>_p with eq. A5 gradients; values_fn: int8 bits [U, n] -> [U] or
    [U, k]."""
    support, counts = self.support_and_counts(generator)
    values = values_fn(support.to(torch.int8))
    return estimators.sampled_expectation(self._energy, self.theta, values,
                                          support, counts)

  def log_partition(self, generator=None) -> torch.Tensor:
    """log Z with the eq. C2 gradient."""
    support, counts = self.support_and_counts(generator)
    return estimators.log_partition(self._energy,
                                    self.log_partition_forward(generator),
                                    self.theta, support, counts)

  def support_counts_state(self, generator=None, state=None):
    """(support, counts, new sampler state): the variant for train steps
    that thread the sampler's state (reference ebm.py:151-155); stateless
    samplers pass `state` through."""
    support, counts = self.support_and_counts(generator)
    return support, counts, state

  def sample_with_state(self, state, num_samples: int,
                        generator: Optional[torch.Generator] = None):
    """(samples [num_samples, n] int8, new sampler state): raw samples for
    a train step that threads the sampler's state (reference ebm.py:157);
    stateless samplers pass `state` through."""
    return self.sample(num_samples, generator), state

  def log_partition_with_state(self, generator=None, state=None):
    """(log Z with the eq. C2 gradient, new sampler state), as
    `log_partition` with the state threaded (reference ebm.py:178-188): the
    support first, then the Monte Carlo forward, from one generator."""
    support, counts, new_state = self.support_counts_state(generator, state)
    value = estimators.log_partition(self._energy,
                                     self.log_partition_forward(generator),
                                     self.theta, support, counts)
    return value, new_state


class AnalyticEnergyInference(EnergyInference):
  """The exact categorical distribution over all 2^n bitstrings (reference
  ebm.py:225-315), for n <= ANALYTIC_MAX_BITS.

  `exact=True` feeds the estimators the full enumeration with expected
  counts N * p(x).  Otherwise `max_unique_samples` None (the default for n
  <= 10) counts N categorical draws over the full enumeration, and a cap
  (default min(2^12, N) above 10 bits) draws N samples and keeps at most
  that many unique rows."""

  def __init__(self, input_energy: energy_model.BitstringEnergy,
               num_expectation_samples: int, initial_seed: Optional[int] = None,
               exact: bool = False, max_unique_samples: Optional[int] = None,
               device=None, name: Optional[str] = None):
    n = input_energy.num_bits
    if n > ANALYTIC_MAX_BITS:
      raise ValueError(
          f"AnalyticEnergyInference enumerates all 2^n bitstrings; n={n} "
          "would materialize a >16M-row enumeration on every inference call. "
          "For large n use BernoulliEnergyInference (factorized energies) or "
          "GibbsWithGradientsInference (MCMC); if you specifically need the "
          "analytic estimator semantics at smaller n, the `exact=True` and "
          "`max_unique_samples=` options bound its cost without changing the "
          "estimator.")
    super().__init__(input_energy, num_expectation_samples, initial_seed,
                     device, name)
    self.exact = exact
    if max_unique_samples is None and n > 10:
      max_unique_samples = min(2**12, self.num_expectation_samples)
    self.max_unique_samples = max_unique_samples
    self.all_bitstrings = utils.all_bitstrings(n, self.device)

  @property
  def all_energies(self) -> torch.Tensor:
    """[2^n] energies of every bitstring, differentiable."""
    return self._energy(self.all_bitstrings)

  def logits(self) -> torch.Tensor:
    return -self.all_energies

  def probabilities(self) -> torch.Tensor:
    return torch.softmax(self.logits(), 0)

  def sample(self, num_samples: int, generator=None) -> torch.Tensor:
    with torch.no_grad():
      idx = utils.categorical_indices(self.logits(), num_samples,
                                      generator or self.generator)
    return self.all_bitstrings[idx]

  @tracing.spanned("qhbm.ebm.sample")
  def support_and_counts(self, generator=None):
    with torch.no_grad():
      logits = self.logits()
      if self.exact:
        return (self.all_bitstrings.to(torch.float32),
                torch.softmax(logits, 0) * self.num_expectation_samples)
      if self.max_unique_samples is None:
        # The full enumeration with the draws' counts: the same estimator
        # as sample-and-dedup, on a static support.
        return (self.all_bitstrings.to(torch.float32),
                categorical_counts(logits, self.num_expectation_samples,
                                   logits.shape[0],
                                   generator or self.generator))
      samples = self.sample(self.num_expectation_samples, generator)
      uniq, _, counts = utils.unique_bitstrings_with_counts(
          samples, size=self.max_unique_samples)
      return uniq.to(torch.float32), counts.to(torch.float32)

  def entropy(self, generator=None) -> torch.Tensor:
    """Exact categorical entropy, differentiable."""
    log_p = torch.log_softmax(self.logits(), 0)
    return -torch.sum(torch.exp(log_p) * log_p)

  def log_partition_forward(self, generator=None) -> torch.Tensor:
    """Exact: LSE over all logits."""
    with torch.no_grad():
      return torch.logsumexp(self.logits(), 0)


class BernoulliEnergyInference(EnergyInference):
  """Factorized Bernoulli per bit (reference ebm.py:318-390)."""

  def __init__(self, input_energy: energy_model.BernoulliEnergy,
               num_expectation_samples: int, initial_seed: Optional[int] = None,
               exact: bool = False, max_unique_samples: Optional[int] = None,
               device=None, name: Optional[str] = None):
    super().__init__(input_energy, num_expectation_samples, initial_seed,
                     device, name)
    n = input_energy.num_bits
    self._enumerable = n <= DEFAULT_ENUM_BITS
    self.exact = exact
    self.max_unique_samples = max_unique_samples or min(
        2**min(n, 12), num_expectation_samples)

  def logits(self) -> torch.Tensor:
    return self._energy.logits

  def sample(self, num_samples: int, generator=None) -> torch.Tensor:
    probs = torch.sigmoid(self.logits().detach())
    u = torch.rand((num_samples, self._energy.num_bits),
                   generator=generator or self.generator, device=self.device)
    return (u < probs).to(torch.int8)

  @tracing.spanned("qhbm.ebm.sample")
  def support_and_counts(self, generator=None):
    with torch.no_grad():
      if self._enumerable and self.exact:
        n = self._energy.num_bits
        bits = utils.all_bitstrings(n, self.device).to(torch.float32)
        l = self.logits()
        # log p(x) = sum_i [b_i log sigmoid(l_i) + (1-b_i) log sigmoid(-l_i)]
        joint = (bits @ torch.nn.functional.logsigmoid(l) +
                 (1.0 - bits) @ torch.nn.functional.logsigmoid(-l))
        counts = torch.softmax(joint, 0) * self.num_expectation_samples
        return bits, counts
      samples = self.sample(self.num_expectation_samples, generator)
      uniq, _, counts = utils.unique_bitstrings_with_counts(
          samples, size=self.max_unique_samples)
      return uniq.to(torch.float32), counts.to(torch.float32)

  def log_partition_forward(self, generator=None) -> torch.Tensor:
    """Exact: sum_i log(2 cosh theta_i)."""
    thetas = 0.5 * self.logits()
    return torch.sum(torch.logaddexp(thetas, -thetas))

  def entropy(self, generator=None) -> torch.Tensor:
    """Exact factorized entropy, differentiable."""
    l = self.logits()
    p = torch.sigmoid(l)
    return torch.sum(p * torch.nn.functional.softplus(-l) +
                     (1.0 - p) * torch.nn.functional.softplus(l))


# ---------------------------------------------------------------------------
# Gibbs With Gradients (arXiv:2102.04509)
# ---------------------------------------------------------------------------

def gwg_index_proposal_probs(energy: energy_model.BitstringEnergy,
                             state_f: torch.Tensor) -> torch.Tensor:
  """q(i | x) for each row x of `state_f` [..., n] (float bits): the softmax
  of the Taylor-approximated energy differences (2x - 1) * dE/dx / 2
  (reference ebm.py:397).  One autograd call over the rows' summed
  energies gives every row's dE/dx: rows are independent."""
  x = state_f.detach().requires_grad_(True)
  with torch.enable_grad():
    (grad_e,) = torch.autograd.grad(energy(x).sum(), x)
  return torch.softmax((2.0 * state_f - 1.0) * grad_e / 2.0, dim=-1)


def gwg_log_accept(energy: energy_model.BitstringEnergy, state: torch.Tensor,
                   probs: torch.Tensor, index: torch.Tensor):
  """(x', log acceptance) of flipping bit `index` [C] of each chain of
  `state` [C, n] (int8) proposed with `probs` = q(. | x): both proposal
  probabilities floored at 1e-30 (1e-38 is subnormal in float32 and
  flushes to 0) and min(E(x) - E(x') + log q(i|x') - log q(i|x), 0), the
  log-space MH rule of the reference's `gwg_one_step` (ebm.py:406-441)."""
  flip = torch.nn.functional.one_hot(index, state.shape[-1]).to(state.dtype)
  x_prime = torch.bitwise_xor(state, flip)
  probs_prime = gwg_index_proposal_probs(energy, x_prime.to(torch.float32))
  pick = lambda p: torch.gather(p, -1, index[:, None])[:, 0]
  log_q_ratio = (torch.log(torch.clamp(pick(probs_prime), min=1e-30)) -
                 torch.log(torch.clamp(pick(probs), min=1e-30)))
  with torch.no_grad():
    energies = energy(torch.cat([x_prime, state]))
  c = state.shape[0]
  return x_prime, torch.clamp(energies[c:] - energies[:c] + log_q_ratio,
                              max=0.0)


def gwg_one_step(energy: energy_model.BitstringEnergy, state: torch.Tensor,
                 generator: torch.Generator,
                 chains: Optional[Tuple[int, int]] = None) -> torch.Tensor:
  """One Gibbs-With-Gradients Metropolis-Hastings step of every chain of
  `state` [C, n] (int8) at once: a flip index drawn from q(. | x) by
  inverse CDF, then accepted where log u <= the log acceptance, u floored
  at 1e-30 (reference ebm.py:406).  Draws C index uniforms, then C
  acceptance uniforms, from `generator`.  With `chains` = (total, first),
  `state` holds chains [first, first + C) of `total`: the step draws the
  uniforms of all `total` chains and keeps these rows, so a slice of the
  chains steps exactly as it does within the whole
  (`parallel.ShardedGibbsWithGradientsInference`)."""
  c, n = state.shape
  total, first = chains if chains is not None else (c, 0)
  probs = gwg_index_proposal_probs(energy, state.to(torch.float32))
  cdf = torch.cumsum(probs, dim=-1)
  u_idx = torch.rand((total, 1), generator=generator,
                     device=state.device)[first:first + c]
  index = torch.clamp(torch.searchsorted(cdf, u_idx * cdf[:, -1:],
                                         right=True)[:, 0], max=n - 1)
  x_prime, log_accept = gwg_log_accept(energy, state, probs, index)
  u = torch.clamp(torch.rand((total,), generator=generator,
                             device=state.device)[first:first + c],
                  min=1e-30)
  return torch.where((torch.log(u) <= log_accept)[:, None], x_prime, state)


class GibbsWithGradientsInference(EnergyInference):
  """MCMC inference by parallel Gibbs-With-Gradients chains (reference
  ebm.py:444-575): `num_chains` chains advance together, one [C, n] tensor
  a step.

  The stateful API (`sample`, `support_and_counts` and the estimators on
  them) re-equilibrates the stored chain with `num_burnin_samples` steps
  whenever the energy's parameters changed since the last call, and
  persists the advanced chain.  A train step that threads the chain
  (`support_counts_state`, `log_partition_with_state`) runs no burn-in, as
  the reference's jitted steps.

  `step_fn(energy, state [C, n] int8, generator) -> state` swaps the
  transition kernel (default `gwg_one_step`); unlike the reference's
  per-chain step it advances every chain at once."""

  def __init__(self, input_energy: energy_model.BitstringEnergy,
               num_expectation_samples: int, num_burnin_samples: int,
               name: Optional[str] = None, num_chains: int = 1,
               max_unique_samples: Optional[int] = None,
               initial_seed: Optional[int] = None,
               step_fn: Optional[Callable] = None, device=None):
    super().__init__(input_energy, num_expectation_samples, initial_seed,
                     device, name)
    self._step_fn = step_fn if step_fn is not None else gwg_one_step
    self.num_burnin_samples = int(num_burnin_samples)
    self.num_chains = int(num_chains)
    n = input_energy.num_bits
    self.max_unique_samples = max_unique_samples or min(
        2**min(n, 12), self.num_expectation_samples, 4096)
    self._chain_state = (torch.rand((self.num_chains, n),
                                    generator=self.generator,
                                    device=self.device) < 0.5).to(torch.int8)
    self._fingerprint = None

  @property
  def chain_state(self) -> torch.Tensor:
    return self._chain_state

  def run_chains(self, chain_state: torch.Tensor, num_steps: int,
                 generator: Optional[torch.Generator] = None):
    """Advances every chain `num_steps` steps: (samples [num_steps, C, n],
    final state)."""
    generator = generator or self.generator
    state, samples = chain_state, []
    with torch.no_grad():
      for _ in range(num_steps):
        with tracing.span("qhbm.ebm.gwg_step"):
          state = self._step_fn(self._energy, state, generator)
        samples.append(state)
    if not samples:
      return chain_state.new_zeros((0,) + tuple(chain_state.shape)), state
    return torch.stack(samples), state

  def sample_with_state(self, chain_state: Optional[torch.Tensor],
                        num_samples: int,
                        generator: Optional[torch.Generator] = None):
    """(samples [num_samples, n], new chain state): ceil(num_samples / C)
    steps from `chain_state` (the stored chain if None), each step's
    chains in order; no burn-in."""
    if chain_state is None:
      chain_state = self._chain_state
    steps = -(-num_samples // self.num_chains)
    samples, final = self.run_chains(chain_state, steps, generator)
    return samples.reshape(-1, samples.shape[-1])[:num_samples], final

  def burn_in(self, chain_state: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if self.num_burnin_samples == 0:
      return chain_state
    return self.run_chains(chain_state, self.num_burnin_samples,
                           generator)[1]

  def _maybe_burn_in(self) -> None:
    """Re-equilibrates the stored chain (drawing from the inference's own
    generator) if the energy's parameters changed since the last call."""
    with tracing.span("qhbm.sync.fingerprint"):
      fp = tuple(p.detach().cpu().numpy().tobytes() for p in self.theta)
    if fp != self._fingerprint:
      self._chain_state = self.burn_in(self._chain_state)
      self._fingerprint = fp

  def sample(self, num_samples: int, generator=None) -> torch.Tensor:
    self._maybe_burn_in()
    samples, self._chain_state = self.sample_with_state(
        self._chain_state, num_samples, generator)
    return samples

  @tracing.spanned("qhbm.ebm.sample")
  def support_and_counts(self, generator=None):
    """Like the reference's `_ready_inference`: burn in on a parameter
    change, then continue the stored chain and persist it."""
    self._maybe_burn_in()
    support, counts, self._chain_state = self.support_counts_state(
        generator, self._chain_state)
    return support, counts

  @tracing.spanned("qhbm.ebm.sample")
  def support_counts_state(self, generator=None, state=None):
    """(support [U, n], counts [U], new chain state) from
    num_expectation_samples draws of the chains from `state` (the stored
    chain if None), deduped to max_unique_samples rows; no burn-in."""
    samples, new_state = self.sample_with_state(
        state, self.num_expectation_samples, generator)
    uniq, _, counts = utils.unique_bitstrings_with_counts(
        samples, size=self.max_unique_samples)
    return uniq.to(torch.float32), counts.to(torch.float32), new_state
