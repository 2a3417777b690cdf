"""Inference on energy functions (port of `qhbmlib_tpu/inference/ebm.py`,
main-path subset: `EnergyInference` and `BernoulliEnergyInference`).

Randomness goes through an explicit `torch.Generator` on the inference's
device, seeded from `initial_seed`.  Unlike the JAX package, whose pinned
seed reuses one key verbatim, the generator advances with every draw (the
PyTorch convention); pass a generator to a call to control it exactly.

Samplers feed the estimators a (support, counts) pair: N samples deduped to
at most `max_unique_samples` rows, or with `exact=True` (n <= 16) the full
2^n enumeration with expected counts N * p(x).
"""

from __future__ import annotations

import abc
from typing import Optional

import torch

from qhbmlib_tpu_torch import utils
from qhbmlib_tpu_torch.inference import estimators
from qhbmlib_tpu_torch.models import energy as energy_model

# Largest n for which the exhaustive 2^n support is built.
DEFAULT_ENUM_BITS = 16


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

  @abc.abstractmethod
  def log_partition_forward(self) -> torch.Tensor:
    """log Z (value only)."""

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
    return estimators.log_partition(self._energy, self.log_partition_forward(),
                                    self.theta, support, counts)


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

  def log_partition_forward(self) -> torch.Tensor:
    """Exact: sum_i log(2 cosh theta_i)."""
    thetas = 0.5 * self.logits()
    return torch.sum(torch.logaddexp(thetas, -thetas))

  def entropy(self) -> torch.Tensor:
    """Exact factorized entropy, differentiable."""
    l = self.logits()
    p = torch.sigmoid(l)
    return torch.sum(p * torch.nn.functional.softplus(-l) +
                     (1.0 - p) * torch.nn.functional.softplus(l))
