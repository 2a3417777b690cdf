"""Faults planted in the program, to show that the check fails them.

Each is a context manager that breaks the port's timed path underneath
the harness while it is open:

  frozen      the step returns its state unchanged: Adam's step does
              nothing;
  half_batch  half of the batch left out: the sampler's second half of
              distinct rows gets count 0, so the mean is taken over the
              rest;
  altered     an answer altered where it is produced: the first state's
              expectation comes out ALTERED times too large;
  negated     the circuit's gradient with the wrong sign, as an adjoint
              sweep that un-applies in the wrong sense gives it: every
              expectation keeps its value, its gradient flips.

(The exchange between chips has nothing to leave out on one chip.)
"""

from __future__ import annotations

import contextlib

import torch

from qhbmlib_tpu_torch.inference import ebm
from qhbmlib_tpu_torch.inference import qnn

ALTERED = 1.0 + 1e-2


@contextlib.contextmanager
def _patched(owner, attr, replace):
  orig = getattr(owner, attr)
  setattr(owner, attr, replace(orig))
  try:
    yield
  finally:
    setattr(owner, attr, orig)


def frozen():
  return _patched(torch.optim.Adam, "step",
                  lambda orig: lambda self, closure=None: None)


def half_batch():
  def replace(orig):
    def support_and_counts(self, generator=None):
      support, counts = orig(self, generator)
      counts = counts.clone()
      counts[counts.shape[0] // 2:] = 0.0
      return support, counts
    return support_and_counts
  return _patched(ebm.BernoulliEnergyInference, "support_and_counts",
                  replace)


def altered():
  def replace(orig):
    def _expectation(self, initial_states, observables, generator=None):
      out = orig(self, initial_states, observables, generator)
      scale = torch.ones_like(out)
      scale[0] = ALTERED
      return out * scale
    return _expectation
  return _patched(qnn.AnalyticQuantumInference, "_expectation", replace)


def negated():
  def replace(orig):
    def _expectation(self, initial_states, observables, generator=None):
      out = orig(self, initial_states, observables, generator)
      return 2.0 * out.detach() - out
    return _expectation
  return _patched(qnn.AnalyticQuantumInference, "_expectation", replace)


FAULTS = {"frozen": frozen, "half_batch": half_batch, "altered": altered,
          "negated": negated}
# What needs no run: a frozen step reads change_gap 1 by construction.
RUN = tuple(name for name in FAULTS if name != "frozen")
