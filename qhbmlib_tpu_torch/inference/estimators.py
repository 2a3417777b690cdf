"""Custom-gradient Monte-Carlo estimators for EBM inference (port of
`qhbmlib_tpu/inference/estimators.py`).

  * `sampled_expectation`: the count-weighted average of per-sample values
    whose backward adds the score-function gradient of the QHBM paper's
    eq. A5 for the energy parameters (`_aws_bwd`, :64-91).
  * `log_partition`: a log Z value whose gradient is eq. C2,
    dlogZ = -<grad E>_p (`_lp_bwd`, :143-150).

Both estimators take the energy as a module and its parameters explicitly;
the two eq. A5 terms are two vector-Jacobian products of the energy with
different cotangents, so no per-sample Jacobian is ever built.  Sampling
enters only through a (support, counts) pair.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from qhbmlib_tpu_torch import utils


def _energy_vjp(energy: Callable, theta: Sequence[torch.Tensor],
                support: torch.Tensor, cotangents: Sequence[torch.Tensor]):
  """[sum_u c_u dE(x_u)/dtheta for c in cotangents], one energy forward."""
  with torch.enable_grad():
    e = energy(support)
    out = []
    for i, c in enumerate(cotangents):
      out.append(torch.autograd.grad(e, theta, grad_outputs=c,
                                     retain_graph=i + 1 < len(cotangents),
                                     allow_unused=True))
  return [[torch.zeros_like(t) if g is None else g for g, t in zip(gs, theta)]
          for gs in out]


class _AvgWithScore(torch.autograd.Function):
  """Count-weighted average of `values` [U]; backward gives `values` the
  pathwise cotangent counts/total and `theta` the eq. A5 score term."""

  @staticmethod
  def forward(ctx, energy, support, counts, values, *theta):
    ctx.energy = energy
    ctx.theta = theta  # the energy's own parameters, differentiated below
    ctx.save_for_backward(support, counts, values)
    return utils.weighted_average(counts, values)

  @staticmethod
  def backward(ctx, g):
    support, counts, values = ctx.saved_tensors
    theta = ctx.theta
    total = torch.sum(counts)
    weights = counts / total
    values_bar = weights * g
    # <grad E><w.f> - <(w.f) grad E>, with w.f = g * f per sample.
    combined = g * values
    avg_combined = torch.sum(counts * combined) / total
    mean_grad_e, mean_combined_grad_e = _energy_vjp(
        ctx.energy, theta, support, [weights, counts * combined / total])
    theta_bar = [a * avg_combined - b
                 for a, b in zip(mean_grad_e, mean_combined_grad_e)]
    return (None, None, None, values_bar, *theta_bar)


def sampled_expectation(energy: Callable, theta: Sequence[torch.Tensor],
                        values: torch.Tensor, support: torch.Tensor,
                        counts: torch.Tensor) -> torch.Tensor:
  """Count-weighted average of per-sample `values` with eq. A5 gradients.

  Args:
    energy: callable support [U, n] -> energies [U], differentiable in theta.
    theta: the energy's parameters; they receive the score-function term.
    values: [U] per-sample values of f (pathwise gradients flow through
      ordinary autograd to whatever they depend on).
    support: [U, n] sampled bitstrings (no grad).
    counts: [U] float occurrence counts (no grad).
  """
  return _AvgWithScore.apply(energy, support.detach(), counts.detach(),
                             values, *theta)


class _LogPartition(torch.autograd.Function):

  @staticmethod
  def forward(ctx, energy, value, support, counts, *theta):
    ctx.energy = energy
    ctx.theta = theta
    ctx.save_for_backward(support, counts)
    return value.detach().clone()

  @staticmethod
  def backward(ctx, g):
    support, counts = ctx.saved_tensors
    (mean_grad_e,) = _energy_vjp(ctx.energy, ctx.theta, support,
                                 [counts / torch.sum(counts)])
    return (None, None, None, None, *[-g * x for x in mean_grad_e])


def log_partition(energy: Callable, forward_value: torch.Tensor,
                  theta: Sequence[torch.Tensor], support: torch.Tensor,
                  counts: torch.Tensor) -> torch.Tensor:
  """`forward_value` (a log Z estimate) with the eq. C2 gradient
  -<grad E> over the (support, counts) model samples."""
  return _LogPartition.apply(energy, forward_value, support.detach(),
                             counts.detach(), *theta)
