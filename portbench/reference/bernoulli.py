"""Reference of the Bernoulli energy and its sampler (reference library
`models/energy.py` BernoulliEnergy, `inference/ebm.py:318-390`).

E(x) = sum_i theta_i s_i with spins s = 1 - 2x; p(x_i = 1) = sigmoid(2
theta_i); log Z = sum_i log(2 cosh theta_i).  A draw is one uniform u per
sample and bit against p(x_i = 1), u from the step's generator state.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def leaf_shapes(config) -> List[Tuple[str, Tuple[int, ...]]]:
  return [("theta", (config["qubits"],))]


def sample(theta: torch.Tensor, state: torch.Tensor, count: int,
           device) -> np.ndarray:
  """[count, n] bits drawn from the generator state `state` (on `device`)
  at the energy's parameters rounded to float32."""
  gen = torch.Generator(device=device)
  gen.set_state(state)
  p_one = torch.sigmoid(2.0 * theta.detach().to(torch.float32))
  u = torch.rand((count, theta.shape[0]), generator=gen, device=device)
  return (u < p_one).to(torch.int64).cpu().numpy()


def spins(bits: np.ndarray, like: torch.Tensor) -> torch.Tensor:
  return 1.0 - 2.0 * torch.as_tensor(bits, dtype=like.dtype,
                                     device=like.device)


def energy(theta: torch.Tensor, bits: np.ndarray) -> torch.Tensor:
  return spins(bits, theta) @ theta


def log_partition(theta: torch.Tensor) -> torch.Tensor:
  return torch.sum(torch.logaddexp(theta, -theta))


def top_unique(bits: np.ndarray, size: int):
  """(rows [U, n], counts [U]) of the `size` most frequent distinct rows,
  ties to the smaller row read as a big-endian number, rows that occur
  at all (the reference library's `unique_bitstrings_with_counts`
  without its zero-count padding)."""
  n = bits.shape[1]
  codes = bits @ (1 << np.arange(n - 1, -1, -1, dtype=np.int64))
  uniq, counts = np.unique(codes, return_counts=True)
  order = np.argsort(-counts, kind="stable")[:size]
  uniq, counts = uniq[order], counts[order]
  rows = (uniq[:, None] >> np.arange(n - 1, -1, -1, dtype=np.int64)) & 1
  return rows, counts.astype(np.float64)


def jacobian(theta: torch.Tensor, bits: np.ndarray) -> torch.Tensor:
  """[U, n] dE(x_u)/dtheta: the spins."""
  return spins(bits, theta)
