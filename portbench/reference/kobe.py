"""Reference of the KOBE energy (reference library `models/energy.py`
KOBE), its Gibbs-With-Gradients sampler (arXiv:2102.04509; reference
library `inference/ebm.py:393-575`) and its Monte Carlo log Z
(`inference/ebm.py:203-212`).

E(x) = sum_t w_t prod_{i in c_t} s_i with spins s = 1 - 2x, over every
combination c_t of at most `order` bits: the combinations of one bit,
then of two, ..., each in lexicographic order.  As an operator E is
diagonal, sum_t w_t Z_{c_t}, so its diagonal is the Walsh-Hadamard
transform of the weights placed at the terms' index masks, and the
terms' expectations in a state are the transform of its probabilities
read at those masks (qubit q is bit n-1-q of an index).

A GWG step of C chains draws C index uniforms and then C acceptance
uniforms from one generator; its decisions are taken in float32 on the
energy's weights rounded to float32, with no matrix product (so TF32
never enters them).  The Monte Carlo log Z is n log 2 -
log Ns + LSE(-E(y_i)) over Ns uniform bitstrings y_i (a uniform u < 0.5
a bit).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

# Index bits transformed by one matrix product.
BLOCK = 7
# Floor of a proposal probability and of an acceptance uniform (float32's
# smallest normal is 1.2e-38).
FLOOR = 1e-30


def _combinations(items: List[int], r: int):
  if r == 0:
    yield ()
    return
  for i, first in enumerate(items):
    for rest in _combinations(items[i + 1:], r - 1):
      yield (first,) + rest


def terms(n: int, order: int) -> List[Tuple[int, ...]]:
  """The combinations c_t of at most `order` of n bits, in the energy's
  order."""
  return [c for r in range(1, order + 1)
          for c in _combinations(list(range(n)), r)]


def leaf_shapes(config) -> List[Tuple[str, Tuple[int, ...]]]:
  return [("theta", (len(terms(config["qubits"],
                               config["energy"]["order"])),))]


def masks(n: int, order: int) -> np.ndarray:
  """[T] the index mask of each term: bit n-1-q set for each q in c_t."""
  return np.array([sum(1 << (n - 1 - q) for q in c)
                   for c in terms(n, order)], dtype=np.int64)


def _order(theta: torch.Tensor, n: int) -> int:
  t = theta.shape[0]
  for order in range(1, n + 1):
    if len(terms(n, order)) == t:
      return order
  raise ValueError(f"{t} weights are no KOBE energy of {n} bits")


def _spins(bits, like: torch.Tensor) -> torch.Tensor:
  return 1.0 - 2.0 * torch.as_tensor(bits, dtype=like.dtype,
                                     device=like.device)


def _parities(s: torch.Tensor, order: int) -> torch.Tensor:
  return torch.stack([torch.prod(s[:, list(c)], dim=1)
                      for c in terms(s.shape[-1], order)], dim=1)


def jacobian(theta: torch.Tensor, bits) -> torch.Tensor:
  """[S, T] dE(x_s)/dtheta of the bit rows [S, n] (an array or a tensor):
  the parities prod_{i in c_t} s_i."""
  s = _spins(bits, theta)
  return _parities(s, _order(theta, s.shape[-1]))


def energy(theta: torch.Tensor, bits) -> torch.Tensor:
  """[S] E of the bit rows [S, n]."""
  return torch.sum(jacobian(theta, bits) * theta, dim=1)


def proposal(theta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """q(i | x) [C, n] of float32 bit rows x: the softmax of (2x - 1) dE/dx
  / 2, where dE/dx_i = -2 dE/ds_i and dE/ds_i = s_i sum_{t : i in c_t}
  w_t prod_{j in c_t} s_j (each term's product with s_i taken out)."""
  n = x.shape[-1]
  order = _order(theta, n)
  s = 1.0 - 2.0 * x
  member = torch.zeros((theta.shape[0], n), dtype=x.dtype, device=x.device)
  for t, c in enumerate(terms(n, order)):
    member[t, list(c)] = 1.0
  weighted = _parities(s, order) * theta
  de_dx = -2.0 * s * torch.sum(weighted[:, :, None] * member, dim=1)
  return torch.softmax((2.0 * x - 1.0) * de_dx / 2.0, dim=-1)


def gwg_step(theta: torch.Tensor, state: torch.Tensor,
             gen: torch.Generator) -> torch.Tensor:
  """One Metropolis-Hastings step of every chain of `state` [C, n] (int64
  bits): a bit drawn from q(. | x) by inverse CDF, flipped, and the flip
  kept where log u <= min(E(x) - E(x') + log q(i | x') - log q(i | x),
  0); in float32, at `theta` rounded to float32."""
  theta = theta.detach().to(torch.float32)
  c, n = state.shape
  x = state.to(torch.float32)
  probs = proposal(theta, x)
  cdf = torch.cumsum(probs, dim=-1)
  u_index = torch.rand((c, 1), generator=gen, device=gen.device)
  index = torch.clamp(torch.searchsorted(cdf, u_index * cdf[:, -1:],
                                         right=True)[:, 0], max=n - 1)
  flip = torch.nn.functional.one_hot(index, n).to(state.dtype)
  x_prime = state ^ flip
  probs_prime = proposal(theta, x_prime.to(torch.float32))
  pick = lambda p: torch.gather(p, 1, index[:, None])[:, 0]
  log_q = (torch.log(torch.clamp(pick(probs_prime), min=FLOOR)) -
           torch.log(torch.clamp(pick(probs), min=FLOOR)))
  log_accept = torch.clamp(energy(theta, x) - energy(theta, x_prime) +
                           log_q, max=0.0)
  u = torch.clamp(torch.rand((c,), generator=gen, device=gen.device),
                  min=FLOOR)
  return torch.where((torch.log(u) <= log_accept)[:, None], x_prime, state)


def chain_start(chains: int, n: int, gen: torch.Generator) -> torch.Tensor:
  """[chains, n] random bits (a uniform u < 0.5 a bit)."""
  u = torch.rand((chains, n), generator=gen, device=gen.device)
  return (u < 0.5).to(torch.int64)


def run_chains(theta: torch.Tensor, state: torch.Tensor, steps: int,
               gen: torch.Generator):
  """(samples [steps * C, n] int64 numpy, each step's chains in order, the
  final state)."""
  out = []
  for _ in range(steps):
    state = gwg_step(theta, state, gen)
    out.append(state.cpu().numpy())
  return np.concatenate(out), state


def mc_log_partition(theta: torch.Tensor, gen: torch.Generator,
                     count: int, n: int) -> torch.Tensor:
  """The Monte Carlo log Z over `count` uniform bitstrings drawn from
  `gen`, in `theta`'s dtype."""
  u = torch.rand((count, n), generator=gen, device=gen.device)
  return (n * math.log(2.0) - math.log(float(count)) +
          torch.logsumexp(-energy(theta, u < 0.5), 0))


def walsh_hadamard(v: torch.Tensor) -> torch.Tensor:
  """[2^n] sum_y v(y) (-1)^popcount(x & y) at every x: BLOCK index bits a
  matrix product."""
  size = v.shape[0]
  n = size.bit_length() - 1
  out = v
  for start in range(0, n, BLOCK):
    k = min(BLOCK, n - start)
    kk, a, c = 2**k, 2**start, 2**(n - start - k)
    index = torch.arange(kk, device=v.device)
    pop = torch.zeros((kk, kk), dtype=torch.int64, device=v.device)
    both = index[:, None] & index[None, :]
    for b in range(k):
      pop += (both >> b) & 1
    h = (1.0 - 2.0 * (pop & 1)).to(v.dtype)
    x = out.reshape(a, kk, c).permute(0, 2, 1).reshape(-1, kk)
    out = (x @ h).reshape(a, c, kk).permute(0, 2, 1).reshape(size)
  return out


def diagonal(theta: torch.Tensor, n: int) -> torch.Tensor:
  """[2^n] E at every index (E as the operator sum_t w_t Z_{c_t})."""
  order = _order(theta, n)
  sparse = torch.zeros(2**n, dtype=theta.dtype, device=theta.device)
  sparse[torch.as_tensor(masks(n, order), device=theta.device)] = theta
  return walsh_hadamard(sparse)


def expectations(probs: torch.Tensor, order: int) -> torch.Tensor:
  """[T] <Z_{c_t}> of a state's probabilities [2^n]."""
  n = probs.shape[0].bit_length() - 1
  return walsh_hadamard(probs)[torch.as_tensor(masks(n, order),
                                               device=probs.device)]
