"""Layers used by the energy models (port of
`qhbmlib_tpu/models/energy_utils.py`).

As in the reference, `Parity` keeps its terms as a static 0/1 mask
[num_terms, n] (`itertools.combinations` order): on float spins its terms
are products (differentiable in the input), on bits one matmul and a mod 2.
"""

from __future__ import annotations

import itertools
from typing import List, Optional

import torch
from torch import nn

from qhbmlib_tpu_torch import device as device_lib
from qhbmlib_tpu_torch import nn as qnn_init


def check_bits(bits: List[int]) -> List[int]:
  """Validates a list of bit indices (duplicates would alias energy terms)."""
  if len(set(bits)) != len(bits):
    raise ValueError(f"bit index list contains duplicates: {bits}")
  return bits


def check_order(order: int) -> int:
  """Validates a parity interaction order (must be a positive int)."""
  if not isinstance(order, int):
    raise TypeError(f"parity order must be an int, got {type(order).__name__}")
  if order <= 0:
    raise ValueError(f"parity order must be positive, got {order}")
  return order


class SpinsFromBitstrings(nn.Module):
  """Maps bits to spins: |0> -> +1, |1> -> -1."""

  def forward(self, inputs: torch.Tensor) -> torch.Tensor:
    return 1.0 - 2.0 * inputs.to(torch.float32)


class VariableDot(nn.Module):
  """Dot product with a trainable [num_inputs] kernel on `device` (None
  means the CUDA card, `device.resolve`)."""

  def __init__(self, num_inputs: int,
               initializer: Optional[qnn_init.Initializer] = None,
               device=None):
    super().__init__()
    initializer = initializer or qnn_init.RandomUniform()
    self.kernel = nn.Parameter(initializer([num_inputs],
                                           device_lib.resolve(device)))

  def forward(self, inputs: torch.Tensor) -> torch.Tensor:
    return torch.sum(inputs.to(torch.float32) * self.kernel, dim=-1)


class Parity(nn.Module):
  """All parity products of <= `order` spins (reference
  `energy_utils.py:75-112`).  The mask and the padded term indices are
  buffers on `device` (None means the CUDA card, `device.resolve`)."""

  def __init__(self, bits: List[int], order: int, device=None):
    super().__init__()
    n = len(check_bits(list(bits)))
    order = check_order(order)
    self.indices = [combo for i in range(1, order + 1)
                    for combo in itertools.combinations(range(n), i)]
    self.num_terms = len(self.indices)
    mask = torch.zeros((self.num_terms, n), dtype=torch.float32)
    # Each term's spins, padded with index n: a constant 1 column.
    width = min(order, n)
    padded = torch.full((self.num_terms, width), n, dtype=torch.int64)
    for t, combo in enumerate(self.indices):
      mask[t, list(combo)] = 1.0
      padded[t, :len(combo)] = torch.tensor(combo)
    device = device_lib.resolve(device)
    self.register_buffer("mask", mask.to(device), persistent=False)
    self.register_buffer("_padded", padded.to(device), persistent=False)

  def forward(self, inputs: torch.Tensor) -> torch.Tensor:
    """[batch, n] spins -> [batch, num_terms] parities: the product of each
    term's spins, differentiable in `inputs` (the reference's masked
    product, taken over the term's <= order spins instead of all n)."""
    spins = inputs.to(torch.float32)
    ext = torch.cat([spins, spins.new_ones(spins.shape[:-1] + (1,))], -1)
    out = ext[..., self._padded[:, 0]]
    for j in range(1, self._padded.shape[1]):
      out = out * ext[..., self._padded[:, j]]
    return out

  def apply_to_bits(self, bits: torch.Tensor) -> torch.Tensor:
    """[batch, n] bits -> [batch, num_terms] parities 1 - 2 ((bits @
    mask^T) mod 2), not differentiable.  The counts (<= n) are exact in
    float32, which the card's matmul takes."""
    counts = bits.to(torch.float32) @ self.mask.T
    return 1.0 - 2.0 * torch.remainder(counts, 2.0)
