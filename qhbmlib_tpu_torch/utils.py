"""Shared numerics: the main-path subset of `qhbmlib_tpu/utils/__init__.py`."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def weighted_average(counts: torch.Tensor, values: torch.Tensor):
  """Count-weighted mean over the leading axis of `values`; zero-count
  (padding) rows contribute nothing."""
  c = counts.to(torch.float32)
  return torch.tensordot(c, values.to(torch.float32), dims=1) / c.sum()


def bits_to_ints(bitstrings: torch.Tensor) -> torch.Tensor:
  """Big-endian [..., n] bits -> int64 codes (n <= 62)."""
  n = bitstrings.shape[-1]
  if n > 62:
    raise ValueError(f"bits_to_ints holds at most 62 bits; got n={n}")
  weights = 2**torch.arange(n - 1, -1, -1, device=bitstrings.device)
  return torch.sum(bitstrings.to(torch.int64) * weights, dim=-1)


def ints_to_bits(ints: torch.Tensor, num_bits: int) -> torch.Tensor:
  """Integer codes -> big-endian [..., num_bits] int8 bits."""
  shifts = torch.arange(num_bits - 1, -1, -1, device=ints.device)
  return ((ints.to(torch.int64)[..., None] >> shifts) & 1).to(torch.int8)


def all_bitstrings(num_bits: int, device=None) -> torch.Tensor:
  """[2^n, n] int8 enumeration in ascending index order."""
  return ints_to_bits(torch.arange(2**num_bits, device=device), num_bits)


def unique_bitstrings_with_counts(
    bitstrings: torch.Tensor, size: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Unique rows of a bitstring batch plus inverse indices and counts.

  Same contract and row order as the reference (`utils/__init__.py:125`):
    * size None: every unique row, ascending;
    * size >= batch: uniques ascending, then zero rows with count 0;
    * size < batch: the `size` highest-count rows, ties to the smaller
      bitstring (as `jax.lax.top_k` over the ascending uniques, padded with
      zero-count zero rows when fewer than `size` exist); dropped inputs get
      idx == size.

  Returns (y [size, n] same dtype, idx [batch] int64, counts [size] int32).
  """
  n = bitstrings.shape[-1]
  batch = bitstrings.shape[0]
  codes = bits_to_ints(bitstrings)
  uniq, inv, cnt = torch.unique(codes, sorted=True, return_inverse=True,
                                return_counts=True)
  u = uniq.shape[0]
  if size is not None:
    width = max(size, batch)
    uniq = torch.cat([uniq, uniq.new_zeros(width - u)])
    cnt = torch.cat([cnt, cnt.new_zeros(width - u)])
    if size < batch:
      # Stable descending sort == top_k's order: ties keep ascending codes.
      order = torch.sort(cnt, descending=True, stable=True).indices[:size]
      uniq, cnt = uniq[order], cnt[order]
      pos_map = torch.full((width,), size, dtype=torch.int64,
                           device=codes.device)
      pos_map[order] = torch.arange(size, device=codes.device)
      inv = pos_map[inv]
  return (ints_to_bits(uniq, n).to(bitstrings.dtype), inv,
          cnt.to(torch.int32))
