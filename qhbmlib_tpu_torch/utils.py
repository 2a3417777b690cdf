"""Shared numerics: the main-path subset of `qhbmlib_tpu/utils/__init__.py`."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from qhbmlib_tpu_torch import tracing


def bounded_cache_put(cache: dict, key, value, max_entries: int = 64):
  """FIFO-bounded insert for id()-keyed caches whose entries pin their keyed
  objects (ids are unique only among live objects); evicting the oldest
  entry bounds what a caller that makes a new key object each step keeps
  alive."""
  if key not in cache and len(cache) >= max_entries:
    cache.pop(next(iter(cache)))
  cache[key] = value
  return value


def weighted_average(counts: torch.Tensor, values: torch.Tensor):
  """Count-weighted mean over the leading axis of `values`; zero-count
  (padding) rows contribute nothing."""
  c = counts.to(torch.float32)
  return torch.tensordot(c, values.to(torch.float32), dims=1) / c.sum()


# Bits a code word holds: int64 with the sign bit clear.
WORD_BITS = 62


def bits_to_ints(bitstrings: torch.Tensor) -> torch.Tensor:
  """Big-endian [..., n] bits -> int64 codes [...] for n <= WORD_BITS, or
  [..., W] code words for wider rows: word w is the big-endian code of bits
  [w * WORD_BITS, (w + 1) * WORD_BITS), as the reference's
  `_bit_code_words` packs 31-bit words (`utils/__init__.py:94-105`), so the
  words compare lexicographically as the bitstrings do."""
  n = bitstrings.shape[-1]
  if n > WORD_BITS:
    return torch.stack([bits_to_ints(bitstrings[..., s:s + WORD_BITS])
                        for s in range(0, n, WORD_BITS)], dim=-1)
  weights = 2**torch.arange(n - 1, -1, -1, device=bitstrings.device)
  return torch.sum(bitstrings.to(torch.int64) * weights, dim=-1)


def ints_to_bits(ints: torch.Tensor, num_bits: int) -> torch.Tensor:
  """Integer codes -> big-endian [..., num_bits] int8 bits; for num_bits >
  WORD_BITS, `ints` holds `bits_to_ints`'s [..., W] code words."""
  if num_bits > WORD_BITS:
    return torch.cat([ints_to_bits(ints[..., w],
                                   min(WORD_BITS, num_bits - WORD_BITS * w))
                      for w in range(ints.shape[-1])], dim=-1)
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
  codes = bits_to_ints(bitstrings)  # [batch], or [batch, W] words past 62
  wide = codes.dim() == 2
  with tracing.span("qhbm.sync.unique"):  # waits for the unique count
    uniq, inv, cnt = torch.unique(codes, sorted=True, return_inverse=True,
                                  return_counts=True, dim=0 if wide else None)
  u = uniq.shape[0]
  if size is not None:
    width = max(size, batch)
    uniq = torch.cat([uniq, uniq.new_zeros((width - u,) + uniq.shape[1:])])
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


def expand_unique_results(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """Inverse of `unique_bitstrings_with_counts`: expanded[i] == y[idx[i]]."""
  return torch.index_select(y, 0, idx)


def categorical_indices(logits: torch.Tensor, num_samples: int,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
  """`num_samples` draws from softmax(logits) by inverse-CDF search
  (reference `utils/__init__.py:210`), on the logits' device; int64
  [num_samples]."""
  logits = logits.reshape(-1).to(torch.float32)
  return categorical_indices_from_weights(
      torch.exp(logits - torch.max(logits)), num_samples, generator)


def categorical_indices_from_weights(weights: torch.Tensor, num_samples: int,
                                     generator: Optional[torch.Generator] = None
                                     ) -> torch.Tensor:
  """`categorical_indices` on unnormalized non-negative weights [K]: the
  one-row case of `categorical_rows`; int64 [num_samples]."""
  return categorical_rows(weights.reshape(1, -1), num_samples, generator)[0]


def categorical_rows(weights: torch.Tensor, num_samples: int,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
  """`num_samples` draws from each row of unnormalized non-negative weights
  [rows, K], int64 [rows, num_samples]: one uniform u in [0, total) a draw
  against the row's float32 cumulative sum, the index its right-side
  insertion point.  u can round up to the total itself, where right-side
  insertion gives K, so the last index is clamped as the reference's is
  (`utils/__init__.py:257-264`).  The distribution is the reference's; its
  two-level block search (`utils/__init__.py:234`) is not copied.  A
  float32 cumsum over 2^28 entries drifts (as the reference's does); at
  2^16 a row it is exact to ~1e-7 of the total."""
  cdf = torch.cumsum(weights.to(torch.float32), 1)
  u = torch.rand((weights.shape[0], num_samples), generator=generator,
                 device=cdf.device, dtype=torch.float32) * cdf[:, -1:]
  idx = torch.searchsorted(cdf, u, right=True)
  return torch.clamp(idx, max=cdf.shape[1] - 1)


def parities(indices: torch.Tensor, masks: torch.Tensor,
             num_bits: int) -> torch.Tensor:
  """popcount(indices & mask) & 1 for every index [...] and mask [T] of
  `num_bits` bits: [..., T] of 0 / 1 (int32 below 32 bits, else int64),
  the number the reference computes as `bits @ masks.T % 2` from a
  [shots, n] bit tensor.  XOR-folds the halves down to one bit."""
  dtype = torch.int32 if num_bits < 32 else torch.int64
  v = indices.to(dtype)[..., None] & masks.to(dtype)
  shift = 1
  while shift < num_bits:
    shift <<= 1
  while shift > 1:
    shift >>= 1
    v = v ^ (v >> shift)
  return v & 1
