"""The collectives of the sharded engines, on `torch.distributed`.

  exchange_xor   the reference's `ppermute` with an XOR permutation
                 (`sharded_sv.py:61`): rank s of an axis swaps tensors with
                 rank s ^ mask, one paired isend / irecv;
  all_reduce_sum the reference's `psum`;
  all_gather     the gather at a `shard_map` boundary (chains, rows);
  broadcast      `multihost_utils.broadcast_one_to_all` (`sync_params`).

Transport: NCCL takes CUDA tensors as they are.  Gloo moves host memory
only, so a CUDA tensor given to a gloo group is copied to pinned host
memory and back here, explicitly, and nowhere else: it is how ranks that
share one card exchange (NCCL refuses two ranks on one device), not a
fallback.  Whatever the backend, several tensors of one call travel as
one flat buffer.

`stats` counts, per process, the calls of each collective and the bytes
each sent ("bytes_moved") or copied between device and host
("bytes_staged"); `reset_stats` zeroes them.
"""

from __future__ import annotations

import collections
from typing import List, Sequence

import torch
import torch.distributed as dist

from qhbmlib_tpu_torch.parallel import mesh as mesh_lib

stats = collections.Counter()


def reset_stats() -> None:
  stats.clear()


def _staged(group, t: torch.Tensor) -> bool:
  """Whether `t` must cross to the host for `group`'s backend."""
  return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


_pinned = {}


def _host_buffer(numel: int, dtype, slot: str) -> torch.Tensor:
  """A pinned host buffer of `numel` elements, kept per (slot, dtype) and
  grown as needed: allocating pinned memory costs more than the copy."""
  key = (slot, dtype)
  buf = _pinned.get(key)
  if buf is None or buf.numel() < numel:
    buf = torch.empty(numel, dtype=dtype, pin_memory=torch.cuda.is_available())
    _pinned[key] = buf
  return buf[:numel]


def _to_host(t: torch.Tensor, slot: str) -> torch.Tensor:
  host = _host_buffer(t.numel(), t.dtype, slot)
  host.copy_(t.reshape(-1))
  stats["bytes_staged"] += t.numel() * t.element_size()
  return host


def _from_host(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
  out = torch.empty_like(like)
  out.reshape(-1).copy_(host)
  stats["bytes_staged"] += host.numel() * host.element_size()
  return out


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
  """One contiguous float buffer of `tensors` (complex as float pairs)."""
  parts = [torch.view_as_real(t) if t.is_complex() else t for t in tensors]
  if len(parts) == 1:
    return parts[0].contiguous().reshape(-1)
  return torch.cat([p.reshape(-1) for p in parts])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
  out, pos = [], 0
  for t in like:
    size = t.numel() * (2 if t.is_complex() else 1)
    part = flat[pos:pos + size]
    pos += size
    if t.is_complex():
      part = torch.view_as_complex(part.reshape(t.shape + (2,)))
    out.append(part.reshape(t.shape))
  return out


def exchange_xor(tensors: Sequence[torch.Tensor], mask: int,
                 axis: mesh_lib.Axis) -> List[torch.Tensor]:
  """Sends `tensors` to the rank at position index ^ mask of `axis` and
  returns what that rank sent, same shapes: every rank of the axis calls
  it with the same mask (the XOR permutation pairs them)."""
  if not 0 < mask < axis.size:
    raise ValueError(f"exchange mask {mask} outside axis {axis.name!r} of "
                     f"size {axis.size}")
  peer = axis.ranks[axis.index ^ mask]
  flat = _flat(tensors)
  staged = _staged(axis.group, flat)
  send = _to_host(flat, "send") if staged else flat
  recv = (_host_buffer(flat.numel(), flat.dtype, "recv") if staged else
          torch.empty_like(flat))
  ops = [dist.P2POp(dist.isend, send, peer, group=axis.group),
         dist.P2POp(dist.irecv, recv, peer, group=axis.group)]
  for req in dist.batch_isend_irecv(ops):
    req.wait()
  stats["exchanges"] += 1
  stats["bytes_moved"] += flat.numel() * flat.element_size()
  return _unflat(_from_host(recv, flat) if staged else recv, tensors)


def all_reduce_sum(t: torch.Tensor, axis: mesh_lib.Axis,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
  """The sum (or `op`) of `t` over the ranks of `axis` (a new tensor; `t`
  itself for an axis of size 1)."""
  if axis.size == 1:
    return t
  flat = _flat([t])
  staged = _staged(axis.group, flat)
  buf = _to_host(flat, "reduce") if staged else flat.clone()
  dist.all_reduce(buf, op=op, group=axis.group)
  stats["all_reduces"] += 1
  stats["bytes_moved"] += flat.numel() * flat.element_size()
  return _unflat(_from_host(buf, flat) if staged else buf, [t])[0]


def all_gather(t: torch.Tensor, axis: mesh_lib.Axis) -> torch.Tensor:
  """[axis.size, *t.shape]: every rank's `t`, by position along `axis`."""
  if axis.size == 1:
    return t[None]
  flat = _flat([t])
  staged = _staged(axis.group, flat)
  src = _to_host(flat, "gather") if staged else flat
  parts = [torch.empty_like(src) for _ in range(axis.size)]
  dist.all_gather(parts, src, group=axis.group)
  stats["all_gathers"] += 1
  stats["bytes_moved"] += flat.numel() * flat.element_size()
  whole = torch.stack(parts)
  if staged:
    stats["bytes_staged"] += whole.numel() * whole.element_size()
    whole = whole.to(t.device)
  return torch.stack(_unflat(whole.reshape(-1), [t] * axis.size))


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
  """Overwrites `t` in place with global rank `src`'s `t` over `group`
  (None: the world)."""
  staged = _staged(group, t)
  buf = _to_host(t, "bcast") if staged else t
  dist.broadcast(buf, src, group=group)
  if staged:
    t.reshape(-1).copy_(buf)
    stats["bytes_staged"] += t.numel() * t.element_size()
  stats["broadcasts"] += 1
  stats["bytes_moved"] += t.numel() * t.element_size()
  return t
