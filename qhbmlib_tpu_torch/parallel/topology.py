"""Process-group initialization and parameter sync (port of
`qhbmlib_tpu/parallel/topology.py`).

  * `initialize_distributed` -- `dist.init_process_group` with the
    reference's contract (`topology.py:52`): a world of one process is a
    no-op; explicit arguments make any failure fatal; auto-detection (the
    `RANK` / `WORLD_SIZE` / `MASTER_ADDR` variables `torch.distributed.run`
    sets) that finds nothing continues as one process, with a warning.
  * `local_device` -- this rank's device: `cuda:<local rank % cards>`.
  * `sync_params` -- rank 0's parameters broadcast to every rank: model
    constructors draw unseeded initial values per process, and every rank
    must step the same parameters.

The reference's `ici_mesh` and `dcn_mesh` lay devices out along TPU
interconnect links and slices; one card has no such topology, so they
have no counterpart here.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from qhbmlib_tpu_torch import device as device_lib
from qhbmlib_tpu_torch.parallel import comm

# A collective that waits longer than this fails instead of blocking.
TIMEOUT = datetime.timedelta(seconds=120)

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def local_rank() -> int:
  """This process's rank on its host: `LOCAL_RANK` where the launcher set
  it, else the global rank (0 outside a process group)."""
  if "LOCAL_RANK" in os.environ:
    return int(os.environ["LOCAL_RANK"])
  return dist.get_rank() if dist.is_initialized() else 0


def local_device(device=None) -> torch.device:
  """`device` where given (the tests' "cpu"), else `cuda:<local rank %
  the host's card count>`: ranks beyond the cards share them.  Raises
  without a card (`device.resolve`)."""
  if device is not None:
    return torch.device(device)
  device_lib.resolve(None)
  return torch.device("cuda", local_rank() % torch.cuda.device_count())


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None,
                           timeout: datetime.timedelta = TIMEOUT) -> int:
  """Joins the process group; returns the world size.

  Args:
    init_method: e.g. "tcp://localhost:29500"; None reads the environment
      (`env://`).
    world_size, rank: this process's place; None reads the environment.
    backend: "nccl" or "gloo"; None means nccl for a CUDA `device` and gloo
      for the CPU.  There is no fallback from one to the other: NCCL's
      refusal (two ranks on one card) propagates.
    device: the rank's device (`local_device`), which also picks the
      default backend; None means the card.
    timeout: how long a collective may wait before it fails.
  """
  if world_size is not None and int(world_size) <= 1:
    return 1
  if dist.is_initialized():
    return dist.get_world_size()
  explicit = (init_method, world_size, rank) != (None, None, None)
  if not explicit and not all(k in os.environ for k in _ENV):
    logging.getLogger(__name__).warning(
        "initialize_distributed() found no %s in the environment; "
        "continuing as one process. If this process IS part of a "
        "multi-process job, pass init_method/world_size/rank explicitly -- "
        "explicit arguments make this failure fatal instead.",
        "/".join(_ENV))
    return 1
  if not explicit and int(os.environ["WORLD_SIZE"]) <= 1:
    return 1
  dev = local_device(device)
  if backend is None:
    backend = "gloo" if dev.type == "cpu" else "nccl"
  if backend == "nccl":
    torch.cuda.set_device(dev)
  dist.init_process_group(
      backend, init_method=init_method or "env://",
      world_size=-1 if world_size is None else int(world_size),
      rank=-1 if rank is None else int(rank), timeout=timeout)
  return dist.get_world_size()


def sync_params(params: Iterable[torch.Tensor]):
  """Overwrites every tensor of `params` with rank 0's, in place; returns
  `params`.  A no-op in a world of one process."""
  if not dist.is_initialized() or dist.get_world_size() == 1:
    return params
  with torch.no_grad():
    for p in params:
      comm.broadcast_(p.data if isinstance(p, torch.nn.Parameter) else p, 0)
  return params
