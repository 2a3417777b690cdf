"""Named process meshes (port of `qhbmlib_tpu/parallel/mesh.py`).

Axes:
  'data'  -- splits the unique-bitstring circuit batch (data parallel).
  'state' -- splits the 2^n statevector amplitudes: the rank at position s
             along the axis holds the amplitudes whose first k = log2(size)
             (most significant, cirq-convention) qubit values are the bits
             of s.

A mesh of data * state ranks lays them out as the reference lays out its
devices, `devices.reshape(data, state)`: global rank = d * state + s.  Each
axis of size > 1 is a `torch.distributed` process group per line of the
mesh (the ranks that share d form a state group, those that share s a data
group); every rank creates every group, in one fixed order, as
`dist.new_group` requires.  A 1 x 1 mesh needs no process group at all.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch.distributed as dist

DATA_AXIS = "data"
STATE_AXIS = "state"


@dataclasses.dataclass(frozen=True)
class Axis:
  """One mesh axis as this rank sees it: its size, this rank's position
  along it, the global ranks at each position and their process group
  (None for an axis of size 1)."""
  name: str
  size: int
  index: int
  ranks: Tuple[int, ...]
  group: Optional[object] = None


class Mesh:
  """A ('data', 'state') mesh of ranks; `shape` maps each axis name to its
  size, `coords` is this rank's (d, s), or None for a rank outside the
  mesh (the world may hold more ranks than data * state)."""

  axis_names = (DATA_AXIS, STATE_AXIS)

  def __init__(self, data: int, state: int, coords, axes):
    self.shape = {DATA_AXIS: data, STATE_AXIS: state}
    self.coords = coords
    self._axes = axes

  @property
  def member(self) -> bool:
    return self.coords is not None

  def axis(self, name: str) -> Axis:
    if name not in self.shape:
      raise ValueError(f"mesh {self.axis_names} has no axis {name!r}")
    if not self.member:
      raise ValueError("this rank lies outside the mesh")
    return self._axes[name]

  def __repr__(self):
    return f"Mesh({self.shape}, coords={self.coords})"


def make_mesh(data: int = 1, state: int = 1) -> Mesh:
  """Builds a ('data', 'state') mesh over ranks [0, data * state).

  Args:
    data: size of the data-parallel axis.
    state: size of the amplitude-sharding axis (a power of two).

  A mesh of more than one rank needs `torch.distributed` initialized with
  at least data * state ranks, and every rank of the world must call this
  with the same arguments.
  """
  # `state < 1` must be checked explicitly: 0 & -1 == 0 slips through the
  # power-of-two test and would build a mesh of no rank.
  if state < 1 or state & (state - 1):
    raise ValueError(f"state axis size must be a power of 2, got {state}")
  if data < 1:
    raise ValueError(f"data axis size must be >= 1, got {data}")
  n = data * state
  if n == 1:
    axes = {name: Axis(name, 1, 0, (0,)) for name in Mesh.axis_names}
    return Mesh(1, 1, (0, 0), axes)
  if not dist.is_initialized():
    raise ValueError(f"a mesh of {n} ranks needs torch.distributed "
                     "initialized (topology.initialize_distributed)")
  world = dist.get_world_size()
  if world < n:
    raise ValueError(f"need {n} ranks, have {world}")
  rank = dist.get_rank()
  coords = divmod(rank, state) if rank < n else None
  lines = {
      STATE_AXIS: [tuple(d * state + s for s in range(state))
                   for d in range(data)],
      DATA_AXIS: [tuple(d * state + s for d in range(data))
                  for s in range(state)],
  }
  axes = {}
  for name in (STATE_AXIS, DATA_AXIS):  # the same order on every rank
    for ranks in lines[name]:
      group = dist.new_group(list(ranks)) if len(ranks) > 1 else None
      if rank in ranks:
        axes[name] = Axis(name, len(ranks), ranks.index(rank), ranks, group)
  return Mesh(data, state, coords, axes)


def num_global_qubits(mesh: Mesh, axis_name: str = STATE_AXIS) -> int:
  """log2 of the state-axis size: how many qubits are split over ranks."""
  size = mesh.shape[axis_name]
  k = int(size).bit_length() - 1
  if 2**k != size:
    raise ValueError(f"state axis size {size} is not a power of 2")
  return k
