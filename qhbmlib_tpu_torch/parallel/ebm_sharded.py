"""Mesh-sharded Gibbs-With-Gradients MCMC inference (port of
`qhbmlib_tpu/parallel/ebm_sharded.py`).

`ShardedGibbsWithGradientsInference` is a drop-in
`inference.ebm.GibbsWithGradientsInference` whose chains split over a mesh
axis: chains never communicate, so the only collective is one all-gather
of the sampled bitstrings in chain order.

Draws: every rank holds the same generator and each step draws the
uniforms of ALL chains, as the one-rank step does, keeping its own rows
(`ebm.gwg_one_step`'s `chains`), so the sharded chains are bit-identical
to the one-rank chains and the ranks' generators stay in step.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from qhbmlib_tpu_torch.inference import ebm
from qhbmlib_tpu_torch.models import energy as energy_model
from qhbmlib_tpu_torch.parallel import comm
from qhbmlib_tpu_torch.parallel import mesh as mesh_lib


class ShardedGibbsWithGradientsInference(ebm.GibbsWithGradientsInference):
  """GWG MCMC with the chains split over a mesh axis.  A custom `step_fn`
  takes the keyword `chains` = (total chains, first of this rank's), as
  `ebm.gwg_one_step` does, and must draw for all chains."""

  def __init__(self, input_energy: energy_model.BitstringEnergy,
               num_expectation_samples: int, num_burnin_samples: int,
               mesh: mesh_lib.Mesh,
               chains_axis: str = mesh_lib.DATA_AXIS,
               name: Optional[str] = None, num_chains: int = 1,
               max_unique_samples: Optional[int] = None,
               initial_seed: Optional[int] = None,
               step_fn: Optional[Callable] = None, device=None):
    if chains_axis not in mesh.shape:
      raise ValueError(f"mesh {tuple(mesh.axis_names)} has no axis "
                       f"{chains_axis!r}")
    d = mesh.shape[chains_axis]
    if num_chains % d:
      raise ValueError(
          f"num_chains={num_chains} must be divisible by the "
          f"{chains_axis!r} axis size {d}")
    super().__init__(input_energy, num_expectation_samples,
                     num_burnin_samples, name, num_chains,
                     max_unique_samples, initial_seed, step_fn, device)
    self._mesh = mesh
    self._chains_axis = chains_axis

  @property
  def mesh(self) -> mesh_lib.Mesh:
    return self._mesh

  def run_chains(self, chain_state: torch.Tensor, num_steps: int,
                 generator: Optional[torch.Generator] = None):
    """Advances every chain `num_steps` steps, this rank's slice here:
    (samples [num_steps, C, n], final state [C, n]) on every rank, equal
    to the one-rank chains' for the same arguments."""
    axis = self._mesh.axis(self._chains_axis)
    if axis.size == 1:
      return super().run_chains(chain_state, num_steps, generator)
    generator = generator or self.generator
    total = self.num_chains
    per = total // axis.size
    first = axis.index * per
    state, samples = chain_state[first:first + per], []
    with torch.no_grad():
      for _ in range(num_steps):
        state = self._step_fn(self._energy, state, generator,
                              chains=(total, first))
        samples.append(state)
    if not samples:
      return chain_state.new_zeros((0,) + tuple(chain_state.shape)), \
          chain_state
    mine = torch.stack(samples)  # [steps, per, n]
    whole = comm.all_gather(mine, axis)  # [ranks, steps, per, n]
    whole = whole.transpose(0, 1).reshape(num_steps, total, -1)
    return whole, whole[-1]
