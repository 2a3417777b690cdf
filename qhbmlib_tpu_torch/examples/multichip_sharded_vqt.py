"""VQT training with the statevector amplitude-sharded over a mesh of ranks
(port of `examples/multichip_sharded_vqt.py`).

Each 2^n-amplitude statevector splits over the 'state' axis of a
('data', 'state') mesh: gates on the sharded qubits become partner
exchanges, expectations end in an all-reduce.  The sharded engine is a
drop-in: `ShardedQuantumInference` takes `AnalyticQuantumInference`'s
place and the loss, its gradients and the optimizer are unchanged.  8
qubits, a Bernoulli EBM of 200 samples (at most 32 unique), a 2-layer
hardware-efficient ansatz, Adam 5e-2 for 30 steps at beta 1.2; the loss
must fall.

    python -m qhbmlib_tpu_torch.examples.multichip_sharded_vqt [--steps 30]
        [--device cpu]
    python -m torch.distributed.run --nproc_per_node=2 \\
        -m qhbmlib_tpu_torch.examples.multichip_sharded_vqt

The mesh spans every rank: state = the largest power of two dividing the
world size, data = the rest.  One process runs the 1 x 1 mesh, which is
the dense engine.  Under `torch.distributed.run` each rank joins one
process group on `cuda:<local rank % cards>`; ranks that share a card
exchange through gloo (NCCL refuses two ranks on one device), else NCCL.
Rank 0 prints.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist

from qhbmlib_tpu_torch import models
from qhbmlib_tpu_torch import nn
from qhbmlib_tpu_torch import parallel
from qhbmlib_tpu_torch.examples import vqt_thermal_state as vqt_example
from qhbmlib_tpu_torch.inference import ebm, qhbm, vqt_loss
from qhbmlib_tpu_torch.ops import paulis
from qhbmlib_tpu_torch.parallel import topology

N, BETA, LAYERS, STEPS = 8, 1.2, 2, 30


def mesh_shape(world: int):
  """(data, state): state the largest power of two dividing `world`."""
  state = world & -world
  return world // state, state


def build(device=None):
  """(model, loss, mesh) on this rank's device (`device`, else
  `cuda:<local rank % cards>`), from the example's seeds: the energy's 2,
  the EBM's 2, the circuit's 3.  loss() is the VQT loss at BETA against
  the open TFIM."""
  device = topology.local_device(device)
  world = dist.get_world_size() if dist.is_initialized() else 1
  data, state = mesh_shape(world)
  mesh = parallel.make_mesh(data=data, state=state)
  energy = models.BernoulliEnergy(
      list(range(N)), initializer=nn.RandomUniform(-1, 1, seed=2),
      device=device)
  e_inf = ebm.BernoulliEnergyInference(energy, 200, initial_seed=2,
                                       max_unique_samples=32, device=device)
  circuit = models.DirectQuantumCircuit(
      models.hardware_efficient_ansatz(N, LAYERS),
      initializer=nn.RandomUniform(-0.5, 0.5, seed=3), device=device)
  q_inf = parallel.ShardedQuantumInference(circuit, mesh)  # the only change
  model = qhbm.QHBM(e_inf, q_inf)
  loss_fn = vqt_loss.make_vqt(model, paulis.tfim_1d(N, device=device))
  return model, lambda: loss_fn(BETA), mesh


def join(device=None) -> bool:
  """Joins the process group `torch.distributed.run` describes, if any and
  not joined yet; returns whether this call joined it."""
  if "RANK" not in os.environ or dist.is_initialized():
    return False
  dev = topology.local_device(device)
  shared = (dev.type == "cuda" and
            int(os.environ.get("LOCAL_WORLD_SIZE", 1)) >
            torch.cuda.device_count())
  topology.initialize_distributed(backend="gloo" if shared else None,
                                  device=dev)
  return dist.is_initialized()


def main(steps: Optional[int] = None, device=None) -> List[float]:
  """Trains for `steps` (default 30) and returns the losses."""
  joined = join(device)
  rank = dist.get_rank() if dist.is_initialized() else 0
  model, loss, mesh = build(device)
  ranks = dist.get_world_size() if dist.is_initialized() else 1
  if rank == 0:
    print(f"mesh: {mesh.shape} over {ranks} "
          f"{model.e_inference.device.type} ranks")
  step = vqt_example.make_step(model, loss)
  n = STEPS if steps is None else steps
  if rank == 0:
    losses = vqt_example.train(step, n, every=10)
  else:
    losses = [float(step()[0]) for _ in range(n)]
  assert losses[-1] < losses[0], "loss should decrease"
  if rank == 0:
    print("sharded VQT training ran end to end.")
  if joined:
    dist.destroy_process_group()
  return losses


if __name__ == "__main__":
  vqt_example.cli(__doc__.splitlines()[0], main)
