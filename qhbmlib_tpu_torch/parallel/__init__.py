"""Multi-process parallelism for the port, on `torch.distributed` (port of
`qhbmlib_tpu/parallel/`):

  * `mesh`        -- ('data', 'state') meshes of ranks, one process group
    per axis line; `comm` -- their collectives (XOR-partner exchanges,
    all-reduce, all-gather), NCCL on CUDA tensors, gloo through pinned host
    memory, with per-process counters.
  * `sharded_sv`  -- the amplitude-sharded statevector engine: the 2^n
    amplitudes split over the 'state' axis, gates on global qubits by
    partner exchanges, the local work on the batched engine's kernels.
  * `qnn_sharded` -- `ShardedQuantumInference`, a drop-in QuantumInference
    with the batch over 'data' and each state over 'state'.
  * `sampled_sharded` -- `ShardedSampledQuantumInference`, the shot engine
    with the state batch and its parameter-shift rows over a mesh axis.
  * `ebm_sharded` -- `ShardedGibbsWithGradientsInference`, GWG chains over
    a mesh axis (bit-identical to one rank's).
  * `topology`    -- `initialize_distributed`, `local_device`,
    `sync_params`.  The reference's ICI / DCN mesh layouts (`ici_mesh`,
    `dcn_mesh`) have no counterpart on one card.
"""

from qhbmlib_tpu_torch.parallel.mesh import make_mesh
from qhbmlib_tpu_torch.parallel import comm
from qhbmlib_tpu_torch.parallel import sharded_sv
from qhbmlib_tpu_torch.parallel import topology
from qhbmlib_tpu_torch.parallel.qnn_sharded import ShardedQuantumInference
from qhbmlib_tpu_torch.parallel.sampled_sharded import (
    ShardedSampledQuantumInference)
from qhbmlib_tpu_torch.parallel.ebm_sharded import (
    ShardedGibbsWithGradientsInference)
from qhbmlib_tpu_torch.parallel.topology import initialize_distributed
