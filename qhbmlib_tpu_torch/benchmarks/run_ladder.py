"""Runs the scale ladder's rungs (`ladder.py`) and prints one JSON line a
rung (port of `benchmarks/run_ladder.py`).

    python -m qhbmlib_tpu_torch.benchmarks.run_ladder        # every rung
    python -m qhbmlib_tpu_torch.benchmarks.run_ladder --rung r2_heis8_qmhl \\
        --steps 3
    python -m qhbmlib_tpu_torch.benchmarks.run_ladder --smoke --device cpu
    python -m torch.distributed.run --nproc_per_node=2 \\
        -m qhbmlib_tpu_torch.benchmarks.run_ladder \\
        --rung r4_tfim24_sharded_vqt --backend gloo

Each rung takes two warm-up steps (the first builds the kernels), then
`--steps` timed steps on the host clock ending in a synchronize; its line
holds `steps_per_sec`, `warmup_s`, `final_loss` and the rung's meta (its
qubits, its loss, its mesh's axis sizes, ...).  A rung that raises prints
{"rung": ..., "error": ...} and the others still run; the process exits 1
if any rung failed.  The rungs run on the CUDA card unless `--device`
names another.

Under `torch.distributed.run` (the env:// rendezvous: RANK, WORLD_SIZE,
MASTER_ADDR) every rank joins one process group (`--backend`, default
nccl on the card and gloo on the CPU; ranks that share one card need gloo)
on `cuda:<local rank % cards>`, every rung runs on all ranks, and rank 0
alone prints the lines; a rank whose rung failed exits 1, which fails the
launch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from qhbmlib_tpu_torch.benchmarks import ladder
from qhbmlib_tpu_torch.parallel import topology

# Each rung's meta beside its qubit count (the reference's `build_rung`).
META = {
    "r1_tfim2_vqt": {"loss": "vqt"},
    "r2_heis8_qmhl": {"loss": "qmhl"},
    "r3_kobe16_vqt_shift": {"loss": "vqt", "grad": "parameter-shift"},
    "r4_tfim24_sharded_vqt": {"loss": "vqt"},
    "r5_gwg28_qmhl": {"loss": "qmhl", "ebm": "gwg"},
}
WARMUP_STEPS = 2


def _sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def run_rung(name: str, steps: int, smoke: bool, qubits=None,
             max_unique=None, device=None) -> dict:
  """The rung's JSON record: WARMUP_STEPS steps, then `steps` timed ones."""
  device = topology.local_device(device)
  h, _, train_step = ladder.build_rung(name, smoke=smoke, qubits=qubits,
                                       device=device, max_unique=max_unique)
  t0 = time.perf_counter()
  for _ in range(WARMUP_STEPS):
    loss, _ = train_step()
  _sync(device)
  warmup_s = time.perf_counter() - t0
  t0 = time.perf_counter()
  for _ in range(steps):
    loss, _ = train_step()
  _sync(device)
  dt = time.perf_counter() - t0
  result = {"rung": name, "n": h.e_inference.energy.num_bits, **META[name],
            **train_step.meta, "steps": steps, "steps_per_sec": steps / dt,
            "warmup_s": warmup_s, "final_loss": float(loss)}
  if max_unique is not None:
    result["max_unique"] = max_unique
  return result


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--rung", default=None, choices=ladder.RUNGS)
  p.add_argument("--steps", type=int, default=3)
  p.add_argument("--smoke", action="store_true")
  p.add_argument("--qubits", type=int, default=None,
                 help="override the rung's qubit count")
  p.add_argument("--max-unique", type=int, default=None,
                 help="override the rung's unique-sample cap")
  p.add_argument("--device", default=None,
                 help="torch device (default: the CUDA card)")
  p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                 help="process-group backend under torch.distributed.run")
  args = p.parse_args(argv)
  if "RANK" in os.environ:
    topology.initialize_distributed(backend=args.backend,
                                    device=topology.local_device(args.device))
  rank = dist.get_rank() if dist.is_initialized() else 0
  failed = 0
  for name in [args.rung] if args.rung else ladder.RUNGS:
    try:
      result = run_rung(name, args.steps, args.smoke, args.qubits,
                        args.max_unique, args.device)
      if dist.is_initialized():
        result["ranks"] = dist.get_world_size()
    except Exception as e:  # noqa: BLE001 -- reported as the rung's line
      result = {"rung": name, "error": f"{type(e).__name__}: {e}"}
      failed += 1
    if rank == 0:
      print(json.dumps(result), flush=True)
  if dist.is_initialized():
    dist.destroy_process_group()
  return 1 if failed else 0


if __name__ == "__main__":
  sys.exit(main())
