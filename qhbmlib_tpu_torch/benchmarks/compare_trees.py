"""Times this tree of the port against another tree on one card, in turns.

    python -m qhbmlib_tpu_torch.benchmarks.compare_trees OTHER \
        [--what kernels|bench|pauli|train16q] [--phases phase_k4,...] \
        [--repeats R] [--out DIR]

OTHER is an unpacked tree of another commit (or a variant of this one),
e.g.

    mkdir -p build/parent && git archive <commit> qhbmlib_tpu_torch \
        chip_smoke.py native | tar -x -C build/parent

(`native/` holds the f64 oracle's source, which the bench builds.)

The trees run in turns, other, this, this, other (R times over), each in a
subprocess whose working directory is the tree, so it imports that tree's
package and builds that tree's kernels (both trees build first, at once).
`--what kernels` runs THIS tree's `chip_smoke.py` phases (loaded by path
after the tree's package is imported, so both trees are checked and timed
alike), by default `phase_k4` (K4's `axis_apply` views) and
`phase_single_kernels` (K3 / K2 at 20q/4L and 16q/4L).  `--what bench`
runs each tree's own `python -m qhbmlib_tpu_torch.bench --steps 8`;
`--what pauli` only its PauliSum expectations/s at 20q
(`bench.measure_pauli_expectations`, whose host-clock spread needs more
turns than one bench run gives); `--what train16q` only the 16q/4L/500/64
train step's steps/s over TRAIN_STEPS steps (`bench.run_workload`; a
host-bound step, whose spread also needs many turns).  Each run's output goes to
DIR/<turn>_<tree>.log; its [kernels] and [check] lines, or its last line
(the bench's JSON, the expectations/s), are printed.  Needs the CUDA card.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
PHASES = "phase_k4,phase_single_kernels"
RUN_PHASES = """
import importlib.util
import torch
import qhbmlib_tpu_torch  # the working directory's tree
spec = importlib.util.spec_from_file_location("smoke", {smoke!r})
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print("package:", qhbmlib_tpu_torch.__file__, flush=True)
for name in {phases!r}:
  getattr(smoke, name)(torch.device("cuda:0"))
"""
BUILD = "from qhbmlib_tpu_torch.ops import _cuda; _cuda.build()"
TRAIN_STEPS = 20
TRAIN16Q = f"""
import torch
from qhbmlib_tpu_torch import bench
from qhbmlib_tpu_torch.benchmarks import step_profile
torch.backends.cuda.matmul.allow_tf32 = False
print(bench.run_workload("16q", step_profile.WORKLOADS["16q"], {TRAIN_STEPS},
                         torch.device("cuda")))
"""
PAULI = """
import torch
from qhbmlib_tpu_torch import bench
torch.backends.cuda.matmul.allow_tf32 = False
print(bench.measure_pauli_expectations(bench.WORKLOADS["20q"],
                                       torch.device("cuda")))
"""


def command(what: str, phases: str = PHASES):
  if what == "bench":
    return [sys.executable, "-m", "qhbmlib_tpu_torch.bench", "--steps", "8"]
  if what == "pauli":
    return [sys.executable, "-c", PAULI]
  if what == "train16q":
    return [sys.executable, "-c", TRAIN16Q]
  code = RUN_PHASES.format(smoke=str(ROOT / "chip_smoke.py"),
                           phases=phases.split(","))
  return [sys.executable, "-c", code]


def shown(what: str, out: str) -> str:
  lines = out.splitlines()
  if what in ("bench", "pauli", "train16q"):
    return lines[-1] if lines else ""
  return "\n".join(x for x in lines if x.startswith(("[kernels]", "[check]")))


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("other", type=pathlib.Path)
  p.add_argument("--what", choices=("kernels", "bench", "pauli", "train16q"),
                 default="kernels")
  p.add_argument("--phases", default=PHASES)
  p.add_argument("--repeats", type=int, default=1)
  p.add_argument("--out", type=pathlib.Path,
                 default=ROOT / "build" / "compare_trees")
  args = p.parse_args(argv)
  trees = {"other": args.other.resolve(), "this": ROOT}
  args.out.mkdir(parents=True, exist_ok=True)
  builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree)
            for tree in trees.values()]
  if any(b.wait() for b in builds):
    sys.exit("compare_trees: a tree's kernels did not build")
  failed = 0
  order = ("other", "this", "this", "other") * args.repeats
  for turn, name in enumerate(order):
    proc = subprocess.run(command(args.what, args.phases), cwd=trees[name],
                          capture_output=True, text=True, check=False,
                          env=dict(os.environ, PYTHONPATH=""))
    (args.out / f"{turn}_{name}.log").write_text(proc.stdout + proc.stderr)
    print(f"== turn {turn}: {name} ({trees[name]}), rc {proc.returncode}")
    print(shown(args.what, proc.stdout), flush=True)
    if proc.returncode:
      failed += 1
      print(proc.stderr[-3000:], flush=True)
  return 1 if failed else 0


if __name__ == "__main__":
  sys.exit(main())
