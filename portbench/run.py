"""python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>

Runs one cell of BENCHMARK.json on the CUDA card it is started on and
prints one JSON line (`harness`).  Exits non-zero, printing no result,
without enough cards, without the port in this checkout, or if the
process loaded JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _process_start() -> float:
  """The perf_counter() reading at this process's start (/proc), so that
  set-up counts the interpreter's start too."""
  try:
    with open("/proc/self/stat") as f:
      start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
      uptime = float(f.read().split()[0])
    age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    return time.perf_counter() - max(age, 0.0)
  except (OSError, ValueError, IndexError):
    return time.perf_counter()


def _bytecode_cache() -> None:
  """Python's bytecode cache at a fixed path inside the checkout, written
  even where the environment says not to (PYTHONDONTWRITEBYTECODE): the
  first run of a checkout compiles torch's and the port's modules, later
  runs load them instead of compiling them again."""
  sys.pycache_prefix = os.path.join(
      os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
      ".pbcache", "pyc")
  sys.dont_write_bytecode = False


def main(argv=None, t_start=None) -> int:
  t_start = time.perf_counter() if t_start is None else t_start
  _bytecode_cache()
  # One process and few host threads a card: steadier host time.
  for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "4")
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seed", type=int, required=True)
  p.add_argument("--seconds", type=float, required=True)
  p.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = p.parse_args(argv)

  import torch
  from portbench import harness
  from portbench import registry

  cell = registry.load_cell(args.workload)
  if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
    harness.log(f"portbench: {args.workload} needs {cell.chips} CUDA "
                f"card(s); this machine has "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return 3
  registry.check_program()
  torch.set_num_threads(4)
  try:
    out = harness.measure(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda"), t_start)
  except harness.ForbiddenModule as e:
    harness.log(f"portbench: {e}")
    return 4
  found = harness.forbidden_modules()
  if found:
    harness.log(f"portbench: the process holds {found}")
    return 4
  harness.report(out)
  return 0


if __name__ == "__main__":
  sys.exit(main(t_start=_process_start()))
