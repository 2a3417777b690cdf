"""The readings a cell's limits are set from, on the card at the cell's own
size, in one process (the benchmark's own runs never run this):

  sound     the program's first steps against the reference, a seed each;
            their largest reading of each number is its lower reading;
  control   the reference itself in the program's place, in float32 with
            TF32 matrix products (the nearest precision below the
            configuration's float32 with TF32 off), against the float64
            reference, on the first seeds' weights and draws;
  <fault>   the program with a fault of `faults` planted, a seed each.

    python3 -m portbench.calibrate --workload <cell> [--seeds 12]
        [--control 3] [--faults 3] [--first-seed N] [--out FILE]

Prints a JSON line a reading and one summary line: for each number the
lower reading, and the least reading of the control and of each fault.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import torch

from portbench import compare
from portbench import faults as faults_lib
from portbench import harness
from portbench import registry


def free(device) -> None:
  gc.collect()
  if device.type == "cuda":
    torch.cuda.empty_cache()


def readings(cell, seed, device, fault=None) -> dict:
  """One program run's readings (set-up and its first steps, then the
  check), with `fault` planted, and what the check needs again."""
  with faults_lib.FAULTS[fault]() if fault else contextlib.nullcontext():
    step, record, states, initial = harness.set_up(cell, seed, device)
  del step
  free(device)
  t0 = time.perf_counter()
  values = harness.check(cell, record, states, initial, device)
  values["reference_s"] = time.perf_counter() - t0
  free(device)
  return values, states, initial


def calibrate(cell, seeds, control: int, fault_seeds: int, device,
              emit=print) -> dict:
  rows = []

  def add(kind, seed, values):
    row = {"kind": kind, "seed": seed, **values}
    rows.append(row)
    emit(json.dumps(row))

  kept = []
  for seed in seeds:
    values, states, initial = readings(cell, seed, device)
    add("sound", seed, values)
    if len(kept) < control:
      kept.append((seed, states, initial))
  ref = registry.reference(cell.traffic["loss"])
  for seed, states, initial in kept:
    got = ref.follow(cell.config, cell.traffic, initial, states, device,
                     torch.float32, tf32=True)
    want = ref.follow(cell.config, cell.traffic, initial, states, device,
                      points=got["points"])
    start = harness.flat([torch.as_tensor(initial[name]) for name, _ in
                          ref.leaf_shapes(cell.config)])
    add("control", seed, compare.readings(got, want, start))
    free(device)
  for fault in faults_lib.RUN:
    for seed in seeds[:fault_seeds]:
      values, _, _ = readings(cell, seed, device, fault)
      add(fault, seed, values)
  summary = {}
  for name in compare.NAMES:
    summary[name] = {"lower": max(r[name] for r in rows
                                  if r["kind"] == "sound")}
    for kind in ("control",) + faults_lib.RUN:
      got = [r[name] for r in rows if r["kind"] == kind]
      if got:
        summary[name][kind] = min(got)
  return {"workload": cell.name, "summary": summary, "rows": rows}


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seeds", type=int, default=12)
  p.add_argument("--control", type=int, default=3)
  p.add_argument("--faults", type=int, default=3)
  p.add_argument("--first-seed", type=int, default=3_000_000_000)
  p.add_argument("--out", default=None)
  args = p.parse_args(argv)
  if not torch.cuda.is_available():
    harness.log("calibrate: needs the CUDA card")
    return 3
  registry.check_program()
  cell = registry.load_cell(args.workload)
  torch.backends.cuda.matmul.allow_tf32 = cell.config["precision"]["tf32"]
  torch.backends.cudnn.allow_tf32 = cell.config["precision"]["tf32"]
  seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
  result = calibrate(cell, seeds, args.control, args.faults,
                     torch.device("cuda"))
  line = json.dumps({"workload": cell.name, "card": harness.card(),
                     "summary": result["summary"]})
  print(line, flush=True)
  if args.out:
    with open(args.out, "w") as f:
      json.dump(result, f, indent=1)
  return 0


if __name__ == "__main__":
  sys.exit(main())
