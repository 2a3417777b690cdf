"""Where a VQT train step's device time goes, from one torch.profiler trace.

    python -m qhbmlib_tpu_torch.benchmarks.step_profile [--trace-dir DIR]

For each of the port's bench workloads (`bench.WORKLOADS`) it builds the
train step (`bench.build_train_step`), takes one warm-up step, then traces
STEPS steps inside one `record_function` region that ends in a
synchronize.  From the exported Chrome trace: the busy share, the union of
the device intervals (kernels, copies, sets) inside the region over the
region's wall time -- the profiler stretches the wall, so this is a lower
bound for an untraced step -- and the device milliseconds per step of the
TOP kernels by name (the rest summed).  Prints one JSON line a workload, with the card's
name and power limit.  Needs the CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys

import torch

from qhbmlib_tpu_torch import bench

REGION = "qhbm_train_steps"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STEPS = 3  # traced steps a workload
TOP = 12  # kernels reported by name; the rest are summed


def union_us(intervals) -> float:
  """Total length of the union of (start, end) intervals."""
  total, end = 0.0, float("-inf")
  for s, e in sorted(intervals):
    if e > end:
      total += e - max(s, end)
      end = e
  return total


def kernel_name(name: str) -> str:
  """A trace's kernel name without return type, anonymous namespace and
  arguments: `(anonymous namespace)::axis_apply_kernel<128>(float const*,
  ...)` -> `axis_apply_kernel<128>`, whatever namespace the arguments'
  types are in."""
  head = name.replace("(anonymous namespace)::", "").removeprefix("void ")
  m = re.match(r"([\w:]+(?:<[^()]*>)?)", head)
  return m.group(1) if m else head[:60]


def breakdown(events, steps: int) -> dict:
  """Busy share and per-kernel device ms a step of the REGION in a Chrome
  trace's event list."""
  region = next(e for e in events if e.get("name") == REGION
                and e.get("cat") == "user_annotation")
  t0, t1 = region["ts"], region["ts"] + region["dur"]
  dev = [e for e in events if e.get("cat") in DEVICE_CATS
         and t0 <= e["ts"] <= t1]
  by_name = collections.Counter()
  for e in dev:
    if e["cat"] == "kernel":
      by_name[kernel_name(e["name"])] += e["dur"]
  ranked = by_name.most_common()
  per_step = {k: v / 1e3 / steps for k, v in ranked[:TOP]}
  if len(ranked) > TOP:
    per_step["(other kernels)"] = sum(v for _, v in ranked[TOP:]) / 1e3 / steps
  return {
      "region_ms_per_step": (t1 - t0) / 1e3 / steps,
      "busy_share": union_us((e["ts"], e["ts"] + e["dur"]) for e in dev) /
                    (t1 - t0),
      "kernel_ms_per_step": per_step,
  }


def profile_workload(name: str, trace_dir: str) -> dict:
  device = torch.device("cuda")
  _, _, train_step = bench.build_train_step(bench.WORKLOADS[name], device)
  train_step()  # warm-up: builds the kernels
  torch.cuda.synchronize()
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    with torch.profiler.record_function(REGION):
      for _ in range(STEPS):
        train_step()
      torch.cuda.synchronize()
  os.makedirs(trace_dir, exist_ok=True)
  path = os.path.join(trace_dir, f"step_profile_{name}.json")
  prof.export_chrome_trace(path)
  with open(path) as f:
    events = json.load(f)["traceEvents"]
  return {"workload": name, "steps": STEPS, **breakdown(events, STEPS),
          "trace": path, "card": bench.card(device)}


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--trace-dir", default="chiprun_out")
  args = p.parse_args(argv)
  if not torch.cuda.is_available():
    sys.exit("step_profile: needs the CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  for name in bench.WORKLOADS:
    print(json.dumps(profile_workload(name, args.trace_dir)), flush=True)


if __name__ == "__main__":
  main()
