"""Where a VQT train step's device time goes, from one torch.profiler trace.

    python -m qhbmlib_tpu_torch.benchmarks.step_profile [--trace-dir DIR]

For each of the port's bench workloads (`bench.WORKLOADS`) it builds the
train step (`bench.build_train_step`), takes one warm-up step, then traces
STEPS steps inside one `record_function` region that ends in a
synchronize.  From the exported Chrome trace: the busy share, the union of
the device intervals (kernels, copies, sets) inside the region over the
region's wall time -- the profiler stretches the wall, so this is a lower
bound for an untraced step -- and the device milliseconds per step of the
TOP kernels by name (the rest summed).  Then the same for SINGLE_CALLS
single-state value-and-gradient calls at 20q/4L (`adjoint.expectation` and
its backward: K3, then K2), with the call's host time split by its parts
(`host_split`): each of SINGLE_SPANS traced as a region of its own, and the
CUDA runtime's copies, synchronizations and launches.  Prints one JSON line
a workload, with the card's name and power limit.  Needs the CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import os
import re
import sys

import numpy as np
import torch

from qhbmlib_tpu_torch import bench
from qhbmlib_tpu_torch.models import circuit_utils
from qhbmlib_tpu_torch.ops import adjoint
from qhbmlib_tpu_torch.ops import hopper_adjoint
from qhbmlib_tpu_torch.ops import hopper_sv
from qhbmlib_tpu_torch.ops import paulis
from qhbmlib_tpu_torch.ops import statevector as sv

REGION = "qhbm_train_steps"
SINGLE_REGION = "qhbm_single_state"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
STEPS = 3  # traced steps a workload
SINGLE_CALLS = 3  # traced single-state calls
TOP = 12  # kernels reported by name; the rest are summed
# The single-state call's host parts, in call order: (module, function).
SINGLE_SPANS = (
    (hopper_sv, "host_values"), (hopper_sv, "forward_table"),
    (hopper_sv, "state_buffer"), (hopper_sv, "launch_circuit_forward"),
    (sv, "expectation_terms"), (sv, "apply_pauli_sum"),
    (hopper_adjoint, "sweep_table"), (hopper_adjoint, "launch_adjoint_sweep"),
    (hopper_adjoint, "sweep_grads"))
# CUDA runtime calls reported in the split: copies, syncs, launches.
RUNTIME_CALLS = ("cudaMemcpyAsync", "cudaStreamSynchronize",
                 "cudaDeviceSynchronize", "cudaLaunchCooperativeKernel",
                 "cudaLaunchKernel")


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


def region_of(events, name: str):
  """(start, end) in us of the annotated region `name` of a Chrome trace."""
  region = next(e for e in events if e.get("name") == name
                and e.get("cat") == "user_annotation")
  return region["ts"], region["ts"] + region["dur"]


def breakdown(events, steps: int, name: str = REGION) -> dict:
  """Busy share and per-kernel device ms a step of the region `name` in a
  Chrome trace's event list."""
  t0, t1 = region_of(events, name)
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


def host_split(events, calls: int, name: str = SINGLE_REGION) -> dict:
  """Host ms a call inside the region `name`: each SINGLE_SPANS function's
  own annotated span (the union of its intervals), the CUDA runtime calls
  of RUNTIME_CALLS (summed, with their count a call), and the rest of the
  region's wall time outside every span."""
  t0, t1 = region_of(events, name)
  inside = [e for e in events if t0 <= e.get("ts", -1) <= t1]
  spans = {}
  covered = []
  for _, fn in SINGLE_SPANS:
    iv = [(e["ts"], e["ts"] + e["dur"]) for e in inside
          if e.get("cat") == "user_annotation" and e.get("name") == fn]
    spans[fn] = union_us(iv) / 1e3 / calls
    covered += iv
  runtime = {}
  for call in RUNTIME_CALLS:
    durs = [e["dur"] for e in inside if e.get("cat") in RUNTIME_CATS
            and e.get("name") == call]
    if durs:
      runtime[call] = {"ms": sum(durs) / 1e3 / calls,
                       "count": len(durs) / calls}
  return {"call_ms": (t1 - t0) / 1e3 / calls, "spans_ms": spans,
          "runtime_ms": runtime,
          "rest_ms": ((t1 - t0) - union_us(covered)) / 1e3 / calls}


@contextlib.contextmanager
def traced_spans(spans=SINGLE_SPANS):
  """Runs each (module, function) of `spans` inside a record_function of its
  name while the context is open (the modules call them by module
  attribute, so the wrappers take effect), then puts the originals back."""
  saved = []
  for mod, fn in spans:
    orig = getattr(mod, fn)

    @functools.wraps(orig)
    def wrapper(*args, _orig=orig, _fn=fn, **kwargs):
      with torch.profiler.record_function(_fn):
        return _orig(*args, **kwargs)

    saved.append((mod, fn, orig))
    setattr(mod, fn, wrapper)
  try:
    yield
  finally:
    for mod, fn, orig in saved:
      setattr(mod, fn, orig)


def profile_single(trace_dir: str, device="cuda", n: int = 20,
                   layers: int = 4) -> dict:
  """SINGLE_CALLS single-state value-and-gradient calls (the TFIM of one
  seeded random state, `adjoint.expectation`, then its backward) traced in
  one region after a warm-up call: the region's breakdown and host split."""
  device = torch.device(device)
  pqc = circuit_utils.hardware_efficient_ansatz(n, layers)
  rng = np.random.RandomState(0)
  values = torch.tensor(rng.uniform(0, 2, pqc.num_symbols),
                        dtype=torch.float32, device=device)
  shape = sv.state_shape(n)
  x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
  state = torch.tensor(x / np.linalg.norm(x), dtype=torch.complex64,
                       device=device)
  op = paulis.tfim_1d(n, device=device)

  def call():
    v = values.clone().requires_grad_(True)
    adjoint.expectation(pqc, v, state, op).backward()
    return v.grad

  call()  # warm-up: builds the kernels
  if device.type == "cuda":
    torch.cuda.synchronize()
  acts = [torch.profiler.ProfilerActivity.CPU]
  if device.type == "cuda":
    acts.append(torch.profiler.ProfilerActivity.CUDA)
  with traced_spans(), torch.profiler.profile(activities=acts) as prof:
    with torch.profiler.record_function(SINGLE_REGION):
      for _ in range(SINGLE_CALLS):
        call()
      if device.type == "cuda":
        torch.cuda.synchronize()
  os.makedirs(trace_dir, exist_ok=True)
  path = os.path.join(trace_dir, f"step_profile_single_{n}q.json")
  prof.export_chrome_trace(path)
  with open(path) as f:
    events = json.load(f)["traceEvents"]
  return {"workload": f"single {n}q/{layers}L", "calls": SINGLE_CALLS,
          **breakdown(events, SINGLE_CALLS, SINGLE_REGION),
          "host": host_split(events, SINGLE_CALLS), "trace": path,
          "card": bench.card(device)}


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
  print(json.dumps(profile_single(args.trace_dir)), flush=True)


if __name__ == "__main__":
  main()
