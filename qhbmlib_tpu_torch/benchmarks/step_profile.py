"""Where a VQT train step's device time goes, from one torch.profiler trace.

    python -m qhbmlib_tpu_torch.benchmarks.step_profile [--trace-dir DIR]
        [--only WORKLOAD ...]

For each workload of WORKLOADS (the port's bench workloads, 24q and 20q,
and 16q/4L/500/64, whose lone row block (7,2) takes `axis_apply`'s N < 16
route) it builds the train step (`bench.build_train_step`), and for the QMHL
steps of QMHL_WORKLOADS ("qmhl 24q", `bench.build_qmhl_step`; "r2 8q"
and "r2 11q", the JAX ladder's r2 rung, and "r5 28q", its r5 rung,
`ladder.build_rung`), for the QAIA steps of QAIA_WORKLOADS ("qaia 20q",
"qaia heis 20q": `bench.build_qaia_step`, the TFIM or the Heisenberg
chain) and for the VQT rungs of RUNG_WORKLOADS ("r3 16q", the JAX ladder's
r3 rung: parameter-shift gradients, its step also split by SHIFT_SPANS
into host folds, shared stages, per-row corrections and sampling,
`span_split`) and for the experiment harness's steps of HARNESS_WORKLOADS
("harness 8q": `baselines.train`'s vanilla Adam step on its default
config at an 8-site TFIM ring, with its per-step metrics; "harness natural
8q": its natural-gradient step, the information matrix's 644 shifted
<K_copy> evaluations and the solve, one step traced), takes one
warm-up step, then traces STEPS steps (or the workload's own `steps`)
inside one `record_function` region
that ends in a synchronize.  From the exported Chrome trace: the busy
share, the union of the device intervals (kernels, copies, sets) inside
the region over the region's wall time -- the profiler stretches the wall,
so this is a lower bound for an untraced step -- and the device
milliseconds per step of the TOP kernels by name (the rest summed).  Then
the same for SINGLE_CALLS single-state value-and-gradient calls at 20q/4L
(`adjoint.expectation` and its backward: K3, then K2), with the call's host
time split by its parts (`host_split`): each of SINGLE_SPANS traced as a
region of its own, and the CUDA runtime's copies, synchronizations and
launches.  Prints one JSON line a workload, with the card's name and power
limit.  Needs the CUDA card.
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
from qhbmlib_tpu_torch.baselines import config as harness_config
from qhbmlib_tpu_torch.baselines import train as harness
from qhbmlib_tpu_torch.benchmarks import ladder
from qhbmlib_tpu_torch.inference import qnn
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
# The profiled train steps: the bench's two, and the 20q workload's depth
# and draw at 16 qubits.
WORKLOADS = {**bench.WORKLOADS,
             "16q": dict(n=16, layers=4, samples=500, max_unique=64)}
# The profiled QMHL steps: the bench's (`bench.build_qmhl_step`), the r2
# rung's (`ladder.build_rung`) at its own 8 qubits and at 11 (its thermal
# data's 2^n eigenvectors are the batch), and the r5 rung's at its own 28
# qubits (GWG chains, 4 data states of 2 GB).
QMHL_WORKLOADS = {"qmhl 24q": bench.QMHL_WORKLOAD,
                  "r2 8q": dict(rung="r2_heis8_qmhl", qubits=8),
                  "r2 11q": dict(rung="r2_heis8_qmhl", qubits=11),
                  "r5 28q": dict(rung="r5_gwg28_qmhl", qubits=28)}
# The profiled QAIA VQT steps (`bench.QAIA_WORKLOADS`).
QAIA_WORKLOADS = bench.QAIA_WORKLOADS
# The profiled VQT rungs of the JAX ladder: r3 at its own 16 qubits (KOBE-2,
# 4 unique states, HEA 2L, 1000 shots, parameter-shift gradients), its
# step split by SHIFT_SPANS.
RUNG_WORKLOADS = {"r3 16q": dict(rung="r3_kobe16_vqt_shift", qubits=16)}
# The profiled steps of the experiment harness (`baselines.train`): its
# default config (KOBE-2, analytic EBM of 500 samples, HEA 7L, Adam 0.1) on
# a num_rows x num_cols TFIM ring, at the sweep's first beta.
HARNESS_WORKLOADS = {
    "harness 8q": dict(num_rows=8, num_cols=1, beta=0.5, method="vanilla"),
    "harness natural 8q": dict(num_rows=8, num_cols=1, beta=0.5,
                               method="natural", steps=1),
}
# The r3 step's parts: the host folds (`prepare_segments`) and corrections
# (`shift_corrections`), the shared stages (`apply_stage`: every forward
# stage over the whole batch, measurement suffixes included), the per-row
# corrections (`apply_correction`) and the draws with their parities
# (`_sampled_means`).
SHIFT_SPANS = ((hopper_sv, "prepare_segments"),
               (hopper_sv, "shift_corrections"), (hopper_sv, "apply_stage"),
               (hopper_sv, "apply_correction"), (qnn, "_sampled_means"))
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


def span_split(events, steps: int, spans, name: str = REGION) -> dict:
  """Per (module, function) of `spans` inside the region `name`, a step:
  its host ms (the union of its annotated intervals), the device ms of the
  kernels, copies and sets launched inside it (matched by correlation id)
  and their count; "rest" the device work launched outside every span."""
  t0, t1 = region_of(events, name)
  inside = [e for e in events if t0 <= e.get("ts", -1) <= t1]
  dev = {e["args"]["correlation"]: e for e in inside
         if e.get("cat") in DEVICE_CATS and "correlation" in e.get("args", {})}
  launches = [e for e in inside if e.get("cat") in RUNTIME_CATS
              and e.get("args", {}).get("correlation") in dev]
  out, claimed = {}, set()
  for _, fn in spans:
    iv = [(e["ts"], e["ts"] + e["dur"]) for e in inside
          if e.get("cat") == "user_annotation" and e.get("name") == fn]
    ids = {e["args"]["correlation"] for e in launches
           if any(s <= e["ts"] <= t for s, t in iv)}
    claimed |= ids
    out[fn] = {"host_ms": union_us(iv) / 1e3 / steps,
               "device_ms": sum(dev[i]["dur"] for i in ids) / 1e3 / steps,
               "launches": len(ids) / steps}
  rest = set(dev) - claimed
  out["rest"] = {"device_ms": sum(dev[i]["dur"] for i in rest) / 1e3 / steps,
                 "launches": len(rest) / steps}
  return out


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


def harness_step(cfg, device, log_dir: str):
  """The harness's train step at `cfg` of HARNESS_WORKLOADS: one step of
  `cfg["method"]` (`harness.make_train_step`, seed 42) and its per-step
  metrics (`harness.log_step`, and a natural step's `log_natural`) into
  the MetricsWriter `train_step.writer` on `log_dir`."""
  config = harness_config.get_config()
  config.dataset.num_rows = cfg["num_rows"]
  config.dataset.num_cols = cfg["num_cols"]
  config.training.method = cfg["method"]
  shards = harness.get_tfim_hamiltonian(config.dataset.bias, config, device)
  _, h = harness.get_initial_qhbm(shards, config, "qhbm", seed=42,
                                  device=device)
  optimizer = harness.get_optimizer(config.training.optimizer,
                                    config.training.learning_rate,
                                    h.parameters())
  step = harness.make_train_step(
      h, optimizer, config, target_hamiltonian=shards[0] + shards[1],
      beta=cfg["beta"], target_hamiltonian_shards=shards)
  writer = harness.MetricsWriter(log_dir, tensorboard=False)
  count = [0]

  def train_step():
    loss, grads, _, extra = step(None, count[0])
    harness.log_step(writer, config.logging, count[0], loss, h.params, grads)
    if extra is not None:
      harness.log_natural(writer, config.logging, count[0], extra)
    count[0] += 1

  train_step.writer = writer
  return train_step


def profile_workload(name: str, trace_dir: str) -> dict:
  """A warm-up step, then STEPS traced steps of the VQT workload `name` of
  WORKLOADS, QAIA_WORKLOADS or HARNESS_WORKLOADS or the QMHL workload of
  QMHL_WORKLOADS (a ladder rung where it names one): the region's
  breakdown."""
  device = torch.device("cuda")
  cfg = QMHL_WORKLOADS.get(name, RUNG_WORKLOADS.get(name, {}))
  steps = HARNESS_WORKLOADS.get(name, {}).get("steps", STEPS)
  if name in HARNESS_WORKLOADS:
    train_step = harness_step(
        HARNESS_WORKLOADS[name], device,
        os.path.join(trace_dir, f"{name.replace(' ', '_')}_metrics"))
  elif "rung" in cfg:
    _, _, train_step = ladder.build_rung(cfg["rung"], qubits=cfg["qubits"],
                                         device=device)
  elif name in QMHL_WORKLOADS:
    _, _, train_step = bench.build_qmhl_step(cfg, device)
  elif name in QAIA_WORKLOADS:
    cfg = QAIA_WORKLOADS[name]
    target = (ladder.heisenberg(cfg["n"], device=device)
              if cfg["target"] == "heisenberg" else
              paulis.tfim_1d(cfg["n"], device=device))
    _, _, train_step = bench.build_qaia_step(cfg, device, target)
  else:
    _, _, train_step = bench.build_train_step(WORKLOADS[name], device)
  train_step()  # warm-up: builds the kernels
  torch.cuda.synchronize()
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  spans = SHIFT_SPANS if name in RUNG_WORKLOADS else ()
  with traced_spans(spans), torch.profiler.profile(activities=acts) as prof:
    with torch.profiler.record_function(REGION):
      for _ in range(steps):
        train_step()
      torch.cuda.synchronize()
  os.makedirs(trace_dir, exist_ok=True)
  path = os.path.join(trace_dir,
                      f"step_profile_{name.replace(' ', '_')}.json")
  prof.export_chrome_trace(path)
  with open(path) as f:
    events = json.load(f)["traceEvents"]
  split = {"split": span_split(events, steps, spans)} if spans else {}
  return {"workload": name, "steps": steps, **breakdown(events, steps),
          **split, "trace": path, "card": bench.card(device)}


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--trace-dir", default="chiprun_out")
  p.add_argument("--only", nargs="*", metavar="WORKLOAD",
                 help="trace only these workloads (names as printed; "
                 "'single' for the single-state calls)")
  args = p.parse_args(argv)
  if not torch.cuda.is_available():
    sys.exit("step_profile: needs the CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  for name in [*WORKLOADS, *QMHL_WORKLOADS, *QAIA_WORKLOADS,
               *RUNG_WORKLOADS, *HARNESS_WORKLOADS]:
    if args.only is None or name in args.only:
      print(json.dumps(profile_workload(name, args.trace_dir)), flush=True)
      torch.cuda.empty_cache()
  if args.only is None or "single" in args.only:
    print(json.dumps(profile_single(args.trace_dir)), flush=True)


if __name__ == "__main__":
  main()
