"""One run of one cell: set-up, the window, the traced steps, the check.

Set-up draws the weights on the device from the seed, builds the port's
train step through its public API and takes its first CHECK_STEPS steps
through the same call the window uses, recording for the check: each
step's loss, the generator state it drew from, the first gradient as the
optimizer holds it, and the parameters after those steps.  Those steps
are also the warm-up: the window finds every kernel built and every
shape seen.  The window then runs steps back to back until `--seconds`
have passed, each ending when its loss reaches the host.  With `--trace
1` a few more steps run under the profiler.  Then the program is freed
and the plain reference (`reference/`) follows the recorded steps in
float64; `compare` decides `correct`.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import resource
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from portbench import compare
from portbench import flops
from portbench import registry
from portbench import trace
from portbench import traffic

# Top-level modules the process may not hold: JAX and the JAX package, its
# harness and its benchmarks.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "qhbmlib_tpu", "baselines",
                       "benchmarks"})


# The steps the check follows: the start, then two updates (`compare`).
CHECK_STEPS = 3


class ForbiddenModule(RuntimeError):
  """The process holds JAX or the JAX package."""


def log(msg: str) -> None:
  print(msg, file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> List[str]:
  """The forbidden top-level names among `names` (the loaded modules by
  default), each compared whole."""
  names = sys.modules if names is None else names
  return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def flat(tensors) -> np.ndarray:
  return np.concatenate([t.detach().double().cpu().numpy().reshape(-1)
                         for t in tensors])


@dataclasses.dataclass
class Context:
  """What the metrics read (`metrics/`)."""
  setup_s: float
  step_s: List[float]
  window_s: float
  window_peak_bytes: Optional[int]
  step_flops: float
  trace: Optional[dict] = None


def set_up(cell, seed: int, device: torch.device):
  """(step, record, states, initial): the port's train step after its
  first CHECK_STEPS steps; their record for the check (losses, the
  first gradient as Adam holds it, the parameters after the steps and
  before each), each by the name of a trained leaf
  (`reference/<loss>.py`, `leaf_shapes`) and flat in its order; the
  generator state each drew from; every drawn leaf's initial weights
  {name: float64 array}, the trained ones and any the loss draws
  besides."""
  loss = cell.traffic["loss"]
  marks = [time.perf_counter()]
  weights = traffic.make_weights(cell.config, loss, seed, device)
  gen = traffic.draw_generator(seed, device)
  sync(device)
  marks.append(time.perf_counter())
  step = registry.program(loss).Step(
      cell.config, cell.traffic, weights, device, gen)
  marks.append(time.perf_counter())
  trained = [name for name, _ in
             registry.reference(loss).leaf_shapes(cell.config)]
  if sorted(step.named_parameters()) != sorted(trained):
    raise ValueError(f"{loss}: the program trains "
                     f"{sorted(step.named_parameters())}, the reference "
                     f"{sorted(trained)}")

  def by_name(named):
    return [named[name] for name in trained]

  states, points, losses, grad1 = [], [], [], None
  for i in range(CHECK_STEPS):
    states.append(gen.get_state())
    points.append({name: p.detach().double().cpu().numpy()
                   for name, p in step.named_parameters().items()})
    losses.append(float(step()))
    marks.append(time.perf_counter())
    if i == 0:
      try:
        grad1 = flat(by_name(step.first_gradient()))
      except KeyError:  # the optimizer holds no state: it took no step
        grad1 = None
  record = {"losses": losses, "grad1": grad1,
            "params": flat(by_name(step.named_parameters())),
            "points": points}
  initial = {name: w.detach().double().cpu().numpy() for name, w in weights}
  took = [f"{b - a:.3f}" for a, b in zip(marks, marks[1:])]
  log(f"[portbench] set-up: weights (and the CUDA context) {took[0]} s, "
      f"build {took[1]} s, first steps {', '.join(took[2:])} s")
  return step, record, states, initial


def check(cell, record, states, initial, device) -> dict:
  """The compared numbers of `record` against the reference's steps from
  the same weights and generator states, each step after the first at
  the program's parameters (`compare.readings`)."""
  ref = registry.reference(cell.traffic["loss"])
  followed = ref.follow(cell.config, cell.traffic, initial, states, device,
                        points=record["points"])
  start = np.concatenate([initial[name].reshape(-1)
                          for name, _ in ref.leaf_shapes(cell.config)])
  return compare.readings(record, followed, start)


def window(step, seconds: float, device: torch.device):
  """(step seconds, window seconds, failed steps): steps back to back until
  `seconds` have passed, each ending when its loss reaches the host."""
  step_s, failed = [], 0
  t0 = last = time.perf_counter()
  while last - t0 < seconds:
    loss = float(step())
    now = time.perf_counter()
    step_s.append(now - last)
    last = now
    failed += not math.isfinite(loss)
  sync(device)
  return step_s, last - t0, failed


def host_usage() -> str:
  """This process's CPU seconds so far and its page faults that read the
  disk: set-up is host work, so its CPU seconds follow its wall time."""
  r = resource.getrusage(resource.RUSAGE_SELF)
  return (f"cpu {r.ru_utime:.3f} user + {r.ru_stime:.3f} sys s, "
          f"{r.ru_majflt} major faults")


def card() -> str:
  """The card's name, power limit, and its SM clock, temperature and power
  draw when read (after the window)."""
  try:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,temperature.gpu,power.draw",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]
  except (OSError, IndexError, subprocess.SubprocessError):
    return "nvidia-smi unavailable"


def measure(cell, seed: int, seconds: float, traced: bool,
            device: torch.device, t_start: float) -> dict:
  """The run's result object; raises ForbiddenModule if the process holds
  a forbidden module once the window has closed."""
  torch.backends.cuda.matmul.allow_tf32 = cell.config["precision"]["tf32"]
  torch.backends.cudnn.allow_tf32 = cell.config["precision"]["tf32"]
  on_card = device.type == "cuda"
  step_flops = flops.step_flops(cell.config, cell.traffic)
  log(f"[portbench] set-up: start to the harness {time.perf_counter() - t_start:.3f} s")
  step, record, states, initial = set_up(cell, seed, device)
  sync(device)
  setup_s = time.perf_counter() - t_start
  log(f"[portbench] set-up: {host_usage()}")
  setup_peak = torch.cuda.max_memory_allocated(device) if on_card else None
  if on_card:
    torch.cuda.reset_peak_memory_stats(device)
  step_s, window_s, failed = window(step, seconds, device)
  window_peak = torch.cuda.max_memory_allocated(device) if on_card else None
  log(f"[portbench] {cell.name} seed {seed}: set-up {setup_s:.3f} s, window "
      f"{len(step_s)} steps in {window_s:.3f} s, {failed} failed")
  ctx = Context(setup_s, step_s, window_s, window_peak, step_flops)
  if traced:
    kernels = trace.load_kernels(registry.kernel_names())
    ctx.trace = trace.profile(step, cell.traffic["trace_steps"], kernels,
                              device, loss=cell.traffic["loss"])
    log(f"[portbench] traced {ctx.trace['steps']} steps: busy "
        f"{ctx.trace['busy_s']:.6f} s of {ctx.trace['window_s']:.6f} s; "
        f"launches {ctx.trace['launches']}")
  found = forbidden_modules()
  if found:
    raise ForbiddenModule(f"the process holds {found} after the window")
  del step
  gc.collect()
  if on_card:
    torch.cuda.empty_cache()
  values = check(cell, record, states, initial, device)
  checks, correct = compare.judge(values, cell.cell["limits"])
  log(f"[portbench] check: {values['left_out']} leaves left out of the "
      f"change (reference gradient under {compare.QUIET} of the median)")
  metrics = {}
  for m in (cell.per_layer if traced else cell.end_to_end):
    value = registry.metric(m["name"]).read(ctx)
    if value is not None:
      metrics[m["name"]] = {"value": value, "unit": m["unit"]}
  out = {"correct": correct, "attempted": len(step_s), "failed": failed,
         "metrics": metrics}
  if on_card:
    peaks = [p for p in (setup_peak, window_peak) if p is not None]
    out["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(device),
                     "count": cell.chips, "memory_peak_bytes": max(peaks)}
    log(f"[portbench] card: {card()}")
  else:
    out["device"] = {"platform": device.type, "kind": device.type,
                     "count": 1, "memory_peak_bytes": 0}
  if traced:
    out["device"].update(busy_s=ctx.trace["busy_s"],
                         window_s=ctx.trace["window_s"])
    out["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                        "idle_gaps": ctx.trace["idle_gaps"]}
  out["checks"] = checks
  return out


def report(out: dict) -> None:
  """Each compared number beside its limit as the last lines on stderr,
  then the result as the last line on stdout."""
  for name, c in out["checks"].items():
    log(f"check {name} {c['value']!r} limit {c['limit']!r}")
  print(json.dumps(out), flush=True)
