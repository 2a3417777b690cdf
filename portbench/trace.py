"""The traced steps: torch.profiler over a few train steps, and the
arithmetic on its Chrome trace.

Copied from the port's `benchmarks/step_profile.py` (`kernel_name`, the
busy share as the union of the intervals of kernels, copies and sets over
the region's wall, and the match of a launch to its device work by
correlation id), with two additions:

  * each kernel wrapper of `kernels/` runs inside a range of its own
    ("portbench.kernel.<name>") and its call's work is recorded from its
    arguments, so each wrapper's device time and least time are known;
  * the device's idle gaps are named by what the host was doing: the
    step's part, a range the program of the cell's loss names
    "<loss>.<part>" ("vqt.loss", ...), and the innermost host operation
    running at the gap's middle.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import importlib
import inspect
import json
import os
import re
import tempfile
from typing import Dict, List, Optional

import torch

REGION = "portbench.window"
KERNEL_RANGE = "portbench.kernel."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
TOP = 10


def merged(intervals):
  """The union of (start, end) intervals as sorted disjoint intervals."""
  out = []
  for s, e in sorted(intervals):
    if out and s <= out[-1][1]:
      out[-1][1] = max(out[-1][1], e)
    else:
      out.append([s, e])
  return out


def kernel_name(name: str) -> str:
  """A trace's kernel name without return type, anonymous namespace and
  arguments: `(anonymous namespace)::axis_apply_kernel<128>(float const*,
  ...)` -> `axis_apply_kernel<128>`."""
  head = name.replace("(anonymous namespace)::", "").removeprefix("void ")
  m = re.match(r"([\w:]+(?:<[^()]*>)?)", head)
  return m.group(1) if m else head[:60]


@dataclasses.dataclass
class Kernel:
  """A kernel wrapper of the port (`kernels/<name>.py`)."""
  name: str
  module: object
  attr: str
  work: object

  @property
  def fn(self):
    return getattr(self.module, self.attr)


def load_kernels(names) -> List[Kernel]:
  out = []
  for name in names:
    spec = importlib.import_module(f"portbench.kernels.{name}")
    module = importlib.import_module(spec.WRAPPER[0])
    out.append(Kernel(name, module, spec.WRAPPER[1], spec.work))
  return out


def launches(kernels: List[Kernel]) -> Dict[str, int]:
  """Each wrapper's launch counter (the port increments it a launch)."""
  return {k.name: int(k.fn.launches) for k in kernels}


@contextlib.contextmanager
def wrapped(kernels: List[Kernel], calls: list):
  """While open, each wrapper runs inside its own profiler range and
  appends (name, work) to `calls`.  The port calls its wrappers by module
  attribute or module global at call time, so the wrappers take effect;
  its counters (`<wrapper>.launches`, read through the same name) carry
  over both ways."""
  saved = []
  for k in kernels:
    orig = k.fn
    sig = inspect.signature(orig)

    @functools.wraps(orig)
    def wrapper(*args, _orig=orig, _k=k, _sig=sig, **kwargs):
      bound = _sig.bind(*args, **kwargs)
      bound.apply_defaults()
      calls.append((_k.name, _k.work(bound.arguments)))
      with torch.profiler.record_function(KERNEL_RANGE + _k.name):
        return _orig(*args, **kwargs)

    wrapper.launches = orig.launches
    saved.append((k, orig, wrapper))
    setattr(k.module, k.attr, wrapper)
  try:
    yield
  finally:
    for k, orig, wrapper in saved:
      orig.launches = wrapper.launches
      setattr(k.module, k.attr, orig)


def profile(step, steps: int, kernels: List[Kernel], device,
            loss: Optional[str] = None) -> dict:
  """Traces `steps` train steps (each ending when its loss reaches the
  host) in one region that ends in a synchronize; returns the trace's
  reading (`read`, its idle gaps labelled by the parts of the step of
  `loss`) with each wrapper's calls and launches."""
  calls: list = []
  before = launches(kernels)
  acts = [torch.profiler.ProfilerActivity.CPU]
  if device.type == "cuda":
    acts.append(torch.profiler.ProfilerActivity.CUDA)
  step.spans = True
  try:
    with wrapped(kernels, calls), torch.profiler.profile(
        activities=acts) as prof:
      with torch.profiler.record_function(REGION):
        for _ in range(steps):
          float(step())
        if device.type == "cuda":
          torch.cuda.synchronize(device)
  finally:
    step.spans = False
  after = launches(kernels)
  fd, path = tempfile.mkstemp(suffix=".json")
  os.close(fd)
  try:
    prof.export_chrome_trace(path)
    with open(path) as f:
      events = json.load(f)["traceEvents"]
  finally:
    os.remove(path)
  out = read(events, [k.name for k in kernels], loss)
  out["steps"] = steps
  out["calls"] = calls
  out["launches"] = {k: after[k] - before[k] for k in after}
  return out


def _innermost(host, starts, t) -> Optional[dict]:
  """The innermost host event running at time t: of nested events, the
  latest started one that has not ended."""
  i = bisect.bisect_right(starts, t) - 1
  while i >= 0:
    e = host[i]
    if e["ts"] + e["dur"] >= t:
      return e
    i -= 1
  return None


class _Threads:
  """Host events by thread, for 'what was running at time t'."""

  def __init__(self, events):
    by_tid = collections.defaultdict(list)
    for e in events:
      by_tid[e.get("tid")].append(e)
    self.lists = {}
    for tid, evs in by_tid.items():
      evs.sort(key=lambda e: (e["ts"], -e["dur"]))
      self.lists[tid] = (evs, [e["ts"] for e in evs])

  def running(self, t, tid=None) -> Optional[dict]:
    """The innermost event running at t on thread `tid`, or of all
    threads' innermost ones the latest started."""
    found = [_innermost(evs, starts, t) for k, (evs, starts)
             in self.lists.items() if tid is None or k == tid]
    found = [e for e in found if e is not None]
    return max(found, key=lambda e: e["ts"]) if found else None


def read(events, kernel_names, loss: Optional[str] = None) -> dict:
  """The region's reading: its wall and busy seconds, device seconds by
  kernel name, each wrapper's device seconds (the device work launched
  inside its ranges, on whatever thread: the backward runs on autograd's,
  matched by correlation id) and the idle gaps' seconds by what the host
  was doing: the step's part (a range "<loss>.<part>"; "between steps"
  outside them, and throughout without a `loss`) and the innermost other
  host operation."""
  region = next(e for e in events if e.get("name") == REGION
                and e.get("cat") == "user_annotation")
  t0, t1 = region["ts"], region["ts"] + region["dur"]
  dev = [e for e in events if e.get("cat") in DEVICE_CATS
         and t0 <= e["ts"] <= t1]
  busy = merged((e["ts"], e["ts"] + e["dur"]) for e in dev)
  by_name = collections.Counter()
  for e in dev:
    by_name[kernel_name(e["name"]) if e["cat"] == "kernel"
            else e["name"]] += e["dur"]

  host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e
          and e["ts"] <= t1 and e["ts"] + e["dur"] >= t0]
  ranges = _Threads([e for e in host if e["cat"] == "user_annotation"
                     and e["name"].startswith(KERNEL_RANGE)])
  by_corr = {e["args"]["correlation"]: e for e in dev
             if "correlation" in e.get("args", {})}
  wrapper_us = collections.Counter()
  for e in host:
    corr = e.get("args", {}).get("correlation")
    if e["cat"] not in RUNTIME_CATS or corr not in by_corr:
      continue
    r = ranges.running(e["ts"], e.get("tid"))
    if r is not None:
      wrapper_us[r["name"][len(KERNEL_RANGE):]] += by_corr[corr]["dur"]

  part_prefix = () if loss is None else (f"{loss}.",)
  parts = _Threads([e for e in host if e["cat"] == "user_annotation"
                    and e["name"].startswith(part_prefix)])
  inner = _Threads([e for e in host if not (
      e["cat"] == "user_annotation" and e["name"].startswith(
          part_prefix + (REGION,)))])
  gaps = collections.Counter()
  edges = [t0] + [x for iv in busy for x in iv] + [t1]
  for s, e in zip(edges[::2], edges[1::2]):
    if e <= s:
      continue
    mid = 0.5 * (s + e)
    part = parts.running(mid)
    op = inner.running(mid)
    label = (part["name"] if part else "between steps") + " / " + (
        op["name"] if op else "no host op")
    gaps[label] += e - s
  return {
      "window_s": (t1 - t0) / 1e6,
      "busy_s": sum(e - s for s, e in busy) / 1e6,
      "device_ops": [[k, v / 1e6] for k, v in by_name.most_common(TOP)],
      "idle_gaps": [[k, v / 1e6] for k, v in gaps.most_common(TOP)],
      "wrapper_s": {k: wrapper_us.get(k, 0) / 1e6 for k in kernel_names},
  }
