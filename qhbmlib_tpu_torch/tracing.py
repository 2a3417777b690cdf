"""Named spans at the port's layer boundaries, on the profiler's clock.

`span(name)` is on only while a torch profiler records
(`torch.profiler.profile`, the experiment harness's
`logging.profiler_steps`): it then opens a `record_function` range, so
the span sits in the profiler's trace beside the kernels it launched,
and adds to in-memory totals a name: calls, inclusive time and self time
(inclusive time less the time of the spans opened inside it on the same
thread; the backward runs on autograd's thread and keeps its own stack).
With no profiler recording it is one global read and a shared no-op
context.  `totals()` reads the totals, `reset()` clears them; the
profiler's trace is the export.  A span's time includes the profiler's
own cost for each operation it records inside the span.

Names start with "qhbm.": "qhbm.<layer>.<part>" for host work, and
"qhbm.sync.<site>" around each call at which the host waits for the
device, so a layer's self time is host work and the waits are counted
once.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Dict

import torch
from torch.autograd import profiler as _profiler

PREFIX = "qhbm."

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_totals: Dict[str, list] = {}  # name -> [calls, inclusive ns, self ns]
_local = threading.local()


class _Span:
  """One open span: its profiler range, start and its children's ns."""

  __slots__ = ("name", "_range", "_start", "child_ns")

  def __init__(self, name: str):
    self.name = name

  def __enter__(self):
    stack = getattr(_local, "stack", None)
    if stack is None:
      stack = _local.stack = []
    self._range = torch.profiler.record_function(self.name)
    self._range.__enter__()
    self.child_ns = 0
    stack.append(self)
    self._start = time.perf_counter_ns()
    return self

  def __exit__(self, *exc):
    took = time.perf_counter_ns() - self._start
    stack = _local.stack
    while stack and stack.pop() is not self:
      pass
    if stack:
      stack[-1].child_ns += took
    with _lock:
      row = _totals.setdefault(self.name, [0, 0, 0])
      row[0] += 1
      row[1] += took
      row[2] += took - self.child_ns
    self._range.__exit__(*exc)
    return False


def span(name: str):
  """A context manager: the span `name` while a profiler records, else a
  shared no-op."""
  return _Span(name) if _profiler._is_profiler_enabled else _OFF


def spanned(name: str):
  """Decorator: each call of the function runs inside `span(name)`."""

  def wrap(fn):
    @functools.wraps(fn)
    def call(*args, **kwargs):
      if not _profiler._is_profiler_enabled:
        return fn(*args, **kwargs)
      with _Span(name):
        return fn(*args, **kwargs)

    return call

  return wrap


def totals() -> Dict[str, dict]:
  """{name: {"calls", "total_ms", "self_ms"}} of every span closed since
  the last `reset()`, a copy."""
  with _lock:
    return {name: {"calls": calls, "total_ms": total / 1e6,
                   "self_ms": own / 1e6}
            for name, (calls, total, own) in _totals.items()}


def reset() -> None:
  with _lock:
    _totals.clear()
