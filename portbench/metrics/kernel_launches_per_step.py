"""Launches a traced step, the sum of the port's kernel wrappers' launch
counters (`kernels/`) over the traced steps."""


def read(ctx):
  t = ctx.trace
  if t is None:
    return None
  total = sum(t["launches"].values())
  return total / t["steps"] if total else None
