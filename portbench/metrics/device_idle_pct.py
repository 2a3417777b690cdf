"""100 x (1 - the union of the device intervals of kernels, copies and sets
/ the traced window's wall), over the traced steps."""


def read(ctx):
  t = ctx.trace
  if t is None or t["busy_s"] <= 0:
    return None
  return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
