"""Train steps completed in the window over the window's seconds (host
clock; each step ends when its loss reaches the host)."""


def read(ctx):
  return len(ctx.step_s) / ctx.window_s
