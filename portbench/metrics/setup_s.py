"""Seconds from the process's start to the first timed step: imports, the
CUDA context, loading the built kernels, the weights drawn on the card,
the model built, and its first steps (the warm-up, recorded for the
check)."""


def read(ctx):
  return ctx.setup_s
