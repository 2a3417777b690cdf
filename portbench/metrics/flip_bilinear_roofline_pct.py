"""`flip_bilinear` alone: the sum of its calls' least times over their
device time in the traced steps."""

from portbench import roofline


def read(ctx):
  return roofline.share_pct(ctx.trace, ("flip_bilinear",))
