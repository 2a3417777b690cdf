"""Every hand-kernel call of the traced steps: the sum of their least
times over their device time (`roofline.share_pct`)."""

from portbench import roofline


def read(ctx):
  return roofline.share_pct(ctx.trace)
