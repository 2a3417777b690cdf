"""K1 `axis2_apply` alone: the sum of its calls' least times over their
device time in the traced steps."""

from portbench import roofline


def read(ctx):
  return roofline.share_pct(ctx.trace, ("axis2_apply",))
