"""The 95th percentile of the host-clock times of all the window's steps,
in ms (numpy's linear interpolation between order statistics)."""

import numpy as np


def read(ctx):
  return float(np.percentile(np.asarray(ctx.step_s), 95.0)) * 1e3
