"""The whole step's share of the card's peak: the model's flops a step
(`flops.step_flops`: the count of the cell's loss, `counts/<loss>.py`,
from the configuration alone) at the window's steps/s, over the dense
TF32 peak, 495 TFLOP/s (the fastest arithmetic a float32-accurate route
can use)."""

from portbench import roofline


def read(ctx):
  steps_per_s = len(ctx.step_s) / ctx.window_s
  return 100.0 * ctx.step_flops * steps_per_s / roofline.PEAK_TF32_PER_S
