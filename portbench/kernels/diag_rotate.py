"""K4's `diag_rotate`: one or two state batches multiplied in place by
exp(i sign theta) from shared [R, C] cos and sin planes."""

WRAPPER = ("qhbmlib_tpu_torch.ops.hopper_sv", "diag_rotate")


def work(a):
  # One complex multiply (6 flops) an amplitude; each batch read and
  # written once, the cos and sin planes read once.
  amps = sum(re.numel() for re, _ in a["states"])
  return {"flops": 6 * amps, "bytes": 16 * amps + 8 * a["cos_t"].numel(),
          "rate": "fp32"}
