"""`flip_apply`: one gate of the flip class on one or two state batches in
place."""

WRAPPER = ("qhbmlib_tpu_torch.ops.hopper_sv", "flip_apply")


def work(a):
  # Two complex products and their sum an output amplitude (~16 flops);
  # each batch read and written once.
  amps = sum(re.numel() for re, _ in a["states"])
  return {"flops": 16 * amps, "bytes": 16 * amps, "rate": "fp32"}
