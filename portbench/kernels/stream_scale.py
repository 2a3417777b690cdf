"""K6: the HBM probe's o = x * v over a [R, 128] plane (on no train
path)."""

WRAPPER = ("qhbmlib_tpu_torch.benchmarks.hbm_probe", "stream_scale")


def work(a):
  # One multiply an element; the plane read and written once.
  amps = a["x"].numel()
  return {"flops": amps, "bytes": 8 * amps, "rate": "fp32"}
