"""`flip_bilinear`: the sweep's stage for one flip gate: a and lambda
un-applied in place and g = 2 Re sum conj(lam) dU a_before."""

WRAPPER = ("qhbmlib_tpu_torch.ops.hopper_adjoint", "flip_bilinear")


def work(a):
  # Three record products an amplitude (~48 flops) and the bilinear (4); a
  # and lambda read and written once.
  amps = a["l_re"].numel()
  return {"flops": 52 * amps, "bytes": 32 * amps, "rate": "fp32"}
