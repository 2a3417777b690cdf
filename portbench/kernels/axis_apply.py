"""K4's `axis_apply`: one [N, N] operator on the middle axis of a [P, N, Q]
view; on the tensor cores in 3xTF32 from N = 16, in float32 below."""

WRAPPER = ("qhbmlib_tpu_torch.ops.hopper_sv", "axis_apply")


def work(a):
  # A complex multiply-add (8 flops) per amplitude per row of the operator;
  # the state read and written once, the operator read.
  p, n, q = a["p"], a["n"], a["q"]
  return {"flops": 8 * p * n * q * n, "bytes": 16 * p * n * q + 8 * n * n,
          "rate": "tf32x3" if n >= 16 else "fp32"}
