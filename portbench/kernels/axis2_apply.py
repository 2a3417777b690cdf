"""K1: two operators on axes 1 and 3 of a [P, N1, M, N2, Q] view in one
pass over the state, contracted on the tensor cores in 3xTF32."""

WRAPPER = ("qhbmlib_tpu_torch.ops.hopper_sv", "axis2_apply")


def work(a):
  # N1 + N2 complex multiply-adds (8 flops) an amplitude; the state read
  # and written once (re and im, 4 bytes each), both operators read.
  amps = a["p"] * a["n1"] * a["m"] * a["n2"] * a["q"]
  return {"flops": 8 * amps * (a["n1"] + a["n2"]),
          "bytes": 16 * amps + 8 * (a["n1"]**2 + a["n2"]**2),
          "rate": "tf32x3"}
