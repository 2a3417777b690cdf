"""K3: the single-state forward, one cooperative launch (no formula kept:
on no train path)."""

WRAPPER = ("qhbmlib_tpu_torch.ops.hopper_sv", "circuit_forward")


def work(a):
  del a
  return None
