"""K2: the single-state adjoint sweep, one cooperative launch (no formula
kept: on no train path)."""

WRAPPER = ("qhbmlib_tpu_torch.ops.hopper_adjoint", "adjoint_sweep")


def work(a):
  del a
  return None
