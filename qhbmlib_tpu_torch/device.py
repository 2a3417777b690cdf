"""The device the port's entry points build on.

Every constructor and builder of the port that takes `device=None` resolves
it here: a given device is kept, and no device means the CUDA card.  There
is no silent fallback to the CPU, where the kernels' plain versions would
run instead of the kernels; a caller that wants the CPU (the tests, a
laptop) says so with `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
  """`device` as a torch.device; None means the CUDA card.

  Raises RuntimeError for None when no CUDA device exists."""
  if device is not None:
    return torch.device(device)
  if not torch.cuda.is_available():
    raise RuntimeError("no CUDA device; pass device='cpu' to run the plain "
                       "versions on the CPU")
  return torch.device("cuda")
