"""Metrics on BitstringEnergy models (port of
`qhbmlib_tpu/inference/ebm_utils.py`)."""

from __future__ import annotations

import torch

from qhbmlib_tpu_torch import utils
from qhbmlib_tpu_torch.models import energy as energy_model


def probabilities(input_energy: energy_model.BitstringEnergy
                  ) -> torch.Tensor:
  """Exact probabilities softmax(-E) over all 2^n bitstrings, ascending
  index order, on the energy's device."""
  device = next(input_energy.parameters()).device
  bits = utils.all_bitstrings(input_energy.num_bits, device)
  return torch.softmax(-input_energy(bits), dim=0)
