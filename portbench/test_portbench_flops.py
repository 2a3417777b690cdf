"""The model's operation count against hand counts, found by the loss."""

import copy

import pytest

from portbench import flops
from portbench import registry


def config(name, qubits, layers):
  c = copy.deepcopy(registry.load_cell(name).config)
  c["qubits"] = qubits
  c["circuit"]["layers"] = layers
  return c


def test_hea_on_three_qubits_by_hand():
  # 3 X^t (14 each), 3 Z^t (6), 2 CZ^t (6): forward 72; the sweep twice
  # that plus 8 for each of the 8 parameterized gates: 208; the TFIM's 5
  # terms one pass of 8 each: 40.
  c = config("tfim24-vqt-u8", 3, 1)
  assert flops.count("vqt").per_amplitude(c) == 72 + 208 + 40
  assert flops.step_flops(c, {"loss": "vqt", "max_unique": 4}) == (
      320 * 8 * 4)


def test_qaia_on_three_qubits_by_hand():
  # Heisenberg on 2 bonds: 2 XX and 2 YY flips (14 each), 2 ZZ and the 3
  # classical Z's diagonal (6 each): forward 86; sweep 172 + 8 x 9 = 244;
  # 6 terms: 48.
  c = config("heis20-qaia-u64", 3, 1)
  assert flops.count("vqt").per_amplitude(c) == 86 + 244 + 48


@pytest.mark.parametrize("name,per_amp,tflop", [
    ("tfim24-vqt-u8", 5220, 0.7006), ("heis20-qaia-u64", 20854, 1.3995)])
def test_the_cells_counts(name, per_amp, tflop):
  cell = registry.load_cell(name)
  assert flops.count(cell.traffic["loss"]).per_amplitude(cell.config) == (
      per_amp)
  assert flops.step_flops(cell.config, cell.traffic) / 1e12 == pytest.approx(
      tflop, abs=1e-4)


def test_a_loss_without_a_count_is_an_error_that_names_its_file():
  with pytest.raises(ModuleNotFoundError, match="portbench/counts/nope.py"):
    flops.step_flops({"qubits": 3}, {"loss": "nope", "max_unique": 4})
