"""On the card, at each cell's own size: the control (the reference in
float32 with TF32 matrix products, in the program's place) is not correct
under the cell's limits, and a sound run of the program is."""

import pytest
import torch

from portbench import compare
from portbench import harness
from portbench import registry

pytestmark = pytest.mark.card
CELLS = ("tfim24-vqt-u8", "heis20-qaia-u64")


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_fails_and_the_program_passes(card, name):
  cell = registry.load_cell(name)
  torch.backends.cuda.matmul.allow_tf32 = False
  step, record, states, initial = harness.set_up(cell, 3_141_592_653, card)
  del step
  torch.cuda.empty_cache()
  sound = harness.check(cell, record, states, initial, card)
  _, correct = compare.judge(sound, cell.cell["limits"])
  assert correct, sound
  ref = registry.reference(cell.traffic["loss"])
  got = ref.follow(cell.config, cell.traffic, initial, states, card,
                   torch.float32, tf32=True)
  want = ref.follow(cell.config, cell.traffic, initial, states, card,
                    points=got["points"])
  start = harness.flat([torch.as_tensor(initial[n])
                        for n, _ in ref.leaf_shapes(cell.config)])
  control = compare.readings(got, want, start)
  _, correct = compare.judge(control, cell.cell["limits"])
  assert not correct, control
