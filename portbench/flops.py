"""The model's operations a train step, from the configuration alone, by
the cell's loss.

Each loss has its own count, `counts/<loss>.py` with `step_flops(config,
traffic)`, found by `traffic["loss"]`; a loss without one is an error
that names the missing file.  The counts charge each gate as a dense
application on every amplitude of each state the step evaluates,
whatever implements it:

  * a dense one-qubit gate: an output amplitude is two complex products
    and a sum, 2 x 6 + 2 = 14 flops;
  * a diagonal gate: one complex product, 6 flops;
  * a two-qubit gate of the flip class (alpha s[x] + beta s[x ^ f]): two
    complex products and a sum, 14 flops;
  * a permutation: 0;
  * an inner product <a| dG |b>, or one Pauli term's pass over a state: a
    complex multiply-add, 8 flops.
"""

from __future__ import annotations

import importlib

DENSE_1Q = 14
DIAGONAL = 6
FLIP_2Q = 14
INNER_PRODUCT = 8
TERM_PASS = 8


def count(loss: str):
  """The count module of `loss` (`counts/<loss>.py`)."""
  name = f"portbench.counts.{loss}"
  try:
    return importlib.import_module(name)
  except ModuleNotFoundError as e:
    if e.name != name:
      raise
    raise ModuleNotFoundError(
        f"the loss {loss!r} has no count: portbench/counts/{loss}.py with "
        f"step_flops(config, traffic) is missing", name=name) from None


def step_flops(config, traffic) -> float:
  """The model's flops in one train step of the cell's loss."""
  return float(count(traffic["loss"]).step_flops(config, traffic))
