"""A cell of `BENCHMARK.json` cut to a size a CPU test holds: the same
configuration and traffic on 5 qubits, 40 draws and 6 distinct rows."""

from __future__ import annotations

import copy

from portbench import registry


def small(name: str):
  cell = registry.load_cell(name)
  cell.config = copy.deepcopy(cell.config)
  cell.cell = copy.deepcopy(cell.cell)
  cell.config["qubits"] = 5
  cell.cell["traffic"].update(samples=40, max_unique=6)
  return cell
