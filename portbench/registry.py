"""`BENCHMARK.json` and the files it names, found by name."""

from __future__ import annotations

import dataclasses
import importlib
import json
import pathlib
import re
from typing import List

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = pathlib.Path(__file__).resolve().parent
PROGRAM = "qhbmlib_tpu_torch"


def module_name(metric: str) -> str:
  return re.sub(r"[.-]", "_", metric)


@dataclasses.dataclass
class Cell:
  name: str
  chips: int
  config: dict
  cell: dict
  end_to_end: List[dict]
  per_layer: List[dict]

  @property
  def traffic(self) -> dict:
    return self.cell["traffic"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
  """The cell `name` of the benchmark at `root`: its configuration's file,
  its own file (`portbench/workloads/<name>.json` under `root`) and the
  metrics it reports (those whose "workloads" list names it, or that have
  none)."""
  bench = json.loads((root / "BENCHMARK.json").read_text())
  entry = next((w for w in bench["workloads"] if w["name"] == name), None)
  if entry is None:
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")
  conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
  config = json.loads((root / conf["file"]).read_text())
  cell = json.loads((root / HERE.name / "workloads" /
                     f"{name}.json").read_text())
  if cell["traffic"]["name"] != entry["traffic"]:
    raise ValueError(f"{name}: BENCHMARK.json's traffic {entry['traffic']!r} "
                     f"is not the cell file's {cell['traffic']['name']!r}")

  def mine(metrics):
    return [m for m in metrics if name in m.get("workloads", [name])]

  return Cell(name, int(entry["chips"]), config, cell,
              mine(bench["end_to_end"]), mine(bench["per_layer"]))


def metric(name: str):
  return importlib.import_module(f"portbench.metrics.{module_name(name)}")


def kernel_names() -> List[str]:
  return sorted(p.stem for p in (HERE / "kernels").glob("*.py")
                if p.stem != "__init__")


def program(kind: str):
  return importlib.import_module(f"portbench.program.{kind}")


def reference(kind: str):
  return importlib.import_module(f"portbench.reference.{kind}")


def check_program() -> None:
  """Imports the port and fails unless it is this checkout's."""
  module = importlib.import_module(PROGRAM)
  where = pathlib.Path(module.__file__).resolve()
  if ROOT not in where.parents:
    raise ImportError(f"{PROGRAM} comes from {where}, not from {ROOT}")
