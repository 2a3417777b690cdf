"""BENCHMARK.json against the benchmark's contract, and every name in it
against the file that the harness finds by it."""

import json
import pathlib
import re

import pytest

from portbench import flops
from portbench import registry

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per_token")


def test_top_level_keys_and_limits():
  assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  assert BENCH["paths"] == ["portbench"]
  assert BENCH["command"][:3] == ["python3", "-m", "portbench.run"]
  assert 1 <= BENCH["run_seconds"] <= 51
  assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_exactly_their_keys():
  for c in BENCH["configs"]:
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert 1 <= len(c["source"]) <= 200 and "\n" not in c["source"]
    assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
    assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    assert not any(WIDTHS.search(k) for k in c["reduced"])
  for w in BENCH["workloads"]:
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
  for m in BENCH["end_to_end"]:
    assert set(m) <= {"name", "unit", "better", "bound", "source",
                      "workloads"}
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
  for m in BENCH["per_layer"]:
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
  names = [x["name"] for part in ("configs", "workloads", "end_to_end",
                                  "per_layer") for x in BENCH[part]]
  assert len(names) == len(set(names))
  assert all(NAME.match(n) for n in names)
  assert all(UNIT.match(m["unit"]) for part in ("end_to_end", "per_layer")
             for m in BENCH[part])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_and_reports_what_it_must(cell):
  c = registry.load_cell(cell)
  names = {m["name"] for m in c.end_to_end}
  assert {"setup_s", "steps_per_s"} <= names and len(names) >= 2
  assert c.per_layer
  for m in c.end_to_end + c.per_layer:
    assert callable(registry.metric(m["name"]).read)
  assert set(c.cell["limits"]) == {"loss_gap", "grad_gap", "change_gap"}
  loss = c.traffic["loss"]
  assert callable(registry.program(loss).Step)
  ref = registry.reference(loss)
  assert callable(ref.parts) and callable(ref.leaf_shapes)
  assert callable(ref.follow)
  assert callable(flops.count(loss).step_flops)
