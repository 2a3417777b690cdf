"""The reference on its own (against dense matrices), the reference against
the port at 5 qubits on the CPU for each configuration's structure, and
the check failing each fault of the timed path."""

import json
import math
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import compare
from portbench import faults
from portbench import hamiltonian
from portbench import harness
from portbench import smallcells
from portbench.reference import hea
from portbench.reference import statevector as sv

CPU = torch.device("cpu")
CELLS = ("tfim24-vqt-u8", "heis20-qaia-u64")
PAULI = {"I": np.eye(2), "X": np.array([[0, 1], [1, 0]]),
         "Y": np.array([[0, -1j], [1j, 0]]), "Z": np.diag([1.0, -1.0])}


def dense(n, ops):
  """The n-qubit matrix of {qubit: 2x2} (qubit 0 the leftmost factor)."""
  out = np.eye(1)
  for q in range(n):
    out = np.kron(out, ops.get(q, np.eye(2)))
  return out


def pauli_sum(n, terms):
  return sum(c * dense(n, {q: PAULI[p] for q, p in qm.items()})
             for c, qm in terms)


def expm_hermitian(h, angle):
  """exp(-i angle h) of a Hermitian h."""
  w, v = np.linalg.eigh(h)
  return (v * np.exp(-1j * angle * w)) @ v.conj().T


@pytest.fixture(autouse=True)
def _threads():
  torch.set_num_threads(2)


def test_hea_matches_its_gates_as_dense_matrices():
  n, layers = 3, 2
  config = {"qubits": n, "circuit": {"layers": layers}}
  rng = np.random.default_rng(5)
  phi = rng.uniform(0, 2, len(hea.symbols(n, layers)))
  space = sv.Space(n, torch.float64, CPU)
  ops = hea.circuit(space, config, {"phi": torch.tensor(phi)})
  got = sv.run(space.basis_states(np.array([[1, 0, 1]])), ops, space)[0]
  got = got[0].numpy() + 1j * got[1].numpy()

  def xp(t):
    return np.exp(1j * math.pi * t / 2) * (
        math.cos(math.pi * t / 2) * np.eye(2) -
        1j * math.sin(math.pi * t / 2) * PAULI["X"])

  value = {(k, layer, q): phi[i] for i, (_, k, layer, q) in
           enumerate(hea.symbols(n, layers))}
  psi = np.zeros(8, complex)
  psi[0b101] = 1.0
  for layer in range(layers):
    psi = dense(n, {q: xp(value["x", layer, q]) for q in range(n)}) @ psi
    psi = dense(n, {q: np.diag([1, np.exp(1j * math.pi * value["z", layer, q])])
                    for q in range(n)}) @ psi
    for q in range(n - 1):
      cz = np.diag([1, 1, 1, np.exp(1j * math.pi * value["cz", layer, q])])
      psi = np.kron(np.kron(np.eye(2**q), cz), np.eye(2**(n - q - 2))) @ psi
  np.testing.assert_allclose(got, psi, atol=1e-12)


@pytest.mark.parametrize("spec", [
    {"chain": "open", "fields": {"X": -1.0}, "couplings": {"ZZ": -1.0}},
    {"chain": "open", "couplings": {"XX": 1.0, "YY": 0.5, "ZZ": 1.0}},
    {"chain": "open", "fields": {"Y": 0.3}, "couplings": {"XZ": 0.7}}])
def test_observable_and_exponentials_match_dense_matrices(spec):
  n = 4
  terms = hamiltonian.chain_terms(spec, n)
  space = sv.Space(n, torch.float64, CPU)
  rng = np.random.default_rng(3)
  x = rng.normal(size=(2, 2**n)) + 1j * rng.normal(size=(2, 2**n))
  psi = torch.tensor(np.stack([x.real, x.imag], 1))
  h = pauli_sum(n, terms)
  want = np.einsum("si,ij,sj->s", x.conj(), h, x).real
  got = sv.Observable(space, terms).expectation(psi).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-12)
  if all(len(set(q.values())) == 1 for _, q in terms):
    for shard in hamiltonian.letter_shards(terms):
      ops = sv.pauli_exponential(space, shard,
                                   torch.tensor(0.37, dtype=torch.float64))
      out = sv.run(psi, ops, space).numpy()
      want = expm_hermitian(pauli_sum(n, shard), 0.37) @ x.T
      np.testing.assert_allclose(out[:, 0] + 1j * out[:, 1], want.T,
                                 atol=1e-12)


@pytest.mark.parametrize("name", CELLS)
def test_the_port_agrees_with_the_reference_at_5_qubits(name):
  cell = smallcells.small(name)
  out = harness.measure(cell, 2**31 + 77, 0.2, False, CPU, time.perf_counter())
  assert out["correct"], out["checks"]
  for c in out["checks"].values():
    assert c["value"] < 1e-4
  assert out["attempted"] >= 1 and out["failed"] == 0
  assert set(out["metrics"]) == {"steps_per_s", "step_ms_p95", "setup_s"}
  assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
  cell = smallcells.small(name)
  with faults.FAULTS[fault]():
    out = harness.measure(cell, 4242, 0.1, False, CPU, time.perf_counter())
  assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_traced_run_reports_per_layer_metrics_only(name):
  cell = smallcells.small(name)
  out = harness.measure(cell, 9, 0.1, True, CPU, time.perf_counter())
  # On the CPU the kernels' plain versions run: nothing is launched and
  # there is no card to read, so the host-clock share of the peak and the
  # program's spans, each called in the traced steps, read; the device's
  # metrics read nothing.
  spans = {m["name"] for m in cell.per_layer
           if m["source"] == "program_span"}
  assert len(spans) == 7
  assert set(out["metrics"]) == {"step_mfu_pct"} | spans
  assert out["device"]["busy_s"] == 0.0
  assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
  # The step's parts are named by the cell's loss.
  assert all(label.startswith("vqt.")
             for label, _ in out["breakdown"]["idle_gaps"])


def test_readings_of_one_record_are_zero_and_a_frozen_step_reads_one():
  rng = np.random.default_rng(0)
  start = rng.normal(size=10)
  rec = {"losses": [1.5, 1.4, 1.3], "grad1": rng.normal(size=10),
         "params": start + 0.03}
  same = compare.readings(rec, rec, start)
  assert same["loss_gap"] == same["grad_gap"] == same["change_gap"] == 0.0
  frozen = dict(rec, params=start.copy(), grad1=None)
  got = compare.readings(frozen, rec, start)
  assert got["change_gap"] == 1.0 and got["grad_gap"] == math.inf
  flipped = dict(rec, grad1=-rec["grad1"], params=start - 0.03)
  got = compare.readings(flipped, rec, start)
  assert got["grad_gap"] == 2.0
  assert got["change_gap"] == pytest.approx(2.0, rel=1e-12)
  quiet = dict(rec, grad1=np.where(np.arange(10) == 3, 1e-9, rec["grad1"]))
  assert compare.readings(quiet, quiet, start)["left_out"] == 1


def test_run_needs_the_card_and_prints_no_result():
  root = pathlib.Path(__file__).resolve().parent.parent
  out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "tfim24-vqt-u8", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=root, timeout=300)
  if torch.cuda.is_available():
    pytest.skip("this machine has a card")
  assert out.returncode != 0 and out.stdout == ""


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
  root = pathlib.Path(__file__).resolve().parent.parent
  shutil.copy(root / "BENCHMARK.json", tmp_path)
  shutil.copytree(root / "portbench", tmp_path / "portbench",
                  ignore=shutil.ignore_patterns("__pycache__"))
  out = subprocess.run([sys.executable, "-c",
                        "from portbench import registry\n"
                        "registry.load_cell('tfim24-vqt-u8')\n"
                        "registry.check_program()"],
                       capture_output=True, text=True, cwd=tmp_path,
                       timeout=300)
  assert out.returncode != 0 and out.stdout == ""
  assert json.loads((tmp_path / "BENCHMARK.json").read_text())
