"""The benchmark's 28q GWG QMHL cell (`gwg28-qmhl-u4`) cut to CPU size
(`smallcells.small`: 5 qubits, 40 draws, 6 rows, 8 chains), its plain
reference (`portbench/reference/qmhl.py`, `kobe.py`) against brute-force
enumeration at 5 bits and against the port's GWG step, faults of the
timed path that the check must fail, its count, and its three span
metrics.  The whole run (`harness.measure`) goes in a subprocess: it
refuses a process that holds JAX, as a test process does."""

import contextlib
import itertools
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import calibrate
from portbench import compare
from portbench import faults
from portbench import flops
from portbench import harness
from portbench import registry
from portbench import smallcells
from portbench import trace
from portbench.reference import hea
from portbench.reference import kobe
from portbench.reference import qmhl as reference_qmhl
from portbench.reference import statevector as sv
from qhbmlib_tpu_torch import models
from qhbmlib_tpu_torch import nn
from qhbmlib_tpu_torch import tracing
from qhbmlib_tpu_torch.inference import ebm

torch.set_num_threads(1)

CELL = "gwg28-qmhl-u4"
CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 5
METRICS = ("chain_host_ms", "chain_steps_per_step", "logz_host_ms")


def brute_energy(theta, x, order):
  """E(x) = sum_t w_t prod_{i in c_t} (1 - 2 x_i), term by term."""
  terms = [c for r in range(1, order + 1)
           for c in itertools.combinations(range(len(x)), r)]
  return sum(w * math.prod(1 - 2 * x[i] for i in c)
             for w, c in zip(theta, terms))


def every_row(n):
  return np.array(list(itertools.product((0, 1), repeat=n)))


def test_the_small_cell_is_correct_through_the_whole_run():
  code = (
      "import json, time, torch\n"
      "from portbench import harness, smallcells\n"
      "torch.set_num_threads(1)\n"
      f"cell = smallcells.small({CELL!r})\n"
      "for seed in (5, 2**31 + 77, 2**33 + 12345):\n"
      "  out = harness.measure(cell, seed, 0.2, False, torch.device('cpu'),\n"
      "                        time.perf_counter())\n"
      "  print(json.dumps(out))\n")
  run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
  assert run.returncode == 0, run.stderr[-3000:]
  outs = [json.loads(line) for line in run.stdout.splitlines()]
  assert len(outs) == 3
  for out in outs:
    # Under the cell's own limits, those the card's runs are judged by.
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"steps_per_s", "step_ms_p95", "setup_s"}


def test_kobe_energy_parities_and_log_z_against_enumeration():
  order = 2
  rng = np.random.default_rng(4)
  theta = torch.tensor(rng.uniform(-0.5, 0.5, N + N * (N - 1) // 2))
  rows = every_row(N)
  want = np.array([brute_energy(theta.numpy(), x, order) for x in rows])
  np.testing.assert_allclose(kobe.energy(theta, rows).numpy(), want,
                             rtol=1e-12, atol=1e-12)
  terms = list(itertools.chain(*(itertools.combinations(range(N), r)
                                 for r in (1, 2))))
  assert kobe.terms(N, order) == terms
  par = np.array([[math.prod(1 - 2 * x[i] for i in c) for c in terms]
                  for x in rows])
  np.testing.assert_array_equal(kobe.jacobian(theta, rows).numpy(), par)
  # The operator's diagonal, at every index (qubit 0 the leading bit).
  np.testing.assert_allclose(kobe.diagonal(theta, N).numpy(), want,
                             rtol=1e-12, atol=1e-12)
  # The terms' expectations of a distribution over the indices.
  probs = rng.dirichlet(np.ones(2**N))
  np.testing.assert_allclose(
      kobe.expectations(torch.tensor(probs), order).numpy(), probs @ par,
      rtol=1e-12, atol=1e-12)
  # The Monte Carlo log Z is n log 2 - log Ns + LSE(-E) over its draws.
  gen = torch.Generator().manual_seed(9)
  again = torch.Generator().manual_seed(9)
  got = float(kobe.mc_log_partition(theta, gen, 40, N))
  drawn = (torch.rand((40, N), generator=again) < 0.5).numpy()
  energies = np.array([brute_energy(theta.numpy(), x, order) for x in drawn])
  assert got == pytest.approx(N * math.log(2) - math.log(40) + np.log(
      np.sum(np.exp(-energies))), rel=1e-12)
  # Over every row once, it is the exact log Z.
  exact = np.log(np.sum(np.exp(-want)))
  assert float(torch.logsumexp(-kobe.energy(theta, rows), 0)) == (
      pytest.approx(exact, rel=1e-12))


def test_the_plain_gwg_chain_takes_the_port_s_steps():
  energy = models.KOBE(list(range(N)), 2,
                       initializer=nn.RandomUniform(-0.5, 0.5, seed=3),
                       device="cpu")
  theta = energy.kernel.detach()
  start = torch.Generator().manual_seed(21)
  port_state = (torch.rand((8, N), generator=start) < 0.5).to(torch.int8)
  ref_state = port_state.to(torch.int64)
  port_gen = torch.Generator().manual_seed(22)
  ref_gen = torch.Generator().manual_seed(22)
  kept = 0
  with torch.no_grad():
    for _ in range(4):
      before = ref_state
      port_state = ebm.gwg_one_step(energy, port_state, port_gen)
      ref_state = kobe.gwg_step(theta, ref_state, ref_gen)
      assert torch.equal(port_state.to(torch.int64), ref_state)
      kept += int(torch.all(ref_state == before, dim=1).sum())
  # Some proposals were rejected and some taken.
  assert 0 < kept < 4 * 8
  assert torch.equal(port_gen.get_state(), ref_gen.get_state())


def test_the_inverse_circuit_s_leaves_give_autograd_s_gradient():
  config = {"qubits": N, "circuit": {"layers": 2}}
  space = sv.Space(N, torch.float64, CPU)
  rng = np.random.default_rng(6)
  phi = torch.tensor(rng.uniform(0, 2, len(hea.symbols(N, 2))),
                     requires_grad=True)
  psi = torch.tensor(rng.normal(size=(1, 2, 2**N)))
  weights = torch.tensor(rng.normal(size=2**N))

  def value(out):
    return (out[0, 0]**2 + out[0, 1]**2) @ weights

  inverse = reference_qmhl.InverseHEA(space, config, phi)
  got = value(sv.run(psi, inverse.ops(), space))
  got.backward()
  grad = inverse.gradient()
  # The same inverse from the circuit's own steps, through autograd.
  forward = hea.circuit(space, config, {"phi": phi})
  undo = [(k, {q: m.conj().T for q, m in body.items()} if k == "layer"
           else -body) for k, body in reversed(forward)]
  want = value(sv.run(psi, undo, space))
  (want_grad,) = torch.autograd.grad(want, phi)
  assert float(got.detach()) == pytest.approx(float(want.detach()),
                                             rel=1e-12)
  np.testing.assert_allclose(grad.numpy(), want_grad.numpy(), rtol=1e-10,
                             atol=1e-12)


@contextlib.contextmanager
def chain_stuck():
  """The chains never advance: every draw is the chain's start."""
  orig = ebm.GibbsWithGradientsInference.run_chains

  def run_chains(self, chain_state, num_steps, generator=None):
    samples, _ = orig(self, chain_state, num_steps, generator)
    return chain_state.expand(samples.shape).clone(), chain_state

  ebm.GibbsWithGradientsInference.run_chains = run_chains
  try:
    yield
  finally:
    ebm.GibbsWithGradientsInference.run_chains = orig


@contextlib.contextmanager
def accept_all():
  """Every proposal is accepted: the acceptance test always passes."""
  orig = ebm.gwg_log_accept

  def gwg_log_accept(energy, state, probs, index):
    x_prime, log_accept = orig(energy, state, probs, index)
    return x_prime, torch.zeros_like(log_accept)

  ebm.gwg_log_accept = gwg_log_accept
  try:
    yield
  finally:
    ebm.gwg_log_accept = orig


# accept_all's seed is one whose chains reject a proposal that changes the
# kept rows: at 5 bits and weights of 0.05 most proposals are accepted.
FAULTS = {"chain_stuck": (chain_stuck, 4242), "accept_all": (accept_all, 77),
          "half_batch": (None, 4242)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_sampler_is_not_correct(fault, monkeypatch):
  cell = smallcells.small(CELL)
  planted, seed = FAULTS[fault]
  if planted is not None:
    monkeypatch.setitem(faults.FAULTS, fault, planted)
  values, _, _ = calibrate.readings(cell, seed, CPU, fault)
  checks, correct = compare.judge(values, cell.cell["limits"])
  assert not correct, checks


def test_the_count_by_hand():
  cell = registry.load_cell(CELL)
  count = flops.count("qmhl")
  # Each HEA layer on 28 qubits: 28 X^t (14 each), 28 Z^t and 27 CZ^t (6):
  # forward 722; the model's sweep 2 x 722 + 8 x 83 = 2108; 406 KOBE-2
  # terms, one pass of 8 each: 3248; the data's forward 722.
  assert count.per_amplitude(cell.config) == 722 + 722 + 2108 + 3248
  assert flops.step_flops(cell.config, cell.traffic) == 6800 * 2**28 * 4
  assert flops.step_flops(cell.config, cell.traffic) / 1e12 == (
      pytest.approx(7.3014, abs=1e-4))


def context(reading=None):
  return harness.Context(setup_s=1.0, step_s=[0.1], window_s=0.1,
                         window_peak_bytes=None, step_flops=1.0,
                         trace=reading)


def test_the_span_metrics_read_the_chain_and_log_z():
  cell = smallcells.small(CELL)
  for name in METRICS:
    assert name in {m["name"] for m in cell.per_layer}
    assert registry.metric(name).read(context()) is None
  step = harness.set_up(cell, 2**32 + 3, CPU)[0]
  kernels = trace.load_kernels(registry.kernel_names())
  tracing.reset()
  reading = trace.profile(step, 2, kernels, CPU, loss="qmhl")
  ctx = context(reading)
  # 40 draws of 8 chains: 5 chain steps a train step, no burn-in.
  assert registry.metric("chain_steps_per_step").read(ctx) == 5.0
  for name in ("chain_host_ms", "logz_host_ms"):
    value = registry.metric(name).read(ctx)
    assert isinstance(value, float) and 0.0 < value < 1e4, (name, value)
  assert tracing.totals()["qhbm.ebm.log_partition"]["calls"] == 2
  assert all(label.startswith("qmhl.")
             for label, _ in reading["idle_gaps"])
  # The other cells report none of the three.
  for other in ("tfim24-vqt-u8", "heis20-qaia-u64"):
    names = {m["name"] for m in registry.load_cell(other).per_layer}
    assert not names & set(METRICS)
