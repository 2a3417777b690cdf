"""The program's spans (`qhbmlib_tpu_torch.tracing`) on a small VQT step
built from the port's API on the CPU: off with no profiler, and under one
each batched-path span in `totals()` and in the profiler's events, with
its calls a step, self time within inclusive time, per-thread stacks and
a span left by an exception popped."""

import ast
import pathlib
import threading

import pytest
import torch

from qhbmlib_tpu_torch import models
from qhbmlib_tpu_torch import nn
from qhbmlib_tpu_torch import tracing
from qhbmlib_tpu_torch.inference import ebm
from qhbmlib_tpu_torch.inference import qhbm
from qhbmlib_tpu_torch.inference import qnn
from qhbmlib_tpu_torch.inference import vqt_loss
from qhbmlib_tpu_torch.ops import adjoint
from qhbmlib_tpu_torch.ops import paulis

torch.set_num_threads(1)

N = 5
ROWS = 6  # distinct rows a step (the sampler pads to this many)
PACKAGE = pathlib.Path(tracing.__file__).resolve().parent

# The batched train path's spans and their calls a step at one chunk.
ONE_CHUNK = {
    "qhbm.ebm.sample": 1, "qhbm.qnn.expectation": 1, "qhbm.adjoint.plan": 1,
    "qhbm.adjoint.forward": 1, "qhbm.adjoint.backward": 1,
    "qhbm.sv.prepare_segments": 1, "qhbm.sv.stages": 1,
    "qhbm.sv.expectation_terms": 1, "qhbm.sv.apply_pauli_sum": 1,
    "qhbm.adjoint.prepare_backward": 1, "qhbm.adjoint.sweep_stages": 1,
    "qhbm.adjoint.assemble": 1, "qhbm.adjoint.trim_tail": 1,
    "qhbm.sync.unique": 1,
    "qhbm.sync.host_values": 1, "qhbm.sync.basis_planes": 1,
    "qhbm.sync.reductions": 1, "qhbm.sync.gradient": 1,
}
# Each span and the spans opened inside it on the step's thread.
CHILDREN = {
    "qhbm.ebm.sample": ("qhbm.sync.unique",),
    "qhbm.qnn.expectation": ("qhbm.adjoint.plan", "qhbm.adjoint.forward"),
    "qhbm.adjoint.forward": ("qhbm.sync.host_values",
                             "qhbm.sync.basis_planes",
                             "qhbm.sv.prepare_segments", "qhbm.sv.stages",
                             "qhbm.sv.expectation_terms"),
    "qhbm.adjoint.backward": ("qhbm.sv.apply_pauli_sum",
                              "qhbm.adjoint.prepare_backward",
                              "qhbm.adjoint.sweep_stages",
                              "qhbm.adjoint.assemble"),
    "qhbm.adjoint.prepare_backward": ("qhbm.adjoint.trim_tail",),
    "qhbm.adjoint.assemble": ("qhbm.sync.reductions", "qhbm.sync.gradient"),
}


def vqt_step():
  """One VQT step: a Bernoulli EBM of 40 draws kept to ROWS rows, a
  2-layer HEA, the open TFIM; returns the loss after its backward."""
  energy = models.BernoulliEnergy(
      list(range(N)), initializer=nn.RandomUniform(-1, 1, seed=7),
      device="cpu")
  e_inf = ebm.BernoulliEnergyInference(energy, 40, initial_seed=7,
                                       max_unique_samples=ROWS, device="cpu")
  circuit = models.DirectQuantumCircuit(
      models.hardware_efficient_ansatz(N, 2),
      initializer=nn.RandomUniform(-0.5, 0.5, seed=8), device="cpu")
  model = qhbm.QHBM(e_inf, qnn.AnalyticQuantumInference(circuit))
  loss_fn = vqt_loss.make_vqt(model, paulis.tfim_1d(N, device="cpu"))

  def step():
    loss = loss_fn(1.2)
    loss.backward()
    return loss

  return step


def profiled(fn, steps=1):
  """Runs fn `steps` times under a CPU profiler after a reset: (totals,
  the names of the profiler's events)."""
  tracing.reset()
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    for _ in range(steps):
      fn()
  return tracing.totals(), {e.name for e in prof.events()}


def test_without_a_profiler_no_span_opens(monkeypatch):
  opened = []
  real = torch.profiler.record_function

  def counting(name, *args):
    opened.append(name)
    return real(name, *args)

  monkeypatch.setattr(torch.profiler, "record_function", counting)
  tracing.reset()
  vqt_step()()
  with tracing.span("qhbm.test.off") as s:
    assert s is None
  assert tracing.totals() == {}
  assert not [n for n in opened if n.startswith(tracing.PREFIX)]


def test_each_span_is_in_the_totals_and_the_trace_with_its_calls():
  step = vqt_step()
  step()  # warm-up
  totals, events = profiled(step, steps=2)
  assert set(ONE_CHUNK) <= set(totals)
  for name, calls in ONE_CHUNK.items():
    assert totals[name]["calls"] == 2 * calls, name
    assert name in events, name
  assert all(name.startswith(tracing.PREFIX) for name in totals)


def test_chunks_with_psi_recomputed_repeat_the_per_chunk_spans(monkeypatch):
  """Too little free memory for the residual: psi is recomputed and each
  state is a chunk, so the forward's spans run twice a chunk."""
  monkeypatch.setattr(adjoint, "HOST_FREE_BYTES", 2 * 8 * 2**N)
  step = vqt_step()
  totals, _ = profiled(step)
  assert adjoint.last_plan["chunk"] == 1 and not adjoint.last_plan[
      "store_psi"]
  for name in ("qhbm.sv.prepare_segments", "qhbm.sv.stages",
               "qhbm.sync.basis_planes"):
    assert totals[name]["calls"] == 2 * ROWS, name
  for name in ("qhbm.sv.expectation_terms", "qhbm.sv.apply_pauli_sum",
               "qhbm.adjoint.prepare_backward", "qhbm.adjoint.sweep_stages",
               "qhbm.adjoint.assemble", "qhbm.sync.reductions",
               "qhbm.sync.gradient"):
    assert totals[name]["calls"] == ROWS, name
  for name in ("qhbm.adjoint.forward", "qhbm.adjoint.backward",
               "qhbm.sync.host_values", "qhbm.sync.unique"):
    assert totals[name]["calls"] == 1, name


def test_self_time_is_within_total_and_children_within_parents():
  totals, _ = profiled(vqt_step(), steps=2)
  for name, row in totals.items():
    assert 0.0 <= row["self_ms"] <= row["total_ms"], name
  for parent, kids in CHILDREN.items():
    inside = sum(totals[k]["total_ms"] for k in kids)
    assert inside <= totals[parent]["total_ms"], parent
    assert totals[parent]["self_ms"] == pytest.approx(
        totals[parent]["total_ms"] - inside, abs=1e-3), parent


def test_spans_on_another_thread_leave_this_thread_s_self_time():
  """A step runs in another thread (as the backward runs on autograd's
  thread on the card) while a span is open here: its spans are not this
  span's children."""
  step = vqt_step()

  def step_elsewhere():
    worker = threading.Thread(target=step)
    with tracing.span("qhbm.test.outer"):
      worker.start()
      worker.join(timeout=120)
    assert not worker.is_alive()

  totals, _ = profiled(step_elsewhere)
  outer = totals["qhbm.test.outer"]
  assert outer["self_ms"] == outer["total_ms"]
  assert totals["qhbm.adjoint.backward"]["calls"] == 1
  assert totals["qhbm.adjoint.backward"]["total_ms"] <= outer["total_ms"]


def test_a_span_left_by_an_exception_pops():
  def raising():
    with pytest.raises(ValueError):
      with tracing.span("qhbm.test.raises"):
        with tracing.span("qhbm.test.inner"):
          raise ValueError("left")
    with tracing.span("qhbm.test.after"):
      pass

  totals, events = profiled(raising)
  assert totals["qhbm.test.raises"]["calls"] == 1
  assert totals["qhbm.test.inner"]["calls"] == 1
  after = totals["qhbm.test.after"]
  assert after["self_ms"] == after["total_ms"]
  assert "qhbm.test.raises" in events
  assert tracing._local.stack == []


def test_span_names_keep_to_the_program_s_prefix():
  """Every span the package names starts with "qhbm.", never with the
  benchmark's step parts ("vqt.") or kernel ranges ("portbench.")."""
  names = set()
  for path in PACKAGE.rglob("*.py"):
    for node in ast.walk(ast.parse(path.read_text())):
      if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
          in ("span", "spanned") and node.args and
          isinstance(node.args[0], ast.Constant)):
        names.add(node.args[0].value)
  assert set(ONE_CHUNK) <= names
  assert all(n.startswith(tracing.PREFIX) for n in names), names


def gwg_inference(chains=4, samples=12, burn_in=0):
  """A KOBE-2 energy on N bits sampled by `chains` GWG chains."""
  energy = models.KOBE(list(range(N)), 2,
                       initializer=nn.RandomUniform(-0.5, 0.5, seed=3),
                       device="cpu")
  return ebm.GibbsWithGradientsInference(
      energy, samples, num_burnin_samples=burn_in, num_chains=chains,
      max_unique_samples=ROWS, initial_seed=3, device="cpu")


def test_gwg_records_one_span_a_chain_step_under_a_profiler_only():
  e_inf = gwg_inference(chains=4, samples=12)
  tracing.reset()
  e_inf.sample_with_state(None, 12)
  assert tracing.totals() == {}
  totals, events = profiled(lambda: e_inf.sample_with_state(None, 12),
                            steps=2)
  assert totals["qhbm.ebm.gwg_step"]["calls"] == 2 * 3  # ceil(12 / 4) a call
  assert "qhbm.ebm.gwg_step" in events
  # The threaded support of a train step: no burn-in, so one span a step.
  totals, _ = profiled(lambda: e_inf.support_counts_state(None, None))
  assert totals["qhbm.ebm.gwg_step"]["calls"] == 3
  # The stateful API burns in first on a parameter change: its steps count
  # too.
  burning = gwg_inference(chains=4, samples=12, burn_in=5)
  totals, _ = profiled(lambda: burning.support_and_counts())
  assert totals["qhbm.ebm.gwg_step"]["calls"] == 5 + 3
  inside = totals["qhbm.ebm.gwg_step"]["total_ms"]
  assert inside <= totals["qhbm.ebm.sample"]["total_ms"]


def test_log_partition_spans_the_monte_carlo_forward_only():
  e_inf = gwg_inference()
  totals, events = profiled(lambda: e_inf.log_partition_with_state(None,
                                                                   None))
  assert totals["qhbm.ebm.log_partition"]["calls"] == 1
  assert "qhbm.ebm.log_partition" in events
  kobe = models.KOBE(list(range(N)), 2, device="cpu")
  bernoulli = models.BernoulliEnergy(list(range(N)), device="cpu")
  exact = (ebm.AnalyticEnergyInference(kobe, 20, initial_seed=1,
                                       device="cpu"),
           ebm.BernoulliEnergyInference(bernoulli, 20, initial_seed=1,
                                        device="cpu"))
  for inference in exact:
    totals, _ = profiled(lambda: (inference.log_partition(),
                                  inference.log_partition_forward()))
    assert "qhbm.ebm.log_partition" not in totals, type(inference)
  # And no span of the VQT step's changes.
  totals, _ = profiled(vqt_step())
  assert not {"qhbm.ebm.log_partition", "qhbm.ebm.gwg_step"} & set(totals)
