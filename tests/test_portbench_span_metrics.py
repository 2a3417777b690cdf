"""The benchmark's seven span metrics (`portbench/metrics/`, read through
`portbench.spans`) on both cells cut to CPU size: set-up, then two steps
traced as the harness traces them (`trace.profile`), then each metric's
reading.  `harness.measure` is not called: it refuses a process that holds
JAX, as a test process does."""

import math

import pytest
import torch

from portbench import harness
from portbench import registry
from portbench import smallcells
from portbench import trace
from qhbmlib_tpu_torch import tracing

CELLS = ("tfim24-vqt-u8", "heis20-qaia-u64")
METRICS = ("sampler_host_ms", "glue_host_ms", "forward_host_ms",
           "terms_host_ms", "sweep_host_ms", "host_syncs_per_step",
           "sync_wait_ms")
CPU = torch.device("cpu")
STEPS = 2


def context(trace_reading=None):
  return harness.Context(setup_s=1.0, step_s=[0.1], window_s=0.1,
                         window_peak_bytes=None, step_flops=1.0,
                         trace=trace_reading)


@pytest.fixture(scope="module", params=CELLS)
def traced(request):
  """(cell name, the context of a run that traced STEPS steps)."""
  torch.set_num_threads(1)
  cell = smallcells.small(request.param)
  step = harness.set_up(cell, 2_147_483_650 + len(request.param), CPU)[0]
  kernels = trace.load_kernels(registry.kernel_names())
  tracing.reset()
  reading = trace.profile(step, STEPS, kernels, CPU)
  return request.param, context(reading)


def test_the_seven_metrics_are_the_benchmark_s():
  for cell in CELLS:
    names = {m["name"] for m in registry.load_cell(cell).per_layer}
    assert set(METRICS) <= names
  for name in METRICS:
    assert callable(registry.metric(name).read)


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_reads_a_number_from_the_traced_steps(traced, name):
  cell, ctx = traced
  value = registry.metric(name).read(ctx)
  assert isinstance(value, float) and math.isfinite(value), (cell, value)
  assert value > 0.0, (cell, name)


def test_syncs_are_a_whole_number_a_step_and_waits_inside_the_spans(traced):
  cell, ctx = traced
  syncs = registry.metric("host_syncs_per_step").read(ctx)
  assert syncs == int(syncs) and syncs >= 5, (cell, syncs)
  # Every wait on these paths sits inside the sampler or the batched
  # terms' forward or backward.
  holders = sum(tracing.totals()[name]["total_ms"] for name in (
      "qhbm.ebm.sample", "qhbm.adjoint.forward", "qhbm.adjoint.backward"))
  assert registry.metric("sync_wait_ms").read(ctx) <= holders / STEPS


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_reads_none_without_a_trace(name):
  assert registry.metric(name).read(context()) is None


def test_a_program_without_spans_reads_none(monkeypatch):
  from portbench import spans
  ctx = context({"steps": STEPS})
  monkeypatch.setattr(spans, "tracing", None)
  for name in METRICS:
    assert registry.metric(name).read(ctx) is None
