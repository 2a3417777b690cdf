"""The step profiler's reading of a Chrome trace, on synthetic events.

`qhbmlib_tpu_torch.benchmarks.step_profile` traces train steps on the card;
here its arithmetic (busy share as the union of device intervals inside the
annotated region, kernel ms a step by name) runs on a hand-made trace.
"""

import pytest

from qhbmlib_tpu_torch.benchmarks import step_profile as sp


def test_union_merges_overlaps_and_gaps():
  assert sp.union_us([]) == 0.0
  assert sp.union_us([(0, 10), (5, 15), (20, 25)]) == 20.0
  assert sp.union_us([(20, 25), (0, 30)]) == 30.0


@pytest.mark.parametrize("name,short", [
    ("(anonymous namespace)::axis2_apply_kernel(float const*, float*, "
     "long long, int)", "axis2_apply_kernel"),
    ("(anonymous namespace)::axis_apply_kernel<128>(float const*, float "
     "const*)", "axis_apply_kernel<128>"),
    ("void at::native::elementwise_kernel<128, 4>(int)",
     "at::native::elementwise_kernel<128, 4>"),
    ("ampere_sgemm_128x64_nn", "ampere_sgemm_128x64_nn"),
    ("(anonymous namespace)::qubit_transitions_kernel(float const*, "
     "(anonymous namespace)::TransPlan, float*)", "qubit_transitions_kernel"),
])
def test_kernel_names_lose_namespace_and_arguments(name, short):
  assert sp.kernel_name(name) == short


def test_breakdown_counts_only_the_region():
  k1 = "(anonymous namespace)::axis2_apply_kernel(float const*)"
  events = [
      {"name": sp.REGION, "cat": "user_annotation", "ts": 100, "dur": 1000},
      {"name": k1, "cat": "kernel", "ts": 150, "dur": 300},
      {"name": k1, "cat": "kernel", "ts": 400, "dur": 100},  # overlaps
      {"name": "Memcpy HtoD", "cat": "gpu_memcpy", "ts": 700, "dur": 100},
      {"name": "gemm", "cat": "kernel", "ts": 900, "dur": 50},
      {"name": "gemm", "cat": "kernel", "ts": 5000, "dur": 50},  # outside
      {"name": "aten::mm", "cat": "cpu_op", "ts": 150, "dur": 500},
  ]
  out = sp.breakdown(events, steps=2)
  assert out["region_ms_per_step"] == pytest.approx(0.5)
  assert out["busy_share"] == pytest.approx((350 + 100 + 50) / 1000)
  assert out["kernel_ms_per_step"] == pytest.approx(
      {"axis2_apply_kernel": 0.2, "gemm": 0.025})


def test_breakdown_names_the_top_kernels_and_sums_the_rest():
  events = [{"name": sp.REGION, "cat": "user_annotation", "ts": 0,
             "dur": 10_000}]
  events += [{"name": f"k{i}", "cat": "kernel", "ts": 100 * i, "dur": i + 1}
             for i in range(sp.TOP + 3)]
  per_step = sp.breakdown(events, steps=1)["kernel_ms_per_step"]
  assert len(per_step) == sp.TOP + 1
  assert per_step[f"k{sp.TOP + 2}"] == pytest.approx((sp.TOP + 3) / 1e3)
  assert per_step["(other kernels)"] == pytest.approx(6 / 1e3)


def test_host_split_sums_spans_runtime_and_the_rest():
  region = sp.SINGLE_REGION
  events = [
      {"name": region, "cat": "user_annotation", "ts": 0, "dur": 1000},
      {"name": "forward_table", "cat": "user_annotation", "ts": 10,
       "dur": 100},
      {"name": "sweep_table", "cat": "user_annotation", "ts": 300, "dur": 200},
      {"name": "sweep_table", "cat": "user_annotation", "ts": 350, "dur": 50},
      {"name": "cudaStreamSynchronize", "cat": "cuda_runtime", "ts": 600,
       "dur": 40},
      {"name": "forward_table", "cat": "user_annotation", "ts": 2000,
       "dur": 100},  # outside
  ]
  out = sp.host_split(events, calls=2)
  assert out["call_ms"] == pytest.approx(0.5)
  assert out["spans_ms"]["forward_table"] == pytest.approx(0.05)
  assert out["spans_ms"]["sweep_table"] == pytest.approx(0.1)
  assert out["spans_ms"]["sweep_grads"] == 0.0
  assert out["runtime_ms"] == {
      "cudaStreamSynchronize": {"ms": pytest.approx(0.02), "count": 0.5}}
  assert out["rest_ms"] == pytest.approx((1000 - 300) / 2e3)


def test_single_state_region_runs_on_cpu(tmp_path):
  """The single-state region at 9q/1L on the CPU (the plain versions): it
  traces its calls, the value-and-gradient parts that the CPU path runs
  show as spans, and the module functions are restored after."""
  before = sp.hopper_sv.forward_table
  out = sp.profile_single(str(tmp_path), device="cpu", n=9, layers=1)
  assert sp.hopper_sv.forward_table is before
  assert out["calls"] == sp.SINGLE_CALLS and out["card"] is None
  assert out["busy_share"] == 0.0  # no device on the CPU
  spans = out["host"]["spans_ms"]
  assert set(spans) == {fn for _, fn in sp.SINGLE_SPANS}
  for fn in ("host_values", "expectation_terms", "apply_pauli_sum"):
    assert spans[fn] > 0.0, fn
  assert 0.0 <= out["host"]["rest_ms"] <= out["host"]["call_ms"]


def test_workloads_are_the_bench_s_and_16q():
  """The profiled steps: the bench's two at their own configurations, and
  the 20q workload's depth and draw at 16 qubits, whose lone row block
  (7, 2) is an `axis_apply` pass at N = 4."""
  assert {k: sp.WORKLOADS[k] for k in sp.bench.WORKLOADS} == \
      sp.bench.WORKLOADS
  assert sp.WORKLOADS["16q"] == {**sp.bench.WORKLOADS["20q"], "n": 16}
  n = sp.WORKLOADS["16q"]["n"]
  assert sp.sv._row_blocks(n - sp.sv.minor_bits(n)) == [(0, 7), (7, 2)]


def test_compare_trees_runs_this_tree_s_phases():
  """compare_trees runs THIS tree's chip_smoke phases in another tree's
  working directory, and shows only their check and kernel lines (or the
  bench's, the expectations/s run's or the 16q step's, last line)."""
  from qhbmlib_tpu_torch.benchmarks import compare_trees as ct
  cmd = ct.command("kernels", "phase_k4")
  assert cmd[1] == "-c" and str(ct.ROOT / "chip_smoke.py") in cmd[2]
  assert "['phase_k4']" in cmd[2]
  compile(cmd[2], "<phases>", "exec")
  assert ct.command("bench")[1:] == ["-m", "qhbmlib_tpu_torch.bench",
                                     "--steps", "8"]
  pauli = ct.command("pauli")
  assert "measure_pauli_expectations" in pauli[2]
  compile(pauli[2], "<pauli>", "exec")
  train = ct.command("train16q")
  assert "run_workload" in train[2] and 'WORKLOADS["16q"]' in train[2]
  compile(train[2], "<train16q>", "exec")
  out = "[build] x\n[check] a ok\n[kernels] b\n[bench] c\n{\"value\": 1}"
  assert ct.shown("kernels", out) == "[check] a ok\n[kernels] b"
  assert (ct.shown("bench", out) == ct.shown("pauli", out) ==
          ct.shown("train16q", out) == "{\"value\": 1}")


def test_span_split_attributes_device_work_by_launch():
  """Kernels go to the span whose host interval holds their launch (by
  correlation id), whenever they run; the rest is unclaimed."""
  def launch(ts, cid):
    return {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": ts,
            "dur": 5, "args": {"correlation": cid}}

  def kernel(ts, dur, cid):
    return {"name": "k", "cat": "kernel", "ts": ts, "dur": dur,
            "args": {"correlation": cid}}

  events = [
      {"name": sp.REGION, "cat": "user_annotation", "ts": 0, "dur": 1000},
      {"name": "apply_stage", "cat": "user_annotation", "ts": 10, "dur": 40},
      {"name": "apply_stage", "cat": "user_annotation", "ts": 300,
       "dur": 20},
      {"name": "_sampled_means", "cat": "user_annotation", "ts": 100,
       "dur": 50},
      launch(20, 1), launch(310, 2), launch(120, 3), launch(500, 4),
      kernel(200, 30, 1), kernel(400, 10, 2), kernel(450, 7, 3),
      kernel(600, 3, 4),
  ]
  spans = ((None, "apply_stage"), (None, "_sampled_means"),
           (None, "shift_corrections"))
  out = sp.span_split(events, 1, spans)
  assert out["apply_stage"] == pytest.approx(
      {"host_ms": 0.06, "device_ms": 0.04, "launches": 2})
  assert out["_sampled_means"] == pytest.approx(
      {"host_ms": 0.05, "device_ms": 0.007, "launches": 1})
  assert out["shift_corrections"]["launches"] == 0
  assert out["rest"] == pytest.approx({"device_ms": 0.003, "launches": 1})


def test_harness_step_runs_on_cpu(tmp_path):
  """The harness workload's step: the trainer's vanilla step on its 8q
  config, each step's metrics written as the trainer writes them."""
  import json
  import torch
  torch.set_num_threads(1)
  step = sp.harness_step(sp.HARNESS_WORKLOADS["harness 8q"], "cpu",
                         str(tmp_path))
  step()
  step()
  step.writer.close()
  with open(tmp_path / "metrics.jsonl") as f:
    recs = [json.loads(line) for line in f]
  losses = [r for r in recs if r["tag"] == "loss"]
  assert [r["step"] for r in losses] == [0, 1]
  assert losses[1]["value"] < losses[0]["value"]
  assert {"variables/stats", "grads/stats", "grad_norm"} <= {
      r["tag"] for r in recs}
