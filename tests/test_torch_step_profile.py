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
