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
