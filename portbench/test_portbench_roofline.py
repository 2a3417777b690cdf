"""Each kernel's least time against rows of PERF.md's kernel table, and the
trace arithmetic on a synthetic Chrome trace."""

import pytest
import torch

from portbench import registry
from portbench import roofline
from portbench import trace


def planes(*shape):
  return torch.empty(shape, device="meta")


def work(kernel, **args):
  spec = trace.load_kernels([kernel])[0]
  return spec.work(args)


def test_flip_bilinear_20q_b64_is_the_tables_bound():
  # PERF.md: flip_bilinear at 20q B=64, bound 0.6410 ms by bytes.
  p = planes(64, 2**13, 2**7)
  w = work("flip_bilinear", l_re=p, l_im=p, a_re=p, a_im=p, inv=None,
           d_rec=None)
  assert roofline.bound_s(w) * 1e3 == pytest.approx(0.6410, abs=1e-4)
  assert roofline.bound_s(w) == w["bytes"] / roofline.PEAK_BYTES_PER_S


def test_flip_apply_and_diag_rotate_are_the_tables_bounds():
  p = planes(64, 2**13, 2**7)
  w = work("flip_apply", states=[(p, p)], rec=None)
  assert roofline.bound_s(w) * 1e3 == pytest.approx(0.3205, abs=1e-4)
  p24 = planes(8, 2**17, 2**7)
  w = work("diag_rotate", states=[(p24, p24)], cos_t=planes(2**17, 2**7),
           sin_t=None, sign=1)
  assert roofline.bound_s(w) * 1e3 == pytest.approx(0.6811, abs=1e-4)


def test_k1_is_charged_three_tf32_products():
  # 24q B=8 (7,7) x (7,7): 8 flops x 256 rows an amplitude, 3x on 495 TF.
  w = work("axis2_apply", p=8, n1=128, m=1, n2=128, q=2**10)
  amps = 8 * 2**24
  assert w["flops"] == 8 * amps * 256
  assert roofline.bound_s(w) == pytest.approx(3 * w["flops"] / 495e12)


def test_every_kernel_file_names_a_wrapper_with_a_counter():
  names = registry.kernel_names()
  assert len(names) == 10
  for k in trace.load_kernels(names):
    assert hasattr(k.fn, "launches"), k.name


def test_share_needs_a_formula_for_every_call():
  traced = {"calls": [("a", {"flops": 0, "bytes": 3.35e9, "rate": "fp32"}),
                      ("b", None)],
            "wrapper_s": {"a": 0.002, "b": 0.001}}
  assert roofline.share_pct(traced, ("a",)) == pytest.approx(50.0)
  assert roofline.share_pct(traced) is None
  assert roofline.share_pct(traced, ("c",)) is None
  assert roofline.share_pct(None) is None


@pytest.mark.parametrize("loss", ["vqt", "qmhl"])
def test_trace_reading_of_a_synthetic_region(loss):
  ev = [
      {"name": trace.REGION, "cat": "user_annotation", "ts": 0, "dur": 100,
       "tid": 1},
      {"name": f"{loss}.loss", "cat": "user_annotation", "ts": 0, "dur": 50,
       "tid": 1},
      {"name": trace.KERNEL_RANGE + "flip_apply", "cat": "user_annotation",
       "ts": 10, "dur": 5, "tid": 1},
      {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 11, "dur": 2,
       "tid": 1, "args": {"correlation": 7}},
      {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 60, "dur": 2,
       "tid": 1, "args": {"correlation": 8}},
      {"name": "aten::copy_", "cat": "cpu_op", "ts": 70, "dur": 20, "tid": 1},
      {"name": "void (anonymous namespace)::flip_apply_kernel<2>(float*)",
       "cat": "kernel", "ts": 20, "dur": 30, "args": {"correlation": 7}},
      {"name": "other_kernel", "cat": "kernel", "ts": 40, "dur": 20,
       "args": {"correlation": 8}},
  ]
  r = trace.read(ev, ["flip_apply", "flip_bilinear"], loss)
  assert r["window_s"] == pytest.approx(100e-6)
  assert r["busy_s"] == pytest.approx(40e-6)  # [20, 60]
  assert r["wrapper_s"] == {"flip_apply": pytest.approx(30e-6),
                            "flip_bilinear": 0.0}
  assert r["device_ops"][0] == ["flip_apply_kernel<2>", pytest.approx(30e-6)]
  gaps = dict(r["idle_gaps"])
  assert gaps["between steps / aten::copy_"] == pytest.approx(40e-6)
  assert gaps[f"{loss}.loss / portbench.kernel.flip_apply"] == (
      pytest.approx(20e-6))
  # Without the cell's loss no range is a part of the step.
  gaps = dict(trace.read(ev, ["flip_apply"])["idle_gaps"])
  assert gaps["between steps / portbench.kernel.flip_apply"] == (
      pytest.approx(20e-6))
