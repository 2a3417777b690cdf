"""K1's route rule and its per-route launch count (`hopper_sv.axis2_route`,
`hopper_sv.axis2_apply.route_launches`).

Every K1 pass of the 24q, 20q and 28q main paths (and 16q's first) takes
the warpgroup-MMA kernel; the harness's and other small views keep the
mma.sync kernel.  The kernels themselves run in `test_torch_k1_emulated.py`
and on the card (`chip_smoke.check_axis2`)."""

import functools

import pytest
import torch

from qhbmlib_tpu_torch.models import circuit_utils
from qhbmlib_tpu_torch.ops import hopper_sv
from qhbmlib_tpu_torch.ops import statevector as sv

torch.set_num_threads(1)


def _pass_views(n: int, batch: int = 8):
  """[P, N1, M, N2, Q] views of the K1 passes of the first 1q segment of
  the n-qubit two-layer ansatz, as `hopper_sv.apply_pass` makes them."""
  pqc = circuit_utils.hardware_efficient_ansatz(n, 2)
  values = torch.rand(pqc.num_symbols,
                      generator=torch.Generator().manual_seed(0)) * 2.0
  ops = hopper_sv.forward_plan(pqc, values)[0][1]
  passes = hopper_sv.plan_passes(ops, n - sv.minor_bits(n))
  return [(batch << s1, 2**k1, 2**(s2 - s1 - k1), 2**k2, 2**(n - s2 - k2))
          for (s1, k1), _, (s2, k2), _ in (p for p in passes if len(p) == 4)]


@pytest.mark.parametrize("n,pairs", [(16, 1), (20, 1), (24, 2), (28, 2)])
def test_main_path_passes_take_the_wgmma_route(n, pairs):
  views = _pass_views(n)
  assert len(views) == pairs
  assert [hopper_sv.axis2_route(n1, n2, q) for _, n1, _, n2, q in views] == \
      ["wgmma"] * pairs


@pytest.mark.parametrize("n", [8, 9, 12, 13])
def test_small_views_keep_the_mma_sync_route(n):
  views = _pass_views(n)
  assert views
  assert {hopper_sv.axis2_route(n1, n2, q) for _, n1, _, n2, q in views} == \
      {"mma_sync"}


@pytest.mark.parametrize("n1,n2,q,route", [
    (128, 128, 1, "wgmma"),     # pass 1 at 16-28q: (0,7) x minor
    (128, 128, 128, "wgmma"),   # 28q pass 2: (7,7) x (14,7)
    (128, 8, 128, "wgmma"),     # 24q pass 2: (7,7) x (14,3)
    (128, 8, 16, "wgmma"),      # W = 16 = Q
    (128, 8, 8, "mma_sync"),    # a slab row of 64
    (128, 2, 64, "wgmma"),
    (128, 16, 128, "mma_sync"),  # N2 of 16-64: the mma.sync kernel
    (128, 64, 2, "mma_sync"),
    (64, 128, 1, "mma_sync"),
    (2, 128, 1, "mma_sync"),
])
def test_route_rule(n1, n2, q, route):
  assert hopper_sv.axis2_route(n1, n2, q) == route


class _CudaLike:
  """Stands for a CUDA operand in the wrapper's own logic: its device,
  shape and size; the launch itself is replaced."""
  device = torch.device("cuda", 0)

  def __init__(self, *shape):
    self.shape = torch.Size(shape)

  def numel(self):
    return self.shape.numel()


@pytest.mark.parametrize("view,route", [
    ((8, 128, 1024, 128, 1), "wgmma"),
    ((1024, 128, 1, 8, 128), "wgmma"),
    ((8, 32, 1, 128, 1), "mma_sync"),
])
def test_each_launch_counts_once_and_on_its_route(monkeypatch, view, route):
  p, n1, m, n2, q = view
  launched = []

  def launch(rt, x_re, x_im, ops, *shape):
    launched.append((rt, shape))
    return x_re, x_im

  monkeypatch.setattr(hopper_sv, "_axis2_launch", launch)
  monkeypatch.setattr(hopper_sv._cuda, "require", lambda *a, **k: None)
  counts = hopper_sv.axis2_apply.route_launches
  before = hopper_sv.axis2_apply.launches, dict(counts)
  x = [_CudaLike(p * n1 * m * n2 * q) for _ in range(2)]
  ops = [_CudaLike(n1, n1)] * 2 + [_CudaLike(n2, n2)] * 2
  for _ in range(3):
    hopper_sv.axis2_apply(*x, *ops, p, n1, m, n2, q)
  assert launched == [(route, view)] * 3
  assert hopper_sv.axis2_apply.launches == before[0] + 3
  assert counts == {k: v + 3 * (k == route) for k, v in before[1].items()}


def test_route_counts_are_shared_with_a_copying_wrapper():
  """A wrapper made by functools.wraps (as the benchmark's tracer makes
  one) counts into the same route table."""
  wrapper = functools.wraps(hopper_sv.axis2_apply)(lambda *a: None)
  assert wrapper.route_launches is hopper_sv.axis2_apply.route_launches


def test_cpu_tensors_count_no_route():
  counts = dict(hopper_sv.axis2_apply.route_launches)
  x = [torch.randn(8 * 128 * 128) for _ in range(2)]
  ops = [torch.randn(128, 128) for _ in range(4)]
  hopper_sv.axis2_apply(*x, *ops, 8, 128, 1, 128, 1)
  assert hopper_sv.axis2_apply.route_launches == counts
