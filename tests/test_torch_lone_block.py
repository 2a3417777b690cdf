"""The batched engine through a lone row block of N < 16, against the JAX
package on the CPU.

At 15, 16 and 17 qubits the row qubits split into blocks (0, 7) and (7, k),
k = 1, 2, 3: `plan_passes` pairs the first with the minor operator and
leaves (7, k) alone, so every 1q segment applies it through `axis_apply` at
N = 2, 4, 8 (Q = 128) -- in the forward once, in the sweep's un-applies of
a and lambda twice (each 1q segment but the sweep's last, past whose
reductions nothing is read).  Here the port's plain versions run that
path and are held against the Pallas kernels they replace (K4
`apply_circuit_pallas_batched`, K5 `adjoint_sweep_batched`) in interpret
mode, on inputs made with numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qhbmlib_tpu.ops import pallas_adjoint
from qhbmlib_tpu.ops import pallas_sv
from qhbmlib_tpu_torch.models import circuit_utils as tcu
from qhbmlib_tpu_torch.ops import hopper_adjoint
from qhbmlib_tpu_torch.ops import hopper_sv
from tests.test_torch_kernels import (GRAD_ATOL, STATE_ATOL, _c, _problem,
                                      _psi_lam, _rowcol, _split)

torch.set_num_threads(1)

BATCH = 2
LAYERS = 1
SWEEP_LAYERS = 2  # the sweep un-applies every 1q segment but the first


@pytest.fixture
def lone_views(monkeypatch):
  """Records the [P, N, Q] view of every `axis_apply` call."""
  views = []
  orig = hopper_sv.axis_apply

  def spy(x_re, x_im, op_re, op_im, p, n, q):
    views.append((p, n, q))
    return orig(x_re, x_im, op_re, op_im, p, n, q)

  monkeypatch.setattr(hopper_sv, "axis_apply", spy)
  return views


def _lone_view(n):
  """The lone block (7, n - 14) of B states: P = B * 2^7, N, Q = 128."""
  return (BATCH << 7, 2**(n - 14), 128)


@pytest.mark.parametrize("n", [15, 16, 17])
def test_lone_block_forward_matches_pallas_interpret(n, lone_views,
                                                     monkeypatch):
  """apply_circuit_batched within STATE_ATOL (1e-5) of the Pallas forward:
  both sum the same float32 products."""
  monkeypatch.setenv("QHBM_MATMUL_PRECISION", "high")
  pqc, values, bits, _, _ = _problem(n, LAYERS, BATCH, 30 + n)
  rowcol = _rowcol(bits, n)
  expected = pallas_sv.apply_circuit_pallas_batched(
      pqc, jnp.asarray(values), jnp.asarray(rowcol), interpret=True)
  got = hopper_sv.apply_circuit_batched(
      tcu.hardware_efficient_ansatz(n, LAYERS), torch.tensor(values),
      torch.tensor(rowcol))
  np.testing.assert_allclose(_c(got), np.asarray(expected), atol=STATE_ATOL)
  # One 1q segment a layer, one lone-block pass a segment.
  assert lone_views.count(_lone_view(n)) == LAYERS


@pytest.mark.parametrize("n", [15, 16, 17])
def test_lone_block_sweep_matches_pallas_interpret(n, lone_views,
                                                   monkeypatch):
  """adjoint_sweep_batched within GRAD_ATOL (2e-4, the reference's own
  Pallas-vs-XLA sweep tolerance) of the Pallas sweep."""
  monkeypatch.setenv("QHBM_MATMUL_PRECISION", "high")
  pqc, values, bits, op, g = _problem(n, SWEEP_LAYERS, BATCH, 40 + n)
  psis, lams = _psi_lam(pqc, values, bits, op, g)
  expected = pallas_adjoint.adjoint_sweep_batched(
      pqc, jnp.asarray(values), jnp.asarray(psis), jnp.asarray(lams),
      interpret=True)
  got = hopper_adjoint.adjoint_sweep_batched(
      tcu.hardware_efficient_ansatz(n, SWEEP_LAYERS), torch.tensor(values),
      _split(psis), _split(lams))
  np.testing.assert_allclose(got.numpy(), np.asarray(expected),
                             atol=GRAD_ATOL)
  assert np.abs(np.asarray(expected)).max() > 1e-3  # non-trivial gradient
  # The un-applies of a and lambda, a pair of passes a 1q segment, the
  # sweep's last segment (the first layer's) left out.
  assert lone_views.count(_lone_view(n)) == 2 * (SWEEP_LAYERS - 1)
