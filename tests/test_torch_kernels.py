"""The port's K4/K5 kernels through their plain versions, on the CPU.

The CUDA kernels themselves run only on the card (`python3 chip_smoke.py`
holds each against its plain version there).  Here:

  * each kernel's plain version against a numpy (or JAX) reference;
  * the wrappers take the plain version for CPU tensors, count no launch,
    and refuse other devices;
  * the plain K4 forward and K5 sweep against the Pallas kernels they
    replace, run in interpret mode, and against the per-state XLA sweep.

Inputs come from numpy seeds and are fed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qhbmlib_tpu.models import circuit_utils as jcu
from qhbmlib_tpu.ops import adjoint as jadjoint
from qhbmlib_tpu.ops import pallas_adjoint
from qhbmlib_tpu.ops import pallas_sv
from qhbmlib_tpu.ops import paulis as jp
from qhbmlib_tpu.ops import statevector as jsv
from qhbmlib_tpu_torch.models import circuit_utils as tcu
from qhbmlib_tpu_torch.ops import _cuda
from qhbmlib_tpu_torch.ops import adjoint as tadjoint
from qhbmlib_tpu_torch.ops import hopper_adjoint
from qhbmlib_tpu_torch.ops import hopper_sv
from qhbmlib_tpu_torch.ops import paulis as tp

torch.set_num_threads(1)

# Gradient tolerance of the reference's own Pallas-vs-XLA sweep tests
# (tests/ops/test_pallas_adjoint.py): sums of ~2^n float32 products.
GRAD_ATOL = 2e-4
STATE_ATOL = 1e-5


def _planes(rng, shape):
  return [torch.tensor(rng.normal(size=shape).astype(np.float32))
          for _ in range(2)]


def _c(planes):
  return planes[0].numpy() + 1j * planes[1].numpy()


# (P, N, Q) views the main path uses: row blocks (Q > 1) and the minor
# operator (Q = 1), plus a ragged P.
VIEWS = [(2, 128, 64), (3 * 128, 64, 128), (24, 128, 1), (5, 4, 8)]


@pytest.mark.parametrize("p,n,q", VIEWS)
def test_axis_apply_plain_matches_numpy(p, n, q):
  rng = np.random.RandomState(p + n + q)
  x = _planes(rng, (p * n * q,))
  op = _planes(rng, (n, n))
  y = hopper_sv.axis_apply_plain(*x, *op, p, n, q)
  expected = np.einsum("MN,pNq->pMq", _c(op), _c(x).reshape(p, n, q))
  np.testing.assert_allclose(_c(y).reshape(p, n, q), expected, atol=1e-4,
                             rtol=1e-5)


@pytest.mark.parametrize("p,n,q", VIEWS)
def test_axis_gram_plain_matches_numpy(p, n, q):
  rng = np.random.RandomState(p * n + q)
  lam = _planes(rng, (p * n * q,))
  a = _planes(rng, (p * n * q,))
  g = hopper_adjoint.axis_gram_plain(*lam, *a, p, n, q)
  expected = np.einsum("pIq,pJq->IJ", _c(lam).reshape(p, n, q).conj(),
                       _c(a).reshape(p, n, q))
  np.testing.assert_allclose(_c(g), expected, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("n", [9, 15])
def test_parity_bilinear_plain_matches_jax(n):
  """Batch-summed bilinears of Im(conj(lam) a) equal the sum of the
  reference's per-state `parity_bilinear` over the HEA diag factors."""
  rng = np.random.RandomState(n)
  shape = (3,) + jsv.state_shape(n)
  lam, a = _planes(rng, shape), _planes(rng, shape)
  pqc = jcu.hardware_efficient_ansatz(n, 1)
  _, idxs = jsv.segment_circuit(pqc.gates)[1]
  m = jsv.minor_bits(n)
  _, rms, cms, _ = jsv.diag_segment_triples([pqc.gates[i] for i in idxs],
                                            n - m, m)
  got = hopper_adjoint.parity_bilinear_plain(*lam, *a, rms, cms)
  p = _c(lam).conj() * _c(a)
  expected = sum(np.asarray(jsv.parity_bilinear(
      rms, cms, jnp.asarray(p[b].imag.astype(np.float32)))) for b in range(3))
  np.testing.assert_allclose(got.numpy(), expected, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("sign", [1, -1])
def test_diag_rotate_plain_is_in_place_rotation(sign):
  rng = np.random.RandomState(7)
  states = [_planes(rng, (2, 4, 8)), _planes(rng, (2, 4, 8))]
  before = [_c(s) for s in states]
  theta = rng.uniform(-3, 3, (4, 8)).astype(np.float32)
  hopper_sv.diag_rotate_plain([tuple(s) for s in states],
                              torch.tensor(np.cos(theta)),
                              torch.tensor(np.sin(theta)), sign)
  for s, b in zip(states, before):
    np.testing.assert_allclose(_c(s), b * np.exp(1j * sign * theta),
                               atol=1e-6)


def test_cpu_tensors_take_plain_versions_without_launches():
  rng = np.random.RandomState(1)
  x, op = _planes(rng, (2 * 4 * 8,)), _planes(rng, (4, 4))
  wrappers = (hopper_sv.axis_apply, hopper_sv.diag_rotate,
              hopper_adjoint.axis_gram, hopper_adjoint.parity_bilinear)
  before = [w.launches for w in wrappers]
  y = hopper_sv.axis_apply(*x, *op, 2, 4, 8)
  y_ref = hopper_sv.axis_apply_plain(*x, *op, 2, 4, 8)
  np.testing.assert_array_equal(_c(y), _c(y_ref))
  g = hopper_adjoint.axis_gram(*x, *x, 2, 4, 8)
  np.testing.assert_array_equal(_c(g), _c(
      hopper_adjoint.axis_gram_plain(*x, *x, 2, 4, 8)))
  s = [tuple(t.reshape(2, 4, 8) for t in x)]
  hopper_sv.diag_rotate(s, torch.ones(4, 8), torch.zeros(4, 8), 1)
  hopper_adjoint.parity_bilinear(*s[0], *s[0], [0, 1], [3, 0])
  assert [w.launches for w in wrappers] == before
  assert _cuda._lib is None  # nothing was built or loaded


def test_wrappers_refuse_other_devices():
  """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
  device raises instead of taking the plain version."""
  x = torch.zeros(2 * 4 * 8, device="meta")
  op = torch.zeros(4, 4, device="meta")
  with pytest.raises(ValueError, match="unsupported device"):
    hopper_sv.axis_apply(x, x, op, op, 2, 4, 8)
  with pytest.raises(ValueError, match="unsupported device"):
    hopper_adjoint.axis_gram(x, x, x, x, 2, 4, 8)
  s = x.reshape(2, 4, 8)
  with pytest.raises(ValueError, match="unsupported device"):
    hopper_sv.diag_rotate([(s, s)], op, op, 1)
  with pytest.raises(ValueError, match="unsupported device"):
    hopper_adjoint.parity_bilinear(s, s, s, s, [1], [1])


def test_build_is_lazy_and_targets_sm90a():
  assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS
  assert [s.name for s in _cuda.sources()] == ["statevector_kernels.cu"]
  name = _cuda.library_path().name
  assert name.startswith("libqhbm_kernels-") and name.endswith(".so")
  assert _cuda.library_path().parent == _cuda.BUILD_DIR


# -- K4 / K5 plain versions against the Pallas kernels (interpret mode) --------

def _problem(n, layers, batch, seed):
  pqc = jcu.hardware_efficient_ansatz(n, layers)
  rng = np.random.RandomState(seed)
  values = rng.uniform(-1, 1, pqc.num_symbols).astype(np.float32)
  bits = rng.randint(0, 2, (batch, n)).astype(np.int8)
  op = jp.tfim_1d(n)
  g = rng.uniform(-1, 1, (batch, op.num_terms)).astype(np.float32)
  return pqc, values, bits, op, g


def _rowcol(bits, n):
  return np.asarray(jadjoint._bits_to_rowcol(jnp.asarray(bits), n))


@pytest.mark.parametrize("layers", [1, 3])
def test_k4_plain_matches_pallas_interpret(layers, monkeypatch):
  # f32 rotation planes on the JAX side, as the port uses.
  monkeypatch.setenv("QHBM_MATMUL_PRECISION", "high")
  n, batch = 9, 4
  pqc, values, bits, _, _ = _problem(n, layers, batch, layers)
  rowcol = _rowcol(bits, n)
  expected = pallas_sv.apply_circuit_pallas_batched(
      pqc, jnp.asarray(values), jnp.asarray(rowcol), interpret=True)
  got = hopper_sv.apply_circuit_batched(
      tcu.hardware_efficient_ansatz(n, layers), torch.tensor(values),
      torch.tensor(rowcol))
  np.testing.assert_allclose(_c(got), np.asarray(expected), atol=STATE_ATOL)


def _psi_lam(pqc, values, bits, op, g):
  """Reference forward states and lambda = sum_t g_t P_t psi per state."""
  n = pqc.num_qubits
  ones = jp.PauliSum(op.codes, jnp.ones_like(op.coeffs), n)
  psis, lams = [], []
  for b, gg in zip(bits, g):
    psi = jsv.apply_circuit(pqc, jnp.asarray(values),
                            jsv.basis_state(n, jnp.asarray(b)))
    psis.append(np.asarray(psi))
    lams.append(np.asarray(jsv.apply_pauli_sum(psi, ones,
                                               term_weights=jnp.asarray(gg))))
  return np.stack(psis), np.stack(lams)


def _split(x):
  return (torch.tensor(np.ascontiguousarray(x.real)),
          torch.tensor(np.ascontiguousarray(x.imag)))


@pytest.mark.parametrize("layers", [1, 3])
def test_k5_plain_matches_pallas_interpret(layers, monkeypatch):
  monkeypatch.setenv("QHBM_MATMUL_PRECISION", "high")
  n, batch = 9, 4
  pqc, values, bits, op, g = _problem(n, layers, batch, 10 + layers)
  psis, lams = _psi_lam(pqc, values, bits, op, g)
  expected = pallas_adjoint.adjoint_sweep_batched(
      pqc, jnp.asarray(values), jnp.asarray(psis), jnp.asarray(lams),
      interpret=True)
  got = hopper_adjoint.adjoint_sweep_batched(
      tcu.hardware_efficient_ansatz(n, layers), torch.tensor(values),
      _split(psis), _split(lams))
  np.testing.assert_allclose(got.numpy(), np.asarray(expected),
                             atol=GRAD_ATOL)
  assert np.abs(np.asarray(expected)).max() > 1e-3  # non-trivial gradient


def test_k5_plain_matches_xla_sweep_two_row_blocks():
  """n = 15 (row blocks (0, 7), (7, 1)): the batch-summed plain sweep equals
  the reference's per-state XLA reverse sweep summed by hand."""
  n, batch = 15, 2
  pqc, values, bits, op, g = _problem(n, 2, batch, 5)
  psis, lams = _psi_lam(pqc, values, bits, op, g)
  expected = sum(np.asarray(jadjoint._xla_reverse_sweep(
      pqc, op, None, jnp.asarray(values), jnp.asarray(p), jnp.asarray(l)))
                 for p, l in zip(psis, lams))
  got = hopper_adjoint.adjoint_sweep_batched(
      tcu.hardware_efficient_ansatz(n, 2), torch.tensor(values),
      _split(psis), _split(lams))
  np.testing.assert_allclose(got.numpy(), expected, atol=GRAD_ATOL)


def test_k4_plain_matches_xla_forward_two_row_blocks():
  n, batch = 15, 2
  pqc, values, bits, _, _ = _problem(n, 2, batch, 6)
  got = hopper_sv.apply_circuit_batched(
      tcu.hardware_efficient_ansatz(n, 2), torch.tensor(values),
      torch.tensor(_rowcol(bits, n)))
  for b in range(batch):
    expected = jsv.apply_circuit(pqc, jnp.asarray(values),
                                 jsv.basis_state(n, jnp.asarray(bits[b])))
    np.testing.assert_allclose(_c(got)[b], np.asarray(expected),
                               atol=STATE_ATOL)


def test_batched_expectations_value_and_grad_match_jax():
  """The autograd Function (K4 forward, lambda build, K5 backward) against
  jax.value_and_grad of the reference's batched_expectations."""
  import jax
  n, batch = 9, 5
  pqc, values, bits, op, _ = _problem(n, 2, batch, 21)
  w = np.random.RandomState(22).uniform(-1, 1, batch).astype(np.float32)

  def loss_j(v):
    e = jadjoint.batched_expectations(pqc, v, jnp.asarray(bits), (op,))
    return jnp.sum(jnp.asarray(w) * e[:, 0])

  val_j, grad_j = jax.value_and_grad(loss_j)(jnp.asarray(values))
  v = torch.tensor(values, requires_grad=True)
  e = tadjoint.batched_expectations(tcu.hardware_efficient_ansatz(n, 2), v,
                                    torch.tensor(bits), (tp.tfim_1d(n),))
  val_t = torch.sum(torch.tensor(w) * e[:, 0])
  val_t.backward()
  np.testing.assert_allclose(float(val_t.detach()), float(val_j),
                             atol=STATE_ATOL)
  np.testing.assert_allclose(v.grad.numpy(), np.asarray(grad_j),
                             atol=GRAD_ATOL)
