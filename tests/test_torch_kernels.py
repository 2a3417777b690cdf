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
from qhbmlib_tpu_torch.ops import statevector as tsv

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


@pytest.mark.parametrize("n", [9, 15, 16])
def test_qubit_transitions_plain_matches_jax(n):
  """Every qubit's batch-summed 2x2 transition equals the sum over states
  of the reference's partial_trace_1q of its block_transition (row
  qubits, row blocks (0, 7) and (7, 1 or 2) at 15 and 16 qubits) or of its
  cross_gram (minor qubits).  float32 sums of ~10^5 products of unit
  normals: 1e-3 absolute."""
  rng = np.random.RandomState(30 + n)
  shape = (3,) + jsv.state_shape(n)
  lam, a = _planes(rng, shape), _planes(rng, shape)
  m = jsv.minor_bits(n)
  nr = n - m
  got = hopper_adjoint.qubit_transitions_plain(*lam, *a, list(range(n)))
  assert got.shape == (n, 2, 2, 2)
  lam_c, a_c = jnp.asarray(_c(lam)), jnp.asarray(_c(a))
  for q in range(n):
    if q >= nr:
      grams = [jsv.cross_gram(lam_c[b], a_c[b]) for b in range(3)]
      k, pos = m, q - nr
    else:
      start, k = next(blk for blk in jsv._row_blocks(nr)
                      if blk[0] <= q < blk[0] + blk[1])
      grams = [jsv.block_transition(lam_c[b], a_c[b], start, k)
               for b in range(3)]
      pos = q - start
    expected = sum(np.asarray(jsv.partial_trace_1q(g, k, pos))
                   for g in grams)
    np.testing.assert_allclose(got[q, 0].numpy() + 1j * got[q, 1].numpy(),
                               expected, atol=1e-3, rtol=1e-5)


def test_sweep_takes_one_transition_call_per_1q_segment(monkeypatch):
  """The batched sweep reduces each 1q segment with ONE qubit_transitions
  call over its gradient qubits (every qubit of the ansatz), not a gram per
  row block, and gives the plain sweep's gradient."""
  n, batch = 9, 3
  pqc, values, bits, op, g = _problem(n, 2, batch, 31)
  psis, lams = _psi_lam(pqc, values, bits, op, g)
  calls = []

  def counted(*args):
    calls.append(tuple(args[4]))
    return hopper_adjoint.qubit_transitions_plain(*args)

  monkeypatch.setattr(hopper_adjoint, "qubit_transitions", counted)
  tpqc = tcu.hardware_efficient_ansatz(n, 2)
  got = hopper_adjoint.adjoint_sweep_batched(
      tpqc, torch.tensor(values), _split(psis), _split(lams))
  segments = [cls for cls, _ in tsv.segment_circuit(tpqc.gates)]
  assert calls == [tuple(range(n))] * segments.count("1q")
  expected = hopper_adjoint.adjoint_sweep_batched(
      tpqc, torch.tensor(values), _split(psis), _split(lams), plain=True)
  np.testing.assert_array_equal(got.numpy(), expected.numpy())


def test_sweep_takes_one_bilinear_call_per_diag_stage(monkeypatch):
  """The batched sweep runs each diagonal stage as ONE `parity_bilinear`
  call given the stage's cos/sin planes (the bilinears and the un-apply of
  a and lambda in one pass) and calls `diag_rotate` nowhere, and gives the
  plain sweep's gradient."""
  n, batch = 9, 3
  pqc, values, bits, op, g = _problem(n, 2, batch, 32)
  psis, lams = _psi_lam(pqc, values, bits, op, g)
  bilinears, rotations = [], []
  real_bilinear = hopper_adjoint.parity_bilinear

  def counted_bilinear(*args):
    bilinears.append(args[6])
    return real_bilinear(*args)

  def counted_rotate(*args):
    rotations.append(args)
    return hopper_sv.diag_rotate_plain(*args)

  monkeypatch.setattr(hopper_adjoint, "parity_bilinear", counted_bilinear)
  monkeypatch.setattr(hopper_sv, "diag_rotate", counted_rotate)
  tpqc = tcu.hardware_efficient_ansatz(n, 2)
  got = hopper_adjoint.adjoint_sweep_batched(
      tpqc, torch.tensor(values), _split(psis), _split(lams))
  segments = [cls for cls, _ in tsv.segment_circuit(tpqc.gates)]
  assert len(bilinears) == segments.count("diag") == 2
  assert all(len(planes) == 2 for planes in bilinears)
  assert not rotations
  expected = hopper_adjoint.adjoint_sweep_batched(
      tpqc, torch.tensor(values), _split(psis), _split(lams), plain=True)
  np.testing.assert_array_equal(got.numpy(), expected.numpy())


def test_fused_diag_stage_plain_is_bilinear_then_unapply():
  """parity_bilinear with the planes: the bilinears of the states as given
  and both states rotated by exp(-i theta) in place, as the two plain
  versions in sequence; without them the states are left alone."""
  rng = np.random.RandomState(8)
  shape = (3, 2, 8)
  lam, a = _planes(rng, shape), _planes(rng, shape)
  before = [_c(lam), _c(a)]
  theta = rng.uniform(-3, 3, shape[1:]).astype(np.float32)
  planes = (torch.tensor(np.cos(theta)), torch.tensor(np.sin(theta)))
  rms, cms = [0, 1, 3], [5, 0, 7]
  alone = hopper_adjoint.parity_bilinear(*lam, *a, rms, cms)
  np.testing.assert_array_equal(_c(lam), before[0])
  fused = hopper_adjoint.parity_bilinear(*lam, *a, rms, cms, planes)
  np.testing.assert_array_equal(fused.numpy(), alone.numpy())
  for state, b in zip((lam, a), before):
    np.testing.assert_allclose(_c(state), b * np.exp(-1j * theta),
                               atol=1e-6)


def test_k4_plain_matches_pallas_interpret_small_state_large_batch(
    monkeypatch):
  """The forward at the r2 rung's shape, a small state in a large batch:
  8q (the smallest n `pallas_sv.batched_supported` admits) B = 64."""
  monkeypatch.setenv("QHBM_MATMUL_PRECISION", "high")
  n, batch = 8, 64
  pqc, values, bits, _, _ = _problem(n, 2, batch, 41)
  rowcol = _rowcol(bits, n)
  expected = pallas_sv.apply_circuit_pallas_batched(
      pqc, jnp.asarray(values), jnp.asarray(rowcol), interpret=True)
  got = hopper_sv.apply_circuit_batched(
      tcu.hardware_efficient_ansatz(n, 2), torch.tensor(values),
      torch.tensor(rowcol))
  np.testing.assert_allclose(_c(got), np.asarray(expected), atol=STATE_ATOL)


def test_k5_plain_matches_pallas_interpret_small_state_large_batch(
    monkeypatch):
  """The sweep (each diagonal stage one fused `parity_bilinear` call) at
  8q B = 64 against `pallas_adjoint.adjoint_sweep_batched` (its
  "bwddiagrot": the bilinears, then the un-apply) in interpret mode."""
  monkeypatch.setenv("QHBM_MATMUL_PRECISION", "high")
  n, batch = 8, 64
  pqc, values, bits, op, g = _problem(n, 2, batch, 42)
  psis, lams = _psi_lam(pqc, values, bits, op, g)
  expected = pallas_adjoint.adjoint_sweep_batched(
      pqc, jnp.asarray(values), jnp.asarray(psis), jnp.asarray(lams),
      interpret=True)
  got = hopper_adjoint.adjoint_sweep_batched(
      tcu.hardware_efficient_ansatz(n, 2), torch.tensor(values),
      _split(psis), _split(lams))
  np.testing.assert_allclose(got.numpy(), np.asarray(expected),
                             atol=GRAD_ATOL)
  assert np.abs(np.asarray(expected)).max() > 1e-3  # non-trivial gradient


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
              hopper_adjoint.qubit_transitions,
              hopper_adjoint.parity_bilinear)
  before = [w.launches for w in wrappers]
  y = hopper_sv.axis_apply(*x, *op, 2, 4, 8)
  y_ref = hopper_sv.axis_apply_plain(*x, *op, 2, 4, 8)
  np.testing.assert_array_equal(_c(y), _c(y_ref))
  s = [tuple(t.reshape(2, 4, 8) for t in x)]
  np.testing.assert_array_equal(
      hopper_adjoint.qubit_transitions(*s[0], *s[0], [0, 3]),
      hopper_adjoint.qubit_transitions_plain(*s[0], *s[0], [0, 3]))
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
  s = x.reshape(2, 4, 8)
  with pytest.raises(ValueError, match="unsupported device"):
    hopper_adjoint.qubit_transitions(s, s, s, s, [0])
  with pytest.raises(ValueError, match="unsupported device"):
    hopper_sv.diag_rotate([(s, s)], op, op, 1)
  with pytest.raises(ValueError, match="unsupported device"):
    hopper_adjoint.parity_bilinear(s, s, s, s, [1], [1])


def test_build_is_lazy_and_targets_sm90a():
  assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS
  assert [s.name for s in _cuda.sources()] == ["statevector_kernels.cu",
                                               "stream_kernels.cu"]
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
                                    torch.tensor(bits),
                                    (tp.tfim_1d(n, device="cpu"),))
  val_t = torch.sum(torch.tensor(w) * e[:, 0])
  val_t.backward()
  np.testing.assert_allclose(float(val_t.detach()), float(val_j),
                             atol=STATE_ATOL)
  np.testing.assert_allclose(v.grad.numpy(), np.asarray(grad_j),
                             atol=GRAD_ATOL)


# -- K1: the two-axis fused 1q-segment apply ----------------------------------

# (P, N1, M, N2, Q) views: first row block x minor (20q / 24q pattern, cut
# in P and M), two adjacent row blocks (24q pass 2, cut in P), a ragged mix.
VIEWS2 = [(2, 128, 4, 128, 1), (3, 128, 1, 8, 128), (2, 4, 2, 16, 8),
          (5, 2, 1, 2, 2)]


@pytest.mark.parametrize("p,n1,m,n2,q", VIEWS2)
def test_axis2_apply_plain_matches_numpy(p, n1, m, n2, q):
  rng = np.random.RandomState(p + n1 + m + n2 + q)
  x = _planes(rng, (p * n1 * m * n2 * q,))
  a, b = _planes(rng, (n1, n1)), _planes(rng, (n2, n2))
  y = hopper_sv.axis2_apply_plain(*x, *a, *b, p, n1, m, n2, q)
  expected = np.einsum("Ii,Jj,pimjq->pImJq", _c(a), _c(b),
                       _c(x).reshape(p, n1, m, n2, q))
  # float32 sums of N1 * N2 products of unit normals: 1e-5 of the scale.
  np.testing.assert_allclose(_c(y).reshape(expected.shape), expected,
                             atol=1e-5 * np.abs(expected).max())


def test_plan_passes_pairs_first_block_with_minor():
  """24q: (0,7)x minor, (7,7)x(14,3); 22q: (0,7)x minor, (7,7)x(14,1);
  20q: (0,7)x minor, then (7,6) alone; no minor: row blocks in pairs."""
  def bits(ops, nr):
    return [tuple(p[::2]) for p in hopper_sv.plan_passes(ops, nr)]

  for n, want in [(24, [((0, 7), (17, 7)), ((7, 7), (14, 3))]),
                  (22, [((0, 7), (15, 7)), ((7, 7), (14, 1))]),
                  (20, [((0, 7), (13, 7)), ((7, 6),)])]:
    nr = n - 7
    ops = [(blk, "op") for blk in tsv._row_blocks(nr)] + [((nr, 7), "op")]
    assert bits(ops, nr) == want
  rows = [((0, 7), "a"), ((7, 7), "b"), ((14, 3), "c")]
  assert hopper_sv.plan_passes(rows, 17) == [
      ((0, 7), "a", (7, 7), "b"), ((14, 3), "c")]


def _unitary(rng, dim):
  a = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
  return np.linalg.qr(a)[0].astype(np.complex64)


@pytest.mark.parametrize("n", [15, 16])
@pytest.mark.parametrize("use", [(True, True, True), (True, False, True),
                                 (True, True, False), (False, True, True)])
def test_k1_plain_matches_fused_blocks_minor_apply_interpret(n, use):
  """fused_blocks_minor_apply (axis2_apply passes, plain) against the
  reference's Pallas K1 in interpret mode, each stage present or None."""
  rng = np.random.RandomState(n)
  r, c = jsv.state_shape(n)
  state = rng.standard_normal((r, c)) + 1j * rng.standard_normal((r, c))
  state = (state / np.linalg.norm(state)).astype(np.complex64)
  (s1, k1), (s2, k2) = jsv._row_blocks(n - 7)[:2]
  mats = [_unitary(rng, 2**k1), _unitary(rng, 2**k2), _unitary(rng, c)]
  m1, m2, minor = [mat if u else None for mat, u in zip(mats, use)]
  expected = pallas_sv.fused_blocks_minor_apply(
      jnp.asarray(state), k1, k2, None if m1 is None else jnp.asarray(m1),
      None if m2 is None else jnp.asarray(m2),
      None if minor is None else jnp.asarray(minor.T), interpret=True)
  ops = [None if mat is None else _split(mat) for mat in (m1, m2, minor)]
  got = hopper_sv.fused_blocks_minor_apply(
      tuple(t[None] for t in _split(state)), k1, k2, *ops)
  np.testing.assert_allclose(_c(got)[0], np.asarray(expected),
                             atol=STATE_ATOL)


def test_k1_plain_matches_apply_majors_and_minor_22q():
  """Three row blocks (0,7), (7,7), (14,1) and the minor operator: the
  port's apply_majors_and_minor (two axis2_apply passes) against the
  reference's block matmuls."""
  n = 22
  rng = np.random.RandomState(22)
  r, c = jsv.state_shape(n)
  state = (rng.standard_normal((r, c)) +
           1j * rng.standard_normal((r, c))).astype(np.complex64)
  majors = {q: _unitary(rng, 2) for q in (0, 5, 8, 13, 14)}
  minor = np.kron(_unitary(rng, 2), np.eye(64)).astype(np.complex64)
  expected = jsv.apply_majors_and_minor(
      jnp.asarray(state), {q: jnp.asarray(u) for q, u in majors.items()},
      jnp.asarray(minor))
  got = tsv.apply_majors_and_minor(
      torch.tensor(state), {q: torch.tensor(u) for q, u in majors.items()},
      torch.tensor(minor))
  np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-4)


def test_k4_forward_with_k1_stages_matches_xla_16q():
  """The batched forward, whose 1q stages run as K1 passes ((0,7) x minor,
  then (7,2)), against the reference's XLA forward per state at 16q."""
  n, batch = 16, 2
  pqc, values, bits, _, _ = _problem(n, 2, batch, 16)
  stages = hopper_sv.prepare_segments(tcu.hardware_efficient_ansatz(n, 2),
                                      values, "cpu")
  assert any(len(p) == 4 for kind, body in stages if kind == "1q"
             for p in body)
  got = hopper_sv.apply_circuit_batched(
      tcu.hardware_efficient_ansatz(n, 2), torch.tensor(values),
      torch.tensor(_rowcol(bits, n)))
  for b in range(batch):
    expected = jsv.apply_circuit(pqc, jnp.asarray(values),
                                 jsv.basis_state(n, jnp.asarray(bits[b])))
    np.testing.assert_allclose(_c(got)[b], np.asarray(expected),
                               atol=STATE_ATOL)


def test_axis2_apply_cpu_plain_and_other_devices_refused():
  rng = np.random.RandomState(2)
  x, a, b = _planes(rng, (2 * 4 * 8,)), _planes(rng, (4, 4)), _planes(
      rng, (8, 8))
  before = hopper_sv.axis2_apply.launches
  y = hopper_sv.axis2_apply(*x, *a, *b, 2, 4, 1, 8, 1)
  np.testing.assert_array_equal(
      _c(y), _c(hopper_sv.axis2_apply_plain(*x, *a, *b, 2, 4, 1, 8, 1)))
  assert hopper_sv.axis2_apply.launches == before
  meta = [t.to("meta") for t in x + a + b]
  with pytest.raises(ValueError, match="unsupported device"):
    hopper_sv.axis2_apply(*meta, 2, 4, 1, 8, 1)


# -- K1 on the tensor cores: the error budget of 3xTF32 -----------------------

def _tf32(x):
  """float32 -> TF32 as cvt.rna.tf32.f32 rounds: to nearest, ties away from
  zero, on the bit pattern (10 explicit mantissa bits kept)."""
  bits = np.asarray(x, np.float32).view(np.uint32)
  return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _matmul_tf32(a, b, products):
  """a @ b of float32 matrices from TF32 parts, as K1's contraction splits
  them: big = tf32(x), small = tf32(x - big); products 3 sums small*big +
  big*small + big*big, products 1 big*big alone.  TF32 products are exact
  in float32, summed in float32."""
  a_big, b_big = _tf32(a), _tf32(b)
  out = a_big @ b_big
  if products == 3:
    out = (_tf32(a - a_big) @ b_big + a_big @ _tf32(b - b_big)) + out
  return out


def _cmatmul_tf32(o_re, o_im, s_re, s_im, products):
  """Op S in split complex, four real products (no 3-multiply form)."""
  return (_matmul_tf32(o_re, s_re, products) -
          _matmul_tf32(o_im, s_im, products),
          _matmul_tf32(o_re, s_im, products) +
          _matmul_tf32(o_im, s_re, products))


@pytest.mark.parametrize("n,lone", [
    pytest.param(24, False, id="24"), pytest.param(20, False, id="20"),
    pytest.param(20, True, id="20-lone-block-7-6")])
def test_k1_3xtf32_split_holds_the_state_gate(n, lone):
  """K1's first pass ((0,7) block x the minor operator) of the n-qubit
  ansatz's first 1q segment, seeded angles and a seeded state cut to
  M = 4, computed with the 3xTF32 split: within 1e-5 relative L2
  (chip_smoke's STATE_TOL for K1 against its plain version) of the float64
  product and within 2x of plain float32's error, where one TF32 product
  is not within 1e-5.  With `lone`, the row block (7,6) that plan_passes
  leaves unpaired at 20q, one axis alone over 4 x 128 columns: the
  contraction that axis_apply runs on the tensor cores with K1's split."""
  nr = n - tsv.minor_bits(n)
  pqc = tcu.hardware_efficient_ansatz(n, 2)
  values = np.random.RandomState(n).uniform(0, 2, pqc.num_symbols)
  ops = hopper_sv.forward_plan(pqc, values)[0][1]
  passes = hopper_sv.plan_passes(ops, nr)
  rng = np.random.RandomState(n + 1)

  def c128(planes):
    return (planes[0] + 1j * planes[1]).astype(np.complex128)

  def c64(planes):
    return (planes[0] + 1j * planes[1]).astype(np.complex64)

  if lone:
    (s, k), op = passes[1]
    assert (s, k) == (7, 6)
    a = [t.numpy() for t in hopper_sv.split(op)]
    x = [rng.standard_normal((2**k, 4 * 128)).astype(np.float32)
         for _ in range(2)]
    expected = c128(a) @ c128(x)

    def pass_(products):
      y = _cmatmul_tf32(*a, *x, products)
      return y[0] + 1j * y[1].astype(np.complex128)

    fp32 = c64(a) @ c64(x)
  else:
    (s1, k1), op_a, (s2, k2), op_b = passes[0]
    assert (s1, k1, s2, k2) == (0, 7, nr, 7)
    n1, n2, m = 2**k1, 2**k2, 4
    x = [rng.standard_normal((n1, m * n2)).astype(np.float32)
         for _ in range(2)]
    a = [t.numpy() for t in hopper_sv.split(op_a)]
    b = [t.numpy() for t in hopper_sv.split(op_b)]
    expected = (c128(a) @ c128(x)).reshape(n1, m, n2) @ c128(b).T
    expected = expected.reshape(n1, m * n2)

    def pass_(products):
      # A on the N1 axis, the slab held in float32, then B on the N2 axis.
      y = _cmatmul_tf32(*a, *x, products)
      cols = [t.reshape(n1, m, n2).transpose(2, 0, 1).reshape(n2, -1)
              for t in y]
      y = _cmatmul_tf32(*b, *cols, products)
      y = [t.reshape(n2, n1, m).transpose(1, 2, 0).reshape(n1, -1)
           for t in y]
      return y[0] + 1j * y[1].astype(np.complex128)

    # The plain version's float32 complex products, for scale (~3e-7).
    fp32 = (c64(a) @ c64(x)).reshape(n1, m, n2) @ c64(b).T

  def err(y):
    return np.linalg.norm(y - expected) / np.linalg.norm(expected)

  three = err(pass_(3))
  assert three < 1e-5
  assert three < 2 * err(fp32.reshape(expected.shape))
  assert err(pass_(1)) > 1e-5  # one TF32 product: ~4e-4
