"""PyTorch port vs the JAX package: statevector ops, gates, dedup, imports.

Inputs are made with numpy from fixed seeds and fed to both packages.
Tolerance: atol 1e-5 on float32 results of O(1) magnitude unless a test
says otherwise.  n = 15 has two row blocks (nr = 8), the case the 20-qubit
path runs.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qhbmlib_tpu import utils as jutils
from qhbmlib_tpu.models import circuit_utils as jcu
from qhbmlib_tpu.ops import adjoint as jadjoint
from qhbmlib_tpu.ops import circuit_ir as jir
from qhbmlib_tpu.ops import paulis as jp
from qhbmlib_tpu.ops import statevector as jsv
from qhbmlib_tpu_torch import utils as tutils
from qhbmlib_tpu_torch.models import circuit_utils as tcu
from qhbmlib_tpu_torch.ops import adjoint as tadjoint
from qhbmlib_tpu_torch.ops import paulis as tp
from qhbmlib_tpu_torch.ops import statevector as tsv

torch.set_num_threads(1)

ATOL = 1e-5
NS = [3, 9, 15]
NS_WITH_ROWS = [9, 15]


def _state(rng, n, batch=()):
  r, c = jsv.state_shape(n)
  x = rng.normal(size=batch + (r, c)) + 1j * rng.normal(size=batch + (r, c))
  norm = np.sqrt(np.sum(np.abs(x)**2, axis=(-2, -1), keepdims=True))
  return (x / norm).astype(np.complex64)


def _mat(rng, dim):
  return (rng.normal(size=(dim, dim)) +
          1j * rng.normal(size=(dim, dim))).astype(np.complex64) / dim**0.5


def _close(actual, expected, atol=ATOL):
  np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                             atol=atol, rtol=0)


def _diag_segment(n, layers=1):
  """Gates of the first diagonal segment of the hardware-efficient ansatz."""
  pqc = jcu.hardware_efficient_ansatz(n, layers)
  cls, idxs = jsv.segment_circuit(pqc.gates)[1]
  assert cls == "diag"
  return [pqc.gates[i] for i in idxs]


@pytest.mark.parametrize("n", NS_WITH_ROWS)
def test_apply_row_block(n):
  rng = np.random.RandomState(n)
  psi = _state(rng, n)
  nr = n - jsv.minor_bits(n)
  for start, k in jsv._row_blocks(nr):
    mat = _mat(rng, 2**k)
    expected = jsv.apply_row_block(jnp.asarray(mat), start, k,
                                   jnp.asarray(psi))
    actual = tsv.apply_row_block(torch.tensor(mat), start, k,
                                 torch.tensor(psi))
    _close(actual, expected)


@pytest.mark.parametrize("n", NS)
def test_apply_minor_mat(n):
  rng = np.random.RandomState(n + 1)
  psi = _state(rng, n)
  mat = _mat(rng, psi.shape[1])
  _close(tsv.apply_minor_mat(torch.tensor(psi), torch.tensor(mat)),
         jsv.apply_minor_mat(jnp.asarray(psi), jnp.asarray(mat)))


@pytest.mark.parametrize("n", NS_WITH_ROWS)
def test_block_transition(n):
  rng = np.random.RandomState(n + 2)
  lam, a = _state(rng, n), _state(rng, n)
  nr = n - jsv.minor_bits(n)
  for start, k in jsv._row_blocks(nr):
    _close(tsv.block_transition(torch.tensor(lam), torch.tensor(a), start, k),
           jsv.block_transition(jnp.asarray(lam), jnp.asarray(a), start, k))


@pytest.mark.parametrize("n", NS)
def test_cross_gram(n):
  rng = np.random.RandomState(n + 3)
  lam, a = _state(rng, n), _state(rng, n)
  _close(tsv.cross_gram(torch.tensor(lam), torch.tensor(a)),
         jsv.cross_gram(jnp.asarray(lam), jnp.asarray(a)))


@pytest.mark.parametrize("n", NS)
def test_parity_bilinear(n):
  rng = np.random.RandomState(n + 4)
  p = rng.normal(size=jsv.state_shape(n)).astype(np.float32) / 2**(n / 2)
  m = jsv.minor_bits(n)
  _, rms, cms, _ = jsv.diag_segment_triples(_diag_segment(n), n - m, m)
  _close(tsv.parity_bilinear(rms, cms, torch.tensor(p)),
         jsv.parity_bilinear(rms, cms, jnp.asarray(p)))


@pytest.mark.parametrize("n", NS)
def test_diag_segment_phase(n):
  rng = np.random.RandomState(n + 5)
  gates = _diag_segment(n)
  angles = rng.uniform(-1, 1, len(gates)).astype(np.float32)
  # Phases are sums of ~n angles times pi: 1e-5 relative to their scale.
  _close(tsv.diag_segment_phase(gates, angles, jsv.state_shape(n),
                                device="cpu"),
         jsv.diag_segment_phase(gates, [jnp.asarray(x) for x in angles],
                                jsv.state_shape(n)), atol=1e-5 * n)


@pytest.mark.parametrize("n", NS)
def test_expectation_terms_tfim(n):
  rng = np.random.RandomState(n + 6)
  psi = _state(rng, n)
  _close(tsv.expectation_terms(torch.tensor(psi),
                               tp.tfim_1d(n, device="cpu")),
         jsv.expectation_terms(jnp.asarray(psi), jp.tfim_1d(n)))


@pytest.mark.parametrize("n", NS)
def test_expectation_terms_batched(n):
  """A leading batch axis gives the per-state results."""
  rng = np.random.RandomState(n + 7)
  psis = _state(rng, n, (3,))
  actual = tsv.expectation_terms(torch.tensor(psis),
                                 tp.tfim_1d(n, device="cpu"))
  for i in range(3):
    _close(actual[i], jsv.expectation_terms(jnp.asarray(psis[i]),
                                            jp.tfim_1d(n)))


@pytest.mark.parametrize("n", NS)
def test_apply_pauli_sum_tfim(n):
  rng = np.random.RandomState(n + 8)
  psis = _state(rng, n, (2,))
  op_j, op_t = jp.tfim_1d(n), tp.tfim_1d(n, device="cpu")
  w = rng.uniform(-1, 1, (2, op_j.num_terms)).astype(np.float32)
  actual = tsv.apply_pauli_sum(torch.tensor(psis), op_t,
                               term_weights=torch.tensor(w))
  for i in range(2):
    _close(actual[i], jsv.apply_pauli_sum(jnp.asarray(psis[i]), op_j,
                                          term_weights=jnp.asarray(w[i])))


@pytest.mark.parametrize("n", NS)
def test_basis_state(n):
  bits = np.random.RandomState(n + 9).randint(0, 2, n).astype(np.int8)
  _close(tsv.basis_state(n, torch.tensor(bits)),
         jsv.basis_state(n, jnp.asarray(bits)), atol=0)


@pytest.mark.parametrize("kind", [jir.XP, jir.YP, jir.HP, jir.RX, jir.RY,
                                  jir.RZ, jir.ZP, jir.CZP])
def test_gate_matrix(kind):
  for angle in (-1.3, 0.0, 0.37, 2.5):
    _close(tsv.gate_matrix(kind, angle), jsv.gate_matrix(kind, angle),
           atol=1e-6)


@pytest.mark.parametrize("kind", [jir.XP, jir.YP, jir.HP, jir.RX, jir.RY])
def test_gate_matrix_dangle(kind):
  """The closed-form derivative the port uses against jax.jvp."""
  for angle in (-1.3, 0.37, 2.5):
    a = jnp.asarray(angle, jnp.float32)
    _, expected = jax.jvp(lambda t: jsv.gate_matrix(kind, t), (a,),
                          (jnp.ones_like(a),))
    _close(tsv.gate_matrix_dangle(kind, angle), expected, atol=1e-5)


def test_resolve_angles_match_reference():
  pqc_t = tcu.hardware_efficient_ansatz(5, 2)
  pqc_j = jcu.hardware_efficient_ansatz(5, 2)
  vals = np.random.RandomState(1).uniform(-2, 2,
                                          pqc_j.num_symbols).astype(np.float32)
  expected = [np.asarray(jsv.resolve_angle(g, jnp.asarray(vals)))
              for g in pqc_j.gates]
  np.testing.assert_array_equal(tsv.resolve_angles(pqc_t, vals), expected)


@pytest.mark.parametrize("n", NS)
def test_apply_majors_and_minor(n):
  """Per-qubit row operators plus the minor operator folded as a kron (the
  port's fold) against the reference's embedded-product fold and apply."""
  from qhbmlib_tpu_torch.ops import hopper_sv
  rng = np.random.RandomState(n + 10)
  psi = _state(rng, n)
  m = jsv.minor_bits(n)
  gates = [jir.Gate(jir.XP, (q,), -1, 0.0, float(x))
           for q, x in enumerate(rng.uniform(-1, 1, n))]
  angles = np.asarray([g.shift for g in gates], np.float32)
  majors_t, minor_t = hopper_sv.fold_1q(gates, angles, n - m, m)
  majors_j, minor_j = {}, None
  for g, a in zip(gates, angles):
    mat = jsv.gate_matrix(g.kind, a)
    q = g.qubits[0]
    if q >= n - m:
      emb = jsv._embed_minor_mat(mat, (q - (n - m),), m)
      minor_j = emb if minor_j is None else emb @ minor_j
    else:
      majors_j[q] = mat
  _close(minor_t, minor_j, atol=1e-6)
  _close(tsv.apply_majors_and_minor(torch.tensor(psi), majors_t, minor_t),
         jsv.apply_majors_and_minor(jnp.asarray(psi), majors_j, minor_j))


def test_partial_trace_1q():
  g = _mat(np.random.RandomState(3), 2**4)
  for pos in range(4):
    _close(tsv.partial_trace_1q(torch.tensor(g), 4, pos),
           jsv.partial_trace_1q(jnp.asarray(g), 4, pos), atol=1e-6)


def test_hardware_efficient_ansatz_is_the_reference_circuit():
  for n, layers in [(2, 1), (9, 2), (20, 4)]:
    assert (tcu.hardware_efficient_ansatz(n, layers).to_dict() ==
            jcu.hardware_efficient_ansatz(n, layers).to_dict())


def test_20q_segments_and_row_blocks():
  """The 20q/4L ansatz segments as [1q(20), diag(39)] x 4 over an
  [8192, 128] state with row blocks (0, 7), (7, 6); K = 116 parity factors
  per diagonal segment."""
  pqc = tcu.hardware_efficient_ansatz(20, 4)
  assert pqc.num_symbols == 236
  segs = tsv.segment_circuit(pqc.gates)
  assert [(cls, len(idxs)) for cls, idxs in segs] == [("1q", 20),
                                                      ("diag", 39)] * 4
  assert tsv.state_shape(20) == (8192, 128)
  assert tsv._row_blocks(13) == [(0, 7), (7, 6)]
  gates = [pqc.gates[i] for i in segs[1][1]]
  assert len(tsv.diag_segment_triples(gates, 13, 7)[1]) == 116
  jpqc = jcu.hardware_efficient_ansatz(20, 4)
  assert tsv.diag_segment_triples(gates, 13, 7) == jsv.diag_segment_triples(
      [jpqc.gates[i] for i in segs[1][1]], 13, 7)


def test_tfim_target_matches_reference():
  for n, periodic in [(2, False), (9, False), (9, True)]:
    op_t = tp.tfim_1d(n, periodic=periodic, device="cpu")
    op_j = jp.tfim_1d(n, periodic=periodic)
    assert op_t.code_rows() == op_j.codes
    _close(op_t.coeffs, op_j.coeffs, atol=0)


def test_empty_pauli_sum_terms_match_jax():
  """A PauliSum with no terms at n = 9: expectation_terms gives the
  reference's empty float32 [0] vector (exact; it raised in torch.cat)."""
  n = 9
  expected = np.asarray(jsv.expectation_terms(
      jsv.zero_state(n), jp.pauli_sum_from_strings(n, [])))
  got = tsv.expectation_terms(tsv.zero_state(n, device="cpu"),
                              tp.pauli_sum_from_strings(n, [], device="cpu"))
  assert got.dtype == torch.float32 and expected.dtype == np.float32
  assert tuple(got.shape) == expected.shape == (0,)


@pytest.mark.parametrize("path", ["single state", "batched"])
def test_empty_pauli_sum_expectation_and_gradient_match_jax(path):
  """An empty PauliSum at n = 9 on zero_state: the value is 0 and the
  gradient zeros, as jax.value_and_grad of the reference's `expectation`,
  through the single-state path (adjoint.expectation, K3 / K2's plain
  versions) and the batched one (batched_expectations, K4 / K5's; the
  reference's batched_expectations divides by the zero term count)."""
  n = 9
  jpqc = jcu.hardware_efficient_ansatz(n, 1)
  values = np.random.RandomState(9).uniform(
      -1, 1, jpqc.num_symbols).astype(np.float32)
  val_j, grad_j = jax.value_and_grad(lambda v: jadjoint.expectation(
      jpqc, v, jsv.zero_state(n), jp.pauli_sum_from_strings(n, [])))(
          jnp.asarray(values))
  op = tp.pauli_sum_from_strings(n, [], device="cpu")
  v = torch.tensor(values, requires_grad=True)
  if path == "single state":
    value = tadjoint.expectation(tcu.hardware_efficient_ansatz(n, 1), v,
                                 tsv.zero_state(n, device="cpu"), op)
  else:
    value = tadjoint.batched_expectations(
        tcu.hardware_efficient_ansatz(n, 1), v,
        torch.zeros((2, n), dtype=torch.int8), (op,))
    assert tuple(value.shape) == (2, 1)
    value = value.sum()
  value.backward()
  assert float(value.detach()) == float(val_j) == 0.0
  np.testing.assert_array_equal(v.grad.numpy(), np.asarray(grad_j))


# -- utils (dedup, bit codes) ------------------------------------------------

def _dedup_bits(seed, batch, n):
  rng = np.random.RandomState(seed)
  # A narrow pool of rows so counts tie and repeat.
  pool = rng.randint(0, 2, (12, n)).astype(np.int8)
  return pool[rng.randint(0, 12, batch)]


@pytest.mark.parametrize("size", [None, 40, 30, 7, 3])
def test_unique_bitstrings_with_counts_matches_jax(size):
  """Same rows, order, inverse indices and counts as the reference, for no
  size, size >= batch, and overflow (size < number of uniques: top-`size`
  by count, ties to the smaller bitstring)."""
  bits = _dedup_bits(size or 0, 30, 6)
  y_j, idx_j, c_j = jutils.unique_bitstrings_with_counts(jnp.asarray(bits),
                                                         size=size)
  y_t, idx_t, c_t = tutils.unique_bitstrings_with_counts(torch.tensor(bits),
                                                         size=size)
  np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
  np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
  np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def test_unique_overflow_keeps_ties_to_smaller_bitstring():
  bits = np.array([[1, 1], [0, 1], [1, 0], [0, 1], [1, 0], [1, 1]], np.int8)
  y, idx, counts = tutils.unique_bitstrings_with_counts(torch.tensor(bits),
                                                        size=2)
  # Counts 2, 2, 2 for 01, 10, 11: the two smaller bitstrings are kept.
  np.testing.assert_array_equal(y.numpy(), [[0, 1], [1, 0]])
  np.testing.assert_array_equal(counts.numpy(), [2, 2])
  np.testing.assert_array_equal(idx.numpy(), [2, 0, 1, 0, 1, 2])


def test_bit_codes_and_enumeration_match_jax():
  bits = np.random.RandomState(5).randint(0, 2, (17, 11)).astype(np.int8)
  ints_t = tutils.bits_to_ints(torch.tensor(bits))
  np.testing.assert_array_equal(ints_t.numpy(),
                                np.asarray(jutils.bits_to_ints(bits)))
  np.testing.assert_array_equal(tutils.ints_to_bits(ints_t, 11).numpy(), bits)
  np.testing.assert_array_equal(tutils.all_bitstrings(5).numpy(),
                                jutils.all_bitstrings(5))


def test_weighted_average_matches_jax():
  rng = np.random.RandomState(6)
  counts = rng.randint(0, 5, 9).astype(np.int32)
  values = rng.normal(size=9).astype(np.float32)
  _close(tutils.weighted_average(torch.tensor(counts), torch.tensor(values)),
         jutils.weighted_average(jnp.asarray(counts), jnp.asarray(values)),
         atol=1e-6)


# -- the port imports no jax -------------------------------------------------

def test_port_imports_no_jax():
  """Every module of qhbmlib_tpu_torch (its own `baselines/` and
  `benchmarks/ladder.py` among them) imports with jax, the JAX package and
  the repo's jax-importing `baselines/` and `benchmarks/` absent from
  sys.modules (the card's machine has no jax)."""
  code = (
      "import importlib, pkgutil, sys\n"
      "import qhbmlib_tpu_torch as pkg\n"
      "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
      "pkg.__name__ + '.')]\n"
      "for name in names:\n"
      "  importlib.import_module(name)\n"
      "roots = ('jax', 'qhbmlib_tpu', 'baselines', 'benchmarks')\n"
      "bad = sorted(m for m in sys.modules if m.split('.')[0] in roots)\n"
      "assert not bad, bad\n"
      "assert len(names) >= 20, names\n"
      "for want in ('baselines.utils', 'benchmarks.ladder', 'ops.shift', "
      "'data.thermal_data'):\n"
      "  assert pkg.__name__ + '.' + want in names, want\n"
      "print(len(names))\n")
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, check=False)
  assert out.returncode == 0, out.stderr
