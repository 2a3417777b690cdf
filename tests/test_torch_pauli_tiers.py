"""PyTorch port vs the JAX package: every Pauli tier of `expectation_terms`
and `apply_pauli_sum`, `apply_dense`, `major_transition` and the kron bins.

n = 8 has one row qubit (nr = 1): XX on (0, 1) mixes row and column.
n = 15 has the row blocks (0, 7) and (7, 1): terms spanning them, mixed
terms on 1-3 and on 4 row qubits, and > 3-qubit spanning strings (the
per-term fallback).  States are batches of random normalized states made
with numpy from fixed seeds.  Tolerance: relative L2 1e-5 against the JAX
package (float32 on both sides); `make_vqt` with a Heisenberg target and
`QHBM.expectation` at 8q, exact EBMs: values atol 1e-4, gradients 2e-4, as
`tests/test_torch_hamiltonian.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qhbmlib_tpu import models as jmodels
from qhbmlib_tpu import nn as jnn
from qhbmlib_tpu.inference import ebm as jebm
from qhbmlib_tpu.inference import qhbm as jqhbm
from qhbmlib_tpu.inference import qnn as jqnn
from qhbmlib_tpu.inference import vqt_loss as jvqt
from qhbmlib_tpu.ops import paulis as jp
from qhbmlib_tpu.ops import statevector as jsv
from qhbmlib_tpu_torch import convert
from qhbmlib_tpu_torch import models as tmodels
from qhbmlib_tpu_torch.benchmarks import ladder as tladder
from qhbmlib_tpu_torch.inference import ebm as tebm
from qhbmlib_tpu_torch.inference import qhbm as tqhbm
from qhbmlib_tpu_torch.inference import qnn as tqnn
from qhbmlib_tpu_torch.inference import vqt_loss as tvqt
from qhbmlib_tpu_torch.ops import paulis as tp
from qhbmlib_tpu_torch.ops import statevector as tsv

torch.set_num_threads(1)

CPU = "cpu"
REL_TOL = 1e-5
VALUE_ATOL = 1e-4
GRAD_ATOL = 2e-4
BATCH = 3

# Terms as {qubit: Pauli}: every tier of each size.
TERMS = {
    8: [
        {0: "Z", 3: "Z"},                      # diagonal
        {2: "X", 5: "Y"},                      # minor only
        {0: "Y"},                              # in the row block
        {0: "X", 1: "X"},                      # mixed, 1 row qubit
        {0: "Y", 4: "Z", 7: "X"},              # mixed
        {0: "Z", 1: "Y"},                      # mixed, diagonal row factor
        {1: "Z", 6: "Z", 7: "Y"},              # minor only
    ],
    15: [
        {0: "Z", 7: "Z", 12: "Z"},             # diagonal
        {8: "X", 14: "Y"},                     # minor only
        {1: "X", 4: "Y"},                      # block (0, 7)
        {0: "X", 2: "X", 3: "Y", 6: "Z"},      # block (0, 7), 4 qubits
        {7: "Y"},                              # block (7, 1)
        {6: "X", 7: "X"},                      # spanning
        {2: "Y", 5: "Z", 7: "X"},              # spanning, 3 qubits
        {0: "Z", 7: "Y"},                      # spanning, shares a bin
        {3: "X", 7: "Z"},                      # spanning, next bin
        {6: "Y", 8: "Y"},                      # mixed
        {7: "X", 9: "Z", 10: "X"},             # mixed
        {5: "X", 7: "Y", 11: "Z"},             # mixed, 2 row qubits
        {0: "X", 3: "Y", 7: "X", 12: "Z"},     # mixed, 3 row qubits
        {0: "X", 2: "X", 4: "Y", 7: "X"},      # 4 spanning: fallback
        {0: "X", 1: "Y", 2: "Z", 3: "X", 9: "Y"},  # 4 row + minor: fallback
    ],
}


def _states(n, seed, batch=BATCH):
  rng = np.random.RandomState(seed)
  r, c = jsv.state_shape(n)
  x = rng.normal(size=(batch, r, c)) + 1j * rng.normal(size=(batch, r, c))
  x /= np.sqrt(np.sum(np.abs(x)**2, axis=(-2, -1), keepdims=True))
  return x.astype(np.complex64)


def _ops(n, terms, seed):
  rng = np.random.RandomState(seed)
  weighted = [(float(w), t) for w, t in zip(rng.uniform(-1, 1, len(terms)),
                                            terms)]
  return (jp.pauli_sum_from_strings(n, weighted),
          tp.pauli_sum_from_strings(n, weighted, device=CPU))


def _heisenberg(n):
  terms = [(1.0, {q: p, q + 1: p}) for q in range(n - 1) for p in "XYZ"]
  return (jp.pauli_sum_from_strings(n, terms),
          tladder.heisenberg(n, device=CPU))


def _rel(actual, expected):
  actual = np.asarray(actual, np.complex128)
  expected = np.asarray(expected, np.complex128)
  return np.linalg.norm(actual - expected) / np.linalg.norm(expected)


def _check_terms_and_apply(n, jop, top, seed):
  psi = _states(n, seed)
  weights = np.random.RandomState(seed + 1).normal(
      size=(BATCH, top.num_terms)).astype(np.float32)
  want_terms = np.stack([np.asarray(jsv.expectation_terms(jnp.asarray(p),
                                                          jop)) for p in psi])
  got_terms = tsv.expectation_terms(torch.tensor(psi), top)
  assert got_terms.shape == (BATCH, top.num_terms)
  assert _rel(got_terms.numpy(), want_terms) < REL_TOL
  want = np.stack([np.asarray(jsv.apply_pauli_sum(
      jnp.asarray(p), jop, term_weights=jnp.asarray(w)))
                   for p, w in zip(psi, weights)])
  got = tsv.apply_pauli_sum(torch.tensor(psi), top,
                            term_weights=torch.tensor(weights))
  assert got.shape == psi.shape
  assert _rel(got.numpy(), want) < REL_TOL
  # Unbatched: one state, no term weights.
  assert _rel(tsv.apply_pauli_sum(torch.tensor(psi[0]), top).numpy(),
              jsv.apply_pauli_sum(jnp.asarray(psi[0]), jop)) < REL_TOL


@pytest.mark.parametrize("n", [8, 15])
def test_every_tier_matches_jax(n):
  """Random coefficients on TERMS[n]: the port takes every term (none
  raises) and agrees with the reference on the terms and the apply."""
  jop, top = _ops(n, TERMS[n], seed=n)
  diag, minor, blocks, spanning, mixed, fallback = tsv._tier_terms(
      top.code_rows(), n - tsv.minor_bits(n))
  assert diag and minor and blocks and mixed
  if n == 15:
    assert spanning and fallback
    assert {len(q) for _, q in spanning} == {2, 3}
    assert {len(q) for _, q in mixed} == {1, 2, 3}
  _check_terms_and_apply(n, jop, top, seed=n + 100)


@pytest.mark.parametrize("n", [8, 15])
def test_heisenberg_chain_matches_jax(n):
  """XX / YY / ZZ on each neighbouring pair: at 8q the (0, 1) pair mixes
  row and column; at 15q (6, 7) spans the row blocks and (7, 8) mixes."""
  jop, top = _heisenberg(n)
  _check_terms_and_apply(n, jop, top, seed=n + 200)


@pytest.mark.parametrize("n, qubits", [
    (15, (3,)), (15, (2, 6)), (15, (6, 2)), (15, (0, 7)), (15, (1, 4, 7)),
    (15, (9,)), (15, (12, 9)), (15, (5, 11)), (15, (11, 5)), (8, (0, 6)),
    (8, (3, 0))])
def test_apply_dense_matches_jax(n, qubits):
  """Row qubits (1, 2 in either order, 3 sorted), minor qubits, and one
  of each in either order; one operator for every state, and one a
  state."""
  rng = np.random.RandomState(sum(qubits) + n)
  d = 2**len(qubits)
  mats = (rng.normal(size=(BATCH, d, d)) +
          1j * rng.normal(size=(BATCH, d, d))).astype(np.complex64)
  psi = _states(n, seed=sum(qubits))
  want = np.stack([np.asarray(jsv.apply_dense(jnp.asarray(m), qubits,
                                              jnp.asarray(p)))
                   for m, p in zip(mats, psi)])
  got = tsv.apply_dense(torch.tensor(mats), qubits, torch.tensor(psi))
  assert _rel(got.numpy(), want) < REL_TOL
  shared = tsv.apply_dense(torch.tensor(mats[0]), qubits, torch.tensor(psi))
  assert _rel(shared[1].numpy(), jsv.apply_dense(
      jnp.asarray(mats[0]), qubits, jnp.asarray(psi[1]))) < REL_TOL


@pytest.mark.parametrize("bin_qubits", [(6,), (2, 7), (0, 3, 7)])
@pytest.mark.parametrize("keep_cols", [False, True])
def test_major_transition_matches_jax(bin_qubits, keep_cols):
  psi = _states(15, seed=len(bin_qubits))
  got = tsv.major_transition(torch.tensor(psi), bin_qubits, keep_cols)
  for b in range(BATCH):
    want = jsv.major_transition(jnp.asarray(psi[b]), bin_qubits, keep_cols)
    assert got.shape[1:] == want.shape
    assert _rel(got[b].numpy(), want) < REL_TOL


def test_bins_and_static_matrices_match_jax():
  items = [(0, (6, 7)), (1, (2, 5, 7)), (2, (0, 7)), (3, (3, 7)),
           (4, (1, 9)), (5, (0, 1, 2)), (6, (4,))]
  assert tsv._bin_by_support(items) == jsv._bin_by_support(items)
  for bin_qubits, factors in (((2, 7), {2: 1, 7: 2}),
                              ((0, 3, 7), {0: 3, 7: 1})):
    kron = tsv._major_kron_np(bin_qubits, factors)
    np.testing.assert_array_equal(kron,
                                  jsv._major_kron_np(bin_qubits, factors))
    np.testing.assert_array_equal(
        tsv._interleave_kron_np(kron, len(bin_qubits)),
        jsv._interleave_kron_np(kron, len(bin_qubits)))


def test_tfim_tiers_unchanged_and_split_cached():
  """The TFIM's single X and ZZ terms take the diagonal and in-block /
  minor tiers only, and the split is computed once per (rows, nr)."""
  op = tp.tfim_1d(20, device=CPU)
  rows = op.code_rows()
  split = tsv._tier_terms(rows, 13)
  assert split is tsv._tier_terms(rows, 13)
  diag, minor, blocks, spanning, mixed, fallback = split
  assert not spanning and not mixed and not fallback
  assert len(diag) == 19 and len(minor) + sum(len(t) for _, t in blocks) == 20


def _jax_qhbm(n, seed):
  energy = jmodels.BernoulliEnergy(
      list(range(n)), initializer=jnn.RandomUniform(-1, 1, seed=seed))
  e_inf = jebm.BernoulliEnergyInference(energy, 100, initial_seed=1,
                                        exact=True)
  circuit = jmodels.DirectQuantumCircuit(
      jmodels.hardware_efficient_ansatz(n, 2),
      initializer=jnn.RandomUniform(0, 2, seed=seed + 1))
  return jqhbm.QHBM(e_inf, jqnn.AnalyticQuantumInference(circuit))


def _port_qhbm(jh, n):
  h = tqhbm.QHBM(
      tebm.BernoulliEnergyInference(
          tmodels.BernoulliEnergy(list(range(n)), device=CPU), 100,
          initial_seed=0, exact=True),
      tqnn.AnalyticQuantumInference(tmodels.DirectQuantumCircuit(
          tmodels.hardware_efficient_ansatz(n, 2), device=CPU)))
  h.set_params(convert.from_jax_params(jh.params, device=CPU))
  return h


def test_vqt_heisenberg_target_matches_jax():
  """make_vqt at 8q with the Heisenberg chain as its target: loss and the
  gradients of theta, phi and the target's coefficients."""
  n = 8
  jh = _jax_qhbm(n, 4)
  h = _port_qhbm(jh, n)
  jt, tt = _heisenberg(n)
  tt.coeffs.requires_grad_(True)
  params = dict(jh.params)
  params["target_coeffs"] = jnp.asarray(jt.coeffs)
  loss_j, grads = jax.jit(jax.value_and_grad(
      lambda p: jvqt.make_vqt(jh, jt)(p, jax.random.PRNGKey(0),
                                      np.float32(1.2))[0]))(params)
  loss = tvqt.make_vqt(h, tt)(1.2)
  loss.backward()
  np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                             atol=VALUE_ATOL)
  for key in ("theta", "phi"):
    np.testing.assert_allclose(h.params[key][0].grad.numpy(),
                               np.asarray(grads[key][0]), atol=GRAD_ATOL)
  np.testing.assert_allclose(tt.coeffs.grad.numpy(),
                             np.asarray(grads["target_coeffs"]),
                             atol=GRAD_ATOL)
  assert np.abs(np.asarray(grads["phi"][0])).max() > 1e-3


def test_qhbm_expectation_heisenberg_matches_jax():
  """QHBM.expectation of the 8q Heisenberg chain and of a random sum with
  mixed terms: values and the gradients of theta and phi."""
  n = 8
  jh = _jax_qhbm(n, 6)
  h = _port_qhbm(jh, n)
  jops, tops = zip(_heisenberg(n), _ops(n, TERMS[n], seed=3))
  w = np.asarray([0.7, -1.3], np.float32)

  def j_fn(params):
    out, _ = jh.expectation_pure(params, jax.random.PRNGKey(0), list(jops),
                                 None)
    return jnp.sum(out * w), out

  (_, want), grads = jax.jit(jax.value_and_grad(j_fn, has_aux=True))(
      jh.params)
  got = h.expectation(list(tops))
  (got * torch.tensor(w)).sum().backward()
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             atol=VALUE_ATOL)
  for key in ("theta", "phi"):
    np.testing.assert_allclose(h.params[key][0].grad.numpy(),
                               np.asarray(grads[key][0]), atol=GRAD_ATOL)
