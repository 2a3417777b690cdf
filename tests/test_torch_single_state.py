"""The port's single-state engine against the JAX package, on the CPU.

`statevector.apply_circuit` (K3 for 8 <= n <= 20, the segment path
otherwise) and `adjoint.expectation` (K3 forward, K2 reverse sweep) through
their plain versions, against the JAX package's Pallas kernels in interpret
mode and its XLA paths; plus the stage tables the cooperative kernels read,
run by a numpy model of the kernels' stage semantics.  The CUDA kernels
themselves run only on the card (`python3 chip_smoke.py`).

Inputs come from numpy seeds and are fed to both packages.  Tolerances:
states 1e-5 absolute (float32 products in another order; the reference's
own Pallas-vs-dense tests use 1e-5); gradients 2e-4 absolute (sums of 2^n
float32 products, the reference's own sweep tests); the five-point stencil
1e-3 (its float32 truncation at h = 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qhbmlib_tpu.models import circuit_utils as jcu
from qhbmlib_tpu.ops import circuit_ir as jir
from qhbmlib_tpu.ops import adjoint as jadjoint
from qhbmlib_tpu.ops import pallas_adjoint
from qhbmlib_tpu.ops import pallas_sv
from qhbmlib_tpu.ops import paulis as jp
from qhbmlib_tpu.ops import statevector as jsv
from qhbmlib_tpu_torch import convert
from qhbmlib_tpu_torch.models import circuit_utils as tcu
from qhbmlib_tpu_torch.ops import _cuda
from qhbmlib_tpu_torch.ops import adjoint as tadjoint
from qhbmlib_tpu_torch.ops import circuit_ir as tir
from qhbmlib_tpu_torch.ops import hopper_adjoint
from qhbmlib_tpu_torch.ops import hopper_sv
from qhbmlib_tpu_torch.ops import paulis as tp
from qhbmlib_tpu_torch.ops import statevector as tsv

torch.set_num_threads(1)

STATE_ATOL = 1e-5
GRAD_ATOL = 2e-4
STENCIL_ATOL = 1e-3


def _problem(n, layers, seed):
  """Seeded values, a random normalized state, TFIM cotangents g."""
  rng = np.random.RandomState(seed)
  pqc = jcu.hardware_efficient_ansatz(n, layers)
  values = rng.uniform(-1, 1, pqc.num_symbols).astype(np.float32)
  shape = jsv.state_shape(n)
  state = rng.normal(size=shape) + 1j * rng.normal(size=shape)
  state = (state / np.linalg.norm(state)).astype(np.complex64)
  op = jp.tfim_1d(n)
  g = rng.uniform(-1, 1, op.num_terms).astype(np.float32)
  return pqc, tcu.hardware_efficient_ansatz(n, layers), values, state, op, g


def _planes(x):
  x = np.asarray(x)
  return (torch.tensor(np.ascontiguousarray(x.real)),
          torch.tensor(np.ascontiguousarray(x.imag)))


def _psi_lam(pqc, values, state, op, g):
  """Reference forward state and lambda = sum_t g_t P_t psi."""
  psi = jsv.apply_circuit(pqc, jnp.asarray(values), jnp.asarray(state))
  ones = jp.PauliSum(op.codes, jnp.ones_like(op.coeffs), op.num_qubits)
  lam = jsv.apply_pauli_sum(psi, ones, term_weights=jnp.asarray(g))
  return np.asarray(psi), np.asarray(lam)


# -- K3: the whole-circuit forward ---------------------------------------------

@pytest.mark.parametrize("n,layers", [(8, 1), (8, 2), (10, 1), (10, 2)])
def test_k3_plain_matches_pallas_interpret(n, layers):
  pqc, tpqc, values, state, _, _ = _problem(n, layers, 10 * n + layers)
  expected = pallas_sv.apply_circuit_pallas(pqc, jnp.asarray(values),
                                            jnp.asarray(state),
                                            interpret=True)
  got = hopper_sv.circuit_forward(tpqc, torch.tensor(values), _planes(state))
  np.testing.assert_allclose(torch.complex(*got).numpy(),
                             np.asarray(expected), atol=STATE_ATOL)


@pytest.mark.parametrize("n,layers", [(5, 2), (9, 2), (12, 1)])
def test_apply_circuit_matches_jax(n, layers):
  """statevector.apply_circuit: K3's plain version at 9 and 12 qubits, the
  segment path at 5 (outside K3's range)."""
  pqc, tpqc, values, state, _, _ = _problem(n, layers, n)
  expected = jsv.apply_circuit(pqc, jnp.asarray(values), jnp.asarray(state))
  got = tsv.apply_circuit(tpqc, torch.tensor(values), torch.tensor(state))
  np.testing.assert_allclose(got.numpy(), np.asarray(expected),
                             atol=STATE_ATOL)


def test_segment_path_matches_k3_plain():
  """The segment path (K1 passes, diag_rotate) and K3's stage table give
  the same state where both run."""
  _, tpqc, values, state, _, _ = _problem(10, 2, 3)
  x = torch.tensor(state)
  seg = tsv._apply_circuit_torch(tpqc, values, x)
  k3 = torch.complex(*hopper_sv.circuit_forward(tpqc, values, _planes(state)))
  np.testing.assert_allclose(seg.numpy(), k3.numpy(), atol=STATE_ATOL)


def test_state_helpers_match_jax():
  n = 9
  np.testing.assert_array_equal(tsv.zero_state(n, device="cpu").numpy(),
                                np.asarray(jsv.zero_state(n)))
  vec = np.random.RandomState(0).normal(size=2**n).astype(np.complex64)
  st = tsv.from_vector(torch.tensor(vec), n)
  np.testing.assert_array_equal(st.numpy(),
                                np.asarray(jsv.from_vector(jnp.asarray(vec),
                                                           n)))
  np.testing.assert_array_equal(tsv.to_vector(st).numpy(), vec)


# -- K2: the whole reverse sweep ---------------------------------------------

@pytest.mark.parametrize("n,layers", [(8, 1), (8, 2), (10, 2)])
def test_k2_plain_matches_pallas_interpret(n, layers):
  pqc, tpqc, values, state, op, g = _problem(n, layers, 30 + n + layers)
  psi, lam = _psi_lam(pqc, values, state, op, g)
  expected = pallas_adjoint.adjoint_sweep(pqc, jnp.asarray(values),
                                          jnp.asarray(psi), jnp.asarray(lam),
                                          interpret=True)
  got = hopper_adjoint.adjoint_sweep(tpqc, torch.tensor(values), _planes(psi),
                                     _planes(lam))
  np.testing.assert_allclose(got.numpy(), np.asarray(expected),
                             atol=GRAD_ATOL)
  assert np.abs(np.asarray(expected)).max() > 1e-3  # non-trivial gradient


def test_k2_plain_matches_batched_sweep_at_b1():
  """K2's plain version (the per-state sweep) equals K5's plain version run
  on a batch of one, two row blocks (n = 15)."""
  pqc, tpqc, values, state, op, g = _problem(15, 2, 4)
  psi, lam = _psi_lam(pqc, values, state, op, g)
  single = hopper_adjoint.adjoint_sweep(tpqc, values, _planes(psi),
                                        _planes(lam))
  batched = hopper_adjoint.adjoint_sweep_batched(
      tpqc, values, tuple(t[None] for t in _planes(psi)),
      tuple(t[None] for t in _planes(lam)))
  np.testing.assert_allclose(single.numpy(), batched.numpy(), atol=GRAD_ATOL)


def test_expectation_value_and_grad_match_jax():
  """adjoint.expectation (forward K3, backward K2: their plain versions)
  against jax.value_and_grad of the reference's adjoint.expectation at 9q,
  with the circuit values carried over by convert.from_jax_params."""
  n = 9
  pqc, tpqc, values, state, op, _ = _problem(n, 2, 5)
  params = {"theta": [np.zeros(n, np.float32)], "phi": [jnp.asarray(values)]}

  def f(v):
    return jadjoint.expectation(pqc, v, jnp.asarray(state), op)

  val_j, grad_j = jax.value_and_grad(f)(jnp.asarray(values))
  v = convert.from_jax_params(params, device="cpu")["phi"]
  v.requires_grad_(True)
  val_t = tadjoint.expectation(tpqc, v, torch.tensor(state),
                               tp.tfim_1d(n, device="cpu"))
  val_t.backward()
  np.testing.assert_allclose(float(val_t.detach()), float(val_j),
                             atol=STATE_ATOL)
  np.testing.assert_allclose(v.grad.numpy(), np.asarray(grad_j),
                             atol=GRAD_ATOL)


def test_expectation_coefficient_grad_and_terms():
  """Per-term values match the reference; coefficient gradients are the
  per-term expectations (autograd through the contraction)."""
  n = 9
  pqc, tpqc, values, state, op, _ = _problem(n, 1, 6)
  terms_j = jadjoint.adjoint_term_expectations(pqc, jnp.asarray(values),
                                               jnp.asarray(state), op)
  top = tp.tfim_1d(n, device="cpu")
  top.coeffs.requires_grad_(True)
  terms_t = tadjoint.adjoint_term_expectations(tpqc, torch.tensor(values),
                                               torch.tensor(state), top)
  np.testing.assert_allclose(terms_t.detach().numpy(), np.asarray(terms_j),
                             atol=STATE_ATOL)
  tadjoint.expectation(tpqc, torch.tensor(values), torch.tensor(state),
                       top).backward()
  np.testing.assert_allclose(top.coeffs.grad.numpy(), np.asarray(terms_j),
                             atol=STATE_ATOL)


def test_expectation_grad_five_point_stencil():
  """The adjoint gradient at 4q (segment path) against a five-point
  central-difference stencil of the value."""
  n = 4
  _, tpqc, values, state, _, _ = _problem(n, 2, 7)
  op = tp.tfim_1d(n, device="cpu")
  x = torch.tensor(state)

  def f(v):
    return float(tadjoint.expectation(tpqc, torch.tensor(v), x, op))

  v = torch.tensor(values, requires_grad=True)
  tadjoint.expectation(tpqc, v, x, op).backward()
  h = 1e-2
  stencil = []
  for i in range(len(values)):
    e = np.zeros_like(values)
    e[i] = h
    stencil.append((-f(values + 2 * e) + 8 * f(values + e) - 8 * f(values - e)
                    + f(values - 2 * e)) / (12 * h))
  np.testing.assert_allclose(v.grad.numpy(), stencil, atol=STENCIL_ATOL)


# -- the stage tables of the cooperative kernels --------------------------------

def _parity(x, mask):
  return np.array([bin(int(v) & int(mask)).count("1") & 1 for v in x])


def _run_table(table, states):
  """numpy model of `sweep_kernel`: walks the packed records as the kernel
  does (records in order, ping-pong axis stages, in-place diagonal
  rotations, reductions into `out` at their offsets)."""
  records, masks, data = table.pack()
  rec = records.numpy().reshape(-1, hopper_sv.STAGE_INTS)
  masks, data = masks.numpy(), data.numpy().astype(np.float64)
  assert len(rec) == table.num_stages
  # The kernels stage a record's factors in shared memory of this size.
  assert all(r[3] <= hopper_sv.MAX_FACTORS for r in rec)
  n, m = table.n, table.m
  out = np.zeros(max(table.out_len, 1))
  for kind, start, k, count, doff, moff, ooff, _ in rec:
    nn, p, q = 1 << k, 1 << start, 1 << (n - start - k)
    if kind == hopper_sv.AXIS:
      op = (data[doff:doff + nn * nn] +
            1j * data[doff + nn * nn:doff + 2 * nn * nn]).reshape(nn, nn)
      states = [np.einsum("MN,pNq->pMq", op, s.reshape(p, nn, q)).reshape(-1)
                for s in states]
    elif kind == hopper_sv.DIAG:
      idx = np.arange(1 << n)
      theta = sum((1 - 2 * _parity(idx, masks[moff + j])) * data[doff + j]
                  for j in range(count))
      states = [s * np.exp(1j * theta) for s in states]
    elif kind == hopper_sv.TRANS:
      # T[i, j] = sum_{x: x_b = 0} conj(lam[x ^ i 2^b]) a[x ^ j 2^b] per
      # state-index bit b: 8 floats, re then im of T00 T01 T10 T11.
      a, lam = states
      for j in range(count):
        hi = 1 << masks[moff + j]
        pa, pl = a.reshape(-1, 2, hi), lam.reshape(-1, 2, hi)
        t = np.einsum("xiy,xjy->ij", pl.conj(), pa).ravel()
        out[ooff + 8 * j:ooff + 8 * j + 8] = np.concatenate([t.real, t.imag])
    else:
      a, lam = states
      w = (lam.conj() * a).imag.reshape(1 << (n - m), 1 << m)
      for j in range(count):
        s_r = 1 - 2 * _parity(np.arange(1 << (n - m)), masks[moff + j])
        s_c = 1 - 2 * _parity(np.arange(1 << m), masks[moff + count + j])
        out[ooff + j] = s_r @ w @ s_c
  return states, out


@pytest.mark.parametrize("n,layers", [(8, 2), (9, 3)])
def test_k3_stage_table_model_matches_plain(n, layers):
  _, tpqc, values, state, _, _ = _problem(n, layers, 40 + n)
  table = hopper_sv.forward_table(tpqc, values, "cpu")
  # One record per stage: every folded operator and every diagonal segment.
  assert table.num_stages == len(hopper_sv.single_stages(tpqc, values))
  (got,), _ = _run_table(table, [state.reshape(-1).astype(np.complex128)])
  expected = torch.complex(*hopper_sv.circuit_forward(tpqc, values,
                                                      _planes(state)))
  np.testing.assert_allclose(got.reshape(state.shape), expected.numpy(),
                             atol=STATE_ATOL)


@pytest.mark.parametrize("n,layers", [(8, 2), (10, 1)])
def test_k2_stage_table_model_matches_plain(n, layers):
  pqc, tpqc, values, state, op, g = _problem(n, layers, 50 + n)
  psi, lam = _psi_lam(pqc, values, state, op, g)
  table, shapes, plan = hopper_adjoint.sweep_table(tpqc, values, "cpu")
  _, out = _run_table(table, [psi.reshape(-1).astype(np.complex128),
                              lam.reshape(-1).astype(np.complex128)])
  grad = hopper_adjoint.sweep_grads(
      plan, torch.tensor(out, dtype=torch.float32), shapes, tpqc.num_symbols)
  expected = hopper_adjoint.adjoint_sweep(tpqc, values, _planes(psi),
                                          _planes(lam))
  np.testing.assert_allclose(grad.numpy(), expected.numpy(), atol=GRAD_ATOL)


def _long_diag_circuit(builder_cls, n=8, reps=10):
  """1q layer, then reps x all-to-all symbolic CZ (one diagonal segment of
  4 parity factors per gate: 1120 > MAX_FACTORS at n = 8), then 1q."""
  b = builder_cls(n)
  for q in range(n):
    b.rx(q, f"x{q}")
  for r in range(reps):
    for i in range(n):
      for j in range(i + 1, n):
        b.cz(i, j, f"c{r}")
  for q in range(n):
    b.ry(q, f"y{q}")
  return b.build()


def test_long_diag_segment_takes_several_records():
  """A diagonal segment of more factors than a kernel record holds splits
  into records of at most MAX_FACTORS, forward and reverse, with the
  bilinears side by side at one out offset."""
  tpqc = _long_diag_circuit(tir.CircuitBuilder)
  values = np.random.RandomState(60).uniform(
      -1, 1, tpqc.num_symbols).astype(np.float32)
  (_, weights, _, _), = [s for s in hopper_sv.single_stages(tpqc, values)
                         if s[0] == "diag"]
  k = len(weights)
  assert k > hopper_sv.MAX_FACTORS
  split = [hopper_sv.MAX_FACTORS, k - hopper_sv.MAX_FACTORS]
  fwd = hopper_sv.forward_table(tpqc, values, "cpu")
  rec = fwd.pack()[0].numpy().reshape(-1, hopper_sv.STAGE_INTS)
  assert list(rec[rec[:, 0] == hopper_sv.DIAG, 3]) == split
  bwd, shapes, _ = hopper_adjoint.sweep_table(tpqc, values, "cpu")
  rec = bwd.pack()[0].numpy().reshape(-1, hopper_sv.STAGE_INTS)
  bilin = rec[rec[:, 0] == hopper_sv.BILIN]
  assert list(bilin[:, 3]) == split
  assert list(bilin[:, 6]) == [bilin[0, 6], bilin[0, 6] + split[0]]
  assert (k,) in shapes  # one [K] reduction for the assembly


def test_long_diag_segment_tables_match_plain_and_jax():
  """The split records give the plain versions' state and gradient (numpy
  model of the kernels), and the plain forward matches the JAX package."""
  n = 8
  pqc, tpqc = _long_diag_circuit(jir.CircuitBuilder), _long_diag_circuit(
      tir.CircuitBuilder)
  rng = np.random.RandomState(61)
  values = rng.uniform(-1, 1, tpqc.num_symbols).astype(np.float32)
  shape = jsv.state_shape(n)
  state = rng.normal(size=shape) + 1j * rng.normal(size=shape)
  state = (state / np.linalg.norm(state)).astype(np.complex64)
  op = jp.tfim_1d(n)
  g = rng.uniform(-1, 1, op.num_terms).astype(np.float32)
  plain = torch.complex(*hopper_sv.circuit_forward(tpqc, values,
                                                   _planes(state)))
  (got,), _ = _run_table(hopper_sv.forward_table(tpqc, values, "cpu"),
                         [state.reshape(-1).astype(np.complex128)])
  np.testing.assert_allclose(got.reshape(shape), plain.numpy(),
                             atol=STATE_ATOL)
  # The reference sums the segment's phase in float32: |theta| reaches
  # sum_k |w_k| (~380 rad here), so a few float32 roundings of it bound
  # the difference; the port sums in float64, as its kernels do.
  weights = next(s[1] for s in hopper_sv.single_stages(tpqc, values)
                 if s[0] == "diag")
  phase_atol = 4 * np.finfo(np.float32).eps * np.abs(weights).sum()
  np.testing.assert_allclose(
      plain.numpy(), np.asarray(jsv.apply_circuit(pqc, jnp.asarray(values),
                                                  jnp.asarray(state))),
      atol=phase_atol)
  psi, lam = _psi_lam(pqc, values, state, op, g)
  table, shapes, plan = hopper_adjoint.sweep_table(tpqc, values, "cpu")
  _, out = _run_table(table, [psi.reshape(-1).astype(np.complex128),
                              lam.reshape(-1).astype(np.complex128)])
  grad = hopper_adjoint.sweep_grads(
      plan, torch.tensor(out, dtype=torch.float32), shapes, tpqc.num_symbols)
  expected = hopper_adjoint.adjoint_sweep(tpqc, values, _planes(psi),
                                          _planes(lam))
  np.testing.assert_allclose(grad.numpy(), expected.numpy(), atol=GRAD_ATOL)
  assert np.abs(expected.numpy()).max() > 1e-3  # non-trivial gradient


# -- wrappers: plain on the CPU, no launches; refusal elsewhere ---------------

def test_single_state_wrappers_take_plain_versions_on_cpu():
  _, tpqc, values, state, _, _ = _problem(8, 1, 8)
  before = (hopper_sv.circuit_forward.launches,
            hopper_adjoint.adjoint_sweep.launches)
  psi = hopper_sv.circuit_forward(tpqc, values, _planes(state))
  hopper_adjoint.adjoint_sweep(tpqc, values, psi, psi)
  assert (hopper_sv.circuit_forward.launches,
          hopper_adjoint.adjoint_sweep.launches) == before
  assert _cuda._lib is None  # nothing was built or loaded


def test_single_state_wrappers_refuse_other_devices():
  tpqc = tcu.hardware_efficient_ansatz(8, 1)
  x = torch.zeros(tsv.state_shape(8), device="meta")
  with pytest.raises(ValueError, match="unsupported device"):
    hopper_sv.circuit_forward(tpqc, np.zeros(tpqc.num_symbols), (x, x))
  with pytest.raises(ValueError, match="unsupported device"):
    hopper_adjoint.adjoint_sweep(tpqc, np.zeros(tpqc.num_symbols), (x, x),
                                 (x, x))
