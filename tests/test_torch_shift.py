"""The port's parameter shift against the JAX package, on the CPU.

  * `shift.shift_plan` equal to the JAX plan array for array: the
    hardware-efficient ansatz, a QAIA, a circuit with constant gates and a
    GPHASE, and shared symbols with coeff != 1.
  * `statevector.apply_circuit(..., angle_offsets=row)` and every row of
    the shifted batch (`hopper_sv.apply_circuit_shifted`, the base row and
    the 2P shifted ones, each measurement basis's rotated states too)
    against JAX's `apply_circuit(..., angle_offsets=row)` at 6q and 9q,
    within 1e-5 relative L2 a state.  The mixed circuit holds several 1q
    gates on one qubit in one segment (XP, RY, H, RX), shared symbols, a
    ZP after the CZs, an XXP and a CXP (flip-class gates).
  * The shot-free limit of the shift gradient (the means from the
    shifted batch's probabilities) against `jax.grad` of JAX's
    adjoint `batched_expectations` (what `AnalyticQuantumInference`
    differentiates), within 1e-4 relative L2; chunked against
    unchunked with chunks that do not divide 2P.
  * `_group_terms` and the rotation suffixes equal to JAX's for the TFIM,
    the Heisenberg chain and a mixed PauliSum.

Inputs come from numpy seeds; circuits cross as `to_dict` / `from_dict`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qhbmlib_tpu.inference import qnn as jqnn
from qhbmlib_tpu.ops import adjoint as jadjoint
from qhbmlib_tpu.ops import circuit_ir as jir
from qhbmlib_tpu.ops import paulis as jp
from qhbmlib_tpu.ops import shift as jshift
from qhbmlib_tpu.ops import statevector as jsv
from qhbmlib_tpu_torch import models as tmodels
from qhbmlib_tpu_torch.inference import qnn as tqnn
from qhbmlib_tpu_torch.ops import adjoint as tadjoint
from qhbmlib_tpu_torch.ops import circuit_ir as tir
from qhbmlib_tpu_torch.ops import hopper_sv
from qhbmlib_tpu_torch.ops import paulis as tp
from qhbmlib_tpu_torch.ops import shift as tshift
from qhbmlib_tpu_torch.ops import statevector as tsv

torch.set_num_threads(1)

CPU = "cpu"
STATE_TOL = 1e-5
GRAD_TOL = 1e-4
BATCH = 3


def _mixed(n):
  """1q chains of four gates a qubit (two sharing a symbol with coeffs 1
  and -1.3), CZs, a ZP sharing a symbol, an XXP and a CXP (flip class),
  then a YP layer."""
  b = tir.CircuitBuilder(n)
  for q in range(n):
    b.xp(q, f"a{q}")
    b.ry(q, f"b{q}", coeff=0.7)
    b.h(q)
    b.rx(q, f"a{q}", coeff=-1.3, shift=0.2)
  for q in range(n - 1):
    b.cz(q, q + 1, f"c{q}")
  b.zp(0, "b0", coeff=2.0)
  b.add("xxp", (1, n - 2), symbol="x1")
  b.add("cxp", (0, 2), symbol="a1")
  for q in range(n):
    b.yp(q, f"y{q}")
  return b.build()


def _constant(n):
  """Constant gates, a GPHASE (angle scale 0: no shift rows) and a
  symbol shared by two gates of different kinds."""
  b = tir.CircuitBuilder(n)
  b.h(0)
  b.add("gphase", (), symbol="g")
  b.rz(1, "s", coeff=0.5, shift=0.3)
  b.cnot(0, 1)
  b.xp(2, "s", coeff=-2.0)
  b.add("gphase", (), shift=0.4)
  b.zp(2)
  return b.build()


def _qaia(n):
  """A 2-layer QAIA on the TFIM's two shards and a Bernoulli energy's Z
  shards (its X PROTs fold into 1q segments)."""
  x = tp.pauli_sum_from_strings(n, [(-1.0, {q: "X"}) for q in range(n)],
                                device=CPU)
  zz = tp.pauli_sum_from_strings(
      n, [(-1.0, {q: "Z", q + 1: "Z"}) for q in range(n - 1)], device=CPU)
  energy = tmodels.BernoulliEnergy(list(range(n)), device=CPU)
  return tmodels.QAIA([x, zz], energy.operator_shards(n), 2, name="q",
                      device=CPU).pqc


CIRCUITS = {
    "hea": lambda n: tmodels.hardware_efficient_ansatz(n, 2),
    "mixed": _mixed,
    "qaia": _qaia,
    "constant": lambda n: _constant(max(n, 3)),
}


def _jax_circuit(pqc):
  return jir.Circuit.from_dict(pqc.to_dict())


def _values(pqc, seed=0):
  return np.random.RandomState(seed).uniform(
      -2, 2, pqc.num_symbols).astype(np.float32)


def _rel(got, want):
  return (np.linalg.norm(got - want, axis=-1) /
          np.linalg.norm(want, axis=-1)).max()


@pytest.mark.parametrize("kind", sorted(CIRCUITS))
def test_shift_plan_matches_jax(kind):
  pqc = CIRCUITS[kind](6)
  got = tshift.shift_plan(pqc)
  want = jshift.shift_plan(_jax_circuit(pqc))
  for g, w in zip(got, want):
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)
  if kind == "constant":
    # GPHASE has no row; the shared symbol's rows carry coeff * scale / 2.
    np.testing.assert_allclose(got[1], [0.25, -0.25, -np.pi, np.pi],
                               rtol=1e-6)


def test_shift_plan_without_parameters():
  b = tir.CircuitBuilder(2)
  b.h(0)
  b.cnot(0, 1)
  offsets, weights, slots = tshift.shift_plan(b.build())
  assert offsets.shape == (0, 2) and weights.shape == (0,)
  assert slots.dtype == np.int32
  grad = tshift.shift_gradient(b.build(), lambda rows: None, 3, device=CPU)
  np.testing.assert_array_equal(grad.numpy(), np.zeros(3))


def _jax_rows(pqc, values, rows, bits):
  """JAX's apply_circuit(..., angle_offsets=row) of every (row, state):
  [rows, B, 2^n] complex."""
  n = pqc.num_qubits
  jc = _jax_circuit(pqc)
  one = lambda o, b: jsv.apply_circuit(jc, jnp.asarray(values),
                                       jsv.basis_state(n, b),
                                       angle_offsets=o)
  f = jax.jit(jax.vmap(jax.vmap(one, (None, 0)), (0, None)))
  out = f(jnp.asarray(rows), jnp.asarray(bits, jnp.int32))
  return np.asarray(out).reshape(len(rows), len(bits), -1)


@pytest.mark.parametrize("n", [6, 9])
@pytest.mark.parametrize("kind", ["hea", "mixed", "qaia"])
def test_shifted_batch_matches_jax(n, kind):
  pqc = CIRCUITS[kind](n)
  values = _values(pqc, seed=n)
  offsets = tshift.shift_plan(pqc)[0]
  rows = np.concatenate([np.zeros((1, pqc.num_gates), np.float32), offsets])
  bits = np.random.RandomState(n + 1).randint(0, 2, (BATCH, n))
  rowcol = tadjoint.bits_to_rowcol(torch.tensor(bits), n)
  re, im = hopper_sv.apply_circuit_shifted(pqc, values, rowcol, rows)
  got = torch.complex(re, im).numpy().reshape(len(rows), BATCH, -1)
  want = _jax_rows(pqc, values, rows, bits)
  assert _rel(got, want) < STATE_TOL
  # The plain arm computes the same states.
  re_p, im_p = hopper_sv.apply_circuit_shifted(pqc, values, rowcol, rows,
                                               plain=True)
  assert _rel(torch.complex(re_p, im_p).numpy().reshape(got.shape),
              want) < STATE_TOL
  # Both rotated bases: the suffix through the batched forward against
  # JAX's apply_circuit of the same suffix.
  for codes in ([tp.X] * n, [tp.Y, tp.X, tp.Z] * (n // 3)):
    rot = tqnn._measurement_rotation(n, codes)
    r_re, r_im = hopper_sv.apply_circuit_batched(
        rot, np.zeros([0], np.float32), init_planes=(re, im))
    jrot = _jax_circuit(rot)
    r_want = jax.vmap(lambda s: jsv.apply_circuit(
        jrot, jnp.zeros([0], jnp.float32), s))(
            jnp.asarray(want.reshape((-1,) + jsv.state_shape(n))))
    assert _rel(torch.complex(r_re, r_im).numpy().reshape(len(rows) * BATCH,
                                                          -1),
                np.asarray(r_want).reshape(len(rows) * BATCH, -1)) < STATE_TOL


@pytest.mark.parametrize("n,kind", [(6, "mixed"), (9, "hea"), (9, "mixed")])
def test_apply_circuit_offsets_match_jax(n, kind):
  """One state, one offset row: K3's route (9q, no flip gate) or the
  segment route (6q, or a flip gate)."""
  pqc = CIRCUITS[kind](n)
  values = _values(pqc, seed=2)
  rows = tshift.shift_plan(pqc)[0][[0, 3, -1]]
  bits = np.random.RandomState(3).randint(0, 2, (1, n))
  want = _jax_rows(pqc, values, rows, bits)[:, 0]
  for r, row in enumerate(rows):
    state = tsv.apply_circuit(pqc, values,
                              tsv.basis_state(n, torch.tensor(bits[0])),
                              angle_offsets=row)
    assert _rel(state.numpy().reshape(1, -1), want[r:r + 1]) < STATE_TOL
  # The shifted batch at one offset row.
  rowcol = tadjoint.bits_to_rowcol(torch.tensor(bits), n)
  re, im = hopper_sv.apply_circuit_shifted(pqc, values, rowcol, rows[1:2])
  assert _rel(torch.complex(re, im).numpy().reshape(1, -1),
              want[1:2]) < STATE_TOL


def _target(kind, n):
  if kind == "tfim":
    return tp.tfim_1d(n, device=CPU), jp.tfim_1d(n)
  terms = [(0.5 + 0.1 * q, {q: p, q + 1: p})
           for q in range(n - 1) for p in "XYZ"]
  return (tp.pauli_sum_from_strings(n, terms, device=CPU),
          jp.pauli_sum_from_strings(n, terms))


def _exact_shift_gradient(pqc, values, bits, op, weights, chunk=None):
  """d/dvalues sum_b weights_b <op>_b by the shift rule, each row's means
  from the shifted batch's probabilities (no shots)."""
  plan, _ = tqnn.measurement_plan(pqc, (op,))
  rowcol = tadjoint.bits_to_rowcol(torch.tensor(bits), pqc.num_qubits)
  g = torch.tensor(weights, dtype=torch.float32)[:, None] * op.coeffs[None]
  return tqnn.term_means_gradient(pqc, values, rowcol, plan, g, chunk=chunk)


@pytest.mark.parametrize("kind,target", [("hea", "tfim"), ("mixed", "heis"),
                                         ("qaia", "tfim")])
def test_exact_shift_gradient_matches_jax(kind, target):
  n = 6
  pqc = CIRCUITS[kind](n)
  values = _values(pqc, seed=4)
  bits = np.random.RandomState(5).randint(0, 2, (BATCH, n))
  weights = np.asarray([0.5, 0.3, 0.2], np.float32)
  op, jop = _target(target, n)
  got = _exact_shift_gradient(pqc, values, bits, op, weights).numpy()
  jc = _jax_circuit(pqc)

  def f(v):
    exps = jadjoint.batched_expectations(jc, v, jnp.asarray(bits), (jop,))
    return jnp.sum(exps[:, 0] * jnp.asarray(weights))

  want = np.asarray(jax.grad(f)(jnp.asarray(values)))
  assert np.linalg.norm(got - want) / np.linalg.norm(want) < GRAD_TOL


def test_chunked_matches_unchunked():
  n = 6
  pqc = CIRCUITS["mixed"](n)
  values = _values(pqc, seed=6)
  bits = np.random.RandomState(7).randint(0, 2, (2, n))
  op, _ = _target("heis", n)
  weights = np.asarray([0.6, 0.4], np.float32)
  rows = tshift.shift_plan(pqc)[0].shape[0]
  full = _exact_shift_gradient(pqc, values, bits, op, weights, chunk=rows)
  for chunk in (None, 7, 1):
    assert rows % 7
    got = _exact_shift_gradient(pqc, values, bits, op, weights, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-6)


def test_row_chunk_rule(monkeypatch):
  """Whole rows of `adjoint.auto_chunk`'s states, 1 to all rows."""
  monkeypatch.setattr(tadjoint, "free_bytes", lambda device: 2**30)
  per = tadjoint.auto_chunk(16, 400 * 4, 2**30, False) // 4
  assert tshift.row_chunk(16, 400, 4, CPU) == per
  assert tshift.row_chunk(6, 10, 4, CPU) == 10
  monkeypatch.setattr(tadjoint, "free_bytes", lambda device: 0)
  assert tshift.row_chunk(16, 400, 4, CPU) == 1


def _mixed_sum(n):
  terms = [(0.3, {0: "X", 1: "Y"}), (-0.2, {1: "Y", 2: "Z"}),
           (0.7, {0: "Z"}), (0.1, {2: "X", 3: "X"}), (0.4, {0: "X"}),
           (0.5, {3: "Y"}), (-1.0, {})]
  return (tp.pauli_sum_from_strings(n, terms, device=CPU),
          jp.pauli_sum_from_strings(n, terms))


@pytest.mark.parametrize("kind", ["tfim", "heis", "mixed"])
def test_group_terms_match_jax(kind):
  n = 6
  if kind == "mixed":
    ops, jops = zip(_mixed_sum(n), _target("tfim", n))
  else:
    ops, jops = zip(_target(kind, n))
  got = tqnn._group_terms(ops)
  want = jqnn._group_terms(jops)
  assert len(got) == len(want)
  for (basis, masks, idx), (jbasis, jmasks, jidx) in zip(got, want):
    assert tuple(int(c) for c in jbasis) == basis
    np.testing.assert_array_equal(masks, jmasks)
    assert tuple(jidx) == idx
    assert (tqnn._measurement_rotation(n, basis).to_dict() ==
            jqnn._measurement_rotation(n, jbasis).to_dict())
