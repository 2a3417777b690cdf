"""The engine's flip class (CXP, XXP, YYP, PROTs with X or Y factors)
against the JAX package, on the CPU.

Kinds: CXP, XXP, YYP, a two-qubit PROT on X and on Y, a three-qubit PROT
X.Y.Z, and a one-qubit PROT on X (which the port folds into its 1q
segments).  Placements on the [R, C] layout: both qubits column bits
(n = 2, 3, 8), a row and a column bit (8, 9, 15), inside one row block
(9, 15), and across two row blocks (15: blocks (0, 7), (7, 1)).

  * Each kind alone: `statevector.apply_gate` / `apply_gate_dangle` and
    the kernels' record (`hopper_sv.flip_record`, read as numpy float64)
    against the JAX package's `apply_gate` / `apply_gate_dangle`, 1e-5.
  * A circuit of every kind at a placement, between layers of 1q and
    diagonal gates: the forward (`statevector.apply_circuit`) within 1e-5
    relative L2 of JAX's `apply_circuit`, and the gradient of <H> within
    1e-4 of JAX's `adjoint.expectation`, through the single-state route
    and through `batched_expectations` at B = 4 (the flip stages).
  * The records against the float64 `native_oracle` at n = 2 and 9.
  * `simulate`, `simulate_from_bits`, `sample_bitstrings` (frequencies at
    4q within 5 sigma of |psi|^2 over 20,000 draws, never bit for bit
    across PRNGs) and the TF32 pin of the Pauli tiers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qhbmlib_tpu.models import circuit_utils as jcu
from qhbmlib_tpu.ops import adjoint as jadjoint
from qhbmlib_tpu.ops import circuit_ir as jir
from qhbmlib_tpu.ops import paulis as jp
from qhbmlib_tpu.ops import statevector as jsv
from qhbmlib_tpu_torch.models import circuit_utils as tcu
from qhbmlib_tpu_torch.ops import adjoint as tadjoint
from qhbmlib_tpu_torch.ops import circuit_ir as tir
from qhbmlib_tpu_torch.ops import hopper_sv
from qhbmlib_tpu_torch.ops import native_oracle
from qhbmlib_tpu_torch.ops import paulis as tp
from qhbmlib_tpu_torch.ops import statevector as tsv

torch.set_num_threads(1)

STATE_TOL = 1e-5
GRAD_TOL = 1e-4
KINDS = ("cxp", "xxp", "yyp", "prot x", "prot y", "prot xyz", "prot 1x")
# n -> {placement: (q0, q1, third qubit of the 3-qubit PROT)}.
PLACEMENTS = {
    2: {"both column": (1, 0, None)},
    3: {"both column": (2, 0, 1)},
    8: {"row and column": (0, 5, 3), "both column": (3, 7, 1)},
    9: {"one row block": (0, 1, 5), "row and column": (1, 6, 3)},
    15: {"one row block": (2, 5, 12), "across row blocks": (6, 7, 13),
         "row and column": (7, 12, 3)},
}
CASES = [(n, p) for n, ps in PLACEMENTS.items() for p in ps]


def _kinds_at(n):
  """The kinds a placement takes: a three-qubit PROT needs n >= 3."""
  return [k for k in KINDS if k != "prot xyz" or n >= 3]


def _gate(kind, q0, q1, q2, slot=-1, coeff=1.0, shift=0.0):
  """A gate of `kind` on the placement, in the reference's IR."""
  args = dict(slot=slot, coeff=coeff, shift=shift)
  if kind in ("cxp", "xxp", "yyp"):
    return jir.Gate(kind, (q0, q1), **args)
  if kind == "prot xyz":
    return jir.Gate(jir.PROT, (q0, q1, q2), paulis=(1, 2, 3), **args)
  if kind == "prot 1x":
    return jir.Gate(jir.PROT, (q1,), paulis=(1,), **args)
  code = 1 if kind == "prot x" else 2
  return jir.Gate(jir.PROT, (q0, q1), paulis=(code, code), **args)



def _state(rng, n, batch=()):
  r, c = jsv.state_shape(n)
  x = rng.normal(size=batch + (r, c)) + 1j * rng.normal(size=batch + (r, c))
  return (x / np.linalg.norm(x)).astype(np.complex64)


def _rel(x, ref):
  x, ref = np.asarray(x), np.asarray(ref)
  return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def _flip_form(rec, s):
  """The record's operator on complex [..., 2^n] vectors, in float64."""
  x = np.arange(s.shape[-1])
  c = ((x & rec.ctrl) != 0).astype(np.int64)
  sigma = 1.0 - 2.0 * np.array([bin(int(v)).count("1") & 1
                                for v in x & rec.zmask])
  alpha = np.asarray(rec.alpha, np.complex128)[c]
  beta = np.asarray(rec.beta, np.complex128)[c]
  return alpha * s + beta * sigma * s[..., x ^ rec.flip]


def _port(circuit):
  return tir.Circuit.from_dict(circuit.to_dict())


@pytest.mark.parametrize("n,placement,kind",
                         [(n, p, k) for n, p in CASES for k in _kinds_at(n)])
def test_each_kind_alone_matches_jax(n, placement, kind):
  """apply_gate and apply_gate_dangle of one gate against the JAX
  package's, and the record's flip form (forward, inverse at -angle and
  derivative) against them, on a random state."""
  rng = np.random.RandomState(n * 7 + KINDS.index(kind))
  q0, q1, q2 = PLACEMENTS[n][placement]
  gate = _gate(kind, q0, q1, q2)
  psi = _state(rng, n)
  for angle in (0.37, -1.21):
    a = np.float32(angle)
    for deriv in (False, True):
      jfn = jsv.apply_gate_dangle if deriv else jsv.apply_gate
      tfn = tsv.apply_gate_dangle if deriv else tsv.apply_gate
      want = np.asarray(jfn(gate, jnp.asarray(a), jnp.asarray(psi)))
      got = tfn(_port(jir.Circuit(n, (gate,))).gates[0], a,
                torch.tensor(psi)).numpy()
      assert _rel(got, want) < STATE_TOL, (kind, deriv)
      if kind == "prot 1x":
        continue  # a 1q gate: the segment fold takes it, not a record
      rec = hopper_sv.flip_record(gate, a, n, deriv)
      form = _flip_form(rec, psi.reshape(-1).astype(np.complex128))
      assert _rel(form, want.reshape(-1)) < STATE_TOL, (kind, deriv)
    inverse = hopper_sv.flip_record(gate, -a, n) if kind != "prot 1x" else None
    if inverse is not None:
      back = _flip_form(inverse, np.asarray(jsv.apply_gate(
          gate, jnp.asarray(a), jnp.asarray(psi))).reshape(-1))
      assert _rel(back, psi.reshape(-1)) < STATE_TOL, kind


def _mixed_circuit(n, placement):
  """1q layer, every kind at the placement (each with a symbol), a
  constant CNOT, diagonal layer."""
  q0, q1, q2 = PLACEMENTS[n][placement]
  b = jir.CircuitBuilder(n)
  for q in range(n):
    b.rx(q, f"rx{q}")
  for i, kind in enumerate(_kinds_at(n)):
    g = _gate(kind, q0, q1, q2)
    b.add(g.kind, g.qubits, f"g{i}", coeff=0.5 + 0.25 * i, shift=0.1,
          paulis=g.paulis)
  b.cnot(q1, q0)
  for q in range(n):
    b.rz(q, f"rz{q}")
  for q in range(n - 1):
    b.add(jir.ZZP, [q, q + 1], f"zz{q}")
  return b.build()


def _observable(n):
  """A Heisenberg chain plus X fields: terms of every tier."""
  terms = [(0.7, {q: p, q + 1: p}) for q in range(n - 1) for p in "XYZ"]
  terms += [(-0.4, {q: "X"}) for q in range(n)]
  return (jp.pauli_sum_from_strings(n, terms),
          tp.pauli_sum_from_strings(n, terms, device="cpu"))


@pytest.mark.parametrize("n,placement", CASES)
def test_mixed_circuit_matches_jax(n, placement):
  """The forward of one state and <H>'s gradient through the single-state
  route (segment by segment: a flip gate is in the circuit) and through
  `batched_expectations` at B = 4, against the JAX package."""
  jc = _mixed_circuit(n, placement)
  tc = _port(jc)
  assert not hopper_sv.single_supported(tc)
  rng = np.random.RandomState(n + 100)
  vals = rng.uniform(-2, 2, jc.num_symbols).astype(np.float32)
  bits = rng.randint(0, 2, (4, n)).astype(np.int8)
  op_j, op_t = _observable(n)
  init_j = jsv.basis_state(n, jnp.asarray(bits[0]))
  init_t = tsv.basis_state(n, torch.tensor(bits[0]))
  assert _rel(tsv.apply_circuit(tc, torch.tensor(vals), init_t).numpy(),
              jsv.apply_circuit(jc, jnp.asarray(vals), init_j)) < STATE_TOL

  def j_one(v, b):
    return jadjoint.expectation(jc, v, jsv.basis_state(n, b), op_j)

  # One compile: each bitstring's value and gradient.
  e_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(j_one), in_axes=(None, 0)))(
      jnp.asarray(vals), jnp.asarray(bits))
  e_j, g_j = np.asarray(e_j, np.float64), np.asarray(g_j, np.float64)
  v = torch.tensor(vals, requires_grad=True)
  e_t = tadjoint.expectation(tc, v, init_t, op_t)
  e_t.backward()
  assert abs(float(e_t.detach()) - e_j[0]) < GRAD_TOL
  assert _rel(v.grad.numpy(), g_j[0]) < GRAD_TOL
  vb = torch.tensor(vals, requires_grad=True)
  eb_t = tadjoint.batched_expectations(tc, vb, torch.tensor(bits),
                                       (op_t,)).sum()
  eb_t.backward()
  assert abs(float(eb_t.detach()) - e_j.sum()) < GRAD_TOL * 4
  gb_j = g_j.sum(axis=0)
  assert _rel(vb.grad.numpy(), gb_j) < GRAD_TOL


@pytest.mark.parametrize("n", [2, 9])
def test_records_match_the_f64_oracle(n):
  """A circuit of flip-class gates only, applied record by record in
  float64 from a basis state, and the port's forward of the same circuit
  (its plain flip stages), against `native_oracle` (float64 C++)."""
  placements = PLACEMENTS[n]
  b = jir.CircuitBuilder(n)
  i = 0
  for q0, q1, q2 in placements.values():
    for kind in _kinds_at(n):
      if kind == "prot 1x":
        continue
      g = _gate(kind, q0, q1, q2)
      b.add(g.kind, g.qubits, f"s{i}", coeff=1.0, shift=0.05 * i,
            paulis=g.paulis)
      i += 1
  tc = _port(b.build())
  rng = np.random.RandomState(n + 3)
  vals = rng.uniform(-2, 2, tc.num_symbols).astype(np.float32)
  bits = rng.randint(0, 2, n)
  want = native_oracle.simulate(tc, vals.astype(np.float64), bits=bits)
  angles = tsv.resolve_angles(tc, vals)
  psi = np.zeros(2**n, np.complex128)
  psi[int("".join(map(str, bits)), 2)] = 1.0
  for gate, angle in zip(tc.gates, angles):
    psi = _flip_form(hopper_sv.flip_record(gate, angle, n), psi)
  assert _rel(psi, want) < STATE_TOL
  got = tsv.simulate_from_bits(tc, torch.tensor(vals),
                               torch.tensor(bits, dtype=torch.int8))
  assert _rel(tsv.to_vector(got).numpy(), want) < STATE_TOL


def test_single_supported():
  """K3 / K2 take the HEA at 8-20 qubits and no circuit with a CNOT or a
  circuit outside their qubit range; the one-qubit PROT folds in."""
  assert hopper_sv.single_supported(tcu.hardware_efficient_ansatz(9, 2))
  assert hopper_sv.single_supported(tcu.hardware_efficient_ansatz(20, 1))
  assert not hopper_sv.single_supported(tcu.hardware_efficient_ansatz(7, 1))
  assert not hopper_sv.single_supported(
      tir.CircuitBuilder(9).rx(0, "a").cnot(0, 1).build())
  folded = tir.CircuitBuilder(9).rx(0, "a").prot([3], [1], "p").prot(
      [4], [2], "q").build()
  assert [cls for cls, _ in tsv.segment_circuit(folded.gates)] == ["1q"]
  assert hopper_sv.single_supported(folded)


@pytest.mark.parametrize("n", [3, 9])
def test_simulate_matches_jax(n):
  """`simulate` (|0...0>) and `simulate_from_bits` (one bitstring and a
  batch of 3) of a circuit with flip gates against the JAX package."""
  jc = _mixed_circuit(n, next(iter(PLACEMENTS[n])))
  tc = _port(jc)
  rng = np.random.RandomState(n + 11)
  vals = rng.uniform(-2, 2, jc.num_symbols).astype(np.float32)
  bits = rng.randint(0, 2, (3, n)).astype(np.int8)
  tv = torch.tensor(vals)
  assert _rel(tsv.simulate(tc, tv).numpy(),
              jsv.simulate(jc, jnp.asarray(vals))) < STATE_TOL
  assert _rel(tsv.simulate_from_bits(tc, tv, torch.tensor(bits[0])).numpy(),
              jsv.simulate_from_bits(jc, jnp.asarray(vals),
                                     jnp.asarray(bits[0]))) < STATE_TOL
  assert _rel(tsv.simulate_from_bits(tc, tv, torch.tensor(bits)).numpy(),
              jsv.simulate_from_bits(jc, jnp.asarray(vals),
                                     jnp.asarray(bits))) < STATE_TOL


def test_sample_bitstrings_follow_the_born_rule():
  """20,000 draws from a 4-qubit state with flip gates: each basis state's
  count within 5 sigma of 20,000 |psi_x|^2, bitstrings big-endian as the
  reference's `index_to_bits`; a seeded generator repeats its draws."""
  jc = _mixed_circuit(3, "both column")
  tc = tir.Circuit(4, _port(jc).gates, jc.symbol_names)
  vals = torch.tensor(np.random.RandomState(5).uniform(
      -2, 2, tc.num_symbols).astype(np.float32))
  psi = tsv.simulate(tc, vals)
  draws = 20000
  gen = torch.Generator().manual_seed(7)
  bits = tsv.sample_bitstrings(psi, draws, gen)
  assert bits.shape == (draws, 4) and bits.dtype == torch.int8
  idx = tsv.bits_to_index(bits, 4)
  counts = np.bincount(idx.numpy(), minlength=16)
  p = tsv.probabilities(psi).numpy().astype(np.float64)
  sigma = np.sqrt(draws * p * (1 - p))
  assert np.all(np.abs(counts - draws * p) <= 5 * sigma + 1e-9), (counts, p)
  again = tsv.sample_bitstrings(psi, draws, torch.Generator().manual_seed(7))
  assert torch.equal(bits, again)
  np.testing.assert_array_equal(
      tsv.index_to_bits(idx, 4).numpy(),
      np.asarray(jsv.index_to_bits(jnp.asarray(idx.numpy()), 4)))


def test_pauli_tiers_pin_fp32_and_restore_the_flag():
  """`expectation_terms` and `apply_pauli_sum` run with TF32 matmuls off
  and hand the caller's flag back, whichever it was."""
  seen = []
  original = torch.matmul

  def spy(*args, **kwargs):
    seen.append(torch.backends.cuda.matmul.allow_tf32)
    return original(*args, **kwargs)

  _, op = _observable(9)
  psi = torch.tensor(_state(np.random.RandomState(1), 9))
  before = torch.backends.cuda.matmul.allow_tf32
  try:
    for flag in (True, False):
      torch.backends.cuda.matmul.allow_tf32 = flag
      torch.matmul = spy
      try:
        tsv.expectation_terms(psi, op)
        tsv.apply_pauli_sum(psi, op)
      finally:
        torch.matmul = original
      assert torch.backends.cuda.matmul.allow_tf32 is flag
  finally:
    torch.backends.cuda.matmul.allow_tf32 = before
  assert seen and not any(seen)


@pytest.mark.parametrize("kind", ["cxp", "xxp", "yyp", "zzp"])
def test_two_qubit_gate_matrices_match_jax(kind):
  """gate_matrix and its closed-form derivative against the reference's
  matrix and jax.jvp of it."""
  for angle in (-1.3, 0.0, 0.37, 2.5):
    a = jnp.asarray(angle, jnp.float32)
    np.testing.assert_allclose(tsv.gate_matrix(kind, angle).numpy(),
                               np.asarray(jsv.gate_matrix(kind, a)),
                               atol=1e-6)
    _, want = jax.jvp(lambda t: jsv.gate_matrix(kind, t), (a,),
                      (jnp.ones_like(a),))
    np.testing.assert_allclose(tsv.gate_matrix_dangle(kind, angle).numpy(),
                               np.asarray(want), atol=1e-5)


def test_hea_segments_unchanged():
  """The hardware-efficient ansatz segments as before: the one-qubit PROT
  rule touches no other gate."""
  segs = tsv.segment_circuit(tcu.hardware_efficient_ansatz(20, 2).gates)
  assert segs == jsv.segment_circuit(
      jcu.hardware_efficient_ansatz(20, 2).gates)
