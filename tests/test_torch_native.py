"""The port's copies of the native C++ bindings against the JAX package's.

`ops/native_oracle.py` (float64 statevector oracle) and `ops/native_fast.py`
(the independent AVX-512 simulator) are copies, not imports, so they are
held here against the JAX package's bindings of the same C++ sources, on the
same circuits and values (the port's circuit rebuilt from the JAX one's
dict).  The port's statevector engine is then checked against the oracle
(ROADMAP queue 1 item 3).  Tolerances: 1e-12 between the two bindings (the
same float64 C++ and numpy sums), 1e-10 between the two fast_sim bindings
(the same float32 C++ run), 1e-5 for the float32 engine against the oracle
(the reference's own engine-vs-oracle tests use 2e-5).
"""

import numpy as np
import pytest
import torch

from qhbmlib_tpu.models import circuit_utils as jcu
from qhbmlib_tpu.ops import circuit_ir as jir
from qhbmlib_tpu.ops import native_fast as j_fast
from qhbmlib_tpu.ops import native_oracle as j_oracle
from qhbmlib_tpu.ops import paulis as jp
from qhbmlib_tpu_torch.ops import circuit_ir as tir
from qhbmlib_tpu_torch.ops import native_fast as t_fast
from qhbmlib_tpu_torch.ops import native_oracle as t_oracle
from qhbmlib_tpu_torch.ops import paulis as tp
from qhbmlib_tpu_torch.ops import statevector as tsv

torch.set_num_threads(1)

KINDS_1Q = [jir.XP, jir.YP, jir.ZP, jir.HP, jir.RX, jir.RY, jir.RZ]
KINDS_2Q = [jir.CZP, jir.CXP, jir.XXP, jir.YYP, jir.ZZP]


def _random_circuit(n, depth, seed):
  """A JAX circuit of every gate kind the oracle takes, seeded."""
  rng = np.random.RandomState(seed)
  b = jir.CircuitBuilder(n)
  s = 0
  for _ in range(depth):
    for q in range(n):
      b.add(KINDS_1Q[rng.randint(len(KINDS_1Q))], [q], f"s{s}",
            coeff=float(rng.uniform(0.5, 1.5)),
            shift=float(rng.uniform(-1, 1)))
      s += 1
    q0, q1 = (int(q) for q in rng.choice(n, 2, replace=False))
    b.add(KINDS_2Q[rng.randint(len(KINDS_2Q))], [q0, q1], f"s{s}")
    b.prot([q0, q1], [int(rng.randint(1, 4)), int(rng.randint(1, 4))],
           f"p{s}")
    b.add(jir.GPHASE, [], f"g{s}")
    s += 1
  return b.build()


def _port(circuit):
  return tir.Circuit.from_dict(circuit.to_dict())


def _terms(rng, n, count=6):
  return [(float(rng.uniform(-1, 1)),
           {int(q): "XYZ"[rng.randint(3)]
            for q in rng.choice(n, rng.randint(1, n + 1), replace=False)})
          for _ in range(count)]


@pytest.mark.parametrize("n", [2, 8, 10])
def test_oracle_simulate_matches_jax_binding(n):
  circuit = _random_circuit(n, 3, seed=n)
  rng = np.random.RandomState(100 + n)
  values = rng.uniform(-2, 2, circuit.num_symbols)
  bits = rng.randint(0, 2, n)
  for b in (None, bits):
    np.testing.assert_allclose(
        t_oracle.simulate(_port(circuit), values, bits=b),
        j_oracle.simulate(circuit, values, bits=b), atol=1e-12, rtol=0)


@pytest.mark.parametrize("n", [2, 8, 10])
def test_oracle_expectation_f64_matches_jax_binding(n):
  """TFIM and random X/Y/Z strings on a random normalized state."""
  rng = np.random.RandomState(200 + n)
  vec = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
  vec /= np.linalg.norm(vec)
  terms = _terms(rng, n)
  for t_op, j_op in [(tp.tfim_1d(n, device="cpu"), jp.tfim_1d(n)),
                     (tp.pauli_sum_from_strings(n, terms, device="cpu"),
                      jp.pauli_sum_from_strings(n, terms))]:
    np.testing.assert_allclose(t_oracle.expectation_f64(vec, t_op),
                               j_oracle.expectation_f64(vec, j_op),
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize("n", [8, 14])
def test_port_apply_circuit_matches_oracle(n):
  """The port's float32 engine on a basis state through the
  hardware-efficient ansatz against the float64 oracle."""
  circuit = jcu.hardware_efficient_ansatz(n, 2)
  rng = np.random.RandomState(300 + n)
  values = rng.uniform(-2, 2, circuit.num_symbols)
  bits = rng.randint(0, 2, n).astype(np.int8)
  psi = tsv.apply_circuit(_port(circuit), values.astype(np.float32),
                          tsv.basis_state(n, torch.tensor(bits)))
  np.testing.assert_allclose(tsv.to_vector(psi).numpy(),
                             t_oracle.simulate(_port(circuit), values,
                                               bits=bits), atol=1e-5)


def test_fast_sim_vqt_step_matches_jax_binding():
  n = 8
  circuit = jcu.hardware_efficient_ansatz(n, 2)
  rng = np.random.RandomState(400)
  values = rng.uniform(-1.5, 1.5, circuit.num_symbols)
  bits = rng.randint(0, 2, size=(4, n))
  t_terms = t_fast.split_pauli_terms(tp.tfim_1d(n, device="cpu"))
  j_terms = j_fast.split_pauli_terms(jp.tfim_1d(n))
  assert t_terms == j_terms
  got = t_fast.vqt_step(_port(circuit), values, *t_terms, bits)
  want = j_fast.vqt_step(circuit, values, *j_terms, bits)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g, w, atol=1e-10, rtol=0)
  assert np.abs(want[1]).max() > 1e-3  # non-trivial gradient


def test_port_builds_into_its_build_directory():
  """Both libraries land in build/qhbmlib_tpu_torch/, keyed on their
  source and flags (and, for -march=native, the host)."""
  from qhbmlib_tpu_torch.ops import _cuda
  assert t_oracle.available() and t_fast.available()
  assert (_cuda.BUILD_DIR / f"libfast_sim.{t_fast.artifact_key()}.so").exists()
  assert list(_cuda.BUILD_DIR.glob("libqsim_oracle.*.so"))


def test_split_pauli_terms_refuses_other_terms():
  with pytest.raises(ValueError, match="not a ZZ pair or single X"):
    t_fast.split_pauli_terms(tp.pauli_sum_from_strings(
        3, [(1.0, {0: "Y"})], device="cpu"))
