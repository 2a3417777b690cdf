"""Hamiltonian observables of the port against the JAX package, on the CPU.

PauliSum algebra and `dense` (n = 3-5); `statevector.index_to_bits`,
`apply_pauli_string`, `probabilities` and `unitary` (n = 4-8); circuit sums
and inverses and the `Hamiltonian` built on them (the dagger inverts the
circuit, the sum trains the summands' own parameters);
`AnalyticQuantumInference.expectation` of a Hamiltonian (n = 6) and
`QHBM.expectation` over several PauliSums or a Hamiltonian (n = 5), values
and gradients; `make_vqt` with a Hamiltonian target and PauliSum-coefficient
gradients (n = 6); `density_matrix` and `fidelity` (n = 4).  Inputs come
from numpy seeds, weights cross with `convert.from_jax_params`, EBMs use
`exact=True` on both sides.  Tolerances as `tests/test_torch_vqt.py`: loss
and values atol 1e-4, gradients atol 2e-4.
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
from qhbmlib_tpu.inference import qhbm_utils as jqhbm_utils
from qhbmlib_tpu.inference import qnn as jqnn
from qhbmlib_tpu.inference import vqt_loss as jvqt
from qhbmlib_tpu.ops import paulis as jp
from qhbmlib_tpu.ops import statevector as jsv
from qhbmlib_tpu_torch import convert
from qhbmlib_tpu_torch import models as tmodels
from qhbmlib_tpu_torch import nn as tnn
from qhbmlib_tpu_torch.inference import ebm as tebm
from qhbmlib_tpu_torch.inference import qhbm as tqhbm
from qhbmlib_tpu_torch.inference import qhbm_utils as tqhbm_utils
from qhbmlib_tpu_torch.inference import qnn as tqnn
from qhbmlib_tpu_torch.inference import vqt_loss as tvqt
from qhbmlib_tpu_torch.models import energy_utils as tenergy_utils
from qhbmlib_tpu_torch.ops import paulis as tp
from qhbmlib_tpu_torch.ops import statevector as tsv

torch.set_num_threads(1)

CPU = "cpu"  # the port builds on the CUDA card unless told otherwise
VALUE_ATOL = 1e-4
GRAD_ATOL = 2e-4
BETA = 1.2


def _random_terms(rng, n, num_terms):
  """(coeff, {qubit: code}) pairs of random Pauli strings."""
  terms = []
  for _ in range(num_terms):
    codes = rng.randint(0, 4, n)
    terms.append((float(rng.uniform(-1, 1)),
                  {q: int(c) for q, c in enumerate(codes) if c}))
  return terms


@pytest.mark.parametrize("n", [3, 4, 5])
def test_pauli_algebra_and_dense_match_jax(n):
  rng = np.random.RandomState(n)
  ta, tb = _random_terms(rng, n, 3), _random_terms(rng, n, 2)
  ja, jb = jp.pauli_sum_from_strings(n, ta), jp.pauli_sum_from_strings(n, tb)
  a = tp.pauli_sum_from_strings(n, ta, device=CPU)
  b = tp.pauli_sum_from_strings(n, tb, device=CPU)
  want = (ja + 2.0 * jb - (-ja) * 0.5 - jb * 3.0).dense()
  got = (a + 2.0 * b - (-a) * 0.5 - b * 3.0)
  assert got.num_terms == 10
  np.testing.assert_allclose(got.dense(), want, atol=1e-6)
  # The reference's codes and coefficients carried over as arrays.
  carried = tp.from_arrays(ja.codes_array(), np.asarray(ja.coeffs), n,
                           device=CPU)
  np.testing.assert_allclose(carried.dense(), ja.dense(), atol=1e-6)
  masks = rng.randint(0, 2, (4, n))
  shards = tp.z_strings_from_masks(masks, n, device=CPU)
  j_shards = jp.z_strings_from_masks(masks, n)
  for s, js in zip(shards, j_shards):
    np.testing.assert_allclose(s.dense(), js.dense(), atol=0)
  np.testing.assert_allclose(tp.stack_single_term(shards).dense(),
                             jp.stack_single_term(j_shards).dense(), atol=0)
  np.testing.assert_allclose(
      tp.pauli_string(n, {0: "Y", n - 1: "X"}, -0.5, device=CPU).dense(),
      jp.pauli_string(n, {0: "Y", n - 1: "X"}, -0.5).dense(), atol=0)
  with pytest.raises(ValueError, match="same number of qubits"):
    a + tp.pauli_sum_from_strings(n + 1, tb, device=CPU)


def _random_state(rng, n):
  x = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
  return (x / np.linalg.norm(x)).astype(np.complex64)


@pytest.mark.parametrize("n", [4, 6, 8])
def test_statevector_helpers_match_jax(n):
  rng = np.random.RandomState(10 + n)
  idx = rng.randint(0, 2**n, 7)
  np.testing.assert_array_equal(
      tsv.index_to_bits(torch.tensor(idx), n).numpy(),
      np.asarray(jsv.index_to_bits(jnp.asarray(idx), n)))
  vec = _random_state(rng, n)
  state = tsv.from_vector(torch.tensor(vec), n)
  j_state = jsv.from_vector(jnp.asarray(vec), n)
  for codes in rng.randint(0, 4, (4, n)):
    np.testing.assert_allclose(
        tsv.apply_pauli_string(state, tuple(codes)).numpy(),
        np.asarray(jsv.apply_pauli_string(j_state, tuple(int(c)
                                                          for c in codes))),
        atol=1e-6)
  np.testing.assert_allclose(tsv.probabilities(state).numpy(),
                             np.asarray(jsv.probabilities(j_state)),
                             atol=1e-7)
  pqc = jmodels.hardware_efficient_ansatz(n, 2)
  values = rng.uniform(0, 2, pqc.num_symbols).astype(np.float32)
  got = tsv.unitary(tmodels.hardware_efficient_ansatz(n, 2),
                    torch.tensor(values))
  np.testing.assert_allclose(got.numpy(),
                             np.asarray(jsv.unitary(pqc, jnp.asarray(values))),
                             atol=1e-5)


def _port_circuit(n, layers, name="p", seed=0):
  return tmodels.DirectQuantumCircuit(
      tmodels.hardware_efficient_ansatz(n, layers, name=name),
      initializer=tnn.RandomUniform(0, 2, seed=seed), device=CPU)


def test_sum_and_inverse_share_parameters_and_invert():
  n = 4
  model = _port_circuit(n, 2, "p", 1)
  data = _port_circuit(n, 1, "data_p", 2)
  energy = tmodels.BernoulliEnergy(list(range(n)), device=CPU)
  ham = tmodels.Hamiltonian(energy, model)
  total = data + ham.circuit_dagger
  # The sum and the dagger hold the modules, not copies.
  assert [p is q for p, q in zip(total.parameters(),
                                 [data.values, model.values])] == [True, True]
  assert ham.parameters() == [energy.kernel, model.values]
  before = total.resolved_values().detach().clone()
  with torch.no_grad():
    model.values.add_(0.25)
  moved = (total.resolved_values().detach() - before).abs()
  assert torch.all(moved[:data.pqc.num_symbols] == 0)
  assert torch.allclose(moved[data.pqc.num_symbols:], torch.tensor(0.25))
  # U^dagger U = I, and every dagger gate runs at coeff -1.
  u = tsv.unitary(model.pqc, model.resolved_values().detach())
  u_dag = tsv.unitary(ham.circuit_dagger.pqc,
                      ham.circuit_dagger.resolved_values().detach())
  np.testing.assert_allclose((u_dag @ u).numpy(), np.eye(2**n), atol=1e-5)
  assert {g.coeff for g in ham.circuit_dagger.pqc.gates} == {-1.0}
  with pytest.raises(ValueError, match="in common"):
    model + model
  with pytest.raises(ValueError, match="inverse"):
    model**2
  with pytest.raises(ValueError, match="same number of bits"):
    tmodels.Hamiltonian(tmodels.BernoulliEnergy([0, 1], device=CPU), model)


def _jax_hamiltonian(n, layers, name, e_seed, c_seed):
  energy = jmodels.BernoulliEnergy(
      list(range(n)), initializer=jnn.RandomUniform(-1, 1, seed=e_seed))
  circuit = jmodels.DirectQuantumCircuit(
      jmodels.hardware_efficient_ansatz(n, layers, name=name),
      initializer=jnn.RandomUniform(0, 2, seed=c_seed))
  return jmodels.Hamiltonian(energy, circuit)


def _port_hamiltonian(jh, n, layers, name):
  ham = tmodels.Hamiltonian(
      tmodels.BernoulliEnergy(list(range(n)), device=CPU),
      tmodels.DirectQuantumCircuit(
          tmodels.hardware_efficient_ansatz(n, layers, name=name),
          device=CPU))
  ham.set_params(convert.from_jax_params(
      {"energy": jh.energy.trainable_variables,
       "circuit": jh.circuit.trainable_variables}, device=CPU))
  return ham


def test_analytic_expectation_of_a_hamiltonian_matches_jax():
  """[B, 1] <(U + V^dagger)|b>| E-shards |.> post-processed, with gradients
  w.r.t. U's parameters, V's and E's; a repeated bitstring is simulated
  once (dedup) and expanded."""
  n = 6
  rng = np.random.RandomState(3)
  circuit = jmodels.DirectQuantumCircuit(
      jmodels.hardware_efficient_ansatz(n, 2),
      initializer=jnn.RandomUniform(0, 2, seed=5))
  jh = _jax_hamiltonian(n, 1, "obs", 6, 7)
  j_inf = jqnn.AnalyticQuantumInference(circuit)
  bits = rng.randint(0, 2, (5, n)).astype(np.int8)
  bits[3] = bits[1]
  w = rng.normal(size=(5, 1)).astype(np.float32)

  def j_fn(phi, obs_c, obs_e):
    out = j_inf.expectation_pure(phi, jnp.asarray(bits), jh,
                                 obs_circuit_params=obs_c,
                                 obs_energy_params=obs_e)
    return jnp.sum(out * w), out

  (_, want), grads = jax.jit(jax.value_and_grad(
      j_fn, argnums=(0, 1, 2), has_aux=True))(
      circuit.trainable_variables, jh.circuit.trainable_variables,
      jh.energy.trainable_variables)
  t_circuit = tmodels.DirectQuantumCircuit(
      tmodels.hardware_efficient_ansatz(n, 2), device=CPU)
  with torch.no_grad():
    t_circuit.values.copy_(torch.tensor(np.asarray(
        circuit.trainable_variables[0])))
  ham = _port_hamiltonian(jh, n, 1, "obs")
  t_inf = tqnn.AnalyticQuantumInference(t_circuit)
  got = t_inf.expectation(torch.tensor(bits), ham)
  assert got.shape == (5, 1)
  (got * torch.tensor(w)).sum().backward()
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             atol=VALUE_ATOL)
  for param, g in zip([t_circuit.values, ham.circuit.values,
                       ham.energy.kernel], grads):
    np.testing.assert_allclose(param.grad.numpy(), np.asarray(g[0]),
                               atol=GRAD_ATOL)
  assert np.abs(np.asarray(grads[1][0])).max() > 1e-2
  # The composite circuit is built once per Hamiltonian.
  assert t_inf._total_circuit(ham) is t_inf._total_circuit(ham)
  plain = tmodels.BitstringEnergy(list(range(n)), [
      tenergy_utils.SpinsFromBitstrings(),
      tenergy_utils.VariableDot(n, device=CPU)])
  with pytest.raises(TypeError, match="PauliMixin"):
    t_inf.expectation(torch.tensor(bits), tmodels.Hamiltonian(plain,
                                                              ham.circuit))


def _jax_qhbm(n, layers, name, e_seed, c_seed):
  energy = jmodels.BernoulliEnergy(
      list(range(n)), initializer=jnn.RandomUniform(-1, 1, seed=e_seed))
  e_inf = jebm.BernoulliEnergyInference(energy, 100, initial_seed=1,
                                        exact=True)
  circuit = jmodels.DirectQuantumCircuit(
      jmodels.hardware_efficient_ansatz(n, layers, name=name),
      initializer=jnn.RandomUniform(0, 2, seed=c_seed))
  return jqhbm.QHBM(e_inf, jqnn.AnalyticQuantumInference(circuit))


def _port_qhbm(jh, n, layers, name):
  h = tqhbm.QHBM(
      tebm.BernoulliEnergyInference(
          tmodels.BernoulliEnergy(list(range(n)), device=CPU), 100,
          initial_seed=0, exact=True),
      tqnn.AnalyticQuantumInference(tmodels.DirectQuantumCircuit(
          tmodels.hardware_efficient_ansatz(n, layers, name=name),
          device=CPU)))
  h.set_params(convert.from_jax_params(jh.params, device=CPU))
  return h


@pytest.mark.parametrize("kind", ["paulisums", "hamiltonian"])
def test_qhbm_expectation_matches_jax(kind):
  """[k] thermal expectations (the eq. A5 average of the QNN's [U, k]
  values) and their gradients w.r.t. theta, phi and the observables'
  parameters: the PauliSums' coefficients or the Hamiltonian's weights."""
  n = 5
  rng = np.random.RandomState(11)
  jh = _jax_qhbm(n, 2, "p", 2, 3)
  h = _port_qhbm(jh, n, 2, "p")
  if kind == "paulisums":
    terms = [_random_terms(rng, n, 3), _random_terms(rng, n, 2)]
    codes = [jp.pauli_sum_from_strings(n, t) for t in terms]

    def j_obs(obs_params):
      return [jp.PauliSum(c.codes, co, n)
              for c, co in zip(codes, obs_params)], None

    obs_params0 = [jnp.asarray(c.coeffs) for c in codes]
    t_obs = [tp.pauli_sum_from_strings(n, t, device=CPU) for t in terms]
    for op in t_obs:
      op.coeffs.requires_grad_(True)
    t_obs_params = [op.coeffs for op in t_obs]
  else:
    jham = _jax_hamiltonian(n, 1, "obs", 8, 9)

    def j_obs(obs_params):
      return jham, {"circuit": obs_params[0], "energy": obs_params[1]}

    obs_params0 = [jham.circuit.trainable_variables,
                   jham.energy.trainable_variables]
    t_obs = _port_hamiltonian(jham, n, 1, "obs")
    t_obs_params = [t_obs.circuit.values, t_obs.energy.kernel]
  w = rng.normal(size=2 if kind == "paulisums" else 1).astype(np.float32)

  def j_fn(params, obs_params):
    obs, extra = j_obs(obs_params)
    out, _ = jh.expectation_pure(params, jax.random.PRNGKey(0), obs, extra)
    return jnp.sum(out * w), out

  (_, want), (g_params, g_obs) = jax.jit(jax.value_and_grad(
      j_fn, argnums=(0, 1), has_aux=True))(jh.params, obs_params0)
  got = h.expectation(t_obs)
  assert got.shape == want.shape == (len(w),)
  (got * torch.tensor(w)).sum().backward()
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             atol=VALUE_ATOL)
  for key in ("theta", "phi"):
    np.testing.assert_allclose(h.params[key][0].grad.numpy(),
                               np.asarray(g_params[key][0]), atol=GRAD_ATOL)
  for param, g in zip(t_obs_params, g_obs):
    g = g[0] if isinstance(g, list) else g
    np.testing.assert_allclose(param.grad.numpy(), np.asarray(g),
                               atol=GRAD_ATOL)
  assert np.abs(np.asarray(g_params["theta"][0])).max() > 1e-3


def test_modular_hamiltonian_and_circuits():
  n = 5
  h = _port_qhbm(_jax_qhbm(n, 1, "p", 2, 3), n, 1, "p")
  k = h.modular_hamiltonian
  assert k.energy is h.e_inference.energy
  assert k.circuit is h.q_inference.circuit
  assert len(k.operator_shards) == n
  bits, counts = h.circuits(64, torch.Generator().manual_seed(0))
  assert bits.shape[1] == n and int(counts.sum()) == 64
  assert len({tuple(r) for r in bits.tolist()}) == bits.shape[0]


@pytest.mark.parametrize("target", ["hamiltonian", "paulisum_coeffs"])
def test_vqt_target_gradients_match_jax(target):
  """make_vqt against the JAX loss with a Hamiltonian target (gradients to
  its circuit and energy) or a PauliSum target (gradients to its
  coefficients, `params["target_coeffs"]`)."""
  n = 6
  jh = _jax_qhbm(n, 2, "p", 4, 5)
  h = _port_qhbm(jh, n, 2, "p")
  params = dict(jh.params)
  if target == "hamiltonian":
    jt = _jax_hamiltonian(n, 1, "t", 6, 7)
    params["target_circuit"] = jt.circuit.trainable_variables
    params["target_energy"] = jt.energy.trainable_variables
    tt = _port_hamiltonian(jt, n, 1, "t")
    extra = {"target_circuit": tt.circuit.values,
             "target_energy": tt.energy.kernel}
  else:
    jt = jp.tfim_1d(n, h=0.7)
    params["target_coeffs"] = jnp.asarray(jt.coeffs)
    tt = tp.tfim_1d(n, h=0.7, device=CPU)
    tt.coeffs.requires_grad_(True)
    extra = {"target_coeffs": tt.coeffs}
  loss_fn = jvqt.make_vqt(jh, jt)
  loss_j, grads = jax.jit(jax.value_and_grad(
      lambda p: loss_fn(p, jax.random.PRNGKey(0), np.float32(BETA))[0]))(
          params)
  loss = tvqt.make_vqt(h, tt)(BETA)
  loss.backward()
  np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                             atol=VALUE_ATOL)
  for key in ("theta", "phi"):
    np.testing.assert_allclose(h.params[key][0].grad.numpy(),
                               np.asarray(grads[key][0]), atol=GRAD_ATOL)
  for key, param in extra.items():
    g = grads[key][0] if isinstance(grads[key], list) else grads[key]
    np.testing.assert_allclose(param.grad.numpy(), np.asarray(g),
                               atol=GRAD_ATOL)
    assert np.abs(np.asarray(g)).max() > 1e-3


def test_density_matrix_and_fidelity_match_jax():
  n = 4
  jh = _jax_qhbm(n, 2, "p", 12, 13)
  jo = _jax_qhbm(n, 1, "o", 14, 15)
  h, o = _port_qhbm(jh, n, 2, "p"), _port_qhbm(jo, n, 1, "o")
  rho = tqhbm_utils.density_matrix(h.modular_hamiltonian)
  assert rho.dtype == np.complex128
  np.testing.assert_allclose(
      rho, jqhbm_utils.density_matrix(jh.modular_hamiltonian), atol=1e-6)
  np.testing.assert_allclose(np.trace(rho).real, 1.0, atol=1e-5)
  sigma = tqhbm_utils.density_matrix(o.modular_hamiltonian)
  np.testing.assert_allclose(
      tqhbm_utils.fidelity(h.modular_hamiltonian, sigma),
      float(jqhbm_utils.fidelity(jh.modular_hamiltonian, sigma)), atol=1e-4)
  np.testing.assert_allclose(
      tqhbm_utils.fidelity(h.modular_hamiltonian, rho), 1.0, atol=1e-4)


def test_convert_carries_nested_trees():
  jh = _jax_qhbm(4, 1, "p", 1, 2)
  tree = convert.from_jax_params(
      {"model": jh.params, "data": jh.params,
       "target_energy": [np.ones(4)], "target_coeffs": np.zeros(3)},
      device=CPU)
  assert set(tree) == {"model", "data", "target_energy", "target_coeffs"}
  assert set(tree["model"]) == {"theta", "phi"}
  np.testing.assert_array_equal(tree["data"]["phi"].numpy(),
                                np.asarray(jh.params["phi"][0]))
  assert tree["target_coeffs"].shape == (3,)
  # A group of several arrays (QAIA's phi) is a tuple of tensors; loading
  # it into a module of one parameter raises, as does an empty group.
  two = convert.from_jax_params({"model": {"theta": [np.zeros(4)] * 2}},
                                device=CPU)
  assert isinstance(two["model"]["theta"], tuple)
  assert len(two["model"]["theta"]) == 2
  h = _port_qhbm(jh, 4, 1, "p")
  with pytest.raises(ValueError, match="holds 2 tensors for 1 parameters"):
    h.set_params(two["model"])
  with pytest.raises(ValueError, match="empty group"):
    convert.from_jax_params({"model": {"theta": []}}, device=CPU)
