"""The port's ThermalStateData, its batched forward and sweep from given
states, and the r2 ladder rung against the JAX package, on the CPU.

`ThermalStateData` measures a Hamiltonian K = U diag(E) U^dagger through
rho's eigenvectors (`adjoint.batched_probabilities`); the JAX package
builds the dense unitary and differentiates through it (its ladder test's
dense route, `tests/benchmarks/test_ladder.py:43`).  Inputs are made with
numpy from seeds; the JAX weights are copied into the port's parameters.
Tolerances: values 1e-5, gradients 1e-4 (float32 sums over 2^n states of
2^n amplitudes in both packages); probabilities 1e-5; the r2 rung's loss
1e-4 and its parameters after 3 Adam steps 1e-5, as `test_torch_qmhl.py`;
finite differences (float32, central, step 1e-2) 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from baselines import utils as jbaselines
from benchmarks import ladder as jladder
from qhbmlib_tpu import data as jdata
from qhbmlib_tpu import models as jmodels
from qhbmlib_tpu import nn as jnn
from qhbmlib_tpu.inference import ebm as jebm
from qhbmlib_tpu.inference import qhbm as jqhbm
from qhbmlib_tpu.inference import qnn as jqnn
from qhbmlib_tpu.ops import paulis as jp
from qhbmlib_tpu.ops import statevector as jsv
from qhbmlib_tpu_torch import bench
from qhbmlib_tpu_torch import convert
from qhbmlib_tpu_torch import models as tmodels
from qhbmlib_tpu_torch import utils as tutils
from qhbmlib_tpu_torch.baselines import utils as tbaselines
from qhbmlib_tpu_torch.benchmarks import ladder as tladder
from qhbmlib_tpu_torch.data import thermal_data as tthermal
from qhbmlib_tpu_torch.inference import qmhl_loss as tqmhl
from qhbmlib_tpu_torch.ops import adjoint as tadjoint
from qhbmlib_tpu_torch.ops import hopper_sv
from qhbmlib_tpu_torch.ops import paulis as tp
from qhbmlib_tpu_torch.ops import statevector as tsv

torch.set_num_threads(1)

CPU = "cpu"  # the port builds on the CUDA card unless told otherwise
VALUE_ATOL = 1e-5
GRAD_ATOL = 1e-4
LOSS_ATOL = 1e-4
PARAM_ATOL = 1e-5
FD_ATOL = 1e-3
STEPS, LR = 3, 1e-2


def _random_rho(n, seed):
  """A full-rank complex density matrix."""
  rng = np.random.RandomState(seed)
  a = rng.normal(size=(2**n, 2**n)) + 1j * rng.normal(size=(2**n, 2**n))
  rho = a @ a.conj().T
  return rho / np.trace(rho)


def _random_planes(n, batch, seed):
  """`batch` normalized random states as numpy [B, 2^n] and port planes."""
  rng = np.random.RandomState(seed)
  v = rng.normal(size=(batch, 2**n)) + 1j * rng.normal(size=(batch, 2**n))
  v /= np.linalg.norm(v, axis=1, keepdims=True)
  shape = (batch,) + tsv.state_shape(n)
  return v, tuple(torch.tensor(part.reshape(shape), dtype=torch.float32)
                  for part in (v.real, v.imag))


def _circuit_pair(n, layers, seed):
  """A JAX hardware-efficient ansatz and the port's, same values."""
  j = jmodels.DirectQuantumCircuit(
      jmodels.hardware_efficient_ansatz(n, layers),
      initializer=jnn.RandomUniform(0, 2, seed=seed))
  t = tmodels.DirectQuantumCircuit(tmodels.hardware_efficient_ansatz(
      n, layers), device=CPU)
  with torch.no_grad():
    t.values.copy_(torch.tensor(np.asarray(j.trainable_variables[0])))
  return j, t


def _hamiltonian_pair(n, seed):
  """A JAX Hamiltonian (KOBE-2 energy, 2-layer ansatz) and the port's."""
  j_e = jmodels.KOBE(list(range(n)), 2,
                     initializer=jnn.RandomUniform(-1, 1, seed=seed))
  t_e = tmodels.KOBE(list(range(n)), 2, device=CPU)
  with torch.no_grad():
    t_e.kernel.copy_(torch.tensor(np.asarray(j_e.trainable_variables[0])))
  j_c, t_c = _circuit_pair(n, 2, seed + 1)
  return jmodels.Hamiltonian(j_e, j_c), tmodels.Hamiltonian(t_e, t_c)


# -- numpy baselines ----------------------------------------------------------

def test_baselines_utils_match_jax():
  n = 3
  h = jladder._heisenberg(n).dense()
  np.testing.assert_allclose(tbaselines.get_thermal_state(0.7, h),
                             np.asarray(jbaselines.get_thermal_state(0.7, h)),
                             atol=1e-12)
  np.testing.assert_allclose(tbaselines.log_partition_function(0.7, h),
                             jbaselines.log_partition_function(0.7, h),
                             rtol=1e-12)
  np.testing.assert_allclose(tladder.heisenberg(n, device=CPU).dense(), h)


# -- the batched engine from given states -------------------------------------

def test_apply_circuit_batched_from_planes():
  """Given basis planes, the forward equals the basis-state forward
  exactly, and the caller's planes are left as they were (the diagonal
  stages rotate a copy); exactly one initial form is taken."""
  n = 9
  pqc = tmodels.hardware_efficient_ansatz(n, 2)
  values = torch.rand(pqc.num_symbols, generator=torch.Generator()
                      .manual_seed(0)) * 2.0
  bits = torch.tensor(np.random.RandomState(1).randint(0, 2, (5, n)),
                      dtype=torch.int8)
  rowcol = tadjoint.bits_to_rowcol(bits, n)
  init = hopper_sv.basis_planes(rowcol, tsv.state_shape(n))
  kept = tuple(t.clone() for t in init)
  got = hopper_sv.apply_circuit_batched(pqc, values, init_planes=init)
  want = hopper_sv.apply_circuit_batched(pqc, values, rowcol)
  for g, w, i, k in zip(got, want, init, kept):
    torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(i, k, rtol=0, atol=0)
  for args in ((rowcol, False, init), (None, False, None)):
    with pytest.raises(ValueError, match="exactly one"):
      hopper_sv.apply_circuit_batched(pqc, values, args[0], args[1],
                                      init_planes=args[2])


def test_batched_probabilities_match_dense_and_jax_gradient():
  """|U v_b|^2 for 6 random states at 9 qubits against the JAX package's
  dense unitary, and the adjoint gradient of sum g * p against JAX's
  autodiff through that unitary."""
  n, batch = 9, 6
  j_c, t_c = _circuit_pair(n, 2, 3)
  v, planes = _random_planes(n, batch, 4)
  g = np.random.RandomState(5).normal(size=(batch, 2**n)).astype(np.float32)

  def j_fn(vals):
    u = jsv.unitary(j_c.pqc, j_c.resolved_values_flat([vals]))
    psi = jnp.asarray(v, jnp.complex64) @ u.T
    p = jnp.abs(psi)**2
    return jnp.sum(p * g), p

  (_, j_p), j_grad = jax.value_and_grad(j_fn, has_aux=True)(
      j_c.trainable_variables[0])
  p = tadjoint.batched_probabilities(t_c.pqc, t_c.resolved_values(), planes)
  np.testing.assert_allclose(p.detach().reshape(batch, -1).numpy(),
                             np.asarray(j_p), atol=VALUE_ATOL)
  (p.reshape(batch, -1) * torch.tensor(g)).sum().backward()
  np.testing.assert_allclose(t_c.values.grad.numpy(), np.asarray(j_grad),
                             atol=GRAD_ATOL)


def test_batched_probabilities_gradient_matches_finite_differences():
  """The adjoint gradient of sum g * p against central differences of the
  port's own forward (float32, step 1e-2) at 8 qubits, 4 states, on six
  symbols, the plain arm beside it."""
  n, batch = 8, 4
  pqc = tmodels.hardware_efficient_ansatz(n, 2)
  rng = np.random.RandomState(6)
  values = torch.tensor(rng.uniform(0, 2, pqc.num_symbols),
                        dtype=torch.float32)
  _, planes = _random_planes(n, batch, 7)
  g = torch.tensor(rng.normal(size=(batch,) + tsv.state_shape(n)),
                   dtype=torch.float32)

  def f(vals, plain=False):
    return (tadjoint.batched_probabilities(pqc, vals, planes, plain) *
            g).sum()

  for plain in (False, True):
    vals = values.clone().requires_grad_(True)
    f(vals, plain).backward()
    for slot in rng.choice(pqc.num_symbols, 6, replace=False):
      step = torch.zeros_like(values)
      step[slot] = 1e-2
      with torch.no_grad():
        fd = (f(values + step) - f(values - step)) / 2e-2
      np.testing.assert_allclose(float(vals.grad[slot]), float(fd),
                                 atol=FD_ATOL)


# -- ThermalStateData ---------------------------------------------------------

def test_eigenvector_planes_are_in_big_endian_flat_order():
  """rho = |x0><x0| at 8 qubits (one row bit, seven column bits): its one
  nonzero eigenvector is the basis state at x0's big-endian index, and
  through an identity circuit d = e_x0 lines up with `all_bitstrings`, so
  tr[rho K] = E(x0)."""
  n = 8
  x0 = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.int8)
  idx = int(tutils.bits_to_ints(torch.tensor(x0)))
  rho = np.zeros((2**n, 2**n))
  rho[idx, idx] = 1.0
  data = tthermal.ThermalStateData(rho, device=CPU)
  k = int(torch.argmax(data.weights))
  assert float(data.weights[k]) == 1.0
  assert int(torch.argmax(data.planes[0][k].abs().flatten())) == idx
  _, t_k = _hamiltonian_pair(n, 8)
  with torch.no_grad():
    t_k.circuit.values.zero_()
    d = data.basis_weights(t_k)
    assert int(torch.argmax(d)) == idx
    np.testing.assert_array_equal(data.all_bitstrings[idx].numpy(), x0)
    np.testing.assert_allclose(float(data.expectation(t_k)),
                               float(t_k.energy(torch.tensor(x0[None]))[0]),
                               atol=VALUE_ATOL)


@pytest.mark.parametrize("n", [3, 8])
def test_thermal_data_matches_jax(n):
  """tr[rho K] for a Hamiltonian (KOBE-2, 2-layer ansatz) and tr[rho H]
  for a PauliSum with X, Y and Z strings, against the JAX ThermalStateData
  on a random full-rank rho: values, the Hamiltonian's circuit and energy
  gradients, and the PauliSum's coefficient gradients."""
  rho = _random_rho(n, n)
  j_data = jdata.ThermalStateData(rho)
  t_data = tthermal.ThermalStateData(rho, device=CPU)
  assert t_data.num_qubits == n and t_data.params == {} == j_data.params
  np.testing.assert_array_equal(t_data.density_matrix.numpy(), rho)

  j_k, t_k = _hamiltonian_pair(n, 2 * n)
  obs = {"circuit": list(j_k.circuit.trainable_variables),
         "energy": list(j_k.energy.trainable_variables)}
  j_val, j_grad = jax.value_and_grad(
      lambda o: j_data.expectation_pure({}, None, j_k, o)[0])(obs)
  t_val = t_data.expectation(t_k)
  t_val.backward()
  np.testing.assert_allclose(float(t_val.detach()), float(j_val),
                             atol=VALUE_ATOL)
  np.testing.assert_allclose(t_k.circuit.values.grad.numpy(),
                             np.asarray(j_grad["circuit"][0]), atol=GRAD_ATOL)
  np.testing.assert_allclose(t_k.energy.kernel.grad.numpy(),
                             np.asarray(j_grad["energy"][0]), atol=GRAD_ATOL)

  rng = np.random.RandomState(n + 1)
  terms = [(float(rng.normal()), {q: p, q + 1: p})
           for q in range(n - 1) for p in "XYZ"]
  terms += [(float(rng.normal()), {0: "Y"}), (float(rng.normal()),
                                              {n - 1: "X", 0: "Z"})]
  j_op = jp.pauli_sum_from_strings(n, terms)
  t_op = tp.pauli_sum_from_strings(n, terms, device=CPU)
  t_op.coeffs.requires_grad_(True)
  j_val, j_grad = jax.value_and_grad(
      lambda c: j_data.expectation_pure(
          {}, None, dataclasses.replace(j_op, coeffs=c), None)[0])(
              jnp.asarray(j_op.coeffs))
  t_val = t_data.expectation(t_op)
  t_val.backward()
  np.testing.assert_allclose(float(t_val.detach()), float(j_val),
                             atol=VALUE_ATOL)
  np.testing.assert_allclose(t_op.coeffs.grad.numpy(), np.asarray(j_grad),
                             atol=GRAD_ATOL)


def test_convert_carries_a_kobe_model_and_an_empty_data_group():
  """A QMHL tree whose model is a KOBE QHBM and whose data group is empty
  (ThermalStateData's params) carries across into the r2 rung's model."""
  energy = jmodels.KOBE(list(range(4)), 2,
                        initializer=jnn.RandomUniform(-1, 1, seed=1))
  circuit = jmodels.DirectQuantumCircuit(
      jmodels.hardware_efficient_ansatz(4, 4),
      initializer=jnn.RandomUniform(0, 2, seed=2))
  model = jqhbm.QHBM(jebm.AnalyticEnergyInference(energy, 10),
                     jqnn.AnalyticQuantumInference(circuit))
  data = jdata.ThermalStateData(np.eye(16) / 16)
  tree = convert.from_jax_params({"model": model.params,
                                  "data": data.params}, device=CPU)
  assert tree["data"] == {}
  h, t_data, _ = tladder.build_rung("r2_heis8_qmhl", qubits=4, device=CPU)
  assert t_data.params == {}
  h.set_params(tree["model"])
  for key, var in (("theta", energy), ("phi", circuit)):
    np.testing.assert_array_equal(h.params[key][0].detach().numpy(),
                                  np.asarray(var.trainable_variables[0]))


# -- the r2 rung ----------------------------------------------------------------

def _jax_r2(n, layers):
  """The JAX ladder's r2 rung (`benchmarks/ladder.py:123-136`) with its
  EBM on the exact support: its initial model parameters, and the losses
  and parameters of STEPS Adam steps."""
  target = jladder._heisenberg(n)
  data = jdata.ThermalStateData(
      jbaselines.get_thermal_state(1.0, target.dense()))
  energy = jmodels.KOBE(list(range(n)), 2,
                        initializer=jnn.RandomUniform(-0.5, 0.5, seed=n))
  e_inf = jebm.AnalyticEnergyInference(energy, 500, initial_seed=2,
                                       exact=True)
  circuit = jmodels.DirectQuantumCircuit(
      jmodels.hardware_efficient_ansatz(n, layers),
      initializer=jnn.RandomUniform(0, 2, seed=n + 1))
  h = jqhbm.QHBM(e_inf, jqnn.AnalyticQuantumInference(circuit))
  step, params, opt_state = jladder._qmhl_step(data, h, optax.adam(LR))
  params0 = jax.tree_util.tree_map(np.asarray, params)
  losses = []
  for _ in range(STEPS):
    loss, params, opt_state, _ = step(params, opt_state,
                                      jax.random.PRNGKey(0), None)
    losses.append(float(loss))
  return params0, losses, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("smoke,qubits", [(True, None), (False, 8)])
def test_r2_rung_matches_jax(smoke, qubits):
  """The r2 rung at smoke size (4 qubits, 2 layers) and at its own 8
  qubits (4 layers), the model's EBM exact: the loss of each of STEPS Adam
  steps and the parameters after them against optax; the precision gate's
  plain arm (a ThermalStateData copy with `plain=True`) gives the same
  loss on the CPU."""
  n, layers = (4, 2) if smoke else (qubits, 4)
  params0, losses, params = _jax_r2(n, layers)
  h, data, step = tladder.build_rung("r2_heis8_qmhl", smoke=smoke,
                                     qubits=qubits, exact=True, device=CPU)
  assert data.num_qubits == n
  h.set_params(convert.from_jax_params(params0, device=CPU))
  with torch.no_grad():
    plain = bench.plain_loss(h, data)()
    np.testing.assert_allclose(float(plain), float(tqmhl.make_qmhl(data, h)()),
                               atol=VALUE_ATOL)
  for want in losses:
    loss, _ = step()
    np.testing.assert_allclose(float(loss), want, atol=LOSS_ATOL)
  want = convert.from_jax_params(params, device=CPU)
  for key in ("theta", "phi"):
    np.testing.assert_allclose(h.params[key][0].detach().numpy(),
                               want[key].numpy(), atol=PARAM_ATOL)


@pytest.mark.parametrize("name", ["r1_tfim2_vqt", "r3_kobe16_vqt_shift",
                                  "r4_tfim24_sharded_vqt"])
def test_other_rungs_name_what_they_wait_for(name):
  """No rung waits for a module any more (r4 came with parallel/): r1, r3
  and r4 build, in one process on one device (r4 on a 1 x 1 mesh)."""
  assert name in jladder.RUNGS and name in tladder.RUNGS
  assert not hasattr(tladder, "WAITS_FOR")
  _, target, step = tladder.build_rung(name, smoke=True, device=CPU)
  assert callable(step) and target.num_qubits in (2, 6, 8)
  assert step.meta == {"r3_kobe16_vqt_shift": {"data_shards": 1},
                       "r4_tfim24_sharded_vqt": {"state_shards": 1}}.get(
                           name, {})
  with pytest.raises(ValueError, match="unknown rung"):
    tladder.build_rung("r9", device=CPU)
