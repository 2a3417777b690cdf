"""The port's `SampledQuantumInference` and the ladder's r1 / r3 rungs
against the JAX package, on the CPU.

Shots never match the JAX package's bit for bit (another PRNG), so every
sampled number is held to the exact one within 5 standard errors taken
from the shot counts: a term-group mean of a bounded variable in [-s, s]
(s = sum of its terms' |weights|) has variance at most s^2 / shots, the
groups, states and shifted rows draw independently.  The generators are
seeded, so each test is deterministic.

  * PauliSum and Pauli-energy Hamiltonian expectations at 200,000 shots,
    and their parameter-shift gradients, against the JAX package's exact
    adjoint `batched_expectations` and its `jax.grad`;
  * a Hamiltonian with a general energy (dense tanh layer, reference
    tests/inference/test_qnn.py:150-191): <K> against a dense oracle, the
    energy's gradient against the exact one, the circuits' against
    `jax.grad` of the exact measurement average;
  * `sample()`'s shapes, mask and `max_count` errors, and its draws by
    total variation; a generator passed to a call repeats its draws;
  * the r3 smoke rung (6q, 100 shots, 1 layer): 3 Adam steps, each loss
    within 5 standard errors of the analytic VQT loss at the same
    parameters and EBM support;
  * the r1 rung (2q, exact EBM): 3 Adam steps, each loss the dense 2q free
    energy beta tr(rho H) - S of the JAX package's unitary, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qhbmlib_tpu.ops import adjoint as jadjoint
from qhbmlib_tpu.ops import circuit_ir as jir
from qhbmlib_tpu.ops import paulis as jp
from qhbmlib_tpu.ops import shift as jshift
from qhbmlib_tpu.ops import statevector as jsv
from qhbmlib_tpu_torch import models as tmodels
from qhbmlib_tpu_torch import nn as tnn
from qhbmlib_tpu_torch import utils as tutils
from qhbmlib_tpu_torch.benchmarks import ladder as tladder
from qhbmlib_tpu_torch.inference import qhbm as tqhbm
from qhbmlib_tpu_torch.inference import qnn as tqnn
from qhbmlib_tpu_torch.inference import vqt_loss as tvqt
from qhbmlib_tpu_torch.models import energy_utils as teu
from qhbmlib_tpu_torch.ops import paulis as tp

torch.set_num_threads(1)

CPU = "cpu"
SHOTS = 200_000
SIGMAS = 5.0


def _circuit(n, layers=1, seed=1, name="p"):
  return tmodels.DirectQuantumCircuit(
      tmodels.hardware_efficient_ansatz(n, layers, name=name),
      initializer=tnn.RandomUniform(-1, 1, seed=seed), device=CPU)


def _jax_circuit(pqc):
  return jir.Circuit.from_dict(pqc.to_dict())


def _jax_sum(op):
  return jp.PauliSum(op.code_rows(), op.coeffs.detach().numpy(),
                     op.num_qubits)


def _ops(n):
  mixed = [(0.3, {0: "X", 1: "Y"}), (-0.2, {1: "Y", 2: "Z"}),
           (0.7, {0: "Z"}), (0.4, {0: "X"}), (0.5, {2: "Y"})]
  return (tp.tfim_1d(n, device=CPU),
          tp.pauli_sum_from_strings(n, mixed, device=CPU))


def _group_scales(ops, g):
  """[B, groups] sum_{t in group} |g[b, t]| for term cotangents g [B, T]."""
  groups = tqnn._group_terms(ops)
  return np.stack([np.abs(g[:, list(idx)]).sum(axis=1)
                   for _, _, idx in groups], axis=1)


def _grad_sigma(pqc, ops, g, shots):
  """[num_symbols] standard errors of the shift gradient of
  sum_bt g[b, t] <P_t>_b at `shots` a (row, state, group)."""
  _, weights, slots = jshift.shift_plan(_jax_circuit(pqc))
  per_row = (_group_scales(ops, g)**2).sum() / shots
  var = np.zeros(pqc.num_symbols)
  np.add.at(var, slots, weights.astype(np.float64)**2 * per_row)
  return np.sqrt(var)


def _exact(pqc, values, bits, ops):
  jc = _jax_circuit(pqc)
  jops = tuple(_jax_sum(op) for op in ops)

  def f(v, w):
    return jnp.sum(jadjoint.batched_expectations(jc, v, jnp.asarray(bits),
                                                 jops) * w)

  return jc, f


def test_sampled_pauli_means_and_gradients_within_5_sigma():
  n = 3
  circ = _circuit(n)
  q_inf = tqnn.SampledQuantumInference(circ, SHOTS, initial_seed=1)
  ops = _ops(n)
  bits = torch.tensor([[0, 1, 1], [1, 0, 0]], dtype=torch.int8)
  for op in ops:
    op.coeffs.requires_grad_()
  out = q_inf.expectation(bits, ops)
  w = np.asarray([[1.0, -0.5], [0.3, 2.0]], np.float32)
  (out * torch.tensor(w)).sum().backward()
  values = circ.resolved_values().detach().numpy()
  _, f = _exact(circ.pqc, values, bits.numpy(), ops)
  exact = np.asarray(jadjoint.batched_expectations(
      _jax_circuit(circ.pqc), jnp.asarray(values), jnp.asarray(bits.numpy()),
      tuple(_jax_sum(op) for op in ops)))
  coeffs = np.concatenate([op.coeffs.detach().numpy() for op in ops])
  slices = tp.op_slices(ops)
  for k, (a, b) in enumerate(slices):
    g = np.zeros((2, coeffs.size))
    g[:, a:b] = coeffs[a:b]
    sigma = np.sqrt((_group_scales(ops, g)**2).sum(axis=1) / SHOTS)
    z = np.abs(out.detach().numpy()[:, k] - exact[:, k]) / sigma
    assert z.max() < SIGMAS, (k, z)
  # Gradient of sum w * <op>: slot order, against jax.grad.
  want = np.asarray(jax.grad(f)(jnp.asarray(values), jnp.asarray(w)))
  perm = circ._perm.numpy()
  got = circ.values.grad.numpy()[perm]
  g_terms = np.concatenate([w[:, [k]] * coeffs[None, a:b]
                            for k, (a, b) in enumerate(slices)], axis=1)
  z = np.abs(got - want) / _grad_sigma(circ.pqc, ops, g_terms, SHOTS)
  assert z.max() < SIGMAS, z
  # The coefficients' gradients flow by autograd: sum_b w[b, k] <P_t>_b.
  jc = _jax_circuit(circ.pqc)
  for k, op in enumerate(ops):
    terms = [jp.PauliSum((row,), np.ones(1, np.float32), n)
             for row in op.code_rows()]
    means = np.asarray(jadjoint.batched_expectations(
        jc, jnp.asarray(values), jnp.asarray(bits.numpy()), tuple(terms)))
    sigma = np.sqrt((w[:, k]**2).sum() / SHOTS)
    z = np.abs(op.coeffs.grad.numpy() - w[:, k] @ means) / sigma
    assert z.max() < SIGMAS, z


def test_pauli_energy_hamiltonian_within_5_sigma():
  """A Bernoulli energy's Hamiltonian: the shards' means, then its dot."""
  n = 3
  circ = _circuit(n, seed=2)
  energy = tmodels.BernoulliEnergy(list(range(n)), device=CPU,
                                   initializer=tnn.RandomUniform(-1, 1,
                                                                 seed=3))
  obs = tmodels.Hamiltonian(energy, _circuit(n, seed=4, name="o"))
  q_inf = tqnn.SampledQuantumInference(circ, SHOTS, initial_seed=2)
  a_inf = tqnn.AnalyticQuantumInference(circ)
  bits = torch.tensor([[1, 1, 0]], dtype=torch.int8)
  got = q_inf.expectation(bits, obs)
  got.sum().backward()
  want = a_inf.expectation(bits, obs)
  sigma = energy.kernel.detach().abs().sum().item() / np.sqrt(SHOTS)
  assert got.shape == (1, 1)
  assert abs(got.item() - want.item()) < SIGMAS * sigma
  assert energy.kernel.grad is not None and circ.values.grad is not None
  assert float(circ.values.grad.abs().max()) > 1e-3


class _DenseTanh(torch.nn.Module):
  """Dense layer with a tanh (the JAX package's nn.Dense(tanh))."""

  def __init__(self, n, units, seed):
    super().__init__()
    rng = np.random.RandomState(seed)
    self.weight = torch.nn.Parameter(torch.tensor(
        rng.uniform(-1, 1, (n, units)), dtype=torch.float32))
    self.bias = torch.nn.Parameter(torch.zeros(units))

  def forward(self, x):
    return torch.tanh(x.to(torch.float32) @ self.weight + self.bias)


def test_general_energy_observable():
  n = 2
  circ = _circuit(n, layers=2, seed=13)
  energy = tmodels.BitstringEnergy(
      list(range(n)), [teu.SpinsFromBitstrings(), _DenseTanh(n, 4, 14),
                       teu.VariableDot(4, tnn.RandomUniform(-1, 1, seed=15),
                                       device=CPU)])
  obs_circ = _circuit(n, seed=16, name="obs2")
  obs = tmodels.Hamiltonian(energy, obs_circ)
  q_inf = tqnn.SampledQuantumInference(circ, SHOTS, initial_seed=17)
  bits = torch.tensor([[0, 1]], dtype=torch.int8)
  out = q_inf.expectation(bits, obs)
  out.sum().backward()
  # Dense oracle: K = V diag(E) V^dagger, psi = U|01>.
  all_bits = torch.tensor([[0, 0], [0, 1], [1, 0], [1, 1]], dtype=torch.int8)
  with torch.no_grad():
    e_vals = energy(all_bits).double().numpy()
  u_of = lambda c: np.asarray(jsv.unitary(
      _jax_circuit(c.pqc), jnp.asarray(c.resolved_values().detach().numpy())),
                              np.complex128)
  v = u_of(obs_circ)
  psi = u_of(circ)[:, 1]
  exact = float(np.real(psi.conj() @ v @ np.diag(e_vals) @ v.conj().T @ psi))
  e_max = np.abs(e_vals).max()
  assert abs(out.item() - exact) < SIGMAS * e_max / np.sqrt(SHOTS)
  for module in (circ, obs_circ, energy):
    assert max(float(p.grad.abs().max()) for p in module.parameters()) > 1e-3
  # The energy's gradient: sum_x p(x) dE(x)/dtheta on the measurement
  # distribution p of (U + V^dagger)|01>, within 5 sigma of the samples'.
  total = q_inf._total_circuit(obs)
  tv = total.resolved_values().detach()
  jt = _jax_circuit(total.pqc)
  probs = lambda vals: jnp.abs(jsv.apply_circuit(
      jt, vals, jsv.basis_state(n, jnp.asarray([0, 1]))).reshape(-1))**2
  p = np.asarray(probs(jnp.asarray(tv.numpy())), np.float64)
  params = list(energy.parameters())
  per_x = []
  for x in range(4):
    gx = torch.autograd.grad(energy(all_bits[x:x + 1]).sum(), params)
    per_x.append(np.concatenate([t.reshape(-1).numpy() for t in gx]))
  per_x = np.stack(per_x)
  got = np.concatenate([t.grad.reshape(-1).numpy() for t in params])
  sigma = np.abs(per_x).max(axis=0) / np.sqrt(SHOTS) + 1e-12
  assert (np.abs(got - p @ per_x) / sigma).max() < SIGMAS
  # The circuits' gradient by shift on a leaf of the total values, against
  # jax.grad of the exact average sum_x p(x) E(x).
  leaf = tv.clone().requires_grad_()
  q_inf._energy_expectation(total.pqc, leaf, bits, energy,
                            q_inf.generator).sum().backward()
  want = np.asarray(jax.grad(lambda vals: jnp.sum(
      probs(vals) * jnp.asarray(e_vals, jnp.float32)))(
          jnp.asarray(tv.numpy())))
  _, weights, slots = jshift.shift_plan(jt)
  var = np.zeros(total.pqc.num_symbols)
  np.add.at(var, slots, weights.astype(np.float64)**2 * e_max**2 / SHOTS)
  assert (np.abs(leaf.grad.numpy() - want) / np.sqrt(var)).max() < SIGMAS


def test_sample_shapes_mask_and_errors():
  n = 3
  q_inf = tqnn.SampledQuantumInference(_circuit(n, seed=18), 100,
                                       initial_seed=19)
  bits = torch.tensor([[0, 0, 0], [1, 0, 1]], dtype=torch.int8)
  samples, mask = q_inf.sample(bits, torch.tensor([5, 3]))
  assert samples.shape == (2, 5, n) and samples.dtype == torch.int8
  np.testing.assert_array_equal(mask.numpy(), [[1, 1, 1, 1, 1],
                                               [1, 1, 1, 0, 0]])
  samples, mask = q_inf.sample(bits, [5, 3], max_count=8)
  assert samples.shape == (2, 8, n) and mask.shape == (2, 8)
  with pytest.raises(ValueError, match="max_count=4 is smaller"):
    q_inf.sample(bits, [5, 3], max_count=4)


def test_sample_distribution_and_generator():
  n = 3
  circ = _circuit(n, layers=2, seed=20)
  q_inf = tqnn.SampledQuantumInference(circ, 100, initial_seed=21)
  bits = torch.tensor([[1, 0, 1]], dtype=torch.int8)
  draws = 20_000
  samples, _ = q_inf.sample(bits, [draws])
  idx = (samples[0].to(torch.int64) * torch.tensor([4, 2, 1])).sum(1)
  freq = np.bincount(idx.numpy(), minlength=8) / draws
  psi = np.asarray(jsv.unitary(
      _jax_circuit(circ.pqc),
      jnp.asarray(circ.resolved_values().detach().numpy())))[:, 5]
  assert 0.5 * np.abs(freq - np.abs(psi)**2).sum() < 0.02
  # A generator passed to a call repeats its draws; the engine's own
  # advances.
  gen = torch.Generator().manual_seed(5)
  state = gen.get_state()
  a = q_inf.expectation(bits, tp.tfim_1d(n, device=CPU), generator=gen)
  gen.set_state(state)
  b = q_inf.expectation(bits, tp.tfim_1d(n, device=CPU), generator=gen)
  assert torch.equal(a, b)
  c = q_inf.expectation(bits, tp.tfim_1d(n, device=CPU))
  d = q_inf.expectation(bits, tp.tfim_1d(n, device=CPU))
  assert not torch.equal(c, d)


def _snapshot(h):
  return ([p.detach().clone() for p in h.parameters()],
          h.e_inference.generator.get_state())


def _restore(h, snap):
  with torch.no_grad():
    for p, v in zip(h.parameters(), snap[0]):
      p.copy_(v)
  h.e_inference.generator.set_state(snap[1])


def test_r3_smoke_rung_within_sampling_bound():
  h, target, step = tladder.build_rung("r3_kobe16_vqt_shift", smoke=True,
                                       device=CPU)
  n = target.num_qubits
  assert n == 6 and h.q_inference.expectation_samples == 100
  assert h.e_inference.max_unique_samples is None
  analytic = tqhbm.QHBM(h.e_inference, tqnn.AnalyticQuantumInference(
      h.q_inference.circuit))
  loss_fn = tvqt.make_vqt(analytic, target)
  # Each group's sum of |coeff|: the X field and the ZZ bonds.
  scale2 = sum(s**2 for s in _group_scales(
      (target,), target.coeffs.detach().numpy()[None])[0])
  for _ in range(3):
    snap = _snapshot(h)
    loss, grads = step()
    assert torch.isfinite(loss) and torch.isfinite(grads).all()
    after = _snapshot(h)
    _restore(h, snap)
    support, counts = h.e_inference.support_and_counts()
    w = (counts / counts.sum()).numpy()
    h.e_inference.generator.set_state(snap[1])
    with torch.no_grad():
      exact = loss_fn(tladder.BETA)
    sigma = tladder.BETA * np.sqrt((w**2).sum() * scale2 / 100)
    assert abs(float(loss) - float(exact)) < SIGMAS * sigma
    _restore(h, after)
  assert len(support) == 2**n


def test_chip_smoke_standard_errors_match_the_spread():
  """chip_smoke's exact standard errors of a sampled shift gradient
  (`shot_variance` from the shifted rows' probabilities, `shift_sigma`)
  against the spread of 200 seeded draws at 100 shots: the variance ratio
  averaged over the components within 5 of its standard deviations of 1
  (the s^2 / shots bound the tests above use would read ~4x)."""
  import chip_smoke
  from qhbmlib_tpu_torch.ops import adjoint as tadjoint
  from qhbmlib_tpu_torch.ops import hopper_sv
  from qhbmlib_tpu_torch.ops import shift as tshift
  h, target, _ = tladder.build_rung("r3_kobe16_vqt_shift", smoke=True,
                                    qubits=4, device=CPU)
  circuit = h.q_inference.circuit
  pqc = circuit.pqc
  support, counts = h.e_inference.support_and_counts()
  values = circuit.resolved_values().detach()
  rowcol = tadjoint.bits_to_rowcol(support.to(torch.int8), pqc.num_qubits)
  plan, _ = tqnn.measurement_plan(pqc, (target,))
  g = (counts / counts.sum())[:, None] * target.coeffs.detach()[None, :]
  rows = np.concatenate([np.zeros((1, pqc.num_gates), np.float32),
                         tshift.shift_plan(pqc)[0]])
  psi = hopper_sv.apply_circuit_shifted(pqc, values, rowcol, rows)
  row_var = sum(chip_smoke.shot_variance(
      tqnn.group_probabilities(psi, rotation), masks, g[:, list(idx)],
      len(support)) for rotation, masks, idx in plan[0])
  shots, draws = 100, 200
  sigma = chip_smoke.shift_sigma(pqc, row_var[1:], shots)
  gen = torch.Generator().manual_seed(23)
  spread = torch.stack([tqnn.term_means_gradient(
      pqc, values, rowcol, plan, g, shots, gen).double()
                        for _ in range(draws)]).var(dim=0).numpy()
  ratio = float(np.mean(spread / sigma**2))
  assert abs(ratio - 1.0) < SIGMAS * np.sqrt(2.0 / (draws - 1) / len(sigma))


def test_r3_qubits_and_cap_override():
  h, target, _ = tladder.build_rung("r3_kobe16_vqt_shift", smoke=True,
                                    qubits=4, max_unique=2, device=CPU)
  assert target.num_qubits == 4 and h.e_inference.max_unique_samples == 2


def test_r1_rung_matches_dense_free_energy():
  h, target, step = tladder.build_rung("r1_tfim2_vqt", exact=True,
                                       device=CPU)
  n = 2
  h_dense = target.dense().astype(np.complex128)
  spins = 1.0 - 2.0 * np.asarray([[0, 0], [0, 1], [1, 0], [1, 1]])
  for _ in range(3):
    theta = h.e_inference.energy.kernel.detach().double().numpy()
    circ = h.q_inference.circuit
    u = np.asarray(jsv.unitary(
        _jax_circuit(circ.pqc),
        jnp.asarray(circ.resolved_values().detach().numpy())), np.complex128)
    logits = -(spins @ theta)
    p = np.exp(logits - logits.max())
    p /= p.sum()
    rho = u @ np.diag(p) @ u.conj().T
    want = tladder.BETA * np.real(np.trace(rho @ h_dense)) + np.sum(
        p * np.log(p))
    loss, grads = step()
    assert abs(float(loss) - want) < 1e-5
    assert grads.shape == (n + circ.pqc.num_symbols,)
  # The sampled rung runs too.
  h, _, step = tladder.build_rung("r1_tfim2_vqt", device=CPU)
  assert torch.isfinite(step()[0])


@pytest.mark.parametrize("num_bits", [1, 3, 16, 17, 40])
def test_parities_match_popcount(num_bits):
  """`utils.parities` against Python's popcount of index & mask."""
  rng = np.random.RandomState(num_bits)
  idx = rng.randint(0, 2**num_bits, size=(4, 50), dtype=np.int64)
  masks = rng.randint(0, 2**num_bits, size=6, dtype=np.int64)
  got = tutils.parities(torch.tensor(idx), torch.tensor(masks), num_bits)
  want = [[[bin(int(i) & int(m)).count("1") % 2 for m in masks] for i in row]
          for row in idx]
  np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_rows_distribution():
  """Each row's draws follow its own weights (total variation over 40,000
  draws), the last index clamped; one row equals the 1-D draw."""
  weights = torch.tensor([[1.0, 0.0, 3.0, 4.0], [0.0, 0.0, 0.0, 2.0],
                          [5.0, 1.0, 0.0, 0.0]])
  gen = torch.Generator().manual_seed(3)
  idx = tutils.categorical_rows(weights, 40_000, gen)
  assert idx.shape == (3, 40_000) and int(idx.max()) <= 3
  for row, w in zip(idx, weights):
    freq = np.bincount(row.numpy(), minlength=4) / 40_000
    assert 0.5 * np.abs(freq - (w / w.sum()).numpy()).sum() < 0.01
  gen.manual_seed(4)
  one = tutils.categorical_indices_from_weights(weights[0], 100, gen)
  gen.manual_seed(4)
  assert torch.equal(one, tutils.categorical_rows(weights[:1], 100, gen)[0])
