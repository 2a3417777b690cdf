"""The port's QAIA against the JAX package's, on the CPU.

An 8-qubit QAIA of 2 layers (reference `models/circuit.py:226-276`) on the
bench's Bernoulli energy's Z shards as its classical terms, and as its
quantum terms either the TFIM's two shards (the X-field sum and the ZZ
sum, as `baselines/train.py:207-209` builds it) or the Heisenberg chain's
three (the XX, YY and ZZ sums).  The JAX model's weights cross with
`convert.from_jax_params` (QAIA's phi is three arrays: etas, thetas,
gammas).  Held to 1e-4: the symbol values (in the reference's unsorted
flat order), the VQT loss and its gradients with respect to theta, etas,
thetas and gammas; both EBMs are exact (the full 2^8 support), so no
random draw enters.  The Heisenberg QAIA's XX and YY PROTs are gates of
the flip class, so its circuit runs the engine's flip stages; the TFIM
QAIA's X-field PROTs fold into 1q segments (K3 / K2 take it).
"""

import jax
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
from qhbmlib_tpu_torch import convert
from qhbmlib_tpu_torch import models as tmodels
from qhbmlib_tpu_torch.inference import ebm as tebm
from qhbmlib_tpu_torch.inference import qhbm as tqhbm
from qhbmlib_tpu_torch.inference import qnn as tqnn
from qhbmlib_tpu_torch.inference import vqt_loss as tvqt
from qhbmlib_tpu_torch.ops import adjoint as tadjoint
from qhbmlib_tpu_torch.ops import hopper_sv
from qhbmlib_tpu_torch.ops import paulis as tp
from qhbmlib_tpu_torch.ops import statevector as tsv

torch.set_num_threads(1)

N, LAYERS, BETA, SAMPLES = 8, 2, 1.2, 500
CPU = "cpu"
TOL = 1e-4


def _shards(kind, n):
  """(quantum term shards, target) as (coeff, {qubit: pauli}) lists."""
  if kind == "tfim":
    x = [(-1.0, {q: "X"}) for q in range(n)]
    zz = [(-1.0, {q: "Z", q + 1: "Z"}) for q in range(n - 1)]
    return [x, zz], x + zz
  shards = [[(1.0, {q: p, q + 1: p}) for q in range(n - 1)] for p in "XYZ"]
  return shards, [t for q in range(n - 1) for t in
                  (shards[0][q], shards[1][q], shards[2][q])]


def _jax_model(kind):
  shards, target = _shards(kind, N)
  energy = jmodels.BernoulliEnergy(
      list(range(N)), initializer=jnn.RandomUniform(-0.5, 0.5, seed=5))
  e_inf = jebm.BernoulliEnergyInference(energy, SAMPLES, initial_seed=1,
                                        exact=True)
  circuit = jmodels.QAIA([jp.pauli_sum_from_strings(N, s) for s in shards],
                         energy.operator_shards(N), LAYERS,
                         jnn.RandomNormal(0.0, 0.5, seed=6), name="q")
  h = jqhbm.QHBM(e_inf, jqnn.AnalyticQuantumInference(circuit))
  return h, jp.pauli_sum_from_strings(N, target)


def _port_model(kind, jh):
  shards, target = _shards(kind, N)
  energy = tmodels.BernoulliEnergy(list(range(N)), device=CPU)
  circuit = tmodels.QAIA(
      [tp.pauli_sum_from_strings(N, s, device=CPU) for s in shards],
      energy.operator_shards(N), LAYERS, name="q", device=CPU)
  h = tqhbm.QHBM(tebm.BernoulliEnergyInference(energy, SAMPLES,
                                               initial_seed=0, exact=True),
                 tqnn.AnalyticQuantumInference(circuit))
  h.set_params(convert.from_jax_params(jh.params, device=CPU))
  return h, tp.pauli_sum_from_strings(N, target, device=CPU)


@pytest.fixture(scope="module", params=["tfim", "heisenberg"])
def models(request):
  jh, jtarget = _jax_model(request.param)
  h, target = _port_model(request.param, jh)
  return request.param, jh, jtarget, h, target


def test_qaia_circuit_and_symbol_values_match_jax(models):
  """The same IR (gates, slots, coefficients) and symbol names, the three
  parameters in the reference's order, and the tied symbol values
  [gammas_l, etas_l * thetas] per layer."""
  kind, jh, _, h, _ = models
  jc, tc = jh.q_inference.circuit, h.q_inference.circuit
  assert tc.pqc.to_dict() == jc.pqc.to_dict()
  assert tuple(tc.symbol_names) == tuple(jc.symbol_names)
  assert [tuple(p.shape) for p in h.params["phi"]] == [
      (LAYERS,), (N,), (LAYERS, 3 if kind == "heisenberg" else 2)]
  np.testing.assert_allclose(tc.symbol_values().detach().numpy(),
                             np.asarray(jc.symbol_values), atol=TOL)
  np.testing.assert_allclose(tc.resolved_values().detach().numpy(),
                             np.asarray(jc.resolved_values), atol=TOL)
  segments = {cls for cls, _ in tsv.segment_circuit(tc.pqc.gates)}
  assert ("single" in segments) == (kind == "heisenberg")
  assert hopper_sv.single_supported(tc.pqc) == (kind == "tfim")


def test_qaia_vqt_loss_and_gradients_match_jax(models):
  """The VQT loss and its gradient w.r.t. the energy (theta) and QAIA's
  etas, thetas and gammas, through the port's batched forward and sweep
  (flip stages for the Heisenberg QAIA), against the JAX package's."""
  _, jh, jtarget, h, target = models
  key = jax.random.PRNGKey(0)
  jloss_fn = jvqt.make_vqt(jh, jtarget)
  jloss, jgrads = jax.value_and_grad(
      lambda p: jloss_fn(p, key, np.float32(BETA))[0])(jh.params)
  loss = tvqt.make_vqt(h, target)(BETA)
  loss.backward()
  np.testing.assert_allclose(float(loss.detach()), float(jloss),
                             atol=TOL * max(1.0, abs(float(jloss))))
  np.testing.assert_allclose(h.params["theta"][0].grad.numpy(),
                             np.asarray(jgrads["theta"][0]), atol=TOL)
  for got, want in zip(h.params["phi"], jgrads["phi"]):
    np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=TOL)
  assert max(np.abs(np.asarray(g)).max() for g in jgrads["phi"]) > 1e-2


def test_qaia_single_state_expectation_matches_batched(models):
  """One state through `adjoint.expectation` (K3 / K2's plain versions for
  the TFIM QAIA; segment by segment for the Heisenberg one) against the
  batched engine, value and gradient w.r.t. the resolved values."""
  _, _, _, h, target = models
  circuit = h.q_inference.circuit
  bits = torch.tensor([[0, 1, 1, 0, 1, 0, 0, 1]], dtype=torch.int8)
  values = circuit.resolved_values().detach()
  v1 = values.clone().requires_grad_(True)
  e1 = tadjoint.expectation(circuit.pqc, v1,
                            tsv.basis_state(N, bits[0]), target)
  e1.backward()
  v2 = values.clone().requires_grad_(True)
  e2 = tadjoint.batched_expectations(circuit.pqc, v2, bits, (target,))[0, 0]
  e2.backward()
  np.testing.assert_allclose(float(e1.detach()), float(e2.detach()),
                             atol=TOL)
  np.testing.assert_allclose(v1.grad.numpy(), v2.grad.numpy(), atol=TOL)
