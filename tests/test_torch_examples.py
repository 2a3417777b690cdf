"""The port's examples (`qhbmlib_tpu_torch/examples/`) against the JAX
package's (`examples/`), on the CPU.

  * VQT (4q TFIM) and QMHL (3q Heisenberg thermal data): the JAX side is
    built line for line as its example builds it (each line's source is
    named beside it); its initial parameters are carried into the port's
    `build("cpu")` (`convert.from_jax_params`); 25 Adam 5e-2 steps on both
    sides give the same loss at every step within 1e-5 (`LOSS_ATOL`) and
    the same final fidelity within 1e-4 (`FIDELITY_ATOL`).  Both EBMs are
    exact, so no draw enters.
  * The sharded VQT example: one step's loss and gradient at the JAX
    example's initial parameters against the JAX example's own stack
    (`ShardedQuantumInference` on data 1 x state 8 over conftest's 8
    virtual devices), the port on the one-process mesh, with JAX's
    Bernoulli draw (support and counts) fed into the port's EBM inference.
    Loss within 1e-5, gradient within 1e-4 (`GRAD_ATOL`, the sharded
    tests' tolerance).  The port on 8 ranks (data 1 x state 8) against one
    rank: `tests/test_torch_parallel.py`.
  * The port's own runs at its own seeds, uncut: VQT ends at fidelity
    0.96677 and QMHL at 0.95950.  These are the floors, less 0.01, that
    `chip_smoke.py` holds the card's runs to (`EXAMPLE_CPU_FIDELITY`); the
    test holds them equal within 1e-4.
  * `chip_smoke.example_grad_f64` (the card gate's float64 witness)
    against the plain versions at each exact example's first step.
  * The checks `tests/examples/test_examples.py` makes of the JAX
    examples: a fidelity in (0.5, 1] and a sharded loss that falls.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from qhbmlib_tpu import data as jdata
from qhbmlib_tpu import inference as jinference
from qhbmlib_tpu import models as jmodels
from qhbmlib_tpu import nn as jnn
from qhbmlib_tpu import parallel as jparallel
from qhbmlib_tpu.inference import qhbm_utils as jqhbm_utils
from qhbmlib_tpu.models import circuit_utils as jcu
from qhbmlib_tpu.ops import paulis as jp
from qhbmlib_tpu_torch import convert
from qhbmlib_tpu_torch.examples import multichip_sharded_vqt as tsharded
from qhbmlib_tpu_torch.examples import qmhl_modular_hamiltonian as tqmhl
from qhbmlib_tpu_torch.examples import vqt_thermal_state as tvqt

torch.set_num_threads(1)

CPU = "cpu"  # the port builds on the CUDA card unless told otherwise
STEPS = 25
LOSS_ATOL = 1e-5
FIDELITY_ATOL = 1e-4
GRAD_ATOL = 1e-4


def _jax_train(loss_fn, params, steps, key, beta=None):
  """The JAX examples' loop: optax.adam(5e-2), one jitted step a key split
  (examples/vqt_thermal_state.py:62-76).  Returns (losses, params)."""
  opt = optax.adam(5e-2)
  args = () if beta is None else (beta,)

  @jax.jit
  def train_step(params, opt_state, key):
    (loss, _), grads = jax.value_and_grad(
        lambda p: loss_fn(p, key, *args), has_aux=True)(params)
    updates, opt_state = opt.update(grads, opt_state)
    return optax.apply_updates(params, updates), opt_state, loss

  opt_state, losses = opt.init(params), []
  for _ in range(steps):
    key, sub = jax.random.split(key)
    params, opt_state, loss = train_step(params, opt_state, sub)
    losses.append(float(loss))
  return losses, params


def _port_train(model, loss_fn, steps):
  return tvqt.train(tvqt.make_step(model, loss_fn), steps)


def test_vqt_example_matches_jax():
  """25 steps of the VQT example against JAX's from the same parameters."""
  n, beta = 4, 1.0                                        # :45
  energy = jmodels.BernoulliEnergy(list(range(n)),
                                   jnn.RandomUniform(-1, 1, 7))  # :48
  e_inf = jinference.AnalyticEnergyInference(energy, 500, initial_seed=7,
                                             exact=True)  # :49-50
  circuit = jmodels.DirectQuantumCircuit(
      jcu.hardware_efficient_ansatz(n, num_layers=3),
      jnn.RandomUniform(-0.5, 0.5, 8))                    # :51-53
  q_inf = jinference.AnalyticQuantumInference(circuit)    # :54
  model = jinference.QHBM(e_inf, q_inf)                   # :55
  target = jp.tfim_1d(n, 1.0, 1.0)                        # :57, :39-41
  loss_fn = jinference.make_vqt(model, target)            # :58
  params0 = model.params                                  # :68
  losses, params = _jax_train(loss_fn, params0, STEPS,
                              jax.random.PRNGKey(0), beta)  # :69-74
  model.set_params(params)                                # :78
  evals, evecs = np.linalg.eigh(np.asarray(target.dense()))  # :79-80
  w = np.exp(-beta * (evals - evals.min()))               # :81
  sigma = (evecs * (w / w.sum())) @ evecs.conj().T        # :82
  want_fid = float(jqhbm_utils.fidelity(model.modular_hamiltonian, sigma))

  t_model, t_loss, t_target = tvqt.build(CPU)
  t_model.set_params(convert.from_jax_params(params0, device=CPU))
  got = _port_train(t_model, t_loss, STEPS)
  np.testing.assert_allclose(got, losses, rtol=0, atol=LOSS_ATOL)
  assert losses[-1] < losses[0] - 1.0
  np.testing.assert_allclose(tvqt.fidelity(t_model, t_target), want_fid,
                             rtol=0, atol=FIDELITY_ATOL)


def test_qmhl_example_matches_jax():
  """25 steps of the QMHL example against JAX's from the same
  parameters."""
  n, beta = 3, 0.8                                        # :53
  h = jp.pauli_sum_from_strings(
      n, [(1.0, {q: p, q + 1: p}) for q in range(n - 1)
          for p in ("X", "Y", "Z")])                      # :36-41
  evals, evecs = np.linalg.eigh(np.asarray(h.dense()))    # :45
  w = np.exp(-beta * (evals - evals.min()))               # :46
  sigma = (evecs * (w / w.sum())) @ evecs.conj().T        # :47
  data = jdata.ThermalStateData(sigma)                    # :57
  energy = jmodels.KOBE(list(range(n)), order=2,
                        initializer=jnn.RandomUniform(-0.5, 0.5, 3))  # :59-60
  e_inf = jinference.AnalyticEnergyInference(energy, 500, initial_seed=4,
                                             exact=True)  # :61-62
  circuit = jmodels.DirectQuantumCircuit(
      jcu.hardware_efficient_ansatz(n, num_layers=3),
      jnn.RandomUniform(-0.5, 0.5, 5))                    # :63-65
  model = jinference.QHBM(e_inf,
                          jinference.AnalyticQuantumInference(circuit))  # :66
  loss_fn = jinference.make_qmhl(data, model)             # :68
  params0 = {"model": model.params, "data": data.params}  # :70
  losses, params = _jax_train(loss_fn, params0, STEPS,
                              jax.random.PRNGKey(1))      # :80-85
  model.set_params(params["model"])                       # :92
  want_fid = float(jqhbm_utils.fidelity(model.modular_hamiltonian, sigma))

  t_model, t_loss, t_data = tqmhl.build(CPU)
  np.testing.assert_allclose(t_data.density_matrix.numpy(), sigma,
                             rtol=0, atol=1e-6)  # JAX's eigh in complex64
  t_model.set_params(convert.from_jax_params(params0["model"], device=CPU))
  got = _port_train(t_model, t_loss, STEPS)
  np.testing.assert_allclose(got, losses, rtol=0, atol=LOSS_ATOL)
  assert losses[-1] < losses[0] - 0.5
  np.testing.assert_allclose(tqmhl.fidelity(t_model, t_data), want_fid,
                             rtol=0, atol=FIDELITY_ATOL)


def test_sharded_example_step_matches_jax(monkeypatch):
  """One step of the sharded example at JAX's initial parameters and
  draw: loss and gradient against the JAX example's stack on its mesh."""
  n, beta = 8, 1.2                                        # :46
  n_dev = len(jax.devices())                              # :51
  state = n_dev & (-n_dev)                                # :52
  mesh = jparallel.make_mesh(data=n_dev // state, state=state)  # :53
  assert dict(mesh.shape) == {"data": 1, "state": 8}
  energy = jmodels.BernoulliEnergy(list(range(n)),
                                   jnn.RandomUniform(-1, 1, 2))  # :57
  e_inf = jinference.BernoulliEnergyInference(
      energy, 200, initial_seed=2, max_unique_samples=32)  # :58-59
  circuit = jmodels.DirectQuantumCircuit(
      jcu.hardware_efficient_ansatz(n, num_layers=2),
      jnn.RandomUniform(-0.5, 0.5, 3))                    # :60-62
  q_inf = jparallel.ShardedQuantumInference(circuit, mesh)  # :63
  model = jinference.QHBM(e_inf, q_inf)                   # :64
  loss_fn = jinference.make_vqt(model, jp.tfim_1d(n, 1.0, 1.0))  # :66
  params = model.params                                   # :76
  _, key = jax.random.split(jax.random.PRNGKey(0))        # :77, :80
  (loss, _), grads = jax.jit(jax.value_and_grad(
      lambda p: loss_fn(p, key, beta), has_aux=True))(params)
  # make_vqt draws its support from the first of three keys
  # (qhbmlib_tpu/inference/vqt_loss.py:64).
  support, counts = jax.jit(e_inf.support_and_counts)(
      params["theta"], jax.random.split(key, 3)[0])
  assert int(np.sum(np.asarray(counts) > 0)) > 1

  t_model, t_loss, t_mesh = tsharded.build(CPU)
  assert t_mesh.shape == {"data": 1, "state": 1}
  t_model.set_params(convert.from_jax_params(params, device=CPU))
  drawn = (torch.tensor(np.asarray(support, np.float32)),
           torch.tensor(np.asarray(counts, np.float32)))
  monkeypatch.setattr(t_model.e_inference, "support_and_counts",
                      lambda generator=None: drawn)
  t_loss_val = t_loss()
  t_loss_val.backward()
  np.testing.assert_allclose(float(t_loss_val.detach()), float(loss),
                             rtol=0, atol=LOSS_ATOL)
  for key_ in ("theta", "phi"):
    np.testing.assert_allclose(t_model.params[key_][0].grad.numpy(),
                               np.asarray(grads[key_][0]), rtol=0,
                               atol=GRAD_ATOL)
  assert np.abs(np.asarray(grads["phi"][0])).max() > 1e-2


@pytest.mark.parametrize("example", [tvqt, tqmhl],
                         ids=["vqt_thermal_state", "qmhl_modular_hamiltonian"])
def test_example_fidelity_floor(example):
  """The example uncut at the port's seeds on the CPU: the fidelity that
  chip_smoke.py's floor is taken from, and the JAX example test's range."""
  name = example.__name__.rsplit(".", 1)[1]
  fid = example.main(device=CPU)
  assert 0.5 < fid <= 1.0
  np.testing.assert_allclose(fid, chip_smoke.EXAMPLE_CPU_FIDELITY[name],
                             rtol=0, atol=FIDELITY_ATOL)


@pytest.mark.parametrize("example", [tvqt, tqmhl],
                         ids=["vqt_thermal_state", "qmhl_modular_hamiltonian"])
def test_float64_witness_matches_plain(example):
  """`chip_smoke.example_grad_f64`, the float64 gradient the card's gate
  falls back on, against the plain versions' step at the example's first
  point (a gradient of norm ~2.5, where float32 rounding is ~1e-7 of it):
  loss within 1e-6, gradient within 1e-5 relative."""
  model, loss_fn, other = example.build(CPU)
  params = [p.detach().clone() for p in model.parameters()]
  loss, grad = tvqt.make_step(model, loss_fn)()
  want = chip_smoke.example_loss_f64(model, other, example.BETA)(
      *(v.double().numpy() for v in params))
  np.testing.assert_allclose(float(loss), want, rtol=0, atol=1e-6)
  grad64 = chip_smoke.example_grad_f64(model, other, example.BETA, params)
  assert chip_smoke.rel_err(grad, grad64) < 1e-5


def test_sharded_example_loss_falls():
  """The JAX example test's check at its 12 steps, on the one-process
  mesh."""
  losses = tsharded.main(steps=12, device=CPU)
  assert len(losses) == 12 and losses[-1] < losses[0]


def test_examples_need_a_device_or_the_card(monkeypatch):
  """No device means the CUDA card: without one each example raises
  instead of running the plain versions."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  for example in (tvqt, tqmhl, tsharded):
    with pytest.raises(RuntimeError, match="no CUDA device"):
      example.build()
