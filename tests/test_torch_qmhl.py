"""The port's QMHL loss against the JAX package's, on the CPU.

The JAX ladder's r5 structure at n = 8 (`benchmarks/ladder.py:187-235`):
the data are a fixed QHBM (Bernoulli energy from `RandomNormal(0, 0.3,
seed=11)`, hardware-efficient ansatz of 1 layer named "data_p"), the model
a Bernoulli energy and a 2-layer ansatz; both EBMs on their exact 2^8
support (expected counts), so no random draw enters.  The JAX weights cross
with `convert.from_jax_params`; the port's loss and gradients (model and
data) are held against `jax.value_and_grad` of the JAX `make_qmhl`, then 3
Adam steps of `bench.build_qmhl_step` (the model's parameters only) against
optax.  Self-QMHL equals the model's entropy with zero gradients.  The
composite circuit (data ansatz + model dagger: gates at coeff -1, diagonal
segments merged across the boundary) runs the batched forward and sweep
against the Pallas kernels in interpret mode, and a diagonal segment of
1440 parity factors (over one `parity_bilinear` launch) runs the batched
engine against the JAX package.  Tolerances as `tests/test_torch_vqt.py`:
loss atol 1e-4, gradients atol 2e-4, parameters after Adam 1e-5, states
1e-5; the 1440-factor segment, whose float32 phase sums reach ~513 rad in
both packages, relative L2 1e-4 on values and 2e-4 on the gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qhbmlib_tpu import data as jdata
from qhbmlib_tpu import models as jmodels
from qhbmlib_tpu import nn as jnn
from qhbmlib_tpu.inference import ebm as jebm
from qhbmlib_tpu.inference import qhbm as jqhbm
from qhbmlib_tpu.inference import qmhl_loss as jqmhl
from qhbmlib_tpu.inference import qnn as jqnn
from qhbmlib_tpu.ops import adjoint as jadjoint
from qhbmlib_tpu.ops import circuit_ir as jir
from qhbmlib_tpu.ops import pallas_adjoint
from qhbmlib_tpu.ops import pallas_sv
from qhbmlib_tpu.ops import paulis as jp
from qhbmlib_tpu.ops import statevector as jsv
from qhbmlib_tpu_torch import bench
from qhbmlib_tpu_torch import convert
from qhbmlib_tpu_torch import models as tmodels
from qhbmlib_tpu_torch import nn as tnn
from qhbmlib_tpu_torch.data import qhbm_data as tdata
from qhbmlib_tpu_torch.inference import ebm as tebm
from qhbmlib_tpu_torch.inference import qhbm as tqhbm
from qhbmlib_tpu_torch.inference import qmhl_loss as tqmhl
from qhbmlib_tpu_torch.inference import qnn as tqnn
from qhbmlib_tpu_torch.ops import adjoint as tadjoint
from qhbmlib_tpu_torch.ops import circuit_ir as tir
from qhbmlib_tpu_torch.ops import hopper_adjoint
from qhbmlib_tpu_torch.ops import hopper_sv
from qhbmlib_tpu_torch.ops import paulis as tp
from tests.test_torch_kernels import _c, _rowcol, _split

torch.set_num_threads(1)

N, STEPS, LR = 8, 3, 1e-2
CPU = "cpu"  # the port builds on the CUDA card unless told otherwise
CFG = dict(n=N, layers=2, samples=100, max_unique=8, **bench.QMHL_DATA)
LOSS_ATOL = 1e-4
GRAD_ATOL = 2e-4
PARAM_ATOL = 1e-5
STATE_ATOL = 1e-5
LONG_VALUE_RTOL = 1e-4
LONG_GRAD_RTOL = 2e-4


def _jax_qhbm(energy, samples, circuit):
  return jqhbm.QHBM(
      jebm.BernoulliEnergyInference(energy, samples, initial_seed=6,
                                    exact=True),
      jqnn.AnalyticQuantumInference(circuit))


@pytest.fixture(scope="module")
def jax_run():
  """The JAX side once: both QHBMs' parameters, the loss and its gradients,
  and the model's parameters after STEPS Adam steps."""
  data = jdata.QHBMData(_jax_qhbm(
      jmodels.BernoulliEnergy(list(range(N)),
                              jnn.RandomNormal(0.0, 0.3, seed=11)),
      CFG["data_samples"],
      jmodels.DirectQuantumCircuit(
          jmodels.hardware_efficient_ansatz(N, 1, name="data_p"),
          initializer=jnn.RandomUniform(0, 2, seed=12))))
  model = _jax_qhbm(
      jmodels.BernoulliEnergy(list(range(N)),
                              jnn.RandomUniform(-0.5, 0.5, seed=3)),
      CFG["samples"],
      jmodels.DirectQuantumCircuit(
          jmodels.hardware_efficient_ansatz(N, 2),
          initializer=jnn.RandomUniform(0, 2, seed=4)))
  loss_fn = jqmhl.make_qmhl(data, model)
  key = jax.random.PRNGKey(0)
  opt = optax.adam(LR)

  @jax.jit
  def step(model_params, opt_state):
    params = {"model": model_params, "data": data.params}
    loss, grads = jax.value_and_grad(lambda p: loss_fn(p, key)[0])(params)
    updates, opt_state = opt.update(grads["model"], opt_state)
    return (loss, grads, optax.apply_updates(model_params, updates),
            opt_state)

  model_params = model.params
  opt_state = opt.init(model_params)
  losses, grads0 = [], None
  for i in range(STEPS):
    loss, grads, model_params, opt_state = step(model_params, opt_state)
    losses.append(float(loss))
    if i == 0:
      grads0 = jax.tree_util.tree_map(np.asarray, grads)
  return {"params0": jax.tree_util.tree_map(
      np.asarray, {"model": model.params, "data": data.params}),
          "grads0": grads0, "losses": losses,
          "model_params": jax.tree_util.tree_map(np.asarray, model_params)}


def _port(params0):
  """bench.build_qmhl_step on the exact supports, with the JAX weights."""
  h, data, train_step = bench.build_qmhl_step(CFG, CPU, exact=True)
  params = convert.from_jax_params(params0, device=CPU)
  h.set_params(params["model"])
  data.qhbm.set_params(params["data"])
  return h, data, train_step


def test_qmhl_loss_and_gradients_match_jax(jax_run):
  """The loss and the gradients of both QHBMs: the model's through the
  modular Hamiltonian (its dagger's coeff -1 gates and its energy's
  shards), the data's through the composite circuit and eq. A5."""
  h, data, _ = _port(jax_run["params0"])
  loss = tqmhl.make_qmhl(data, h)()
  loss.backward()
  np.testing.assert_allclose(float(loss.detach()), jax_run["losses"][0],
                             atol=LOSS_ATOL)
  for side, qhbm in (("model", h), ("data", data.qhbm)):
    for key in ("theta", "phi"):
      want = jax_run["grads0"][side][key][0]
      np.testing.assert_allclose(qhbm.params[key][0].grad.numpy(), want,
                                 atol=GRAD_ATOL, err_msg=f"{side} {key}")
      assert np.abs(want).max() > 1e-2


def test_adam_steps_match_optax(jax_run):
  h, data, train_step = _port(jax_run["params0"])
  losses = [float(train_step()[0]) for _ in range(STEPS)]
  np.testing.assert_allclose(losses, jax_run["losses"], atol=LOSS_ATOL)
  for key in ("theta", "phi"):
    np.testing.assert_allclose(h.params[key][0].detach().numpy(),
                               jax_run["model_params"][key][0],
                               atol=PARAM_ATOL)
    # The data take no step, and keep no gradient.
    np.testing.assert_array_equal(data.qhbm.params[key][0].detach().numpy(),
                                  jax_run["params0"]["data"][key][0])
    assert data.qhbm.params[key][0].grad is None


def _port_qhbm(n, name, seed):
  energy = tmodels.BernoulliEnergy(
      list(range(n)), initializer=tnn.RandomUniform(-1, 1, seed=seed),
      device=CPU)
  circuit = tmodels.DirectQuantumCircuit(
      tmodels.hardware_efficient_ansatz(n, 2, name=name),
      initializer=tnn.RandomUniform(0, 2, seed=seed + 1), device=CPU)
  return tqhbm.QHBM(
      tebm.BernoulliEnergyInference(energy, 100, initial_seed=0, exact=True),
      tqnn.AnalyticQuantumInference(circuit))


def test_self_qmhl_equals_entropy():
  """QMHL of a model against data in its own state is the entropy, at
  zero gradient (reference tests/inference/test_qmhl_loss.py:20-42)."""
  data = _port_qhbm(4, "data", 7)
  model = _port_qhbm(4, "model", 7)
  loss = tqmhl.make_qmhl(tdata.QHBMData(data), model)()
  loss.backward()
  np.testing.assert_allclose(float(loss.detach()),
                             float(model.e_inference.entropy().detach()),
                             atol=LOSS_ATOL)
  for p in model.parameters():
    np.testing.assert_allclose(p.grad.numpy(), 0.0, atol=GRAD_ATOL)


def _composite(values_seed):
  """(JAX pqc, port pqc through the models' sum and inverse, values): the
  data ansatz + the model ansatz's dagger, as the QMHL step builds it."""
  jpqc = jmodels.hardware_efficient_ansatz(N, 1, name="data_p").append(
      jmodels.hardware_efficient_ansatz(N, 2).inverse())
  data = tmodels.DirectQuantumCircuit(
      tmodels.hardware_efficient_ansatz(N, 1, name="data_p"), device=CPU)
  model = tmodels.DirectQuantumCircuit(
      tmodels.hardware_efficient_ansatz(N, 2), device=CPU)
  tpqc = (data + model**-1).pqc
  assert tpqc.to_dict() == jpqc.to_dict()
  values = np.random.RandomState(values_seed).uniform(
      -1, 1, jpqc.num_symbols).astype(np.float32)
  return jpqc, tpqc, values


def _psi_lam(pqc, values, bits, op, g):
  """Reference forward states and lambda = sum_t g_t P_t psi per state
  (one jitted function of the bitstring and weights)."""
  ones = jp.PauliSum(op.codes, jnp.ones_like(op.coeffs), N)

  @jax.jit
  def one(b, gg):
    psi = jsv.apply_circuit(pqc, jnp.asarray(values), jsv.basis_state(N, b))
    return psi, jsv.apply_pauli_sum(psi, ones, term_weights=gg)

  psis, lams = zip(*[one(jnp.asarray(b), jnp.asarray(gg))
                     for b, gg in zip(bits, g)])
  return np.stack(psis), np.stack(lams)


@pytest.mark.parametrize("stage", ["forward", "sweep"])
def test_composite_circuit_matches_pallas_interpret(stage, monkeypatch):
  """The QMHL step's circuit through the batched forward (K4 / K1's plain
  versions) and sweep (K5's), against the Pallas kernels in interpret
  mode: states within 1e-5, gradients within 2e-4."""
  monkeypatch.setenv("QHBM_MATMUL_PRECISION", "high")
  jpqc, tpqc, values = _composite(21)
  bits = np.random.RandomState(22).randint(0, 2, (2, N)).astype(np.int8)
  if stage == "forward":
    rowcol = _rowcol(bits, N)
    want = pallas_sv.apply_circuit_pallas_batched(
        jpqc, jnp.asarray(values), jnp.asarray(rowcol), interpret=True)
    got = hopper_sv.apply_circuit_batched(tpqc, torch.tensor(values),
                                          torch.tensor(rowcol))
    np.testing.assert_allclose(_c(got), np.asarray(want), atol=STATE_ATOL)
    return
  op = jp.stack_single_term(jp.z_strings_from_masks(np.eye(N, dtype=int), N))
  g = np.random.RandomState(23).uniform(-1, 1, (2, N)).astype(np.float32)
  psis, lams = _psi_lam(jpqc, values, bits, op, g)
  want = pallas_adjoint.adjoint_sweep_batched(
      jpqc, jnp.asarray(values), jnp.asarray(psis), jnp.asarray(lams),
      interpret=True)
  got = hopper_adjoint.adjoint_sweep_batched(tpqc, torch.tensor(values),
                                             _split(psis), _split(lams))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_ATOL)
  assert np.abs(np.asarray(want)).max() > 1e-3


def _long_diag(ir_module, n, reps):
  """RX layer, `reps` all-to-all symbolic CZ layers (one diagonal segment
  of 4 * reps * n(n-1)/2 factors), RY layer."""
  b = ir_module.CircuitBuilder(n)
  for q in range(n):
    b.rx(q, f"x{q}")
  for r in range(reps):
    for i in range(n):
      for j in range(i + 1, n):
        b.cz(i, j, f"c{r}")
  for q in range(n):
    b.ry(q, f"y{q}")
  return b.build()


def test_batched_engine_on_a_diag_segment_over_one_bilinear_launch():
  """batched_expectations' value and gradient through one diagonal segment
  of 1440 > MAX_BILIN_K parity factors at n = 9 against the JAX package
  (the card splits its bilinears into two launches; here the plain
  versions run)."""
  n, reps = 9, 10
  jpqc, tpqc = _long_diag(jir, n, reps), _long_diag(tir, n, reps)
  assert 4 * reps * n * (n - 1) // 2 > hopper_adjoint.MAX_BILIN_K
  rng = np.random.RandomState(31)
  values = rng.uniform(-1, 1, jpqc.num_symbols).astype(np.float32)
  bits = rng.randint(0, 2, (3, n)).astype(np.int8)
  w = rng.normal(size=(3, 1)).astype(np.float32)
  (_, want), g_want = jax.jit(jax.value_and_grad(
      lambda v: (lambda out: (jnp.sum(out * w), out))(
          jadjoint.batched_expectations(jpqc, v, jnp.asarray(bits),
                                        (jp.tfim_1d(n),))),
      has_aux=True))(jnp.asarray(values))
  v = torch.tensor(values, requires_grad=True)
  got = tadjoint.batched_expectations(tpqc, v, torch.tensor(bits),
                                      (tp.tfim_1d(n, device=CPU),))
  (got * torch.tensor(w)).sum().backward()
  # Both packages sum the segment's phase (|theta| up to sum_k |w_k|, ~513
  # rad here) in float32, and each CZ symbol's gradient (-15.0) from 144
  # gates' bilinears: they agree relatively, as the card's reductions are
  # held (relative L2: 1e-4 values, 2e-4 gradient).
  assert _rel(got.detach().numpy(), want) < LONG_VALUE_RTOL
  assert _rel(v.grad.numpy(), g_want) < LONG_GRAD_RTOL
  assert np.abs(np.asarray(g_want)).max() > 1e-3


def _rel(x, ref):
  ref = np.asarray(ref, np.float64)
  return np.linalg.norm(np.asarray(x, np.float64) - ref) / np.linalg.norm(ref)
