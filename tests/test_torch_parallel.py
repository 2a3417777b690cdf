"""The port's sharded engines (`qhbmlib_tpu_torch/parallel/`) in gloo ranks
on the CPU, against the JAX package's sharded and dense engines.

The JAX side runs here, on the 8 virtual CPU devices of
`tests/conftest.py`; the port's side runs in spawned gloo ranks
(`tests/test_torch_parallel_workers.py`, which imports no jax): ONE spawn a
world size (2, 4, 8) runs every case of that size, and each test below
reads its case's results.  Inputs are made from numpy seeds.  Tolerances
are the JAX sharded tests' (`tests/parallel/test_sharded_sv.py`): states
and expectations 2e-5, symbol and coefficient gradients 1e-4.  Exchange
counts are held to the JAX jaxpr's `ppermute` count for the same circuit
(`TestShardedTiering`) and to `sharded_sv.collective_counts`; the sampled
engine and the GWG chains to the port's one-rank engines, bit for bit.
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qhbmlib_tpu import models as jmodels
from qhbmlib_tpu import nn as jnn
from qhbmlib_tpu import parallel as jparallel
from qhbmlib_tpu.inference import ebm as jebm
from qhbmlib_tpu.inference import qhbm as jqhbm
from qhbmlib_tpu.inference import qnn as jqnn
from qhbmlib_tpu.inference import vqt_loss as jvqt
from qhbmlib_tpu.models import circuit_utils as jcu
from qhbmlib_tpu.ops import adjoint as jadjoint
from qhbmlib_tpu.ops import circuit_ir as jir
from qhbmlib_tpu.ops import paulis as jp
from qhbmlib_tpu.ops import statevector as jsv
from qhbmlib_tpu.parallel import sharded_sv as jsharded
from qhbmlib_tpu_torch import parallel
from qhbmlib_tpu_torch.ops import circuit_ir as ir
from qhbmlib_tpu_torch.ops import paulis
from qhbmlib_tpu_torch.parallel import sharded_sv
from qhbmlib_tpu_torch.parallel import topology
from tests import test_torch_parallel_workers as workers
from tests.ops.test_statevector import random_circuit
from tests.parallel.test_sharded_sv import _count_primitive, _rich_circuit

torch.set_num_threads(1)

ATOL = 2e-5
GRAD_ATOL = 1e-4


# ---------------------------------------------------------------------------
# Cases (numpy and the JAX IR only: nothing compiles at collection)
# ---------------------------------------------------------------------------

def _ops_arrays(ops):
  return [(np.asarray(op.codes, np.int8), np.asarray(op.coeffs, np.float32))
          for op in ops]


def _jops(case):
  n = case["circuit"]["num_qubits"]
  return tuple(jp.PauliSum(tuple(tuple(int(c) for c in row) for row in codes),
                           jnp.asarray(coeffs), n)
               for codes, coeffs in case["ops"])


def _two_ops(n):
  return (jp.pauli_sum_from_strings(
      n, [(0.7, {0: "Z"}), (-1.3, {0: "X", 1: "X"}), (0.4, {1: "Y"})]),
          jp.pauli_sum_from_strings(
              n, [(float(c), {q: "Z", (q + 1) % n: "Z"})
                  for q, c in enumerate(np.linspace(-1, 1, n))]))


def _row_ops(n):
  """_two_ops plus XX + YY on neighbours: at 10q on 2 or 4 ranks the local
  block holds row qubits, so these take the block, spanning and mixed
  tiers of the local pass."""
  return _two_ops(n) + (jp.pauli_sum_from_strings(
      n, [(0.3 + 0.1 * q, {q: p, q + 1: p}) for q in range(1, n - 1)
          for p in "XY"]),)


def _chain_circuit():
  """TestShardedTiering's chain circuit: rx+ry on global qubit 0, rx on 1,
  rx+ry on 2, ry on local 4."""
  b = jir.CircuitBuilder(5)
  b.rx(0, "a")
  b.ry(0, "b")
  b.rx(1, "c")
  b.rx(2, "e")
  b.ry(2, "f")
  b.ry(4, "d")
  return b.build()


def _diag_circuit():
  """Diagonal gates on global qubits (TestShardedSimulate:91)."""
  b = jir.CircuitBuilder(5)
  b.rz(0, "a")
  b.zp(1, "b")
  b.cz(0, 2, "c")
  b.cz(1, 4, "d")
  b.add(jir.ZZP, [2, 3], "e")
  return b.build()


def _sim(cid, mesh, circuit, seed, bits=None):
  values = np.random.RandomState(seed).uniform(
      -2, 2, circuit.num_symbols).astype(np.float32)
  return {"id": cid, "kind": "simulate", "mesh": mesh,
          "circuit": circuit.to_dict(), "values": values, "bits": bits}


def _expect(cid, mesh, circuit, seed, batch, ops, data_axis=None):
  rng = np.random.RandomState(seed)
  return {"id": cid, "kind": "expect", "mesh": mesh,
          "circuit": circuit.to_dict(),
          "values": rng.uniform(-2, 2, circuit.num_symbols).astype(
              np.float32),
          "bits": rng.randint(0, 2, (batch, circuit.num_qubits)).astype(
              np.int8), "ops": _ops_arrays(ops), "data_axis": data_axis}


def _random_op(n, rng):
  return jp.pauli_sum_from_strings(
      n, [(float(rng.uniform(-1, 1)),
           {int(q): "XYZ"[rng.randint(3)]
            for q in rng.choice(n, rng.randint(1, 3), replace=False)})
          for _ in range(4)])


def _random_vec(n, seed):
  rng = np.random.RandomState(seed)
  vec = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
  return (vec / np.linalg.norm(vec)).astype(np.complex64)


def _vqt_case(cid, mesh, n=4, kind="vqt"):
  energy = jmodels.BernoulliEnergy(list(range(n)),
                                   initializer=jnn.RandomUniform(-1, 1,
                                                                 seed=11))
  circuit = jmodels.DirectQuantumCircuit(
      jcu.hardware_efficient_ansatz(n, 2),
      initializer=jnn.RandomUniform(0, 2, seed=12))
  target = jp.pauli_sum_from_strings(
      n, [(1.0, {q: "X"}) for q in range(n)] +
      [(-1.0, {q: "Z", q + 1: "Z"}) for q in range(n - 1)])
  return {"id": cid, "kind": kind, "mesh": mesh,
          "circuit": circuit.pqc.to_dict(), "ops": _ops_arrays((target,)),
          "theta": np.asarray(energy.trainable_variables[0], np.float32),
          "phi": np.asarray(circuit.trainable_variables[0], np.float32),
          "beta": 1.3}


def _kobe_params(n, seed):
  return [np.random.RandomState(seed).uniform(
      -1, 1, n + n * (n - 1) // 2).astype(np.float32)]


def _tiering_cases():
  tfim6 = _ops_arrays((jp.tfim_1d(6),))
  chain = _chain_circuit()
  chain_op = jp.pauli_sum_from_strings(
      5, [(1.0, {0: "Z"}), (0.5, {1: "Z", 3: "Z"})])
  return [
      {"id": "tier_expect", "kind": "expect_local", "mesh": (1, 8),
       "vec": _random_vec(6, 21), "ops": tfim6,
       "circuit": {"num_qubits": 6}},
      {"id": "tier_lambda", "kind": "lambda_local", "mesh": (1, 8),
       "vec": _random_vec(6, 22), "ops": tfim6,
       "circuit": {"num_qubits": 6},
       "g": np.random.RandomState(23).normal(size=11).astype(np.float32)},
      {"id": "tier_1q_fwd", "kind": "simulate", "mesh": (1, 8),
       "circuit": chain.to_dict(),
       "values": np.asarray([0.3, -0.8, 1.1, 0.5, -0.2, 0.9], np.float32),
       "bits": None},
      {"id": "tier_1q_bwd", "kind": "expect", "mesh": (1, 8),
       "circuit": chain.to_dict(),
       "values": np.asarray([0.3, -0.8, 1.1, 0.5, -0.2, 0.9], np.float32),
       "bits": np.zeros([1, 5], np.int8), "ops": _ops_arrays((chain_op,)),
       "data_axis": None},
  ]


FUZZ = [(6, 104)]

CASES = {
    2: [
        _sim("sim_s2", (1, 2), _rich_circuit(4), 31),
        _expect("expect_s2", (1, 2), _rich_circuit(4), 32, 5, _two_ops(4)),
        _expect("expect_rows_s2", (1, 2), _rich_circuit(10), 37, 3,
                _row_ops(10)),
        {"id": "sampled", "kind": "sampled", "mesh": (2, 1),
         "circuit": jcu.hardware_efficient_ansatz(4, 1).to_dict(),
         "phi": np.random.RandomState(33).uniform(0, 2, 11).astype(
             np.float32), "shots": 200, "seed": 3,
         "bits": np.asarray([[0, 0, 0, 0], [1, 0, 1, 0], [0, 1, 1, 1]],
                            np.int8),
         "ops": _ops_arrays((jp.tfim_1d(4),))},
        {"id": "sampled_energy", "kind": "sampled_energy", "mesh": (2, 1),
         "circuit": jcu.hardware_efficient_ansatz(3, 1).to_dict(),
         "phi": np.random.RandomState(34).uniform(0, 2, 8).astype(
             np.float32), "shots": 100, "seed": 5,
         "bits": np.asarray([[0, 0, 0], [0, 1, 0], [1, 1, 1], [1, 0, 1],
                             [0, 0, 1]], np.int8),
         "kobe": _kobe_params(3, 35)},
        {"id": "gwg", "kind": "gwg", "mesh": (2, 1), "n": 5, "chains": 16,
         "samples": 64, "burnin": 2, "seed": 8, "steps": 7,
         "max_unique": 16, "kobe": _kobe_params(5, 36),
         "state0": np.random.RandomState(2).randint(0, 2, (16, 5)).astype(
             np.int8)},
        {"id": "topology", "kind": "topology", "mesh": (2, 1), "data": 2,
         "state": 1},
    ],
    4: [
        _sim("sim_s4", (1, 4), _rich_circuit(5), 41),
        _expect("expect_s4", (1, 4), _rich_circuit(5), 42, 3, _two_ops(5)),
        _expect("expect_2x2", (2, 2), _rich_circuit(4), 43, 5, _two_ops(4),
                data_axis="data"),
        _expect("expect_rows_s4", (1, 4), _rich_circuit(10), 37, 3,
                _row_ops(10)),
        _vqt_case("mp_step", (2, 2), kind="mp_step"),
    ],
    8: [
        _sim("sim_zero", (1, 8), _rich_circuit(5), 0),
        _sim("sim_basis", (1, 8), _rich_circuit(4), 1,
             bits=[np.asarray(jsv.all_bitstrings(4)[i], np.int8)
                   for i in (1, 7, 10, 15)]),
        _sim("sim_all_global", (1, 8), _rich_circuit(3), 2),
        _sim("sim_diag_global", (1, 8), _diag_circuit(), 3),
        _expect("expect_s8", (1, 8), _rich_circuit(4), 3, 5, _two_ops(4)),
        _expect("expect_2x4", (2, 4), _rich_circuit(4), 7, 5, _two_ops(4),
                data_axis="data"),
        _vqt_case("vqt", (2, 4)),
        {"id": "example_sharded", "kind": "example_sharded", "steps": 3},
    ] + [
        dict(_expect(f"fuzz_{n}_{seed}", (1, 8),
                     random_circuit(n, depth=2, seed=seed), seed, 3,
                     (_random_op(n, np.random.RandomState(seed + 1)),)))
        for n, seed in FUZZ
    ] + [
        _sim(f"fuzz_sim_{n}_{seed}", (1, 8), random_circuit(n, 2, seed),
             seed) for n, seed in FUZZ
    ] + _tiering_cases(),
}
_BY_ID = {c["id"]: (world, c) for world, cases in CASES.items()
          for c in cases}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
  """ranks(world) -> [rank] -> {case id -> result}: one spawn a world."""
  runs = {}

  def get(world):
    if world not in runs:
      runs[world] = workers.run_world(
          world, CASES[world], tmp_path_factory.mktemp(f"world{world}"))
    return runs[world]

  return get


def _result(ranks, cid, rank=0):
  world, _ = _BY_ID[cid]
  out = ranks(world)[rank][cid]
  assert "error" not in out, out["error"]
  return out


# ---------------------------------------------------------------------------
# JAX references
# ---------------------------------------------------------------------------

def _jcircuit(case):
  return jir.Circuit.from_dict(case["circuit"])


@functools.lru_cache(maxsize=None)
def _jax_expect_fn(circuit_json, codes):
  """One jitted dense value-and-gradient a (circuit, op structure): the
  cases that share them share the compile."""
  circuit = jir.Circuit.from_json(circuit_json)

  def total(values, bits, coeffs):
    o = tuple(jp.PauliSum(c, w, circuit.num_qubits)
              for c, w in zip(codes, coeffs))
    out = jadjoint.batched_expectations(circuit, values, bits, o)
    return jnp.sum(out), out

  return jax.jit(jax.value_and_grad(total, (0, 2), has_aux=True))


@functools.lru_cache(maxsize=None)
def _jax_expect(cid):
  """Dense JAX values, d(sum)/d(values), d(sum)/d(coeffs) of each op."""
  _, case = _BY_ID[cid]
  ops = _jops(case)
  fn = _jax_expect_fn(_jcircuit(case).to_json(),
                      tuple(op.codes for op in ops))
  (_, out), (g, gc) = fn(jnp.asarray(case["values"]),
                         jnp.asarray(case["bits"]),
                         [op.coeffs for op in ops])
  return np.asarray(out), np.asarray(g), [np.asarray(x) for x in gc]


def _jax_states(case):
  circuit = _jcircuit(case)
  values = jnp.asarray(case["values"])
  if case["bits"] is None:
    return [np.asarray(jsv.simulate(circuit, values)).reshape(-1)]
  return [np.asarray(jsv.simulate_from_bits(circuit, values,
                                            jnp.asarray(b))).reshape(-1)
          for b in case["bits"]]


def _predicted(cid, grad=True):
  _, case = _BY_ID[cid]
  circuit = ir.Circuit.from_dict(case["circuit"])
  op, _ = paulis.concat_ops(workers.ops_of(case), circuit.num_qubits)
  k = int(np.log2(case["mesh"][1]))
  return sharded_sv.collective_counts(circuit, op, k,
                                      data_split=case["mesh"][0] > 1,
                                      grad=grad)


# ---------------------------------------------------------------------------
# Simulation
# ---------------------------------------------------------------------------

SIMS = ["sim_s2", "sim_s4", "sim_zero", "sim_basis", "sim_all_global",
        "sim_diag_global"] + [f"fuzz_sim_{n}_{s}" for n, s in FUZZ]


@pytest.mark.parametrize("cid", SIMS)
def test_simulate_matches_dense_jax(ranks, cid):
  """Every state from zero or a basis state, gathered, against the JAX
  dense engine: state 2, 4 and 8, n = k (sim_all_global: one amplitude a
  rank), random circuits of every gate kind."""
  _, case = _BY_ID[cid]
  got = _result(ranks, cid)["states"]
  for g, want in zip(got, _jax_states(case)):
    np.testing.assert_allclose(g, want, atol=ATOL)


def test_simulate_matches_sharded_jax(ranks):
  """The rich 5q circuit at state 8 against the JAX sharded engine."""
  _, case = _BY_ID["sim_zero"]
  mesh = jparallel.make_mesh(data=1, state=8)
  want = jax.jit(lambda v: jsharded.simulate_sharded(
      _jcircuit(case), v, mesh))(jnp.asarray(case["values"]))
  np.testing.assert_allclose(_result(ranks, "sim_zero")["states"][0],
                             np.asarray(want), atol=ATOL)


def test_diagonal_gates_on_global_qubits_use_no_exchange(ranks):
  out = _result(ranks, "sim_diag_global")
  assert out["stats"].get("exchanges", 0) == 0
  assert out["stats"]["all_gathers"] == 1  # the gather of the result only


# ---------------------------------------------------------------------------
# Expectations and gradients
# ---------------------------------------------------------------------------

EXPECTS = ["expect_s2", "expect_s4", "expect_s8", "expect_2x2",
           "expect_2x4", "expect_rows_s2", "expect_rows_s4"] + [
               f"fuzz_{n}_{s}" for n, s in FUZZ]


@pytest.mark.parametrize("cid", EXPECTS)
def test_expectations_match_dense_jax(ranks, cid):
  """Values (2e-5), symbol and coefficient gradients (1e-4) against the
  JAX dense engine, every rank the same; state 2 / 4 / 8 and data 2 x
  state 2 / 4 with a padded batch of 5; at 10q local blocks with row
  qubits (every other case's blocks are minor columns only)."""
  want, g_want, gc_want = _jax_expect(cid)
  world, _ = _BY_ID[cid]
  for rank in range(world):
    out = _result(ranks, cid, rank)
    np.testing.assert_allclose(out["values"], want, atol=ATOL)
    np.testing.assert_allclose(out["grad"], g_want, atol=GRAD_ATOL)
    for got, gc in zip(out["coeff_grads"], gc_want):
      np.testing.assert_allclose(got, gc, atol=GRAD_ATOL)
  assert np.abs(g_want).max() > 1e-3


@pytest.mark.parametrize("cid", EXPECTS + ["tier_1q_bwd"])
def test_collectives_match_prediction(ranks, cid):
  """The counters of the forward alone and of value and gradient equal
  `collective_counts` for the circuit and the observable."""
  out = _result(ranks, cid)
  for stats, grad in ((out["fwd_stats"], False), (out["stats"], True)):
    want = _predicted(cid, grad)
    assert {k: stats.get(k, 0) for k in want} == want


def test_gradients_match_sharded_jax(ranks):
  """Values and gradients at state 8 against the JAX sharded engine."""
  _, case = _BY_ID["expect_s8"]
  mesh = jparallel.make_mesh(data=1, state=8)
  circuit, ops, bits = _jcircuit(case), _jops(case), jnp.asarray(
      case["bits"])
  val, g = jax.jit(jax.value_and_grad(lambda v: jnp.sum(
      jsharded.batched_expectations(circuit, v, bits, ops, mesh))))(
          jnp.asarray(case["values"]))
  out = _result(ranks, "expect_s8")
  np.testing.assert_allclose(out["values"].sum(), float(val), atol=ATOL * 10)
  np.testing.assert_allclose(out["grad"], np.asarray(g), atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# Tiering: exchange counts against the JAX jaxpr
# ---------------------------------------------------------------------------

def _jax_shard_body(fn, n, k, out_spec):
  from jax.sharding import PartitionSpec
  try:
    from jax import shard_map
  except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map
  mesh = jparallel.make_mesh(data=1, state=2**k)
  return lambda *args: shard_map(
      lambda chunk, *rest: fn(jsv.from_vector(chunk, n - k), *rest),
      mesh=mesh, in_specs=(PartitionSpec("state"),) +
      (PartitionSpec(),) * (len(args) - 1), out_specs=out_spec)(*args)


def _jax_permutes(cid):
  """ppermutes of the JAX jaxpr of the same work (TestShardedTiering)."""
  from jax.sharding import PartitionSpec
  _, case = _BY_ID[cid]
  mesh = jparallel.make_mesh(data=1, state=8)
  if cid in ("tier_expect", "tier_lambda"):
    op = _jops(case)[0]
    if cid == "tier_expect":
      fn = _jax_shard_body(lambda local: jsharded.expectation_terms_local(
          local, op, 3, "state"), 6, 3, PartitionSpec())
      args = (jnp.asarray(case["vec"]),)
    else:
      fn = _jax_shard_body(lambda local, w: jsharded.build_lambda_local(
          local, op, w, 3, "state").reshape(-1), 6, 3,
                           PartitionSpec("state"))
      args = (jnp.asarray(case["vec"]), jnp.asarray(case["g"]))
    return _count_primitive(jax.make_jaxpr(fn)(*args).jaxpr, "ppermute")
  circuit = _jcircuit(case)
  values = jnp.asarray(case["values"])
  if cid == "tier_1q_fwd":
    fn = lambda v: jsharded.simulate_sharded(circuit, v, mesh)
  else:
    ops, bits = _jops(case), jnp.asarray(case["bits"])
    fn = jax.value_and_grad(lambda v: jnp.sum(jsharded.batched_expectations(
        circuit, v, bits, ops, mesh)))
  return _count_primitive(jax.make_jaxpr(fn)(values).jaxpr, "ppermute")


@pytest.mark.parametrize("cid,want", [("tier_expect", 3), ("tier_lambda", 3),
                                      ("tier_1q_fwd", 3),
                                      ("tier_1q_bwd", 9)])
def test_exchange_counts_match_jax_jaxpr(ranks, cid, want):
  """One exchange a distinct global XOR mask (6q TFIM on 8 ranks: 3, for
  the expectation and for lambda), one a global qubit's chain of a 1q
  segment (3), and 3 + 3 + 1 stacked a qubit for value and gradient (9):
  the port's counters, the JAX jaxpr's ppermutes and the number the JAX
  tests assert agree."""
  assert _result(ranks, cid)["stats"].get("exchanges", 0) == want
  assert _jax_permutes(cid) == want


def test_tiered_values_match_dense_jax(ranks):
  """The tiering cases' values: expectation terms, lambda, the chain
  circuit's state, its value and gradient."""
  _, case = _BY_ID["tier_expect"]
  op = _jops(case)[0]
  want = jsv.expectation_terms(jsv.from_vector(jnp.asarray(case["vec"]), 6),
                               op)
  np.testing.assert_allclose(_result(ranks, "tier_expect")["terms"],
                             np.asarray(want), atol=ATOL)
  _, case = _BY_ID["tier_lambda"]
  ones = jp.PauliSum(op.codes, jnp.ones_like(op.coeffs), 6)
  want = jsv.apply_pauli_sum(jsv.from_vector(jnp.asarray(case["vec"]), 6),
                             ones, term_weights=jnp.asarray(case["g"]))
  np.testing.assert_allclose(_result(ranks, "tier_lambda")["lam"],
                             np.asarray(want).reshape(-1), atol=ATOL)
  _, case = _BY_ID["tier_1q_fwd"]
  np.testing.assert_allclose(_result(ranks, "tier_1q_fwd")["states"][0],
                             _jax_states(case)[0], atol=ATOL)
  want, g_want, _ = _jax_expect("tier_1q_bwd")
  out = _result(ranks, "tier_1q_bwd")
  np.testing.assert_allclose(out["values"], want, atol=ATOL)
  np.testing.assert_allclose(out["grad"], g_want, atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# Inference, sampled engine, GWG, topology
# ---------------------------------------------------------------------------

def _jax_vqt(cid):
  _, case = _BY_ID[cid]
  n = case["circuit"]["num_qubits"]
  energy = jmodels.BernoulliEnergy(list(range(n)))
  e_inf = jebm.AnalyticEnergyInference(energy, 128, initial_seed=5,
                                       exact=True)
  circuit = jmodels.DirectQuantumCircuit(_jcircuit(case))
  h = jqhbm.QHBM(e_inf, jqnn.AnalyticQuantumInference(circuit))
  loss_fn = jvqt.make_vqt(h, _jops(case)[0])
  params = {"theta": [jnp.asarray(case["theta"])],
            "phi": [jnp.asarray(case["phi"])]}
  loss, grads = jax.jit(jax.value_and_grad(lambda p: loss_fn(
      p, jax.random.PRNGKey(11), jnp.float32(case["beta"]))[0]))(params)
  return float(loss), np.asarray(grads["theta"][0]), np.asarray(
      grads["phi"][0])


def test_sharded_qnn_vqt_matches_jax(ranks):
  """The VQT loss and gradients through ShardedQuantumInference on a data
  2 x state 4 mesh against the JAX package's single-device stack (exact
  EBM, the same parameters)."""
  loss, g_theta, g_phi = _jax_vqt("vqt")
  for rank in range(8):
    out = _result(ranks, "vqt", rank)
    np.testing.assert_allclose(out["loss"], loss, atol=ATOL)
    np.testing.assert_allclose(out["theta"], g_theta, atol=GRAD_ATOL)
    np.testing.assert_allclose(out["phi"], g_phi, atol=GRAD_ATOL)
  assert np.abs(g_phi).max() > 1e-4


def test_sharded_example_on_8_ranks_matches_one_rank(ranks):
  """The sharded VQT example (`examples/multichip_sharded_vqt.py`) in a
  world of 8: the JAX example's mesh under conftest's 8 virtual devices,
  data 1 x state 8.  At each step's point (parameters and EBM generator
  state, so the same draw) every rank's loss and gradient equal one
  rank's (this process: the 1 x 1 mesh, the dense engine), and each step
  made the exchanges and all-reduces `collective_counts` predicts.

  The ranks' own trajectory is the reference's points: two float orders
  do not stay on one trajectory.  The example's bit 7 takes one value
  over the whole drawn support, so its score-function gradient is zero but
  for rounding (1e-7 on 8 ranks, 0.0 on one), and Adam's first step
  scales that to a step of ~lr: by step 2 free-running losses differ by
  4e-3."""
  from qhbmlib_tpu_torch.examples import multichip_sharded_vqt as tsharded
  steps = _BY_ID["example_sharded"][1]["steps"]
  assert tsharded.mesh_shape(8) == (1, 8)
  model, loss_fn, mesh = tsharded.build("cpu")
  assert mesh.shape == {"data": 1, "state": 1}
  per_step = sharded_sv.collective_counts(
      model.q_inference.circuit.pqc, paulis.tfim_1d(tsharded.N, device="cpu"),
      3)
  outs = [_result(ranks, "example_sharded", rank) for rank in range(8)]
  for out in outs:
    assert out["mesh"] == {"data": 1, "state": 8}
    assert {k: out["stats"].get(k, 0) for k in per_step} == {
        k: steps * v for k, v in per_step.items()}
    for a, b in zip(out["losses"] + out["grads"],
                    outs[0]["losses"] + outs[0]["grads"]):
      np.testing.assert_array_equal(a, b)
  for (params, state), loss, grad in zip(*(outs[0][k] for k in (
      "points", "losses", "grads"))):
    model.set_params({"theta": torch.tensor(params[0]),
                      "phi": torch.tensor(params[1])})
    model.e_inference.generator.set_state(state)
    for p in model.parameters():
      p.grad = None
    want = loss_fn()
    want.backward()
    np.testing.assert_allclose(loss, float(want.detach()), rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        grad, torch.cat([p.grad.reshape(-1) for p in model.parameters()]),
        rtol=0, atol=GRAD_ATOL)
  assert outs[0]["losses"][-1] < outs[0]["losses"][0]
  assert per_step["exchanges"] > 0


def test_multiprocess_step_with_sync_params(ranks):
  """test_multiprocess.py's dress rehearsal at data 2 x state 2: unseeded
  circuits differ across ranks until `sync_params`; then each rank's
  sharded loss and gradients match the dense engine on that rank, and
  every rank holds the same loss, gradients and Adam-stepped parameters."""
  outs = [_result(ranks, "mp_step", r) for r in range(4)]
  assert any(not np.array_equal(outs[0]["drawn"], o["drawn"])
             for o in outs[1:])
  for o in outs:
    loss_s, grads_s = o["sharded"]
    loss_d, grads_d = o["dense"]
    np.testing.assert_allclose(loss_s, loss_d, atol=ATOL)
    for gs, gd in zip(grads_s, grads_d):
      np.testing.assert_allclose(gs, gd, atol=GRAD_ATOL)
  for o in outs[1:]:
    assert o["sharded"][0] == outs[0]["sharded"][0]
    for a, b in zip(o["sharded"][1] + o["after"],
                    outs[0]["sharded"][1] + outs[0]["after"]):
      np.testing.assert_array_equal(a, b)


def test_sampled_matches_one_rank_at_the_same_draws(ranks):
  """ShardedSampledQuantumInference on data 2 against the one-rank engine
  from the same seed, two calls: expectations bit for bit, phi gradients
  to float32 reassociation (the shards' sums add in another order)."""
  for rank in range(2):
    out = _result(ranks, "sampled", rank)
    (v1, g1), (v2, g2) = out["one"], out["shard"]
    for a, b in zip(v1, v2):
      np.testing.assert_array_equal(a, b)
    for a, b in zip(g1, g2):
      np.testing.assert_allclose(a, b, rtol=3e-6, atol=1e-6)
    assert not np.array_equal(v1[0], v1[1])  # the generators advanced


def test_sampled_general_energy_matches_one_rank(ranks):
  """The general-energy observable (samples fed to a KOBE energy): values
  bit for bit, circuit and energy gradients to reassociation."""
  out = _result(ranks, "sampled_energy")
  (e1, g1, ge1), (e2, g2, ge2) = out["one"], out["shard"]
  np.testing.assert_array_equal(e1, e2)
  np.testing.assert_allclose(g1, g2, rtol=3e-6, atol=1e-6)
  for a, b in zip(ge1, ge2):
    np.testing.assert_allclose(a, b, rtol=3e-6, atol=1e-6)


def test_gwg_chains_bit_identical_to_one_rank(ranks):
  """Sharded GWG chains on data 2 against one rank's: samples, final
  state, support, counts and the generator's state all equal; a frozen
  step_fn freezes the sharded chains, a flip-all one matches one rank."""
  for rank in range(2):
    out = _result(ranks, "gwg", rank)
    for a, b in zip(out["one"], out["shard"]):
      np.testing.assert_array_equal(a, b)
    samples, final = out["frozen"]
    state0 = _BY_ID["gwg"][1]["state0"]
    np.testing.assert_array_equal(final, state0)
    for t in range(3):
      np.testing.assert_array_equal(samples[t], state0)
    for a, b in zip(*out["flip"]):
      np.testing.assert_array_equal(a, b)
  assert out["stats"]["all_gathers"] >= 2


def test_topology_axes_and_checks(ranks):
  """Mesh layout (rank = d * state + s), the axis and argument checks
  (test_topology.py) on a live world of 2."""
  for rank in range(2):
    out = _result(ranks, "topology", rank)
    assert out["shape"] == {"data": 2, "state": 1}
    assert out["coords"] == (rank, 0)
    assert out["data_ranks"] == (0, 1) and out["state_ranks"] == (rank,)
    assert (out["world_one"], out["world"]) == (1, 2)
    errs = out["errors"]
    assert "power of 2" in errs["state3"] and "power of 2" in errs["state0"]
    assert ">= 1" in errs["data0"] and "need 4 ranks" in errs["too_big"]
    assert "no axis 'batch'" in errs["batch"]
    assert "no axis 'amps'" in errs["amps"]
    assert "divisible" in errs["chains"]
    assert out["none_axis"] is None


def test_single_process_needs_no_process_group(monkeypatch, caplog):
  """A world of one: make_mesh(1, 1) without init_process_group, the
  degenerate mesh runs the dense engine, initialize_distributed with
  world_size 1 is a no-op and auto-detection that finds nothing warns and
  continues as one process."""
  for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
    monkeypatch.delenv(var, raising=False)
  mesh = parallel.make_mesh(1, 1)
  assert mesh.shape == {"data": 1, "state": 1} and mesh.coords == (0, 0)
  assert topology.initialize_distributed(world_size=1) == 1
  with caplog.at_level(logging.WARNING):
    assert topology.initialize_distributed(device="cpu") == 1
  assert "continuing as one process" in caplog.text
  circuit = ir.Circuit.from_dict(_rich_circuit(3).to_dict())
  values = torch.linspace(-1, 1, circuit.num_symbols)
  op = paulis.tfim_1d(3, device="cpu")
  bits = torch.tensor([[0, 1, 1], [1, 0, 0]], dtype=torch.int8)
  from qhbmlib_tpu_torch.ops import adjoint
  np.testing.assert_array_equal(
      sharded_sv.batched_expectations(circuit, values, bits, (op,),
                                      mesh).numpy(),
      adjoint.batched_expectations(circuit, values, bits, (op,)).numpy())
  with pytest.raises(ValueError, match="needs torch.distributed"):
    parallel.make_mesh(1, 2)
