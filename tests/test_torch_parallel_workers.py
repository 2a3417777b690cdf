"""Rank-side code of the sharded engines' CPU tests (imports no jax).

`tests/test_torch_parallel.py` builds its cases from numpy seeds (circuits
as `Circuit.to_dict`, values, bitstrings, Pauli codes and coefficients) and
runs every case of one world size in ONE spawn of that many gloo ranks
(`run_world`): each rank runs the cases in order and pickles its results;
the parent polls the ranks against a deadline and kills them on expiry.
Each case records its collective counts (`comm.stats`) beside its values.
This file holds no test of its own.
"""

import datetime
import os
import pickle
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from qhbmlib_tpu_torch import models
from qhbmlib_tpu_torch import nn
from qhbmlib_tpu_torch import parallel
from qhbmlib_tpu_torch.examples import multichip_sharded_vqt
from qhbmlib_tpu_torch.examples import vqt_thermal_state as vqt_example
from qhbmlib_tpu_torch.inference import ebm, qhbm, qnn, vqt_loss
from qhbmlib_tpu_torch.ops import adjoint
from qhbmlib_tpu_torch.ops import circuit_ir as ir
from qhbmlib_tpu_torch.ops import paulis
from qhbmlib_tpu_torch.ops import statevector as sv
from qhbmlib_tpu_torch.parallel import comm
from qhbmlib_tpu_torch.parallel import sharded_sv
from qhbmlib_tpu_torch.parallel import topology

CPU = "cpu"
DEADLINE_S = 120.0
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def free_port() -> int:
  with socket.socket() as s:
    s.bind(("localhost", 0))
    return s.getsockname()[1]


def run_world(world: int, cases, tmpdir, deadline_s: float = DEADLINE_S):
  """Runs `cases` in `world` spawned gloo ranks; returns [rank] -> {case id
  -> result}.  A rank that raises, exits nonzero or outlives the deadline
  fails the call (the others are killed)."""
  port = free_port()
  ctx = mp.start_processes(_rank_main, args=(world, port, cases, str(tmpdir)),
                           nprocs=world, join=False, start_method="spawn")
  end = time.monotonic() + deadline_s
  try:
    while not ctx.join(timeout=1.0):
      if time.monotonic() > end:
        raise TimeoutError(f"{world} ranks outlived {deadline_s} s")
  finally:
    for p in ctx.processes:
      if p.is_alive():
        p.kill()
  out = []
  for rank in range(world):
    with open(os.path.join(str(tmpdir), f"rank{rank}.pkl"), "rb") as f:
      out.append(pickle.load(f))
  return out


def _rank_main(rank, world, port, cases, tmpdir):
  torch.set_num_threads(1)
  topology.initialize_distributed(f"tcp://localhost:{port}", world, rank,
                                  backend="gloo", device=CPU,
                                  timeout=COLLECTIVE_TIMEOUT)
  results = {}
  for case in cases:
    comm.reset_stats()
    try:
      results[case["id"]] = RUNNERS[case["kind"]](case)
    except Exception:  # noqa: BLE001 -- the parent reports it per case
      results[case["id"]] = {"error": traceback.format_exc()}
    results[case["id"]]["stats"] = dict(comm.stats)
  with open(os.path.join(tmpdir, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(results, f)
  dist.barrier()
  dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Case builders shared with the test file (numpy only)
# ---------------------------------------------------------------------------

def circuit_of(case) -> ir.Circuit:
  return ir.Circuit.from_dict(case["circuit"])


def ops_of(case):
  n = case["circuit"]["num_qubits"]
  return tuple(paulis.from_arrays(codes, coeffs, n, device=CPU)
               for codes, coeffs in case["ops"])


def _mesh(case):
  return parallel.make_mesh(*case["mesh"])


def _np(t: torch.Tensor) -> np.ndarray:
  return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Runners: one a case kind, each returning a dict of numpy values
# ---------------------------------------------------------------------------

def run_simulate(case):
  """The gathered state from zero or from each of `bits`."""
  mesh = _mesh(case)
  circuit = circuit_of(case)
  values = torch.tensor(case["values"])
  bits = case.get("bits")
  inits = [None] if bits is None else [torch.tensor(b) for b in bits]
  states = [_np(sharded_sv.simulate_sharded(circuit, values, mesh, b,
                                            gather=True)) for b in inits]
  return {"states": np.stack(states)}


def run_expect(case):
  """Values [B, n_ops], d(sum)/d(values), d(sum)/d(each op's coeffs)."""
  mesh = _mesh(case)
  circuit = circuit_of(case)
  values = torch.tensor(case["values"], requires_grad=True)
  ops = ops_of(case)
  for op in ops:
    op.coeffs.requires_grad_(True)
  out = sharded_sv.batched_expectations(
      circuit, values, torch.tensor(case["bits"]), ops, mesh,
      data_axis=case.get("data_axis"))
  fwd = dict(comm.stats)
  out.sum().backward()
  return {"values": _np(out), "grad": _np(values.grad),
          "coeff_grads": [_np(op.coeffs.grad) for op in ops],
          "fwd_stats": fwd}


def _local_block(case, vec: np.ndarray):
  """This rank's [1, R, C] planes of a full state vector."""
  mesh = _mesh(case)
  axis = mesh.axis("state")
  k = parallel.mesh.num_global_qubits(mesh)
  n = int(np.log2(vec.size))
  size = 2**(n - k)
  block = torch.tensor(vec[axis.index * size:(axis.index + 1) * size])
  block = block.reshape((1,) + sv.state_shape(n - k))
  return (block.real.contiguous(), block.imag.contiguous()), axis, k


def run_expect_local(case):
  """`expectation_terms_local` of a given state."""
  planes, axis, k = _local_block(case, case["vec"])
  op = ops_of(case)[0]
  return {"terms": _np(sharded_sv.expectation_terms_local(planes, op, k,
                                                          axis)[0])}


def run_lambda_local(case):
  """`build_lambda_local` of a given state and weights, gathered."""
  planes, axis, k = _local_block(case, case["vec"])
  op = ops_of(case)[0]
  lam = sharded_sv.build_lambda_local(planes, op,
                                      torch.tensor(case["g"])[None], k, axis)
  local = torch.complex(*lam).reshape(-1)
  return {"lam": _np(comm.all_gather(local, axis).reshape(-1))}


def _vqt_model(case, q_inf_fn):
  n = case["circuit"]["num_qubits"]
  energy = models.BernoulliEnergy(list(range(n)), device=CPU)
  with torch.no_grad():
    energy.kernel.copy_(torch.tensor(case["theta"]))
  e_inf = ebm.AnalyticEnergyInference(energy, 128, initial_seed=5,
                                      exact=True, device=CPU)
  circuit = models.DirectQuantumCircuit(circuit_of(case), device=CPU)
  if case.get("phi") is not None:
    with torch.no_grad():
      circuit.values.copy_(torch.tensor(case["phi"]))
  h = qhbm.QHBM(e_inf, q_inf_fn(circuit))
  return h, vqt_loss.make_vqt(h, ops_of(case)[0])


def run_vqt(case):
  """The VQT loss and its gradients through ShardedQuantumInference."""
  mesh = _mesh(case)
  h, loss_fn = _vqt_model(
      case, lambda c: parallel.ShardedQuantumInference(c, mesh))
  loss = loss_fn(case["beta"])
  loss.backward()
  return {"loss": float(loss), "theta": _np(h.params["theta"][0].grad),
          "phi": _np(h.params["phi"][0].grad)}


def run_mp_step(case):
  """test_multiprocess.py's dress rehearsal: an UNSEEDED circuit (each
  rank draws its own values), reconciled by sync_params; the sharded loss
  and gradients against the dense engine on this rank; one Adam step."""
  mesh = _mesh(case)
  case = dict(case, phi=None)
  h, loss_fn = _vqt_model(
      case, lambda c: parallel.ShardedQuantumInference(c, mesh))
  drawn = _np(h.params["phi"][0]).copy()
  topology.sync_params(h.parameters())
  dense_h, dense_fn = _vqt_model(
      dict(case, phi=_np(h.params["phi"][0])),
      qnn.AnalyticQuantumInference)
  out = {"drawn": drawn}
  for tag, model, fn in (("sharded", h, loss_fn), ("dense", dense_h,
                                                   dense_fn)):
    loss = fn(case["beta"])
    loss.backward()
    out[tag] = (float(loss), [_np(p.grad) for p in model.parameters()])
  opt = torch.optim.Adam(h.parameters(), lr=1e-2)
  opt.step()
  out["after"] = [_np(p) for p in h.parameters()]
  return out


def _sampled_pair(case, seed):
  n = case["circuit"]["num_qubits"]
  mesh = _mesh(case)
  c1, c2 = (models.DirectQuantumCircuit(circuit_of(case), device=CPU)
            for _ in range(2))
  with torch.no_grad():
    c1.values.copy_(torch.tensor(case["phi"]))
    c2.values.copy_(torch.tensor(case["phi"]))
  one = qnn.SampledQuantumInference(c1, case["shots"], initial_seed=seed)
  shard = parallel.ShardedSampledQuantumInference(c2, case["shots"], mesh,
                                                  initial_seed=seed)
  return n, one, shard


def run_sampled(case):
  """One-rank SampledQuantumInference and the sharded one, same seed:
  expectations and phi gradients of their sum, twice (the generators
  advance in step)."""
  _, one, shard = _sampled_pair(case, case["seed"])
  bits = torch.tensor(case["bits"])
  ops = ops_of(case)
  out = {}
  for tag, inf in (("one", one), ("shard", shard)):
    vals, grads = [], []
    for _ in range(2):
      e = inf.expectation(bits, ops)
      e.sum().backward()
      vals.append(_np(e))
      grads.append(_np(inf.circuit.values.grad))
      inf.circuit.values.grad = None
    out[tag] = (vals, grads)
  return out


def run_sampled_energy(case):
  """The general-energy observable path (samples fed to a KOBE energy):
  values, phi gradients and the energy's gradients, one rank vs sharded."""
  n, one, shard = _sampled_pair(case, case["seed"])
  bits = torch.tensor(case["bits"])
  out = {}
  for tag, inf in (("one", one), ("shard", shard)):
    energy = models.KOBE(list(range(n)), 2, device=CPU)
    with torch.no_grad():
      for p, v in zip(energy.parameters(), case["kobe"]):
        p.copy_(torch.tensor(v))
    obs = models.Hamiltonian(energy, models.DirectQuantumCircuit(
        models.hardware_efficient_ansatz(n, 1, name="obs"),
        initializer=nn.RandomUniform(0, 2, seed=6), device=CPU))
    e = inf.expectation(bits, obs)
    e.sum().backward()
    out[tag] = (_np(e), _np(inf.circuit.values.grad),
                [_np(p.grad) for p in energy.parameters()])
  return out


def _gwg_pair(case, step_fn=None):
  n = case["n"]
  mesh = _mesh(case)
  energy = models.KOBE(list(range(n)), 2, device=CPU)
  with torch.no_grad():
    for p, v in zip(energy.parameters(), case["kobe"]):
      p.copy_(torch.tensor(v))
  kw = dict(num_chains=case["chains"], initial_seed=case["seed"],
            max_unique_samples=case.get("max_unique"), device=CPU)
  if step_fn is not None:
    kw["step_fn"] = step_fn
  one = ebm.GibbsWithGradientsInference(energy, case["samples"],
                                        case["burnin"], **kw)
  shard = parallel.ShardedGibbsWithGradientsInference(
      energy, case["samples"], case["burnin"], mesh, **kw)
  return one, shard


def _flip_all(energy, state, generator, chains=None):
  del energy, generator, chains
  return torch.bitwise_xor(state, torch.ones_like(state))


def _frozen(energy, state, generator, chains=None):
  del energy, generator, chains
  return state


def run_gwg(case):
  """run_chains and support_counts_state, one rank vs sharded, from the
  same generator state and initial chains; a frozen and a flip-all
  step_fn through the sharded path."""
  one, shard = _gwg_pair(case)
  state0 = torch.tensor(case["state0"])
  out = {}
  for tag, inf in (("one", one), ("shard", shard)):
    samples, final = inf.run_chains(state0, case["steps"])
    sup, cnt, st = inf.support_counts_state(None, state0)
    out[tag] = (_np(samples), _np(final), _np(sup), _np(cnt), _np(st),
                inf.generator.get_state().numpy())
  _, frozen = _gwg_pair(case, _frozen)
  out["frozen"] = [_np(x) for x in frozen.run_chains(state0, 3)]
  one, shard = _gwg_pair(case, _flip_all)
  out["flip"] = [[_np(x) for x in inf.run_chains(state0, 4)]
                 for inf in (one, shard)]
  return out


def run_topology(case):
  """Mesh layout and the axis / argument checks on a live world."""
  world = dist.get_world_size()
  mesh = parallel.make_mesh(case["data"], case["state"])
  out = {"shape": dict(mesh.shape), "coords": mesh.coords,
         "state_ranks": mesh.axis("state").ranks,
         "data_ranks": mesh.axis("data").ranks,
         "world_one": topology.initialize_distributed(world_size=1),
         "world": topology.initialize_distributed(), "errors": {}}
  circ = models.DirectQuantumCircuit(
      models.hardware_efficient_ansatz(3, 1), device=CPU)
  checks = {
      "state3": lambda: parallel.make_mesh(1, 3),
      "state0": lambda: parallel.make_mesh(1, 0),
      "data0": lambda: parallel.make_mesh(0, 1),
      "too_big": lambda: parallel.make_mesh(world, 2),
      "batch": lambda: parallel.ShardedQuantumInference(circ, mesh,
                                                        data_axis="batch"),
      "amps": lambda: parallel.ShardedQuantumInference(circ, mesh,
                                                       state_axis="amps"),
      "chains": lambda: parallel.ShardedGibbsWithGradientsInference(
          models.KOBE([0, 1], 2, device=CPU), 8, 0, mesh, num_chains=3,
          device=CPU),
  }
  for name, fn in checks.items():
    try:
      fn()
      out["errors"][name] = None
    except ValueError as e:
      out["errors"][name] = str(e)
  out["none_axis"] = parallel.ShardedQuantumInference(
      circ, mesh, data_axis=None)._data_axis
  return out


def run_example_sharded(case):
  """The sharded VQT example's train loop for a few steps on the mesh it
  makes of this world: each step's point (parameters and EBM generator
  state before it), loss and gradient."""
  model, loss, mesh = multichip_sharded_vqt.build(CPU)
  step = vqt_example.make_step(model, loss)
  points, grads = [], []

  def before_step(_):
    points.append(([_np(p).copy() for p in model.parameters()],
                   model.e_inference.generator.get_state()))

  def recorded_step():
    loss, grad = step()
    grads.append(_np(grad))
    return loss, grad

  losses = vqt_example.train(recorded_step, case["steps"],
                             before_step=before_step)
  return {"mesh": mesh.shape, "points": points, "losses": losses,
          "grads": grads}


RUNNERS = {
    "simulate": run_simulate,
    "expect": run_expect,
    "expect_local": run_expect_local,
    "lambda_local": run_lambda_local,
    "vqt": run_vqt,
    "mp_step": run_mp_step,
    "sampled": run_sampled,
    "sampled_energy": run_sampled_energy,
    "gwg": run_gwg,
    "topology": run_topology,
    "example_sharded": run_example_sharded,
}
