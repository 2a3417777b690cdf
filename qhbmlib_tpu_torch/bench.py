"""The port's bench: VQT train steps/s at 24 qubits on one CUDA card.

The counterpart of the repo's `bench.py` for its accelerator path, with its
workloads (bench.py:49-52) at full width and depth:

  * 24q: 1D TFIM, Bernoulli EBM (100 samples, 8 unique states), 2-layer
    hardware-efficient ansatz -- the headline;
  * 20q: the same at 500 samples, 64 unique states, 4 layers;
  * qmhl 24q: the 24q model trained by the QMHL loss on the data of a fixed
    random 24q QHBM (the JAX ladder's r5 structure, `QMHL_DATA`).

A train step is what bench.py:134-176 builds (EBM sampling, VQT loss with
the eq. A5 score-function and adjoint gradients, Adam 1e-2), with seeded
random weights; steps/s comes from a host-clock loop of `--steps` steps
after one warm-up, ending in a synchronize.  Then, as bench.py does:

  * the precision gate: at each timed 24q step's (params, EBM generator
    state) the kernels' loss and gradient against the same step through
    the kernels' plain versions (`plain=True`, TF32 off), bar 1e-2 on the
    gradient's relative error (the JAX bench's reference arm is its
    `highest` matmul precision; the port has one precision);
  * the 24q forward <H> of one basis state against the float64 C++ oracle
    (`native/qsim_oracle.cc`);
  * the QMHL step's gate (its data QNN's plain arm, both EBM generators
    restored) and its forward <Z_i> shards of one basis state through the
    data circuit + model dagger against the oracle (`qmhl_*` keys);
  * PauliSum expectations/s at 20q: 16 chained forwards of 64 states;
  * the HBM stream probe (`benchmarks/hbm_probe.py`, with its kernel K6);
  * with `--independent`, the 24q step of the independent single-core C++
    simulator (`native/fast_sim.cc`), cached in `build/qhbmlib_tpu_torch/`.

  python -m qhbmlib_tpu_torch.bench [--steps 8] [--independent]

Prints ONE JSON line on stdout, {"metric": "vqt_train_steps_per_sec_24q",
"value", "unit": "steps/s", "extra": {...}}, with the card's name and power
limit (nvidia-smi) in extra; progress goes to stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from qhbmlib_tpu_torch import device as device_lib
from qhbmlib_tpu_torch import models
from qhbmlib_tpu_torch import nn
from qhbmlib_tpu_torch.benchmarks import hbm_probe
from qhbmlib_tpu_torch.data import qhbm_data
from qhbmlib_tpu_torch.data import thermal_data
from qhbmlib_tpu_torch.inference import ebm, qhbm, qmhl_loss, qnn, vqt_loss
from qhbmlib_tpu_torch.ops import _cuda
from qhbmlib_tpu_torch.ops import adjoint
from qhbmlib_tpu_torch.ops import hopper_sv
from qhbmlib_tpu_torch.ops import native_fast
from qhbmlib_tpu_torch.ops import native_oracle
from qhbmlib_tpu_torch.ops import paulis

BETA = 1.2
GRAD_REL_GATE = 1e-2
WORKLOADS = {
    "24q": dict(n=24, layers=2, samples=100, max_unique=8),
    "20q": dict(n=20, layers=4, samples=500, max_unique=64),
}
# The QMHL workload's data: the JAX ladder's r5 structure (benchmarks/
# ladder.py:187-235: a fixed random Bernoulli QHBM, HEA 1L "data_p", 32
# samples, 4 unique states), learned by the 24q workload's model (a
# Bernoulli energy and its exact sampler in r5's KOBE-2 / GWG place).
QMHL_DATA = dict(data_layers=1, data_samples=32, data_max_unique=4)
QMHL_WORKLOAD = {**WORKLOADS["24q"], **QMHL_DATA}
INDEPENDENT_CACHE = _cuda.BUILD_DIR / "independent_anchor.json"
# The 20q workload with QAIA (reference `models/circuit.py:226-276`) in the
# ansatz's place, as the harness builds it (`baselines/train.py:207-209`,
# its `circuit_init_*` RandomNormal(0, 0.1)): quantum terms the target's
# shards (`pauli_shards`), classical terms the energy's Z shards.  With
# the TFIM target at 4 layers its X-field PROTs fold into 1q segments; with
# the Heisenberg chain at 2 layers its XX and YY PROTs are flip gates.
QAIA_WORKLOADS = {
    "qaia 20q": dict(WORKLOADS["20q"], target="tfim"),
    "qaia heis 20q": dict(WORKLOADS["20q"], layers=2, target="heisenberg"),
}


def log(msg: str) -> None:
  print(msg, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def flat_grads(h: qhbm.QHBM) -> torch.Tensor:
  return torch.cat([p.grad.reshape(-1) for p in h.parameters()])


def _bench_model(cfg, device, exact: bool, circuit=None) -> qhbm.QHBM:
  """The bench's model QHBM at cfg's shape: Bernoulli energy (seed 2), its
  EBM (seed 11), the hardware-efficient ansatz (seed 3), or
  `circuit(energy)` in its place."""
  n = cfg["n"]
  energy = models.BernoulliEnergy(
      list(range(n)), initializer=nn.RandomUniform(seed=2),
      device=device)
  e_inf = ebm.BernoulliEnergyInference(energy, cfg["samples"],
                                       initial_seed=11, exact=exact,
                                       max_unique_samples=cfg["max_unique"],
                                       device=device)
  if circuit is None:
    model_circuit = models.DirectQuantumCircuit(
        models.hardware_efficient_ansatz(n, cfg["layers"]),
        initializer=nn.RandomUniform(0, 2, seed=3), device=device)
  else:
    model_circuit = circuit(energy)
  return qhbm.QHBM(e_inf, qnn.AnalyticQuantumInference(model_circuit))


def build_train_step(cfg, device, exact: bool = False, target=None,
                     circuit=None):
  """The bench's VQT train step (bench.py:134-176) in the port, with
  seeded random weights (`_bench_model`).

  Returns (h, target, train_step): train_step() takes one Adam step on h's
  parameters and returns the loss and the flat gradient [theta, phi] from
  before the update, both on the device.  `exact` uses the full 2^n EBM
  support with expected counts (n <= 16) instead of sampling.  `target`
  (a PauliSum on `device`) replaces the open-chain TFIM of bench.py;
  `circuit` (energy -> QuantumCircuit on `device`, e.g. a QAIA on the
  energy's operator shards, as `baselines/train.py:207-209` builds it)
  replaces the hardware-efficient ansatz."""
  if target is None:
    target = paulis.tfim_1d(cfg["n"], device=device)
  h = _bench_model(cfg, device, exact, circuit)
  loss_fn = vqt_loss.make_vqt(h, target)
  opt = torch.optim.Adam(h.parameters(), lr=1e-2)

  def train_step():
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(BETA)
    loss.backward()
    grads = flat_grads(h)
    opt.step()
    return loss.detach(), grads

  return h, target, train_step


def pauli_shards(op: paulis.PauliSum):
  """op's terms grouped by their one Pauli letter, X then Y then Z: a
  TFIM's X-field and ZZ sums, a Heisenberg chain's XX, YY and ZZ sums."""
  rows = op.code_rows()
  shards, taken = [], 0
  for code in (paulis.X, paulis.Y, paulis.Z):
    idx = [t for t, row in enumerate(rows) if set(row) - {paulis.I} == {code}]
    if idx:
      pick = torch.tensor(idx)
      shards.append(paulis.PauliSum(op.codes[pick],
                                    op.coeffs[pick.to(op.coeffs.device)],
                                    op.num_qubits))
      taken += len(idx)
  if taken != op.num_terms:
    raise ValueError("pauli_shards takes terms of one Pauli letter each")
  return shards


def build_qaia_step(cfg, device, target: paulis.PauliSum):
  """`build_train_step` with a QAIA of cfg["layers"] layers on `target`'s
  shards (`pauli_shards`) and the energy's Z shards, weights
  RandomNormal(0, 0.1, seed 3) (QAIA_WORKLOADS)."""
  return build_train_step(cfg, device, target=target, circuit=(
      lambda energy: models.QAIA(
          pauli_shards(target), energy.operator_shards(cfg["n"]),
          cfg["layers"], initializer=nn.RandomNormal(0.0, 0.1, seed=3),
          device=device)))


def build_qmhl_step(cfg, device, exact: bool = False):
  """The QMHL train step of QMHL_WORKLOAD in the port, with seeded random
  weights: the model is `build_train_step`'s (same seeds), the data a fixed
  QHBM of r5's (`RandomNormal(0, 0.3, seed=11)` energy, a "data_p" ansatz
  of cfg["data_layers"] layers, its EBM seeded 6).

  Returns (h, data, train_step): train_step() takes one Adam step on the
  model's parameters alone and returns the loss and the model's flat
  gradient [theta, phi] from before the update; the data's gradients are
  dropped.  `exact` uses both EBMs' full 2^n support (n <= 16)."""
  n = cfg["n"]
  d_energy = models.BernoulliEnergy(
      list(range(n)), initializer=nn.RandomNormal(0.0, 0.3, seed=11),
      device=device)
  d_e_inf = ebm.BernoulliEnergyInference(
      d_energy, cfg["data_samples"], initial_seed=6, exact=exact,
      max_unique_samples=cfg["data_max_unique"], device=device)
  d_circuit = models.DirectQuantumCircuit(
      models.hardware_efficient_ansatz(n, cfg["data_layers"], name="data_p"),
      initializer=nn.RandomUniform(0, 2, seed=12), device=device)
  data = qhbm_data.QHBMData(qhbm.QHBM(d_e_inf,
                                      qnn.AnalyticQuantumInference(d_circuit)))
  h = _bench_model(cfg, device, exact)
  loss_fn = qmhl_loss.make_qmhl(data, h)
  opt = torch.optim.Adam(h.parameters(), lr=1e-2)

  def train_step():
    opt.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    grads = flat_grads(h)
    opt.step()
    for p in data.qhbm.parameters():
      p.grad = None
    return loss.detach(), grads

  return h, data, train_step


def generators(h: qhbm.QHBM, other):
  """The EBM generators a step draws from: the model's, then the data's
  for a QMHL step (`other` a QHBMData)."""
  gens = [h.e_inference.generator]
  if isinstance(other, qhbm_data.QHBMData):
    gens.append(other.qhbm.e_inference.generator)
  return gens


def run_workload(name: str, cfg, steps: int, device, traj=None,
                 build=build_train_step) -> float:
  """Steps/s of `steps` train steps (`build`: `build_train_step` or
  `build_qmhl_step`) after one warm-up, host clock ending in a synchronize.

  With `traj` (a dict) it records the gate's trajectory: the model and
  its target or data, and for every timed step its input (parameters, the
  states of the EBM generators it draws from) and its output (loss, flat
  gradient), copied to the host after the timing."""
  h, other, train_step = build(cfg, device)
  t0 = time.perf_counter()
  loss, _ = train_step()
  log(f"[bench:{name}] warm-up step (builds the kernels if unbuilt): "
      f"{time.perf_counter() - t0:.2f} s, loss {float(loss):.6f}")
  gens = generators(h, other)
  snaps, losses, grads = [], [], []
  t0 = time.perf_counter()
  for _ in range(steps):
    if traj is not None:
      snaps.append(([p.detach().clone() for p in h.parameters()],
                    [g.get_state() for g in gens]))
    loss, g = train_step()
    if traj is not None:
      losses.append(loss)
      grads.append(g)
  _sync(device)
  dt = time.perf_counter() - t0
  if traj is not None:
    traj.update(model=h, other=other, snaps=snaps,
                losses=[float(x) for x in losses],
                grads=[g.cpu() for g in grads])
  log(f"[bench:{name}] {steps} steps in {dt:.3f} s -> {steps / dt:.4f} "
      f"steps/s (final loss {float(loss):.6f})")
  return steps / dt


def plain_loss(h: qhbm.QHBM, other, beta: float = BETA):
  """The step's loss through the kernels' plain versions: the QNN that
  evaluates the circuits rebuilt with `plain=True` -- the model's for VQT
  (`other` the target, at `beta`), the data's for QMHL (`other` a
  QHBMData) -- or, for QMHL on a ThermalStateData, a copy of the data with
  `plain=True` (the same eigenvectors)."""
  if isinstance(other, thermal_data.ThermalStateData):
    data = copy.copy(other)
    data.plain = True
    return qmhl_loss.make_qmhl(data, h)
  if isinstance(other, qhbm_data.QHBMData):
    d = other.qhbm
    data = qhbm_data.QHBMData(qhbm.QHBM(d.e_inference,
                                        qnn.AnalyticQuantumInference(
                                            d.q_inference.circuit,
                                            plain=True)))
    return qmhl_loss.make_qmhl(data, h)
  plain = qhbm.QHBM(h.e_inference, qnn.AnalyticQuantumInference(
      h.q_inference.circuit, plain=True))
  loss_fn = vqt_loss.make_vqt(plain, other)
  return lambda: loss_fn(beta)


def precision_gate(traj) -> dict:
  """Kernels against plain versions at the trajectory's recorded points.

  Each point's (parameters, generator states) is restored and the step's
  loss and gradient recomputed with `plain=True`: both arms see the same
  parameters and the same EBM supports, so every difference is the
  kernels' rounding against the plain PyTorch ops.  `traj["plain_loss"]`,
  where given, is the reference arm's loss in place of `plain_loss`'s (a
  step at another beta, or another engine named by `traj["reference"]`).
  The reference arm's gradients are left in `traj["plain_grads"]`."""
  h = traj["model"]
  loss_fn = traj.get("plain_loss") or plain_loss(h, traj["other"])
  reference = traj.get("reference", "plain")
  gens = generators(h, traj["other"])
  traj["plain_grads"] = []
  loss_err = grad_rel = 0.0
  for (params, states), loss_k, grad_k in zip(traj["snaps"], traj["losses"],
                                              traj["grads"]):
    with torch.no_grad():
      for p, v in zip(h.parameters(), params):
        p.copy_(v)
    for gen, state in zip(gens, states):
      gen.set_state(state)
    for p in h.parameters():
      p.grad = None
    loss = loss_fn()
    loss.backward()
    grad_p = flat_grads(h).cpu().double()
    traj["plain_grads"].append(grad_p)
    loss_err = max(loss_err, abs(loss_k - float(loss.detach())))
    grad_rel = max(grad_rel, float(
        torch.linalg.vector_norm(grad_k.double() - grad_p) /
        max(float(torch.linalg.vector_norm(grad_p)), 1e-12)))
  out = {"gate_loss_err": loss_err, "gate_grad_rel_err": grad_rel,
         "gate_reference": reference,
         "gate_trajectory_steps": len(traj["snaps"])}
  log(f"[bench:gate] kernels vs {reference} at {out['gate_trajectory_steps']} "
      f"identical (params, generator state) points: max loss err "
      f"{loss_err:.3e}, max grad rel err {grad_rel:.3e} (gate "
      f"{GRAD_REL_GATE:.0e})")
  return out


def measure_oracle_forward_err(cfg, device) -> dict:
  """The engine's TFIM <H> against the float64 C++ oracle
  (`native_oracle.simulate` + `expectation_f64`) for one basis-state-
  prepared, circuit-evolved state at cfg's shape (bench.py:436-472)."""
  n = cfg["n"]
  circuit = models.hardware_efficient_ansatz(n, cfg["layers"])
  rng = np.random.RandomState(3)
  values = rng.uniform(0, 2, circuit.num_symbols).astype(np.float32)
  bits = rng.randint(0, 2, size=(1, n)).astype(np.int8)
  target = paulis.tfim_1d(n, device=device)
  with torch.no_grad():
    got = float(adjoint.batched_expectations(
        circuit, torch.from_numpy(values).to(device),
        torch.from_numpy(bits).to(device), (target,))[0, 0])
  psi = native_oracle.simulate(circuit, values.astype(np.float64),
                               bits=bits[0])
  want = native_oracle.expectation_f64(psi, target)
  err = abs(got - want)
  log(f"[bench:accuracy] {n}q forward <H> {got:.8f}, f64 oracle {want:.8f}, "
      f"abs err {err:.3e}")
  return {"forward_h": got, "forward_h_f64_oracle": want,
          "forward_h_abs_err": err,
          "forward_h_rel_err": err / max(abs(want), 1e-12)}


def measure_qmhl_oracle_err(cfg, device) -> dict:
  """The QMHL step's forward shard expectations <Z_i> of one basis state
  through the data circuit + the model's dagger (every gate of the dagger
  at coeff -1) against the float64 C++ oracle, at cfg's shape with the
  seeded initial weights: relative L2 and max abs error over the shards."""
  n = cfg["n"]
  h, data, _ = build_qmhl_step(cfg, device)
  k = h.modular_hamiltonian
  total = data.qhbm.q_inference.circuit + k.circuit_dagger
  bits = np.random.RandomState(5).randint(0, 2, size=(1, n)).astype(np.int8)
  with torch.no_grad():
    values = total.resolved_values()
    got = adjoint.batched_expectations(
        total.pqc, values, torch.from_numpy(bits).to(device),
        k.operator_shards)[0].cpu().double()
  psi = native_oracle.simulate(total.pqc, hopper_sv.host_values(values)
                               .astype(np.float64), bits=bits[0])
  want = torch.tensor([native_oracle.expectation_f64(psi, op)
                       for op in k.operator_shards], dtype=torch.float64)
  rel = float(torch.linalg.vector_norm(got - want) /
              torch.linalg.vector_norm(want))
  out = {"qmhl_shards_rel_err": rel,
         "qmhl_shards_max_abs_err": float((got - want).abs().max())}
  log(f"[bench:accuracy] qmhl {n}q forward <Z_i> ({len(want)} shards, "
      f"{total.pqc.num_gates} gates) vs f64 oracle: rel err {rel:.3e}, max "
      f"abs err {out['qmhl_shards_max_abs_err']:.3e}")
  return out


def measure_pauli_expectations(cfg, device, iters: int = 16) -> float:
  """PauliSum expectations/s (bench.py:288-331): one expectation is <H>
  of the TFIM for one basis-state-prepared, circuit-evolved state; `iters`
  chained forwards of cfg's unique-state count, each nudging the
  parameters by 1e-9 * mean(<H>), best of 3 after a warm-up."""
  n, batch = cfg["n"], cfg["max_unique"]
  target = paulis.tfim_1d(n, device=device)
  circuit = models.DirectQuantumCircuit(
      models.hardware_efficient_ansatz(n, cfg["layers"]),
      initializer=nn.RandomUniform(0, 2, seed=3), device=device)
  q_inf = qnn.AnalyticQuantumInference(circuit)
  bits = torch.from_numpy(np.random.RandomState(2).randint(
      0, 2, (batch, n)).astype(np.int8)).to(device)
  phi = circuit.values.detach().clone()

  @torch.no_grad()
  def run():
    circuit.values.copy_(phi)
    outs = []
    for _ in range(iters):
      mean = q_inf.expectation(bits, target, dedup=False).mean()
      circuit.values.add_(mean * 1e-9)
      outs.append(mean)
    return torch.stack(outs)

  run()
  _sync(device)
  best = float("inf")
  for _ in range(3):
    t0 = time.perf_counter()
    run()
    _sync(device)
    best = min(best, time.perf_counter() - t0)
  eps = iters * batch / best
  log(f"[bench:{n}q] {iters}x{batch} PauliSum expectations in {best:.3f} s "
      f"-> {eps:.1f} expectations/s")
  return eps


def run_independent_anchor(cfg) -> float:
  """Steps/s of the workload's quantum step through the independent C++
  simulator (`native/fast_sim.cc`, one core): forward, TFIM <H> and adjoint
  gradient for each unique state (bench.py:475-495).  It omits the
  classical EBM / Adam arithmetic, so it overstates the CPU's rate."""
  circuit = models.hardware_efficient_ansatz(cfg["n"], cfg["layers"])
  rng = np.random.RandomState(0)
  values = rng.uniform(0, 2, circuit.num_symbols)
  zz, xs = native_fast.split_pauli_terms(paulis.tfim_1d(cfg["n"],
                                                        device="cpu"))
  bits = rng.randint(0, 2, size=(cfg["max_unique"], cfg["n"]))
  return 1.0 / native_fast.step_seconds(circuit, values, zz, xs, bits,
                                        repeats=2)


def independent_steps_per_sec(name: str, cfg) -> float:
  """`run_independent_anchor`, cached in INDEPENDENT_CACHE keyed on the
  config and the simulator's artifact key (source, flags, host CPU)."""
  src = native_fast.artifact_key()
  cache = (json.loads(INDEPENDENT_CACHE.read_text())
           if INDEPENDENT_CACHE.exists() else {})
  entry = cache.get(name)
  if entry and entry["config"] == cfg and entry["src"] == src:
    log(f"[bench:{name}] cached independent C++ anchor: "
        f"{entry['steps_per_sec']:.6f} steps/s")
    return entry["steps_per_sec"]
  log(f"[bench:{name}] measuring the independent C++ anchor (minutes)...")
  sps = run_independent_anchor(cfg)
  cache[name] = {"config": cfg, "src": src, "steps_per_sec": sps}
  INDEPENDENT_CACHE.parent.mkdir(parents=True, exist_ok=True)
  INDEPENDENT_CACHE.write_text(json.dumps(cache, indent=1))
  return sps


def card(device: torch.device):
  """The first card's `nvidia-smi --query-gpu=name,power.limit` line, or
  None off the card."""
  if device.type != "cuda":
    return None
  out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def run_bench(device, steps: int = 8, independent: bool = False,
              workloads=WORKLOADS, path=contextlib.nullcontext) -> dict:
  """Every measurement of the bench; returns its JSON object.

  `path(name)` is a context manager entered around each main path ("train
  24q", "train 20q", "train qmhl 24q", "pauli 20q", "probe");
  `chip_smoke.py` counts the kernels' launches with it."""
  if steps < 1:
    raise ValueError(f"steps must be >= 1, not {steps}")
  device = torch.device(device)
  torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products, both arms
  torch.backends.cudnn.allow_tf32 = False
  w24, w20 = workloads["24q"], workloads["20q"]
  traj = {}
  with path("train 24q"):
    sps24 = run_workload("24q", w24, steps, device, traj)
  with path("train 20q"):
    sps20 = run_workload("20q", w20, steps, device)
  # QMHL: the 24q workload's model learning r5's data.
  w_qmhl, traj_qmhl = {**w24, **QMHL_DATA}, {}
  with path("train qmhl 24q"):
    sps_qmhl = run_workload("qmhl 24q", w_qmhl, steps, device, traj_qmhl,
                            build=build_qmhl_step)
  extra = {"steps_per_sec_20q": sps20}
  extra.update(precision_gate(traj))
  extra.update(measure_oracle_forward_err(w24, device))
  extra["qmhl_steps_per_sec_24q"] = sps_qmhl
  extra.update({f"qmhl_{k}": v for k, v in precision_gate(traj_qmhl).items()})
  extra.update(measure_qmhl_oracle_err(w_qmhl, device))
  with path("pauli 20q"):
    extra["pauli_expectations_per_sec_20q"] = measure_pauli_expectations(
        w20, device)
  with path("probe"):
    extra["hbm_probe"] = hbm_probe.measure(w24["n"], device=device)
  if independent:
    indep = independent_steps_per_sec("24q", w24)
    extra["cpu_independent_steps_per_sec"] = indep
    extra["vs_independent"] = sps24 / indep
  extra.update(
      steps=steps, workload=w24, workload_20q=w20, workload_qmhl=w_qmhl,
      device=(torch.cuda.get_device_name(device) if device.type == "cuda"
              else str(device)),
      card=card(device))
  return {"metric": "vqt_train_steps_per_sec_24q", "value": sps24,
          "unit": "steps/s", "extra": extra}


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--steps", type=int, default=8,
                 help="timed train steps per workload (and gate points)")
  p.add_argument("--independent", action="store_true",
                 help="also measure the 24q C++ anchor (minutes, cached)")
  args = p.parse_args(argv)
  result = run_bench(device_lib.resolve(), args.steps, args.independent)
  print(json.dumps(result), flush=True)


if __name__ == "__main__":
  main()
