"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the CUDA kernels of `qhbmlib_tpu_torch/csrc/` with nvcc and holds
each of the seven against its plain PyTorch version: `axis_apply`,
`diag_rotate`, `axis_gram`, `parity_bilinear` at the 20-qubit shapes;
`axis2_apply` (K1) at the 24- and 20-qubit pass shapes; `circuit_forward`
(K3) and `adjoint_sweep` (K2) at 20q/4L for one random state.  Then it
holds the batched forward and sweep against their plain versions and the
9-qubit VQT loss and single-state `adjoint.expectation` against the CPU,
and drives the main paths, each with every launch count reset just
before it: the VQT train step (TFIM target, beta = 1.2, Adam 1e-2) at
20q/4L/500 samples/64 unique and 24q/2L/100/8 for a warm-up and three
timed steps, and three single-state value-and-gradient calls at 20q/4L.
Before the last line it prints a JSON line {"kernels": [...]} with each
kernel's launches on the main paths, its error against the plain version,
and both times; the last line is {"ok": true, "device": {...}}.  It exits
non-zero without a CUDA device, and on any failed check.  Imports no jax.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_QUBITS = 20
LAYERS = 4
SAMPLES = 500
MAX_UNIQUE = 64
BETA = 1.2
BATCH = 8  # states in the kernel and K4/K5 comparisons
STEPS = 3
SEED = 0
# The JAX bench's 24-qubit workload (bench.py:50): 2 layers, 100 samples,
# 8 unique states.
N24 = 24
LAYERS24 = 2
SAMPLES24 = 100
MAX_UNIQUE24 = 8
SINGLE_CALLS = 3  # single-state value-and-gradient calls at 20q/4L
# ||kernel - plain||_2 / ||plain||_2 limits.  States: both versions are fp32
# with the same products in another summation order.  Grams and bilinears
# sum ~10^5-10^6 products per entry, so their order differs more.
STATE_TOL = 1e-5
REDUCTION_TOL = 1e-4
GRAD_TOL = 1e-4


def log(msg: str) -> None:
  print(msg, flush=True)


def rel_err(x, ref) -> float:
  x = torch.as_tensor(x, dtype=torch.float64)
  ref = torch.as_tensor(ref, dtype=torch.float64)
  return float(torch.linalg.vector_norm(x - ref) /
               torch.linalg.vector_norm(ref).clamp_min(1e-30))


def max_abs(x, ref) -> float:
  return float((torch.as_tensor(x) - torch.as_tensor(ref)).abs().max())


def cuda_ms(fn, reps: int = 10) -> float:
  """Mean milliseconds of fn() over `reps` runs after a warm-up, by CUDA
  events on the current stream."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def check(name: str, err: float, tol: float) -> None:
  status = "ok" if err <= tol else "FAIL"
  log(f"[check] {name}: rel err {err:.3e} (tol {tol:.0e}) {status}")
  if not err <= tol:
    raise AssertionError(f"{name}: relative error {err} > {tol}")


def main_path_operands(device):
  """Real operators of the first [1q, diag] layer of the 20q/4L ansatz with
  seeded angles, and seeded random state planes [B, R, C]."""
  from qhbmlib_tpu_torch.models import circuit_utils
  from qhbmlib_tpu_torch.ops import hopper_sv
  from qhbmlib_tpu_torch.ops import statevector as sv
  pqc = circuit_utils.hardware_efficient_ansatz(N_QUBITS, LAYERS)
  gen = torch.Generator().manual_seed(SEED)
  values = torch.rand(pqc.num_symbols, generator=gen) * 2.0
  stages = hopper_sv.prepare_segments(pqc, values, device)
  ops = hopper_sv.forward_plan(pqc, values)[0][1]  # the first 1q segment
  moved = iter(hopper_sv.to_device(
      [t for _, op in ops for t in hopper_sv.split(op)], device))
  ops = [(bits, (next(moved), next(moved))) for bits, _ in ops]
  r, c = sv.state_shape(N_QUBITS)
  dgen = torch.Generator(device=device).manual_seed(SEED)
  planes = [torch.randn((BATCH, r, c), generator=dgen, device=device)
            for _ in range(4)]
  return pqc, values, stages, ops, planes


def phase_kernels(device):
  """Each kernel against its plain version at the 20q main-path shapes."""
  from qhbmlib_tpu_torch.ops import hopper_adjoint as ha
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  from qhbmlib_tpu_torch.ops import statevector as sv
  pqc, _, stages, ops1q, (x_re, x_im, l_re, l_im) = main_path_operands(
      device)
  b = x_re.shape[0]
  # First layer: rowblock (0,7), rowblock (7,6), minor, then diag.
  cos_t, sin_t = next(body for kind, body in stages if kind == "diag")
  shapes = [((b << s, 2**k, 2**(N_QUBITS - s - k)), ops)
            for (s, k), ops in ops1q]
  report = {}

  def apply_all(fn):
    return [fn(x_re, x_im, ops[0], ops[1], *pnq) for pnq, ops in shapes]

  got, ref = apply_all(hs.axis_apply), apply_all(hs.axis_apply_plain)
  err = max(rel_err(torch.cat([g[0], g[1]]), torch.cat([f[0], f[1]]))
            for g, f in zip(got, ref))
  check("axis_apply (rowblock 0:7, rowblock 7:6, minor)", err, STATE_TOL)
  report["axis_apply"] = dict(
      err=err, max_abs_err=max(max_abs(torch.cat(g), torch.cat(f))
                               for g, f in zip(got, ref)),
      ms=cuda_ms(lambda: apply_all(hs.axis_apply)),
      plain_ms=cuda_ms(lambda: apply_all(hs.axis_apply_plain)))

  def rot(fn, states):
    fn(states, cos_t, sin_t, -1)
    return states

  two = [(x_re.clone(), x_im.clone()), (l_re.clone(), l_im.clone())]
  two_ref = [(x_re.clone(), x_im.clone()), (l_re.clone(), l_im.clone())]
  got = torch.cat([t for p in rot(hs.diag_rotate, two) for t in p])
  ref = torch.cat([t for p in rot(hs.diag_rotate_plain, two_ref) for t in p])
  err = rel_err(got, ref)
  check("diag_rotate (a and lambda, sign -1)", err, STATE_TOL)
  one = [(x_re.clone(), x_im.clone())]
  report["diag_rotate"] = dict(
      err=err, max_abs_err=max_abs(got, ref),
      ms=cuda_ms(lambda: hs.diag_rotate(one, cos_t, sin_t, +1)),
      plain_ms=cuda_ms(lambda: hs.diag_rotate_plain(one, cos_t, sin_t, +1)))

  def gram_all(fn):
    return [fn(l_re, l_im, x_re, x_im, *pnq) for pnq, _ in shapes]

  got, ref = gram_all(ha.axis_gram), gram_all(ha.axis_gram_plain)
  err = max(rel_err(torch.cat([g[0], g[1]]), torch.cat([f[0], f[1]]))
            for g, f in zip(got, ref))
  check("axis_gram (G block 0:7, G block 7:6, kmat)", err, REDUCTION_TOL)
  report["axis_gram"] = dict(
      err=err, max_abs_err=max(max_abs(torch.cat(g), torch.cat(f))
                               for g, f in zip(got, ref)),
      ms=cuda_ms(lambda: gram_all(ha.axis_gram)),
      plain_ms=cuda_ms(lambda: gram_all(ha.axis_gram_plain)))

  nr = N_QUBITS - sv.minor_bits(N_QUBITS)
  diag_gates = [pqc.gates[i] for cls, idxs in sv.segment_circuit(pqc.gates)
                if cls == "diag" for i in idxs][:2 * N_QUBITS - 1]
  _, rms, cms, _ = sv.diag_segment_triples(diag_gates, nr,
                                           sv.minor_bits(N_QUBITS))
  log(f"[kernels] parity factors of a 20q diag segment: K = {len(rms)}")
  args = (l_re, l_im, x_re, x_im, rms, cms)
  got, ref = ha.parity_bilinear(*args), ha.parity_bilinear_plain(*args)
  err = rel_err(got, ref)
  check(f"parity_bilinear (K={len(rms)})", err, REDUCTION_TOL)
  report["parity_bilinear"] = dict(
      err=err, max_abs_err=max_abs(got, ref),
      ms=cuda_ms(lambda: ha.parity_bilinear(*args)),
      plain_ms=cuda_ms(lambda: ha.parity_bilinear_plain(*args)))
  for name, rec in report.items():
    log(f"[kernels] {name}: kernel {rec['ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f} ms, max abs err {rec['max_abs_err']:.3e}")
  return report


def phase_end_to_end(device, n=N_QUBITS, layers=LAYERS, batch=BATCH):
  """K4 forward and K5 sweep against their plain versions."""
  from qhbmlib_tpu_torch.models import circuit_utils
  from qhbmlib_tpu_torch.ops import adjoint
  from qhbmlib_tpu_torch.ops import hopper_adjoint
  from qhbmlib_tpu_torch.ops import hopper_sv
  from qhbmlib_tpu_torch.ops import paulis
  from qhbmlib_tpu_torch.ops import statevector as sv
  pqc = circuit_utils.hardware_efficient_ansatz(n, layers)
  gen = torch.Generator().manual_seed(SEED + 1)
  values = (torch.rand(pqc.num_symbols, generator=gen) * 2.0).to(device)
  bits = torch.randint(0, 2, (batch, n), generator=gen, dtype=torch.int8)
  rowcol = adjoint.bits_to_rowcol(bits.to(device), n)
  psi = hopper_sv.apply_circuit_batched(pqc, values, rowcol)
  psi_ref = hopper_sv.apply_circuit_batched(pqc, values, rowcol, plain=True)
  check(f"K4 apply_circuit_batched {n}q/{layers}L B={batch}",
        rel_err(torch.cat(psi), torch.cat(psi_ref)), STATE_TOL)
  op = paulis.tfim_1d(n)
  g = torch.rand((batch, op.num_terms), generator=gen).to(device) - 0.5
  lam = sv.apply_pauli_sum(torch.complex(*psi_ref), op, term_weights=g)
  lam = (lam.real.contiguous(), lam.imag.contiguous())
  grad = hopper_adjoint.adjoint_sweep_batched(pqc, values, psi_ref, lam)
  grad_ref = hopper_adjoint.adjoint_sweep_batched(pqc, values, psi_ref, lam,
                                                  plain=True)
  if not bool(torch.isfinite(grad).all()):
    raise AssertionError("K5 gradient is not finite")
  check(f"K5 adjoint_sweep_batched {n}q/{layers}L B={batch} gradient",
        rel_err(grad.cpu(), grad_ref.cpu()), GRAD_TOL)


def build_vqt(device, n, layers, samples, max_unique, exact=False):
  """The bench's VQT model (bench.py build_train_step), built with the
  port, with seeded random weights."""
  from qhbmlib_tpu_torch import models, nn
  from qhbmlib_tpu_torch.inference import ebm, qhbm, qnn, vqt_loss
  from qhbmlib_tpu_torch.ops import paulis
  target = paulis.tfim_1d(n, device=device)
  energy = models.BernoulliEnergy(
      list(range(n)), initializer=nn.RandomUniform(seed=SEED + 2),
      device=device)
  e_inf = ebm.BernoulliEnergyInference(energy, samples, initial_seed=11,
                                       exact=exact,
                                       max_unique_samples=max_unique,
                                       device=device)
  circuit = models.DirectQuantumCircuit(
      models.hardware_efficient_ansatz(n, layers),
      initializer=nn.RandomUniform(0, 2, seed=SEED + 3), device=device)
  h = qhbm.QHBM(e_inf, qnn.AnalyticQuantumInference(circuit))
  return h, vqt_loss.make_vqt(h, target)


def loss_and_grads(h, loss_fn):
  for p in h.parameters():
    p.grad = None
  loss = loss_fn(BETA)
  loss.backward()
  return loss.detach(), [p.grad.detach().clone() for p in h.parameters()]


def phase_small_reference(device):
  """The port's VQT loss and gradients at 9q on the card against the same
  model on the CPU (plain versions), with the exact EBM support."""
  h_dev, f_dev = build_vqt(device, 9, 2, SAMPLES, None, exact=True)
  h_cpu, f_cpu = build_vqt("cpu", 9, 2, SAMPLES, None, exact=True)
  l_dev, g_dev = loss_and_grads(h_dev, f_dev)
  l_cpu, g_cpu = loss_and_grads(h_cpu, f_cpu)
  check("9q/2L VQT loss, card vs CPU", rel_err(l_dev.cpu(), l_cpu), 1e-5)
  check("9q/2L VQT gradient, card vs CPU",
        rel_err(torch.cat([g.cpu() for g in g_dev]), torch.cat(g_cpu)),
        GRAD_TOL)


def kernel_wrappers():
  from qhbmlib_tpu_torch.ops import hopper_adjoint as ha
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  return {"axis_apply": hs.axis_apply, "diag_rotate": hs.diag_rotate,
          "axis_gram": ha.axis_gram, "parity_bilinear": ha.parity_bilinear,
          "axis2_apply": hs.axis2_apply,
          "circuit_forward": hs.circuit_forward,
          "adjoint_sweep": ha.adjoint_sweep}


def reset_launches() -> None:
  for fn in kernel_wrappers().values():
    fn.launches = 0


def read_launches(path: str, required) -> dict:
  """The counts since reset_launches(); fails if a kernel of `path` never
  launched."""
  launches = {name: fn.launches for name, fn in kernel_wrappers().items()}
  log(f"[{path}] kernel launches: {launches}")
  for name in required:
    if launches[name] <= 0:
      raise AssertionError(f"{path}: kernel {name} never launched")
  return launches


def phase_train(device, n, layers, samples, max_unique, required):
  """Warm-up plus STEPS timed VQT train steps; returns the launches."""
  h, loss_fn = build_vqt(device, n, layers, samples, max_unique)
  opt = torch.optim.Adam(h.parameters(), lr=1e-2)
  tag = f"train {n}q/{layers}L"
  reset_launches()
  times = []
  for step in range(STEPS + 1):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    opt.zero_grad()
    loss = loss_fn(BETA)
    loss.backward()
    grads = [p.grad for p in h.parameters()]
    opt.step()
    end.record()
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    grad_norm = float(torch.cat(grads).norm())
    log(f"[{tag}] step {step}{' (warm-up)' if step == 0 else ''}: loss "
        f"{float(loss.detach()):.6f}, |grad| {grad_norm:.4e}, "
        f"{start.elapsed_time(end):.2f} ms")
    if not finite:
      raise AssertionError(f"{tag} step {step}: non-finite loss or gradient")
    if step > 0:
      times.append(start.elapsed_time(end))
  launches = read_launches(tag, required)
  log(f"[{tag}] {samples} samples/{max_unique} unique: mean step "
      f"{sum(times) / len(times):.2f} ms over {STEPS} steps "
      f"({', '.join(f'{t:.2f}' for t in times)})")
  return launches


def first_segment_passes(n, device):
  """The K1 passes of the first 1q segment of the n-qubit ansatz, with
  seeded angles, on `device`."""
  from qhbmlib_tpu_torch.models import circuit_utils
  from qhbmlib_tpu_torch.ops import hopper_sv
  from qhbmlib_tpu_torch.ops import statevector as sv
  pqc = circuit_utils.hardware_efficient_ansatz(n, 2)
  values = torch.rand(pqc.num_symbols,
                      generator=torch.Generator().manual_seed(SEED)) * 2.0
  ops = hopper_sv.forward_plan(pqc, values)[0][1]
  return hopper_sv.device_passes(ops, n - sv.minor_bits(n), device)


def phase_k1(device):
  """axis2_apply (K1) against its plain version on the passes of a 1q
  segment at 24q and 20q, B = BATCH; returns the 24q record."""
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  from qhbmlib_tpu_torch.ops import statevector as sv
  report = None
  for n in (N24, N_QUBITS):
    passes = first_segment_passes(n, device)
    pairs = [p for p in passes if len(p) == 4]
    r, c = sv.state_shape(n)
    dgen = torch.Generator(device=device).manual_seed(SEED + n)
    x = [tuple(torch.randn((BATCH, r, c), generator=dgen, device=device)
               for _ in range(2))]

    def run(plain):
      return [hs.apply_pass(p, x, n, plain)[0] for p in pairs]

    got, ref = run(False), run(True)
    err = max(rel_err(torch.cat(g), torch.cat(f)) for g, f in zip(got, ref))
    views = [f"({s1},{k1})x({s2},{k2})" for (s1, k1), _, (s2, k2), _ in pairs]
    check(f"axis2_apply {n}q B={BATCH} passes {' '.join(views)}", err,
          STATE_TOL)
    rec = dict(err=err, max_abs_err=max(max_abs(torch.cat(g), torch.cat(f))
                                        for g, f in zip(got, ref)),
               ms=cuda_ms(lambda: run(False), reps=5),
               plain_ms=cuda_ms(lambda: run(True), reps=5))
    # The same operators one axis_apply pass each, as before K1.
    singles = [(p[0], p[1]) for p in pairs] + [(p[2], p[3]) for p in pairs]
    unfused_ms = cuda_ms(lambda: [hs.apply_pass(p, x, n) for p in singles],
                         reps=5)
    log(f"[kernels] axis2_apply {n}q ({len(pairs)} passes, B={BATCH}): "
        f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, the "
        f"same operators as {len(singles)} axis_apply passes {unfused_ms:.4f}"
        f" ms, max abs err {rec['max_abs_err']:.3e}")
    del got, ref, x
    torch.cuda.empty_cache()
    report = report or rec
  return report


def random_state(n, device, seed):
  """A seeded random normalized [R, C] complex64 state on `device`."""
  from qhbmlib_tpu_torch.ops import statevector as sv
  gen = torch.Generator(device=device).manual_seed(seed)
  st = torch.complex(*(torch.randn(sv.state_shape(n), generator=gen,
                                   device=device) for _ in range(2)))
  return st / torch.linalg.vector_norm(st)


def phase_single_kernels(device):
  """K3 (circuit_forward) and K2 (adjoint_sweep) against their plain
  versions at 20q/4L for one random normalized state; returns both
  records.  A record's `ms` times the cooperative launch alone, on a stage
  table and state buffers built beforehand; `wrapper_ms` times the whole
  wrapper (host stage table, copies, and for K2 the device->host copy and
  the gradient assembly)."""
  from qhbmlib_tpu_torch.models import circuit_utils
  from qhbmlib_tpu_torch.ops import hopper_adjoint as ha
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  from qhbmlib_tpu_torch.ops import paulis
  from qhbmlib_tpu_torch.ops import statevector as sv
  n = N_QUBITS
  pqc = circuit_utils.hardware_efficient_ansatz(n, LAYERS)
  gen = torch.Generator().manual_seed(SEED + 4)
  values = torch.rand(pqc.num_symbols, generator=gen) * 2.0
  x = random_state(n, device, SEED + 5)
  planes = (x.real.contiguous(), x.imag.contiguous())
  got = hs.circuit_forward(pqc, values, planes)
  ref = hs.circuit_forward(pqc, values, planes, plain=True)
  err = rel_err(torch.cat(got), torch.cat(ref))
  check(f"circuit_forward (K3) {n}q/{LAYERS}L", err, STATE_TOL)
  table, buf = hs.forward_table(pqc, values, device), hs.state_buffer(planes)
  blocks = hs.sweep_blocks(device, 1)
  k3 = dict(err=err, max_abs_err=max_abs(torch.cat(got), torch.cat(ref)),
            ms=cuda_ms(lambda: hs.launch_circuit_forward(table, buf, blocks)),
            wrapper_ms=cuda_ms(lambda: hs.circuit_forward(pqc, values,
                                                          planes)),
            plain_ms=cuda_ms(lambda: hs.circuit_forward(pqc, values, planes,
                                                        plain=True)))
  op = paulis.tfim_1d(n, device=device)
  g = torch.rand(op.num_terms, generator=gen).to(device) - 0.5
  ones = paulis.PauliSum(op.codes, torch.ones_like(op.coeffs), n)
  lam = sv.apply_pauli_sum(torch.complex(*ref), ones, term_weights=g)
  lam = (lam.real.contiguous(), lam.imag.contiguous())
  grad = ha.adjoint_sweep(pqc, values, ref, lam)
  grad_ref = ha.adjoint_sweep(pqc, values, ref, lam, plain=True)
  if not bool(torch.isfinite(grad).all()):
    raise AssertionError("K2 gradient is not finite")
  err = rel_err(grad.cpu(), grad_ref.cpu())
  check(f"adjoint_sweep (K2) {n}q/{LAYERS}L gradient, TFIM", err, GRAD_TOL)
  table, _, _ = ha.sweep_table(pqc, values, device)
  bufs = hs.state_buffer(ref), hs.state_buffer(lam)
  blocks = hs.sweep_blocks(device, 2)
  k2 = dict(err=err, max_abs_err=max_abs(grad.cpu(), grad_ref.cpu()),
            ms=cuda_ms(lambda: ha.launch_adjoint_sweep(table, *bufs, blocks)),
            wrapper_ms=cuda_ms(lambda: ha.adjoint_sweep(pqc, values, ref,
                                                        lam), reps=5),
            plain_ms=cuda_ms(lambda: ha.adjoint_sweep(pqc, values, ref, lam,
                                                      plain=True), reps=5))
  for name, rec in (("circuit_forward", k3), ("adjoint_sweep", k2)):
    log(f"[kernels] {name} {n}q/{LAYERS}L: kernel {rec['ms']:.4f} ms (the "
        f"launch alone; the whole wrapper {rec['wrapper_ms']:.4f} ms), plain "
        f"{rec['plain_ms']:.4f} ms, max abs err {rec['max_abs_err']:.3e}")
  return k3, k2


def phase_long_diag(device, n=9, reps=10):
  """K3 and K2 against their plain versions on a diagonal segment of more
  parity factors than one stage record holds (reps all-to-all symbolic CZ
  layers: 4 factors a gate), which the stage table splits."""
  from qhbmlib_tpu_torch.ops import circuit_ir
  from qhbmlib_tpu_torch.ops import hopper_adjoint as ha
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  from qhbmlib_tpu_torch.ops import paulis
  from qhbmlib_tpu_torch.ops import statevector as sv
  b = circuit_ir.CircuitBuilder(n)
  for q in range(n):
    b.rx(q, f"x{q}")
  for r in range(reps):
    for i in range(n):
      for j in range(i + 1, n):
        b.cz(i, j, f"c{r}")
  for q in range(n):
    b.ry(q, f"y{q}")
  pqc = b.build()
  gen = torch.Generator().manual_seed(SEED + 7)
  values = torch.rand(pqc.num_symbols, generator=gen) * 2.0 - 1.0
  x = random_state(n, device, SEED + 8)
  planes = (x.real.contiguous(), x.imag.contiguous())
  got = hs.circuit_forward(pqc, values, planes)
  ref = hs.circuit_forward(pqc, values, planes, plain=True)
  k = 4 * reps * n * (n - 1) // 2
  check(f"circuit_forward (K3) {n}q, one diag segment of K={k} > "
        f"{hs.MAX_FACTORS}", rel_err(torch.cat(got), torch.cat(ref)),
        STATE_TOL)
  op = paulis.tfim_1d(n, device=device)
  g = torch.rand(op.num_terms, generator=gen).to(device) - 0.5
  ones = paulis.PauliSum(op.codes, torch.ones_like(op.coeffs), n)
  lam = sv.apply_pauli_sum(torch.complex(*ref), ones, term_weights=g)
  lam = (lam.real.contiguous(), lam.imag.contiguous())
  grad = ha.adjoint_sweep(pqc, values, ref, lam)
  grad_ref = ha.adjoint_sweep(pqc, values, ref, lam, plain=True)
  check(f"adjoint_sweep (K2) {n}q, K={k} gradient",
        rel_err(grad.cpu(), grad_ref.cpu()), GRAD_TOL)


def single_value_and_grad(device, n, layers, seed):
  """adjoint.expectation of the TFIM and its gradient for one random
  normalized state."""
  from qhbmlib_tpu_torch.models import circuit_utils
  from qhbmlib_tpu_torch.ops import adjoint
  from qhbmlib_tpu_torch.ops import paulis
  pqc = circuit_utils.hardware_efficient_ansatz(n, layers)
  gen = torch.Generator().manual_seed(seed)
  values = (torch.rand(pqc.num_symbols, generator=gen) * 2.0).to(device)
  values.requires_grad_(True)
  state = random_state(n, "cpu", seed).to(device)
  value = adjoint.expectation(pqc, values, state,
                              paulis.tfim_1d(n, device=device))
  value.backward()
  return value.detach(), values.grad.detach()


def phase_single_small(device):
  """adjoint.expectation value and gradient at 9q/2L, card vs CPU."""
  v_dev, g_dev = single_value_and_grad(device, 9, 2, SEED + 6)
  v_cpu, g_cpu = single_value_and_grad("cpu", 9, 2, SEED + 6)
  check("9q/2L adjoint.expectation value, card vs CPU",
        rel_err(v_dev.cpu(), v_cpu), STATE_TOL)
  check("9q/2L adjoint.expectation gradient, card vs CPU",
        rel_err(g_dev.cpu(), g_cpu), GRAD_TOL)


def phase_single_main(device):
  """SINGLE_CALLS single-state value-and-gradient calls at 20q/4L (the
  single-state engine's main path: K3 forward, K2 sweep)."""
  reset_launches()
  for call in range(SINGLE_CALLS):
    t0 = time.time()
    value, grad = single_value_and_grad(device, N_QUBITS, LAYERS,
                                        SEED + 10 + call)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    if not (bool(torch.isfinite(value)) and bool(torch.isfinite(grad).all())):
      raise AssertionError(f"single-state call {call}: non-finite result")
    log(f"[single {N_QUBITS}q/{LAYERS}L] call {call}: <H> {float(value):.6f}"
        f", |grad| {float(grad.norm()):.4e}, {ms:.2f} ms (host clock)")
  return read_launches(f"single {N_QUBITS}q/{LAYERS}L",
                       ["circuit_forward", "adjoint_sweep"])


SOURCE = "qhbmlib_tpu_torch/csrc/statevector_kernels.cu"
REPLACES = {
    "axis_apply": "qhbmlib_tpu/ops/pallas_sv.py:459",
    "diag_rotate": "qhbmlib_tpu/ops/pallas_sv.py:459",
    "axis_gram": "qhbmlib_tpu/ops/pallas_adjoint.py:540",
    "parity_bilinear": "qhbmlib_tpu/ops/pallas_adjoint.py:540",
    "axis2_apply": "qhbmlib_tpu/ops/pallas_sv.py:615",
    "circuit_forward": "qhbmlib_tpu/ops/pallas_sv.py:667",
    "adjoint_sweep": "qhbmlib_tpu/ops/pallas_adjoint.py:480",
}
BATCHED = ["axis_apply", "diag_rotate", "axis_gram", "parity_bilinear",
           "axis2_apply"]


def kernel_name(entry: str, source: str) -> str:
  """`name<N>` of the kernel whose mangled symbol opens a ptxas entry: the
  source's *_kernel name that the symbol holds as <length><name>."""
  mangled = re.match(r"'(\w+)'", entry).group(1)
  for name in sorted(set(re.findall(r"\b([a-z]\w*_kernel)\b", source))):
    at = mangled.find(f"{len(name)}{name}")
    if at >= 0:
      tmpl = re.match(r"ILi(\d+)", mangled[at + len(str(len(name))) +
                                           len(name):])
      return name + (f"<{tmpl.group(1)}>" if tmpl else "")
  return mangled


def main() -> int:
  if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
          "needs a CUDA device", file=sys.stderr)
    return 1
  from qhbmlib_tpu_torch.ops import _cuda

  torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
  torch.backends.cudnn.allow_tf32 = False
  device = torch.device("cuda:0")
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  card = smi.stdout.strip().splitlines()[0]
  log(card)
  log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
      f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
      f"count {torch.cuda.device_count()}")

  t0 = time.time()
  _cuda.build(verbose=True)
  _cuda.library()
  log(f"[build] nvcc {' '.join(_cuda.NVCC_FLAGS)}: "
      f"{time.time() - t0:.1f} s -> {_cuda.library_path().name}")
  regs = [int(x) for x in re.findall(r"Used (\d+) registers",
                                     _cuda.last_build_log)]
  spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                          _cuda.last_build_log))
  log(f"[build] ptxas: {len(regs)} kernels, at most {max(regs, default=0)} "
      f"registers per thread, {spills} bytes of spill stores")
  source = "".join(src.read_text() for src in _cuda.sources())
  for entry in re.split(r"Compiling entry function ", _cuda.last_build_log)[1:]:
    log(f"[build] ptxas {kernel_name(entry, source)}: "
        f"{re.search(r'Used (\d+) registers', entry).group(1)} registers, "
        f"{re.search(r'(\d+) bytes spill stores', entry).group(1)} bytes "
        "spill stores")

  report = phase_kernels(device)
  report["axis2_apply"] = phase_k1(device)
  report["circuit_forward"], report["adjoint_sweep"] = (
      phase_single_kernels(device))
  phase_end_to_end(device)
  phase_small_reference(device)
  phase_single_small(device)
  phase_long_diag(device)
  # The main paths, each driven with every count at 0 just before it.
  paths = [
      phase_train(device, N_QUBITS, LAYERS, SAMPLES, MAX_UNIQUE, BATCHED),
      # Every 24q operator pairs into an axis2_apply pass: no axis_apply.
      phase_train(device, N24, LAYERS24, SAMPLES24, MAX_UNIQUE24,
                  [k for k in BATCHED if k != "axis_apply"]),
      phase_single_main(device),
  ]
  log(f"[done] on {card}, {time.time() - t0:.1f} s since the build started")
  kernels = [{
      "name": name, "route": "cuda", "source": SOURCE,
      "replaces": REPLACES[name],
      "launches": sum(path[name] for path in paths),
      "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
      "plain_ms": rec["plain_ms"]} for name, rec in report.items()]
  print(json.dumps({"kernels": kernels}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
