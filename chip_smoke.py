"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the CUDA kernels of `qhbmlib_tpu_torch/csrc/` with nvcc, holds each
kernel against its plain PyTorch version at the shapes of the 20-qubit
workload, holds the batched forward (K4 port) and reverse sweep (K5 port)
against their plain versions, then runs the 20-qubit / 4-layer VQT train
step (500 samples, 64 unique states, TFIM target, beta = 1.2, Adam 1e-2) for
a warm-up and three timed steps on cuda:0.  Before the last line it prints a
JSON line {"kernels": [...]} with each kernel's launches during the train
steps, its error against the plain version, and both times; the last line
is {"ok": true, "device": {...}}.  It exits non-zero without a CUDA device,
and on any failed check.  Imports no jax.
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
  r, c = sv.state_shape(N_QUBITS)
  dgen = torch.Generator(device=device).manual_seed(SEED)
  planes = [torch.randn((BATCH, r, c), generator=dgen, device=device)
            for _ in range(4)]
  return pqc, values, stages, planes


def phase_kernels(device):
  """Each kernel against its plain version at the 20q main-path shapes."""
  from qhbmlib_tpu_torch.ops import hopper_adjoint as ha
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  from qhbmlib_tpu_torch.ops import statevector as sv
  pqc, _, stages, (x_re, x_im, l_re, l_im) = main_path_operands(device)
  b, r, c = x_re.shape
  # First layer: rowblock (0,7), rowblock (7,6), minor, diag.
  ops1q = [s for s in stages[:4] if s[0] != "diag"]
  cos_t, sin_t = next(s for s in stages if s[0] == "diag")[2]
  shapes = []
  for kind, meta, ops in ops1q:
    if kind == "rowblock":
      start, k = meta
      shapes.append(((b << start, 2**k, (r * c) >> (start + k)), ops))
    else:
      shapes.append(((b * r, c, 1), ops))
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
          "axis_gram": ha.axis_gram, "parity_bilinear": ha.parity_bilinear}


def phase_train(device):
  """Warm-up plus STEPS timed 20q/4L VQT train steps; returns (launches,
  step times in ms)."""
  h, loss_fn = build_vqt(device, N_QUBITS, LAYERS, SAMPLES, MAX_UNIQUE)
  opt = torch.optim.Adam(h.parameters(), lr=1e-2)
  wrappers = kernel_wrappers()
  for fn in wrappers.values():
    fn.launches = 0
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
    log(f"[train] step {step}{' (warm-up)' if step == 0 else ''}: loss "
        f"{float(loss.detach()):.6f}, |grad| {grad_norm:.4e}, "
        f"{start.elapsed_time(end):.2f} ms")
    if not finite:
      raise AssertionError(f"step {step}: non-finite loss or gradient")
    if step > 0:
      times.append(start.elapsed_time(end))
  launches = {name: fn.launches for name, fn in wrappers.items()}
  log(f"[train] kernel launches over {STEPS + 1} steps: {launches}")
  for name, count in launches.items():
    if count <= 0:
      raise AssertionError(f"kernel {name} never launched on the main path")
  return launches, times


SOURCE = "qhbmlib_tpu_torch/csrc/statevector_kernels.cu"
REPLACES = {
    "axis_apply": "qhbmlib_tpu/ops/pallas_sv.py:459",
    "diag_rotate": "qhbmlib_tpu/ops/pallas_sv.py:459",
    "axis_gram": "qhbmlib_tpu/ops/pallas_adjoint.py:540",
    "parity_bilinear": "qhbmlib_tpu/ops/pallas_adjoint.py:540",
}


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

  report = phase_kernels(device)
  phase_end_to_end(device)
  phase_small_reference(device)
  launches, times = phase_train(device)
  mean_ms = sum(times) / len(times)
  log(f"[train] {N_QUBITS}q/{LAYERS}L/{SAMPLES} samples/{MAX_UNIQUE} unique: "
      f"mean step {mean_ms:.2f} ms over {STEPS} steps "
      f"({', '.join(f'{t:.2f}' for t in times)}) on {card}")
  kernels = [{
      "name": name, "route": "cuda", "source": SOURCE,
      "replaces": REPLACES[name], "launches": launches[name],
      "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
      "plain_ms": rec["plain_ms"]} for name, rec in report.items()]
  print(json.dumps({"kernels": kernels}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
