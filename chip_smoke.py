"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the CUDA kernels of `qhbmlib_tpu_torch/csrc/` with nvcc (one
process per source, in parallel) and holds each of the ten against its
plain PyTorch version: `axis_apply` (K4) on the three passes of a 20-qubit
1q segment, at the 20q train step's own shape (B = 64, the lone row block
(7,6)), on the minor operator alone and on the lone row blocks (7,1),
(7,2), (7,3) of 15-17 qubits (N = 2, 4, 8: the register-stream route) at
B = 64 and on 16q's at B = 8, those also timed as CUDA-graph replays
(device time); `diag_rotate`, `parity_bilinear` at the 20-qubit shapes;
`axis2_apply` (K1) at the 24- and 20-qubit pass shapes;
`qubit_transitions` (K5's 1q reductions) at 24 and 20 qubits, B = 8 and
64; `circuit_forward` (K3) and `adjoint_sweep` (K2) at 20q/4L and 16q/4L
for one random state, with the cost of one near-empty stage of their
cooperative launch; `parity_bilinear` again at the train steps' own shapes
(24q B=8, 20q B=64); `diag_rotate` (one batch) and the batched sweep's
fused diagonal stage (`parity_bilinear` given the stage's cos/sin planes:
the bilinears and the un-apply of a and lambda in one launch) at the r2
rung's shapes (8q B=256, 11q B=2048, also timed as CUDA-graph replays)
and the VQT steps' (20q B=64, 24q B=8); `stream_scale` (K6) on the
24-qubit plane at each tile size; `flip_apply` and `flip_bilinear` (the
engine's flip class: CXP, XXP, YYP, PROTs with X or Y factors, which no
Pallas kernel takes) on XX across row blocks and across row and column,
CXP, a three-qubit PROT spanning row and column and (24q) YY on column
bits, at 20q B=64 and 24q B=8.  Each kernel is timed beside its plain
version, the one PyTorch call that computes the same function where there
is one (`library_ms`),
and its bound: the larger of its bytes over 3.35 TB/s and its float32
operations over 67 TFLOP/s (H100 SXM), or three times them over 495
TFLOP/s for the contractions on the tensor cores in 3xTF32 (K1, K4 from N
= 16, and the axis stages of K3 / K2 from N = 16, whose other stages count
at the fp32 rate), counted from the shapes it ran on.  Then it holds the
batched forward and sweep against their plain versions, the 9-qubit VQT
and QMHL losses and single-state `adjoint.expectation` against the CPU,
K3 / K2 and the batched engine on a diagonal segment of 1440 parity
factors (over one stage record and over one `parity_bilinear` launch),
the JAX ladder's r2 rung at 8q (8q Heisenberg thermal data, QMHL, KOBE-2,
exact categorical EBM) card against CPU and its tr[rho K] against a
float64 oracle, and drives the main paths, each with every launch count
reset just before it and read just after: the port's bench (`qhbmlib_tpu_torch.bench`: a
warm-up and three timed VQT train steps at 24q/2L/100/8 and at
20q/4L/500/64, and QMHL ones of that 24q model on the data of a fixed
random 24q QHBM ("train qmhl 24q"), the precision gates, the 24q forward
<H> and the QMHL step's forward <Z_i> shards against the f64 oracle,
PauliSum expectations/s at 20q, the HBM stream probe), the train step at
16q/4L/500/64 (whose lone row block takes `axis_apply`'s N < 16 route),
its gradient held against the plain versions, the r2 rung's train step
at 8q and 11q ("train r2 8q", "train r2 11q": the thermal data's 2^n
eigenvectors of rho through the batched forward and sweep, a warm-up and
three timed steps, the gradient against the plain versions), three
single-state value-and-gradient calls at 20q/4L, the 20q workload with the
Heisenberg chain as its target ("vqt heis 20q": terms that span row blocks
and that mix row and column; one step's gradient against the plain
versions, <H> of one sampled bitstring against the f64 oracle), "train
qaia 20q" (the 20q workload with QAIA on the TFIM's shards, 4 layers: a
warm-up and three steps, the gradient against the plain versions), "vqt
qaia heis 20q" (QAIA on the Heisenberg chain's shards, 2 layers: its XX
and YY PROTs run the flip kernels; one step's gradient against the plain
versions, <H> of one sampled bitstring against the f64 oracle), the JAX
ladder's r1 rung ("train r1 2q": a warm-up and one step; its exact-EBM
loss against a float64 free-energy oracle), its r3 rung at its own 16
qubits ("train r3 16q": KOBE-2 VQT measured by `SampledQuantumInference`
at 1000 shots, parameter-shift gradients: 188 shifted rows of 4 states
through the batched forward, each row's shifted gate a correction on its
slice; a warm-up and three timed steps, steps/s and peak memory; no sweep
kernel may launch; every row's group probabilities against the plain
versions, the shot-free shift gradient against the adjoint one, the
step's sampled gradient within 6 standard errors of it, <H> against the
f64 oracle), the port's
experiment harness ("train harness 8q": `baselines.train.run_experiment`
on its default config at an 8-site TFIM ring, the whole 1300-step VQT
beta sweep; steps/s, peak memory, every loss finite, beta 0.5 ending at
fidelity >= 0.88 and relative entropy <= 0.35 and each later beta's
relative entropy falling tenfold, bounds from the JAX harness's CPU run;
the last checkpoint's fidelity against the logged one; one step's
gradient at beta 0.5's checkpoint against the plain versions, and at the
last one both arms' circuit gradient against a float64 one), the
harness's other methods and loss on that config ("train harness natural
8q": 3 natural-gradient steps at beta 0.5, the first step's BKM
information matrix through the kernels against the plain versions;
"train harness mirror 8q": 2 mirror-descent outer steps of 100 inner
steps at beta 0.5, each outer step's first divergence against -log Z of
its anchor; "train harness qvartz 8q": QVARTZ uncut, 1000 VQT steps at
beta 1.0 and three Trotter time steps of 100 QMHL steps, each time
point's fidelity and D(target || model) within bounds from a JAX CPU
run, one QMHL step's gradient at the last checkpoint against the plain
versions), the ladder's command line in subprocesses (r2 at 8q exits 0
with its steps/s, r4 prints its error and exits 1), and last
the JAX ladder's r5 rung at its own 28 qubits ("train r5 28q": KOBE-2
sampled by 8 Gibbs-With-Gradients chains threaded through the steps, the
data 4 states of 2 GB; a warm-up and three timed steps, peak memory and
the batch-chunk plan, the gradient against the plain versions, and
<K_model> of the first data bitstring against a float64 oracle of the
28q circuit run on the host in a thread from the start).  Before r5 it
times r5's kernels at their 28q shapes and measures the batch-chunking
rule's state count at 24q, and before the main paths it checks that a
24q expectation agrees within 1e-6 with the caller's TF32 flag on and off
(the engine pins fp32).  On every train path with an adjoint sweep
`diag_rotate` must launch as often as `parity_bilinear`: once a diagonal
segment in the forward and never in the sweep.  It fails if the VQT
gate's gradient error reaches 1e-2, the QMHL, r2, r5, Heisenberg and
QAIA steps' 1e-4, or the oracle checks are more than 1e-4 off.  Before the last line it prints a
JSON line {"kernels": [...]} with each kernel's launches on the main
paths, its error against the plain version, its times and its bound;
the last line is {"ok": true, "device": {...}}.  It exits non-zero
without a CUDA device, and on any failed check.  Imports no jax.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_QUBITS = 20
LAYERS = 4
SAMPLES = 500
BATCH = 8  # states in the kernel and K4/K5 comparisons
STEPS = 3  # timed train steps per bench workload (after one warm-up)
SEED = 0
N24 = 24  # the bench's headline workload: 24q/2L/100 samples/8 unique
SINGLE_CALLS = 3  # single-state value-and-gradient calls at 20q/4L
# ||kernel - plain||_2 / ||plain||_2 limits.  States: both versions are fp32
# with the same products in another summation order.  Transitions and
# bilinears sum ~10^5-10^6 products per entry, so their order differs more.
STATE_TOL = 1e-5
REDUCTION_TOL = 1e-4
GRAD_TOL = 1e-4
# The bench's bars: the gate's gradient error (bench.GRAD_REL_GATE) and the
# 24q forward <H> against the f64 oracle, relative.
ORACLE_TOL = 1e-4
# H100 SXM peaks (NVIDIA's data sheet, at its 700 W limit): memory rate,
# float32 outside the tensor cores, and dense TF32 on the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12


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


def graph_ms(fn, reps: int = 20, replays: int = 3) -> float:
  """Device milliseconds of one fn() call: `reps` calls captured in one CUDA
  graph, replayed once to warm up, then `replays` times between CUDA
  events; the mean over the replays' calls.  A replay launches the calls
  back to back with no host work between them, so this is the card's time
  where cuda_ms may time the host's launch path."""
  cur = torch.cuda.current_stream()
  side = torch.cuda.Stream()
  side.wait_stream(cur)
  with torch.cuda.stream(side):
    fn()  # warm-up off the capture, as torch.cuda.graph asks
  cur.wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(reps):
      fn()
  graph.replay()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(replays):
    graph.replay()
  end.record()
  torch.cuda.synchronize()
  ms = start.elapsed_time(end) / (replays * reps)
  del graph
  torch.cuda.empty_cache()
  return ms


def bound(flops: float, nbytes: float, ops_per_s: float = PEAK_FP32_PER_S
          ) -> dict:
  """The least time the card could take for `flops` float32 operations
  at `ops_per_s` over `nbytes` bytes (each input read once, each output
  written once): {"bound_ms", "bound_by", "flops", "bytes"}."""
  t_ops = flops / ops_per_s * 1e3
  t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
  return {"bound_ms": max(t_ops, t_bytes),
          "bound_by": "operations" if t_ops >= t_bytes else "bytes",
          "flops": flops, "bytes": nbytes}


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
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  pqc, _, stages, ops1q, (x_re, x_im, l_re, l_im) = main_path_operands(
      device)
  b = x_re.shape[0]
  # First layer: rowblock (0,7), rowblock (7,6), minor, then diag.
  cos_t, sin_t = next(body for kind, body in stages if kind == "diag")
  shapes = [((b << s, 2**k, 2**(N_QUBITS - s - k)), ops)
            for (s, k), ops in ops1q]
  report = {}
  report["axis_apply"] = check_axis_apply(
      f"{N_QUBITS}q B={b}, three passes (rowblock 0:7, rowblock 7:6, minor)",
      shapes, (x_re, x_im))
  x_c = torch.complex(x_re, x_im)

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
  phase = torch.complex(cos_t, sin_t)
  amps = x_re.numel()
  report["diag_rotate"] = dict(
      err=err, max_abs_err=max_abs(got, ref),
      ms=cuda_ms(lambda: hs.diag_rotate(one, cos_t, sin_t, +1)),
      plain_ms=cuda_ms(lambda: hs.diag_rotate_plain(one, cos_t, sin_t, +1)),
      library_ms=cuda_ms(lambda: x_c * phase),
      # One complex multiply (6 flops) per amplitude; the batch read and
      # written once, the [R, C] cos and sin planes read once.
      **bound(6 * amps, 16 * amps + 8 * cos_t.numel()))
  rec = report["diag_rotate"]
  log(f"[kernels] diag_rotate: kernel {rec['ms']:.4f} ms, plain "
      f"{rec['plain_ms']:.4f} ms, library {fmt_ms(rec['library_ms'])}, "
      f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), max abs err "
      f"{rec['max_abs_err']:.3e}")

  report["qubit_transitions"] = check_transitions(
      f"{N_QUBITS}q", (l_re, l_im, x_re, x_im), first_segment_qubits(pqc))

  rms, cms = first_diag_factors(pqc)
  log(f"[kernels] parity factors of a 20q diag segment: K = {len(rms)}")
  report["parity_bilinear"] = check_bilinear(
      f"{N_QUBITS}q", (l_re, l_im, x_re, x_im), rms, cms, library=True)
  return report


def first_diag_factors(pqc):
  """(row masks, column masks) of the parity factors of the circuit's first
  diagonal segment (the ansatz's first Z rotations and CZ entanglers)."""
  from qhbmlib_tpu_torch.ops import statevector as sv
  n = pqc.num_qubits
  m = sv.minor_bits(n)
  idxs = next(i for cls, i in sv.segment_circuit(pqc.gates) if cls == "diag")
  _, rms, cms, _ = sv.diag_segment_triples([pqc.gates[i] for i in idxs],
                                           n - m, m)
  return rms, cms


def check_bilinear(label, planes, rms, cms, library=False):
  """parity_bilinear against its plain version on [B, R, C] planes
  (l_re, l_im, a_re, a_im), timed beside the plain version, its bound and,
  with `library`, one complex64 einsum of the same sums; returns the
  record."""
  from qhbmlib_tpu_torch.ops import hopper_adjoint as ha
  from qhbmlib_tpu_torch.ops import statevector as sv
  args = (*planes, rms, cms)
  got, ref = ha.parity_bilinear(*args), ha.parity_bilinear_plain(*args)
  err = rel_err(got, ref)
  b, r, c = planes[0].shape
  k = len(rms)
  check(f"parity_bilinear {label} B={b} (K={k})", err, REDUCTION_TOL)
  amps = planes[0].numel()
  rec = dict(err=err, max_abs_err=max_abs(got, ref),
             ms=cuda_ms(lambda: ha.parity_bilinear(*args)),
             plain_ms=cuda_ms(lambda: ha.parity_bilinear_plain(*args)),
             library_ms=None,
             # Im(conj(lam) a) summed over the batch (4 flops an amplitude),
             # then each factor's signed sum over [R, C] as a matrix-vector
             # product (2 flops an entry) and a dot over R; four planes read
             # once.
             **bound(4 * amps + 2 * r * c * k + 2 * r * k, 16 * amps + 4 * k))
  if library:
    # One einsum: Im of sum_b s_r[k] (conj(lam) a)_b s_c[k] with the sign
    # matrices in complex64, built outside the timed call.
    l_c = torch.complex(planes[0], planes[1])
    x_c = torch.complex(planes[2], planes[3])
    lib = ("brc,brc,kr,kc->k", l_c.conj(), x_c,
           *(sv.parity_signs(m, size, l_c.device).to(torch.complex64)
             for m, size in ((rms, r), (cms, c))))
    check(f"parity_bilinear's library einsum {label} vs its plain version",
          rel_err(torch.einsum(*lib).imag, ref), REDUCTION_TOL)
    rec["library_ms"] = cuda_ms(lambda: torch.einsum(*lib).imag)
  log(f"[kernels] parity_bilinear {label} B={b} (K={k}): kernel "
      f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
      f"{fmt_ms(rec['library_ms'])}, bound {rec['bound_ms']:.4f} ms "
      f"({rec['bound_by']}; share {rec['bound_ms'] / rec['ms']:.1%}), max abs "
      f"err {rec['max_abs_err']:.3e}")
  return rec


def phase_bilinear_steps(device):
  """parity_bilinear at the train steps' own shapes, the bench workloads'
  batches (24q B=8, 20q B=64), over the K factors of each ansatz's first
  diagonal segment, beside its library einsum (at 24q its [K, R] sign
  matrix is 140 x 2^17 complex64, 147 MB)."""
  from qhbmlib_tpu_torch import bench
  from qhbmlib_tpu_torch.models import circuit_utils
  from qhbmlib_tpu_torch.ops import statevector as sv
  dgen = torch.Generator(device=device).manual_seed(SEED + 50)
  for name, cfg in bench.WORKLOADS.items():
    n, b = cfg["n"], cfg["max_unique"]
    pqc = circuit_utils.hardware_efficient_ansatz(n, cfg["layers"])
    r, c = sv.state_shape(n)
    planes = tuple(torch.randn((b, r, c), generator=dgen, device=device)
                   for _ in range(4))
    check_bilinear(f"{name} step", planes, *first_diag_factors(pqc),
                   library=True)
    del planes
    torch.cuda.empty_cache()


# The diagonal kernels' shapes timed in phase_diag: (qubits, batch).  The
# r2 rung's (rho's 2^n eigenvectors, states of 2^n amplitudes, at 8q and
# at its qubits=11 override) and the VQT steps' (the 20q and 24q
# workloads' batches), where one state alone fills the card.
DIAG_SHAPES = ((8, 256), (11, 2048), (N_QUBITS, 64), (N24, BATCH))


@functools.lru_cache(maxsize=1)
def bilinear_fuses() -> bool:
  """Whether this tree's `parity_bilinear` takes a stage's planes."""
  import inspect
  from qhbmlib_tpu_torch.ops import hopper_adjoint as ha
  return "planes" in inspect.signature(ha.parity_bilinear).parameters


def fused_diag_stage(planes, rms, cms, cos_t, sin_t):
  """The batched sweep's diagonal stage on [B, R, C] planes (l_re, l_im,
  a_re, a_im), in place; returns the bilinears.  One `parity_bilinear`
  launch given the stage's planes, where the wrapper takes them; else (a
  tree from before the fused stage, timed in turns with this one) its
  sweep's pair: `parity_bilinear`, then `diag_rotate` of a and lambda."""
  from qhbmlib_tpu_torch.ops import hopper_adjoint as ha
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  if bilinear_fuses():
    return ha.parity_bilinear(*planes, rms, cms, (cos_t, sin_t))
  out = ha.parity_bilinear(*planes, rms, cms)
  hs.diag_rotate([planes[2:], planes[:2]], cos_t, sin_t, -1)
  return out


def fused_diag_stage_plain(planes, rms, cms, cos_t, sin_t):
  """fused_diag_stage's plain version: the two plain versions in turn."""
  from qhbmlib_tpu_torch.ops import hopper_adjoint as ha
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  out = ha.parity_bilinear_plain(*planes, rms, cms)
  hs.diag_rotate_plain([planes[2:], planes[:2]], cos_t, sin_t, -1)
  return out


def phase_diag(device):
  """The diagonal kernels at DIAG_SHAPES, over the K parity factors of the
  first diagonal segment of each size's ansatz with seeded weights:
  `diag_rotate` on one batch (the forward, sign +1) and the sweep's fused
  stage on two (`fused_diag_stage`: the bilinears, then a and lambda
  un-applied) against their plain versions, at STATE_TOL for the states
  and REDUCTION_TOL for the bilinears.  Each is timed four ways: the kernel
  (CUDA events over wrapper calls; at the r2 shapes also as CUDA-graph
  replays, device time), its plain version, the library call (`x_c *
  phase`; check_bilinear's einsum plus two complex multiplies) and its
  bound.  Beside the fused stage, its two parts as separate launches
  (`parity_bilinear` alone, then `diag_rotate` of both batches)."""
  from qhbmlib_tpu_torch.models import circuit_utils
  dgen = torch.Generator(device=device).manual_seed(SEED + 60)
  for n, b in DIAG_SHAPES:
    check_diag(device, n, b, *first_diag_factors(
        circuit_utils.hardware_efficient_ansatz(n, 2)), dgen)


def check_diag(device, n, b, rms, cms, dgen):
  """phase_diag's checks and times at one shape: `diag_rotate` (one batch,
  sign +1) and the fused diagonal stage over the parity factors (rms, cms)
  with weights from `dgen`, on B = b states of n qubits; graph replays
  at n <= 11.  Returns the two records."""
  from qhbmlib_tpu_torch.ops import hopper_adjoint as ha
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  from qhbmlib_tpu_torch.ops import statevector as sv
  r, c = sv.state_shape(n)
  k = len(rms)
  weights = torch.rand(k, generator=dgen, device=device) * 2.0
  cos_t, sin_t = hs.rotation_planes(weights, rms, cms, (r, c))
  planes = [torch.randn((b, r, c), generator=dgen, device=device)
            for _ in range(4)]
  amps = planes[0].numel()
  r2 = n <= 11
  label = f"{n}q B={b}"

  one = [tuple(t.clone() for t in planes[2:])]
  one_ref = [tuple(t.clone() for t in planes[2:])]
  hs.diag_rotate(one, cos_t, sin_t, +1)
  hs.diag_rotate_plain(one_ref, cos_t, sin_t, +1)
  got, ref = torch.cat(one[0]), torch.cat(one_ref[0])
  err = rel_err(got, ref)
  check(f"diag_rotate {label} (one batch, sign +1)", err, STATE_TOL)
  x_c = torch.complex(*planes[2:])
  phase = torch.complex(cos_t, sin_t)
  rot = dict(err=err, max_abs_err=max_abs(got, ref),
             ms=cuda_ms(lambda: hs.diag_rotate(one, cos_t, sin_t, +1)),
             plain_ms=cuda_ms(lambda: hs.diag_rotate_plain(one, cos_t,
                                                           sin_t, +1)),
             library_ms=cuda_ms(lambda: x_c * phase),
             # One complex multiply (6 flops) an amplitude; the batch read
             # and written once, the cos and sin planes read once.
             **bound(6 * amps, 16 * amps + 8 * r * c))
  if r2:
    rot["graph_ms"] = graph_ms(lambda: hs.diag_rotate(one, cos_t, sin_t,
                                                      +1))
    rot["library_graph_ms"] = graph_ms(lambda: x_c * phase)
  del one, one_ref, got, ref

  four = [t.clone() for t in planes]
  four_ref = [t.clone() for t in planes]
  bil = fused_diag_stage(four, rms, cms, cos_t, sin_t)
  bil_ref = fused_diag_stage_plain(four_ref, rms, cms, cos_t, sin_t)
  err = rel_err(bil, bil_ref)
  check(f"fused diagonal stage {label} (K={k}): bilinears", err,
        REDUCTION_TOL)
  state_err = rel_err(torch.cat(four), torch.cat(four_ref))
  check(f"fused diagonal stage {label}: a and lambda un-applied",
        state_err, STATE_TOL)
  l_c = torch.complex(*planes[:2])
  lib = ("brc,brc,kr,kc->k", l_c.conj(), x_c,
         *(sv.parity_signs(m, size, device).to(torch.complex64)
           for m, size in ((rms, r), (cms, c))))
  unapply = torch.conj(phase)

  def library():
    return (torch.einsum(*lib).imag, x_c * unapply, l_c * unapply)

  check(f"fused diagonal stage {label}: library einsum vs plain",
        rel_err(library()[0], bil_ref), REDUCTION_TOL)
  stage = dict(
      err=err, state_err=state_err, max_abs_err=max_abs(bil, bil_ref),
      ms=cuda_ms(lambda: fused_diag_stage(four, rms, cms, cos_t, sin_t)),
      plain_ms=cuda_ms(lambda: fused_diag_stage_plain(four, rms, cms,
                                                      cos_t, sin_t)),
      library_ms=cuda_ms(library),
      parts_ms=cuda_ms(lambda: (ha.parity_bilinear(*four, rms, cms),
                                hs.diag_rotate([four[2:], four[:2]], cos_t,
                                               sin_t, -1))),
      # Im(conj(lam) a) and its batch sum (4 flops an amplitude), two
      # complex multiplies (12); each row's C log2 C butterflies and K
      # signed adds; a and lambda read and written once, the cos and sin
      # planes and the masks read once, K floats written.
      **bound(16 * amps + r * c * (c.bit_length() - 1) + 2 * r * k,
              32 * amps + 8 * r * c + 12 * k))
  if r2:
    stage["graph_ms"] = graph_ms(lambda: fused_diag_stage(
        four, rms, cms, cos_t, sin_t))
    stage["library_graph_ms"] = graph_ms(library)
  del four, four_ref, planes, x_c, l_c, lib
  torch.cuda.empty_cache()
  for name, rec in (("diag_rotate", rot), ("fused diagonal stage", stage)):
    device_time = ""
    if r2:
      device_time = (f"; device time (graph replay) kernel "
                     f"{rec['graph_ms']:.4f} ms (share "
                     f"{rec['bound_ms'] / rec['graph_ms']:.1%}), library "
                     f"{rec['library_graph_ms']:.4f} ms")
    parts = (f", its parts as two launches {rec['parts_ms']:.4f} ms"
             if "parts_ms" in rec else "")
    log(f"[kernels] {name} {label}" + (f" (K={k})" if parts else "")
        + f": kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
        f"library {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} "
        f"ms ({rec['bound_by']}; share {rec['bound_ms'] / rec['ms']:.1%})"
        + parts + device_time + f", max abs err {rec['max_abs_err']:.3e}")
  return rot, stage


def flip_gates(n):
  """The flip-class gates the kernel phase holds at n qubits (qubits
  sorted): XX on (6, 7) (across the row blocks (0,7) / (7,6) at 20q) and
  on (12, 13) (row and column at 20q), CXP on (3, 15) (a row control, a
  column target at 20q), a PROT X.Y.Z on (2, 14, 17) spanning row and
  column, and at 24q YY on (19, 20) (both column bits)."""
  from qhbmlib_tpu_torch.ops import circuit_ir as ir
  gates = {"XX (6,7)": ir.Gate(ir.XXP, (6, 7)),
           "XX (12,13)": ir.Gate(ir.XXP, (12, 13)),
           "CXP (3,15)": ir.Gate(ir.CXP, (3, 15)),
           "PROT X.Y.Z (2,14,17)": ir.Gate(ir.PROT, (2, 14, 17),
                                           paulis=(1, 2, 3))}
  if n >= 21:
    gates["YY (19,20)"] = ir.Gate(ir.YYP, (19, 20))
  return gates


def flip_library(gate, angle, x_c):
  """One torch.einsum of the gate's 2^k x 2^k matrix on the complex view
  [B, ..., 2, ..., 2, ...] of x_c (the gate's qubits sorted)."""
  from qhbmlib_tpu_torch.ops import statevector as sv
  k = len(gate.qubits)
  mat = sv.gate_matrix(gate.kind, angle, gate.paulis).to(x_c.device)
  mat = mat.reshape((2,) * (2 * k))
  shape, prev = [x_c.shape[0]], -1
  for q in gate.qubits:
    shape += [2**(q - prev - 1), 2]
    prev = q
  view = x_c.reshape(shape + [-1])
  outs, ins, rest = "XYZ"[:k], "xyz"[:k], "pqr"[:k]
  prog = (f"{outs}{ins},b{''.join(r + i for r, i in zip(rest, ins))}e->"
          f"b{''.join(r + o for r, o in zip(rest, outs))}e")
  return lambda: torch.einsum(prog, mat, view)


def check_flip(device, n, b, label, gate, dgen):
  """`flip_apply` (the gate's record on one batch) and `flip_bilinear`
  (the un-apply of a and lambda and g = 2 Re sum conj(lam) dU a_before)
  on B = b random states of n qubits against their plain versions, timed
  beside them, the library einsum (`flip_library`, for flip_apply) and
  their bounds.  Returns the two records."""
  from qhbmlib_tpu_torch.ops import hopper_adjoint as ha
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  from qhbmlib_tpu_torch.ops import statevector as sv
  r, c = sv.state_shape(n)
  angle = 0.6180339887
  rec = hs.flip_record(gate, angle, n)
  inv = hs.flip_record(gate, -angle, n)
  d_rec = hs.flip_record(gate, angle, n, deriv=True)
  planes = [torch.randn((b, r, c), generator=dgen, device=device)
            for _ in range(4)]
  amps = planes[0].numel()
  where = f"{label} {n}q B={b}"

  one = [tuple(t.clone() for t in planes[2:])]
  one_ref = [tuple(t.clone() for t in planes[2:])]
  hs.flip_apply(one, rec)
  hs.flip_apply_plain(one_ref, rec)
  got, ref = torch.cat(one[0]), torch.cat(one_ref[0])
  err = rel_err(got, ref)
  check(f"flip_apply {where}", err, STATE_TOL)
  library = flip_library(gate, angle, torch.complex(*planes[2:]))
  check(f"flip_apply {where}: library einsum vs plain",
        rel_err(torch.view_as_real(library()).reshape(-1),
                torch.view_as_real(torch.complex(*one_ref[0])).reshape(-1)),
        STATE_TOL)
  apply = dict(err=err, max_abs_err=max_abs(got, ref),
               ms=cuda_ms(lambda: hs.flip_apply(one, rec)),
               plain_ms=cuda_ms(lambda: hs.flip_apply_plain(one, rec)),
               library_ms=cuda_ms(library),
               # Two complex products and their sum an output amplitude
               # (~16 flops); the batch read and written once.
               **bound(16 * amps, 16 * amps))
  del one, one_ref, got, ref, library

  four = [t.clone() for t in planes]
  four_ref = [t.clone() for t in planes]
  g = ha.flip_bilinear(*four, inv, d_rec)
  g_ref = ha.flip_bilinear_plain(*four_ref, inv, d_rec)
  err = rel_err(g, g_ref)
  check(f"flip_bilinear {where}: g", err, REDUCTION_TOL)
  state_err = rel_err(torch.cat(four), torch.cat(four_ref))
  check(f"flip_bilinear {where}: a and lambda un-applied", state_err,
        STATE_TOL)
  bil = dict(err=err, state_err=state_err, max_abs_err=max_abs(g, g_ref),
             g=float(g), g_plain=float(g_ref),
             ms=cuda_ms(lambda: ha.flip_bilinear(*four, inv, d_rec)),
             # The same bytes without the reduction: the un-apply of both
             # batches alone.
             parts_ms=cuda_ms(lambda: hs.flip_apply([four[2:], four[:2]],
                                                    inv)),
             plain_ms=cuda_ms(lambda: ha.flip_bilinear_plain(*four, inv,
                                                             d_rec)),
             # No single PyTorch call un-applies two states and reduces.
             library_ms=None,
             # Three record products an amplitude (~48 flops) and the
             # bilinear (4); a and lambda read and written once.
             **bound(52 * amps, 32 * amps))
  del four, four_ref, planes
  torch.cuda.empty_cache()
  for name, rec_ in (("flip_apply", apply), ("flip_bilinear", bil)):
    log(f"[kernels] {name} {where}: kernel {rec_['ms']:.4f} ms, plain "
        f"{rec_['plain_ms']:.4f} ms, library {fmt_ms(rec_['library_ms'])}, "
        f"bound {rec_['bound_ms']:.4f} ms ({rec_['bound_by']}; share "
        f"{rec_['bound_ms'] / rec_['ms']:.1%})"
        + (f", the un-apply of both batches alone (flip_apply) "
           f"{rec_['parts_ms']:.4f} ms" if "parts_ms" in rec_ else "")
        + f", max abs err {rec_['max_abs_err']:.3e}")
  return apply, bil


# The flip kernels' shapes: the "vqt qaia heis 20q" step's batch, and 24q
# at the bench's headline batch.
FLIP_SHAPES = ((N_QUBITS, 64), (N24, BATCH))


def phase_flip(device):
  """flip_apply and flip_bilinear against their plain versions on each
  gate of `flip_gates` at FLIP_SHAPES (`check_flip`).  Returns the records
  of the main path's own: XX on (6, 7) at 20q B=64."""
  dgen = torch.Generator(device=device).manual_seed(SEED + 140)
  main = None
  for n, b in FLIP_SHAPES:
    for label, gate in flip_gates(n).items():
      recs = check_flip(device, n, b, label, gate, dgen)
      if (n, b, label) == (N_QUBITS, 64, "XX (6,7)"):
        main = recs
  return main


def phase_tf32_pin(device):
  """One 24q/2L `adjoint.expectation` of the TFIM (segment by segment:
  24q is outside K3's range, so L3's Pauli tiers and the diagonal
  segments' parity sums run as torch matmuls) with the caller's TF32 flag
  on and off: the engine pins fp32 inside, so the two agree within 1e-6
  and the caller's flag comes back as it was."""
  from qhbmlib_tpu_torch.models import circuit_utils
  from qhbmlib_tpu_torch.ops import adjoint
  from qhbmlib_tpu_torch.ops import paulis
  pqc = circuit_utils.hardware_efficient_ansatz(N24, 2)
  gen = torch.Generator().manual_seed(SEED + 150)
  values = (torch.rand(pqc.num_symbols, generator=gen) * 2.0).to(device)
  state = random_state(N24, device, SEED + 151)
  op = paulis.tfim_1d(N24, device=device)
  got = {}
  for flag in (True, False):
    torch.backends.cuda.matmul.allow_tf32 = flag
    with torch.no_grad():
      got[flag] = float(adjoint.expectation(pqc, values, state, op))
    if torch.backends.cuda.matmul.allow_tf32 is not flag:
      raise AssertionError("the engine did not restore the caller's TF32 "
                           "flag")
  torch.backends.cuda.matmul.allow_tf32 = False
  log(f"[tf32 pin] 24q/2L <H> with the caller's TF32 on {got[True]:.8f}, "
      f"off {got[False]:.8f}")
  check("24q expectation, caller's TF32 on vs off",
        abs(got[True] - got[False]) / abs(got[False]), 1e-6)


def check_axis_apply(label, shapes, planes, graph=False):
  """axis_apply against its plain version on the [P, N, Q] views `shapes`
  [((p, n, q), (op_re, op_im))] of the planes (re, im), one launch a view,
  timed beside its plain version, one torch.matmul of the complex view a
  view (`library_ms`) and its bounds; returns the record.  With `graph`,
  the kernel and the library call are also timed as CUDA-graph replays
  (`graph_ms`, `library_graph_ms`: device time).  Operators of
  N >= 16 contract on the tensor cores in 3xTF32, so where every view has
  N >= 16 the bound is the 3xTF32 tensor bound, max(bytes / 3.35 TB/s,
  3 * flops / 495 TFLOP/s), else the fp32-core one; the fp32-core bound
  is logged beside it as `fp32_bound_ms`."""
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  x_re, x_im = planes

  def apply_all(fn):
    return [fn(x_re, x_im, op[0], op[1], *pnq) for pnq, op in shapes]

  got, ref = apply_all(hs.axis_apply), apply_all(hs.axis_apply_plain)
  err = max(rel_err(torch.cat(g), torch.cat(f)) for g, f in zip(got, ref))
  check(f"axis_apply {label}", err, STATE_TOL)
  abs_err = max(max_abs(torch.cat(g), torch.cat(f)) for g, f in zip(got, ref))
  del got, ref
  # Per view: a complex multiply-add (8 flops) per amplitude per row of the
  # [N, N] operator; the state read and written once, the operator read.
  flops = sum(8 * p * n * q * n for (p, n, q), _ in shapes)
  nbytes = sum(16 * p * n * q + 8 * n * n for (p, n, q), _ in shapes)
  tensor = all(n >= 16 for (_, n, _), _ in shapes)
  x_c = torch.complex(x_re, x_im)
  lib_ops = [(torch.complex(*op), x_c.view(pnq)) for pnq, op in shapes]
  rec = dict(err=err, max_abs_err=abs_err,
             ms=cuda_ms(lambda: apply_all(hs.axis_apply)),
             plain_ms=cuda_ms(lambda: apply_all(hs.axis_apply_plain)),
             library_ms=cuda_ms(lambda: [torch.matmul(o, v)
                                         for o, v in lib_ops]),
             **(bound(3 * flops, nbytes, PEAK_TF32_PER_S) if tensor
                else bound(flops, nbytes)))
  rec["fp32_bound_ms"] = bound(flops, nbytes)["bound_ms"]
  device_time = ""
  if graph:
    rec["graph_ms"] = graph_ms(lambda: apply_all(hs.axis_apply))
    rec["library_graph_ms"] = graph_ms(lambda: [torch.matmul(o, v)
                                                for o, v in lib_ops])
    device_time = (f"; device time (graph replay) kernel "
                   f"{rec['graph_ms']:.4f} ms (share "
                   f"{rec['bound_ms'] / rec['graph_ms']:.1%}), library "
                   f"{rec['library_graph_ms']:.4f} ms")
  log(f"[kernels] axis_apply {label}: kernel {rec['ms']:.4f} ms, plain "
      f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, "
      f"{'3xTF32 tensor' if tensor else 'fp32-core'} bound "
      f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; share "
      f"{rec['bound_ms'] / rec['ms']:.1%})"
      + (f", fp32-core bound {rec['fp32_bound_ms']:.4f} ms" if tensor
         else "") + device_time + f", max abs err {abs_err:.3e}")
  return rec


# K4's views timed in phase_k4: (qubits, batch, view).  "lone" is the row
# block plan_passes leaves unpaired, "minor" the minor operator of the first
# pass.  The 20q step's lone block (7,6) runs on the tensor cores; the lone
# blocks (7,1), (7,2), (7,3) of 15-17 qubits (N = 2, 4, 8, Q = 128) take
# the register stream, at the train steps' batch (64) and at B = BATCH.
K4_VIEWS = ((N_QUBITS, 64, "lone"), (N_QUBITS, BATCH, "minor"),
            (15, 64, "lone"), (16, 64, "lone"), (17, 64, "lone"),
            (16, BATCH, "lone"))


def phase_k4(device):
  """axis_apply against its plain version on K4_VIEWS, each timed by CUDA
  events over back-to-back wrapper calls (`ms`) and, for N < 16, also as
  CUDA-graph replays (device time), the library call likewise; returns the
  20q B = 64 record (P = 8192, N = 64, Q = 128, 1 GiB of planes in and
  out).  The three-pass B = BATCH check runs in phase_kernels."""
  from qhbmlib_tpu_torch.ops import statevector as sv
  dgen = torch.Generator(device=device).manual_seed(SEED + 40)
  report = None
  for n, b, which in K4_VIEWS:
    passes = first_segment_passes(n, device)
    if which == "lone":
      (s, k), op = next(p for p in passes if len(p) == 2)
    else:
      (s, k), op = next(p[2:] for p in passes if len(p) == 4)
    r, c = sv.state_shape(n)
    planes = tuple(torch.randn((b, r, c), generator=dgen, device=device)
                   for _ in range(2))
    view = (b << s, 2**k, 2**(n - s - k))
    rec = check_axis_apply(
        f"{n}q B={b}, {'lone row block' if which == 'lone' else 'minor'} "
        f"({s},{k}): P={view[0]}, N={view[1]}, Q={view[2]}", [(view, op)],
        planes, graph=view[1] < 16)
    del planes
    torch.cuda.empty_cache()
    report = report or rec
  return report


def first_segment_qubits(pqc):
  """The gradient qubits of the circuit's first 1q segment."""
  from qhbmlib_tpu_torch.ops import statevector as sv
  idxs = next(i for cls, i in sv.segment_circuit(pqc.gates) if cls == "1q")
  return sorted({pqc.gates[i].qubits[0] for i in idxs
                 if pqc.gates[i].slot >= 0})


def check_transitions(label, planes, qubits):
  """qubit_transitions against its plain version on [B, R, C] planes
  (l_re, l_im, a_re, a_im) for `qubits`, timed beside the plain version
  and the library's way to the same traces; returns the record."""
  from qhbmlib_tpu_torch.ops import hopper_adjoint as ha
  got = ha.qubit_transitions(*planes, qubits)
  ref = ha.qubit_transitions_plain(*planes, qubits)
  err = rel_err(got, ref)
  check(f"qubit_transitions {label} B={planes[0].shape[0]}, {len(qubits)} "
        "qubits", err, REDUCTION_TOL)
  b, r, c = planes[0].shape
  n = (r * c).bit_length() - 1
  m = c.bit_length() - 1
  l_c = torch.complex(planes[0], planes[1])
  a_c = torch.complex(planes[2], planes[3])
  blocks = ha.gram_blocks(qubits, n - m, m)

  def library():
    # One complex einsum per gram the traces come from, then each qubit's
    # partial trace: the library's way to the same numbers.
    grams = {}
    for s, k in blocks:
      view = (b << s, 2**k, 2**(n - s - k))
      grams[(s, k)] = torch.einsum("pIq,pJq->IJ", l_c.view(view).conj(),
                                   a_c.view(view))
    return ha.traces_of_grams(grams, qubits, n - m, m)

  lib = library()
  check(f"qubit_transitions' library traces {label} vs its plain version",
        rel_err(torch.stack([lib.real, lib.imag], dim=1), ref),
        REDUCTION_TOL)
  amps = planes[0].numel()
  rec = dict(err=err, max_abs_err=max_abs(got, ref),
             ms=cuda_ms(lambda: ha.qubit_transitions(*planes, qubits)),
             plain_ms=cuda_ms(lambda: ha.qubit_transitions_plain(*planes,
                                                                 qubits)),
             library_ms=cuda_ms(library),
             # conj(l) a per amplitude (8 flops with its sums) and, per
             # qubit, two complex multiply-adds per pair and the diagonal's
             # add (10 an amplitude); the four planes read once, Q x 8
             # floats written.
             **bound((8 + 10 * len(qubits)) * amps,
                     16 * amps + 32 * len(qubits)))
  log(f"[kernels] qubit_transitions {label} B={b} ({len(qubits)} qubits, "
      f"{len(blocks)} grams' worth): kernel {rec['ms']:.4f} ms, plain "
      f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, bound "
      f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; share "
      f"{rec['bound_ms'] / rec['ms']:.1%}); max abs err "
      f"{rec['max_abs_err']:.3e}")
  return rec


def phase_k5(device):
  """qubit_transitions at 24q B = BATCH over all 24 qubits (the row's
  headline shape, returned), and at 20q over the first 1q segment's qubits
  at the batch of the bench's 20q workload, which the 20q train step gives
  it (B = 64: 1 GiB of planes).  The 20q B = BATCH check runs in
  phase_kernels."""
  from qhbmlib_tpu_torch import bench
  from qhbmlib_tpu_torch.models import circuit_utils
  from qhbmlib_tpu_torch.ops import statevector as sv
  dgen = torch.Generator(device=device).manual_seed(SEED + 30)
  batch_20q = bench.WORKLOADS["20q"]["max_unique"]
  pqc = circuit_utils.hardware_efficient_ansatz(N_QUBITS, LAYERS)
  report = None
  for n, b, qubits in ((N24, BATCH, list(range(N24))),
                       (N_QUBITS, batch_20q, first_segment_qubits(pqc))):
    r, c = sv.state_shape(n)
    planes = tuple(torch.randn((b, r, c), generator=dgen, device=device)
                   for _ in range(4))
    rec = check_transitions(f"{n}q", planes, qubits)
    del planes
    torch.cuda.empty_cache()
    report = report or rec
  return report


def fmt_ms(ms) -> str:
  return "--" if ms is None else f"{ms:.4f} ms"


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


def phase_small_reference(device):
  """The bench's VQT train step (`bench.build_train_step`, seeded weights)
  at 9q on the card against the same step on the CPU (plain versions),
  with the exact EBM support: loss and gradient before the update."""
  from qhbmlib_tpu_torch import bench
  cfg = dict(n=9, layers=2, samples=SAMPLES, max_unique=None)
  l_dev, g_dev = bench.build_train_step(cfg, device, exact=True)[2]()
  l_cpu, g_cpu = bench.build_train_step(cfg, "cpu", exact=True)[2]()
  check("9q/2L VQT loss, card vs CPU", rel_err(l_dev.cpu(), l_cpu), 1e-5)
  check("9q/2L VQT gradient, card vs CPU", rel_err(g_dev.cpu(), g_cpu),
        GRAD_TOL)


def kernel_wrappers():
  from qhbmlib_tpu_torch.benchmarks import hbm_probe
  from qhbmlib_tpu_torch.ops import hopper_adjoint as ha
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  return {"axis_apply": hs.axis_apply, "diag_rotate": hs.diag_rotate,
          "qubit_transitions": ha.qubit_transitions,
          "parity_bilinear": ha.parity_bilinear,
          "axis2_apply": hs.axis2_apply,
          "circuit_forward": hs.circuit_forward,
          "adjoint_sweep": ha.adjoint_sweep,
          "stream_scale": hbm_probe.stream_scale,
          "flip_apply": hs.flip_apply, "flip_bilinear": ha.flip_bilinear}


def reset_launches() -> None:
  for fn in kernel_wrappers().values():
    fn.launches = 0


def read_launches(path: str, required, paired: bool = False) -> dict:
  """The counts since reset_launches(); fails if a kernel of `path` never
  launched.  With `paired` (a train path: each step one forward and one
  sweep, every diagonal segment of at most MAX_BILIN_K factors), fails
  unless `diag_rotate` launched as often as `parity_bilinear`: once a
  diagonal segment in the forward, and never in the sweep, whose diagonal
  stages un-apply inside their `parity_bilinear` launch."""
  launches = {name: fn.launches for name, fn in kernel_wrappers().items()}
  log(f"[{path}] kernel launches: {launches}")
  for name in required:
    if launches[name] <= 0:
      raise AssertionError(f"{path}: kernel {name} never launched")
  if paired and launches["diag_rotate"] != launches["parity_bilinear"]:
    raise AssertionError(
        f"{path}: {launches['diag_rotate']} diag_rotate launches against "
        f"{launches['parity_bilinear']} parity_bilinear: the sweep must not "
        "launch diag_rotate")
  return launches


# Kernels each main path of the bench must launch.  Every 24q operator
# pairs into an axis2_apply pass, so the 24q step launches no axis_apply.
BENCH_PATHS = {
    "train 24q": ["axis2_apply", "diag_rotate", "qubit_transitions",
                  "parity_bilinear"],
    "train 20q": ["axis_apply", "axis2_apply", "diag_rotate",
                  "qubit_transitions", "parity_bilinear"],
    "train qmhl 24q": ["axis2_apply", "diag_rotate", "qubit_transitions",
                       "parity_bilinear"],
    "pauli 20q": ["axis_apply", "axis2_apply", "diag_rotate"],
    "probe": ["stream_scale"],
}


# Kernels the 16q train step must launch: its lone row block (7,2) takes
# axis_apply at N = 4, once in the forward and twice in the sweep a layer;
# diag_rotate runs in the forward only (the sweep's diagonal stages are
# parity_bilinear launches that also un-apply).
TRAIN_16Q = ["axis_apply", "axis2_apply", "diag_rotate", "qubit_transitions",
             "parity_bilinear"]


def phase_train_16q(device):
  """The VQT train step at 16q/4L/500/64 (`step_profile.WORKLOADS["16q"]`,
  `bench.run_workload`: a warm-up and STEPS steps) with every launch count
  reset just before and read just after; then, as the bench's gate does
  (TF32 off), the kernels' loss and gradient against the plain versions at
  each timed step's parameters and EBM draw, within GRAD_TOL.  Returns the
  launches."""
  from qhbmlib_tpu_torch import bench
  from qhbmlib_tpu_torch.benchmarks import step_profile
  cfg = step_profile.WORKLOADS["16q"]
  traj = {}
  reset_launches()
  sps = bench.run_workload("16q", cfg, STEPS, device, traj)
  torch.cuda.synchronize()
  launches = read_launches("train 16q", TRAIN_16Q, paired=True)
  per_step = {k: v / (STEPS + 1) for k, v in launches.items() if v}
  log(f"[train 16q] {sps:.4f} steps/s; launches per step (warm-up + "
      f"{STEPS} steps): {per_step}")
  gate = bench.precision_gate(traj)
  check(f"train 16q gradient, kernels vs plain at {STEPS} steps",
        gate["gate_grad_rel_err"], GRAD_TOL)
  return launches


# Kernels the r2 train steps must launch: the only row block of an 8q or
# 11q state pairs with the minor operator, so every 1q segment is one
# axis2_apply pass and no axis_apply runs; a step launches 12 axis2_apply,
# 4 diag_rotate (the forward's), 4 qubit_transitions and 4 parity_bilinear
# (the sweep's diagonal stages, each with its un-apply).
TRAIN_R2 = ["axis2_apply", "diag_rotate", "qubit_transitions",
            "parity_bilinear"]


def r2_build(qubits):
  """`bench.run_workload`'s build of the JAX ladder's r2 rung
  (`ladder.build_rung("r2_heis8_qmhl")`) at `qubits`, logging the
  construction's host time (two complex eigh of 2^n x 2^n: the target's
  for rho, then rho's own)."""
  from qhbmlib_tpu_torch.benchmarks import ladder

  def build(cfg, device):
    del cfg
    t0 = time.time()
    out = ladder.build_rung("r2_heis8_qmhl", qubits=qubits, device=device)
    log(f"[train r2 {qubits}q] rung built in {time.time() - t0:.2f} s "
        f"(host: thermal state, its eigendecomposition, {2**qubits} "
        "eigenvector planes to the card)")
    return out

  return build


def phase_train_r2(device, qubits):
  """The r2 rung's QMHL train step at `qubits` (8: its own size; 11: the
  reference's `qubits` override, sample-and-dedup at max_unique 500): a
  warm-up and STEPS steps (`bench.run_workload`), with every launch count
  reset just before and read just after; then, as the bench's gate does
  (TF32 off), the model's gradient through the kernels against the plain
  versions at each timed step's parameters and EBM draw, within GRAD_TOL.
  The thermal data's 2^n eigenvectors are the batch.  Returns the
  launches."""
  from qhbmlib_tpu_torch import bench
  traj = {}
  reset_launches()
  sps = bench.run_workload(f"r2 {qubits}q", None, STEPS, device, traj,
                           build=r2_build(qubits))
  torch.cuda.synchronize()
  launches = read_launches(f"train r2 {qubits}q", TRAIN_R2, paired=True)
  per_step = {k: v / (STEPS + 1) for k, v in launches.items() if v}
  log(f"[train r2 {qubits}q] {sps:.4f} steps/s; launches per step (warm-up "
      f"+ {STEPS} steps): {per_step}")
  gate = bench.precision_gate(traj)
  check(f"train r2 {qubits}q gradient, kernels vs plain at {STEPS} steps",
        gate["gate_grad_rel_err"], GRAD_TOL)
  return launches


def r2_oracle(data, k):
  """tr[rho K] of the r2 data against the Hamiltonian k (KOBE-2 energy,
  circuit U) in float64 without the port's engine: U^dagger built column
  by column by the C++ oracle (`native_oracle.simulate` of each basis
  state), d = diag(U^dagger rho U), and E(x) = sum_t w_t prod_{i in c_t}
  s_i over the combinations of <= 2 qubits."""
  import itertools
  import numpy as np
  from qhbmlib_tpu_torch.ops import hopper_sv
  from qhbmlib_tpu_torch.ops import native_oracle
  n = data.num_qubits
  dagger = k.circuit_dagger
  values = hopper_sv.host_values(dagger.resolved_values()).astype(np.float64)
  idx = np.arange(2**n)
  bits = (idx[:, None] >> np.arange(n - 1, -1, -1)) & 1
  w = np.stack([native_oracle.simulate(dagger.pqc, values, bits=b)
                for b in bits], axis=1)
  rho = data.density_matrix.numpy()
  d = np.real(np.einsum("xi,ij,xj->x", w, rho, np.conj(w)))
  spins = 1.0 - 2.0 * bits
  combos = [c for order in (1, 2)
            for c in itertools.combinations(range(n), order)]
  kernel = k.energy.kernel.detach().cpu().double().numpy()
  energies = sum(kernel[t] * np.prod(spins[:, list(c)], axis=1)
                 for t, c in enumerate(combos))
  return float(d @ energies)


def phase_small_r2(device, qubits=8):
  """The r2 rung at its own 8 qubits, the model's EBM exact: the card's
  loss and gradient (one step) against the same step on the CPU (plain
  versions), and tr[rho K] at the initial parameters against the float64
  oracle (`r2_oracle`)."""
  from qhbmlib_tpu_torch.benchmarks import ladder
  build = lambda dev: ladder.build_rung("r2_heis8_qmhl", qubits=qubits,
                                        exact=True, device=dev)
  h, data, step = build(device)
  with torch.no_grad():
    got = float(data.expectation(h.modular_hamiltonian))
  want = r2_oracle(data, h.modular_hamiltonian)
  log(f"[r2 {qubits}q] tr[rho K] at the initial parameters {got:.8f}, f64 "
      f"oracle {want:.8f}")
  check(f"r2 {qubits}q tr[rho K] (batched forward over rho's {2**qubits} "
        "eigenvectors) vs f64 oracle", abs(got - want) / abs(want),
        ORACLE_TOL)
  l_dev, g_dev = step()
  l_cpu, g_cpu = build("cpu")[2]()
  check(f"r2 {qubits}q QMHL loss, card vs CPU", rel_err(l_dev.cpu(), l_cpu),
        1e-5)
  check(f"r2 {qubits}q QMHL gradient, card vs CPU",
        rel_err(g_dev.cpu(), g_cpu), GRAD_TOL)


def phase_bench(device):
  """The port's bench (`qhbmlib_tpu_torch.bench.run_bench`, STEPS timed
  steps a workload) with every launch count reset just before each of its
  main paths and read just after; checks its gate, its oracle error and
  that every number it reports is finite.  Returns (result, launches by
  path)."""
  from qhbmlib_tpu_torch import bench
  paths = {}

  @contextlib.contextmanager
  def path(name):
    reset_launches()
    yield
    torch.cuda.synchronize()
    paths[name] = read_launches(f"bench {name}", BENCH_PATHS[name],
                                paired=name.startswith("train"))

  result = bench.run_bench(device, steps=STEPS, path=path)
  log(f"[bench] {json.dumps(result)}")
  extra = result["extra"]
  for name in ("train 24q", "train 20q", "train qmhl 24q"):
    per_step = {k: v / (STEPS + 1) for k, v in paths[name].items() if v}
    log(f"[bench {name}] launches per step (warm-up + {STEPS} steps): "
        f"{per_step}")
  numbers = [result["value"], extra["steps_per_sec_20q"],
             extra["gate_grad_rel_err"], extra["forward_h_rel_err"],
             extra["pauli_expectations_per_sec_20q"],
             extra["qmhl_steps_per_sec_24q"], extra["qmhl_gate_grad_rel_err"],
             extra["qmhl_shards_rel_err"]]
  numbers += [r["gb_per_s"] for r in extra["hbm_probe"]["results"].values()]
  if not all(x == x and abs(x) != float("inf") for x in numbers):
    raise AssertionError(f"bench: a non-finite number in {numbers}")
  if not extra["gate_grad_rel_err"] < bench.GRAD_REL_GATE:
    raise AssertionError(f"bench: gate gradient error "
                         f"{extra['gate_grad_rel_err']} >= "
                         f"{bench.GRAD_REL_GATE}")
  check("bench 24q forward <H> vs f64 oracle", extra["forward_h_rel_err"],
        ORACLE_TOL)
  check(f"train qmhl 24q gradient, kernels vs plain at {STEPS} steps",
        extra["qmhl_gate_grad_rel_err"], GRAD_TOL)
  check("train qmhl 24q forward <Z_i> shards (data circuit + model dagger, "
        "coeff -1 gates) vs f64 oracle", extra["qmhl_shards_rel_err"],
        ORACLE_TOL)
  log(f"[bench] 24q {result['value']:.4f} steps/s, 20q "
      f"{extra['steps_per_sec_20q']:.4f} steps/s, qmhl 24q "
      f"{extra['qmhl_steps_per_sec_24q']:.4f} steps/s, gate grad rel err "
      f"{extra['gate_grad_rel_err']:.3e} (qmhl "
      f"{extra['qmhl_gate_grad_rel_err']:.3e}), "
      f"{extra['pauli_expectations_per_sec_20q']:.1f} expectations/s")
  return result, paths


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


def check_axis2(device, n, b):
  """axis2_apply (K1) against its plain version on the passes of the first
  1q segment of the n-qubit ansatz, on [B, R, C] planes, timed beside its
  plain version, its library einsum and its bounds; returns the record."""
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  from qhbmlib_tpu_torch.ops import statevector as sv
  passes = first_segment_passes(n, device)
  pairs = [p for p in passes if len(p) == 4]
  r, c = sv.state_shape(n)
  dgen = torch.Generator(device=device).manual_seed(SEED + n)
  x = [tuple(torch.randn((b, r, c), generator=dgen, device=device)
             for _ in range(2))]

  def run(plain):
    return [hs.apply_pass(p, x, n, plain)[0] for p in pairs]

  got, ref = run(False), run(True)
  err = max(rel_err(torch.cat(g), torch.cat(f)) for g, f in zip(got, ref))
  views = [f"({s1},{k1})x({s2},{k2})" for (s1, k1), _, (s2, k2), _ in pairs]
  check(f"axis2_apply {n}q B={b} passes {' '.join(views)}", err, STATE_TOL)
  abs_err = max(max_abs(torch.cat(g), torch.cat(f))
                for g, f in zip(got, ref))
  del got, ref
  # One einsum of both operators with the [P, N1, M, N2, Q] view a pass.
  x_c = torch.complex(*x[0])
  lib = [(torch.complex(*op1), torch.complex(*op2),
          x_c.view(b << s1, 2**k1, 2**(s2 - s1 - k1), 2**k2,
                   2**(n - s2 - k2)))
         for (s1, k1), op1, (s2, k2), op2 in pairs]
  amps = x_c.numel()
  # Per pass: N1 + N2 complex multiply-adds per amplitude; the state read
  # and written once, both operators read.
  flops = sum(8 * amps * (2**k1 + 2**k2) for (_, k1), _, (_, k2), _ in pairs)
  nbytes = sum(16 * amps + 8 * (4**k1 + 4**k2) for (_, k1), _, (_, k2), _
               in pairs)
  rec = dict(err=err, max_abs_err=abs_err,
             ms=cuda_ms(lambda: run(False), reps=5),
             plain_ms=cuda_ms(lambda: run(True), reps=5),
             # The state first: contracted left to right (torch's order
             # without opt_einsum), no [N1, N1, N2, N2] product forms.
             library_ms=cuda_ms(lambda: [
                 torch.einsum("pimjq,Ii,Jj->pImJq", v, a, b)
                 for a, b, v in lib], reps=5),
             **bound(3 * flops, nbytes, PEAK_TF32_PER_S))
  rec["fp32_bound_ms"] = bound(flops, nbytes)["bound_ms"]
  # The same operators one axis_apply pass each, as before K1.
  singles = [(p[0], p[1]) for p in pairs] + [(p[2], p[3]) for p in pairs]
  unfused_ms = cuda_ms(lambda: [hs.apply_pass(p, x, n) for p in singles],
                       reps=5)
  each = ", ".join(f"{v} {cuda_ms(lambda p=p: hs.apply_pass(p, x, n), 5):.4f}"
                   f" ms" for v, p in zip(views, pairs))
  log(f"[kernels] axis2_apply {n}q ({len(pairs)} passes, B={b}; {each}): "
      f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
      f"library {rec['library_ms']:.4f} ms, 3xTF32 tensor bound "
      f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; share "
      f"{rec['bound_ms'] / rec['ms']:.1%}), fp32-core bound "
      f"{rec['fp32_bound_ms']:.4f} ms, the same operators as {len(singles)} "
      f"axis_apply passes {unfused_ms:.4f} ms, max abs err "
      f"{rec['max_abs_err']:.3e}")
  del x, x_c, lib
  torch.cuda.empty_cache()
  return rec


def phase_k1(device):
  """axis2_apply (K1) against its plain version on the passes of a 1q
  segment at 24q and 20q, B = BATCH (`check_axis2`); returns the 24q
  record.  K1 runs its contractions on the tensor cores in 3xTF32 (three
  TF32 products per float32 product), so its bound is the 3xTF32 tensor
  bound, max(bytes / 3.35 TB/s, 3 * flops / 495 TFLOP/s); the float32-core
  bound of earlier records is logged beside it as `fp32_bound_ms`."""
  report = check_axis2(device, N24, BATCH)
  check_axis2(device, N_QUBITS, BATCH)
  return report


def random_state(n, device, seed):
  """A seeded random normalized [R, C] complex64 state on `device`."""
  from qhbmlib_tpu_torch.ops import statevector as sv
  gen = torch.Generator(device=device).manual_seed(seed)
  st = torch.complex(*(torch.randn(sv.state_shape(n), generator=gen,
                                   device=device) for _ in range(2)))
  return st / torch.linalg.vector_norm(st)


def check_single(device, n, layers):
  """K3 (circuit_forward) and K2 (adjoint_sweep) against their plain
  versions at n qubits / `layers` for one random normalized state; returns
  both records.  A record's `ms` times the cooperative launch alone, on a
  stage table and state buffers built beforehand; `wrapper_ms` times the
  whole wrapper (host stage table, copies, and for K2 the device->host
  copy and the gradient assembly).  Its bound is the 3xTF32 one
  (`single_bound`), the fp32-core one beside it."""
  from qhbmlib_tpu_torch.models import circuit_utils
  from qhbmlib_tpu_torch.ops import hopper_adjoint as ha
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  from qhbmlib_tpu_torch.ops import paulis
  from qhbmlib_tpu_torch.ops import statevector as sv
  pqc = circuit_utils.hardware_efficient_ansatz(n, layers)
  gen = torch.Generator().manual_seed(SEED + 4)
  values = torch.rand(pqc.num_symbols, generator=gen) * 2.0
  x = random_state(n, device, SEED + 5)
  planes = (x.real.contiguous(), x.imag.contiguous())
  got = hs.circuit_forward(pqc, values, planes)
  ref = hs.circuit_forward(pqc, values, planes, plain=True)
  err = rel_err(torch.cat(got), torch.cat(ref))
  check(f"circuit_forward (K3) {n}q/{layers}L", err, STATE_TOL)
  k3_table = hs.forward_table(pqc, values, device)
  buf = hs.state_buffer(planes)
  blocks = hs.sweep_blocks(device, 1)
  k3 = dict(err=err, max_abs_err=max_abs(torch.cat(got), torch.cat(ref)),
            ms=cuda_ms(lambda: hs.launch_circuit_forward(k3_table, buf,
                                                         blocks)),
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
  check(f"adjoint_sweep (K2) {n}q/{layers}L gradient, TFIM", err, GRAD_TOL)
  table, _, _ = ha.sweep_table(pqc, values, device)
  bufs = hs.state_buffer(ref), hs.state_buffer(lam)
  blocks = hs.sweep_blocks(device, 2)
  k2 = dict(err=err, max_abs_err=max_abs(grad.cpu(), grad_ref.cpu()),
            ms=cuda_ms(lambda: ha.launch_adjoint_sweep(table, *bufs, blocks)),
            wrapper_ms=cuda_ms(lambda: ha.adjoint_sweep(pqc, values, ref,
                                                        lam), reps=5),
            plain_ms=cuda_ms(lambda: ha.adjoint_sweep(pqc, values, ref, lam,
                                                      plain=True), reps=5))
  # No one PyTorch call runs a whole circuit or a whole reverse sweep.  Each
  # state is read and written once, the table read once, K2's reductions
  # written once.
  size = 2**n
  k3.update(library_ms=None, **single_bound(
      k3_table, 1, 16 * size + table_bytes(k3_table)))
  k2.update(library_ms=None, **single_bound(
      table, 2, 32 * size + table_bytes(table) + 4 * table.out_len))
  for name, rec in (("circuit_forward", k3), ("adjoint_sweep", k2)):
    log(f"[kernels] {name} {n}q/{layers}L: kernel {rec['ms']:.4f} ms (the "
        f"launch alone; the whole wrapper {rec['wrapper_ms']:.4f} ms), plain "
        f"{rec['plain_ms']:.4f} ms, 3xTF32 bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}; share {rec['bound_ms'] / rec['ms']:.1%}), "
        f"fp32-core bound {rec['fp32_bound_ms']:.4f} ms, max abs err "
        f"{rec['max_abs_err']:.3e}")
  return k3, k2


def stage_ms(device, stages=64, n=8):
  """The cost of one near-empty stage of the cooperative kernel: K3
  launches at n qubits on tables of one and of 1 + `stages` kDiag records
  of one zero-weight factor (a rotation by 1 of 2^n amplitudes, then the
  grid barrier), timed in turn: (t_many - t_one) / stages."""
  import numpy as np
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  tables = []
  for count in (1, 1 + stages):
    table = hs.StageTable(n, torch.device(device))
    for _ in range(count):
      table.diag(np.zeros(1, np.float32), [0], [0])
    tables.append(table)
  x = random_state(n, device, SEED + 11)
  buf = hs.state_buffer((x.real.contiguous(), x.imag.contiguous()))
  blocks = hs.sweep_blocks(device, 1)
  one, many = (cuda_ms(lambda t=t: hs.launch_circuit_forward(t, buf, blocks),
                       reps=20) for t in tables)
  return (many - one) / stages


def phase_single_kernels(device):
  """K3 and K2 against their plain versions at 20q/4L (the records of the
  kernels line) and at 16q/4L, whose launches run an N = 128 row block, an
  N = 4 one on the FMA body and the minor operator; then the cost of one
  near-empty stage (`stage_ms`).  Returns the 20q records."""
  k3, k2 = check_single(device, N_QUBITS, LAYERS)
  check_single(device, 16, LAYERS)
  log(f"[kernels] one near-empty stage of the cooperative kernel (8q, one "
      f"zero-weight kDiag factor, then grid.sync): {stage_ms(device):.4f} ms")
  return k3, k2


def table_work(table, states: int):
  """Float operations of one cooperative launch over `table` on `states`
  states (1: K3; 2: K2's a and lambda), as (on the tensor cores, on the
  fp32 cores): per record, an axis stage's complex multiply-adds (8 flops,
  2^k an amplitude; N = 2^k >= 16 contracts on the tensor cores, N < 16 on
  fp32 FMAs) and a diagonal stage's K-term phase sum and complex multiply
  (K + 6 an amplitude; the kernel sums the phase in float64, counted here
  at the float32 rate) on each state; a transition record's four complex
  multiply-adds a pair along each of its K qubits' bits (16 K an
  amplitude); a bilinear's Im(conj(lam) a) and K signed sums (4 + K an
  amplitude)."""
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  size = 2**table.n
  tensor = fp32 = 0
  records = table.pack()[0].cpu().view(-1, hs.STAGE_INTS).tolist()
  for kind, _, k, count, *_ in records:
    if kind == hs.AXIS:
      flops = states * 8 * size * 2**k
      if k >= 4:
        tensor += flops
      else:
        fp32 += flops
    elif kind == hs.DIAG:
      fp32 += states * size * (count + 6)
    elif kind == hs.TRANS:
      fp32 += 16 * size * count
    else:
      fp32 += size * (4 + count)
  return tensor, fp32


def single_bound(table, states: int, nbytes: int) -> dict:
  """bound() of one cooperative launch over `table`: its tensor-core
  operations in 3xTF32 (3 x flops / 495 TFLOP/s) plus its fp32-core ones
  (/ 67 TFLOP/s), stages running one after another, against `nbytes` over
  3.35 TB/s; `fp32_bound_ms` is the bound with every operation on the fp32
  cores."""
  tensor, fp32 = table_work(table, states)
  t_ops = (3 * tensor / PEAK_TF32_PER_S + fp32 / PEAK_FP32_PER_S) * 1e3
  t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
  return {"bound_ms": max(t_ops, t_bytes),
          "bound_by": "operations" if t_ops >= t_bytes else "bytes",
          "flops": tensor + fp32, "bytes": nbytes,
          "fp32_bound_ms": bound(tensor + fp32, nbytes)["bound_ms"]}


def table_bytes(table) -> int:
  """Bytes of a packed stage table (records, masks, data), read once."""
  return sum(4 * t.numel() for t in table.pack())


def long_diag_circuit(n, reps):
  """RX on every qubit, `reps` all-to-all symbolic CZ layers (4 parity
  factors a gate: one diagonal segment of 4 * reps * n(n-1)/2 factors),
  RY on every qubit."""
  from qhbmlib_tpu_torch.ops import circuit_ir
  b = circuit_ir.CircuitBuilder(n)
  for q in range(n):
    b.rx(q, f"x{q}")
  for r in range(reps):
    for i in range(n):
      for j in range(i + 1, n):
        b.cz(i, j, f"c{r}")
  for q in range(n):
    b.ry(q, f"y{q}")
  return b.build()


def phase_long_diag(device, n=9, reps=10):
  """K3 and K2 against their plain versions on a diagonal segment of more
  parity factors than one stage record holds (reps all-to-all symbolic CZ
  layers: 4 factors a gate), which the stage table splits."""
  from qhbmlib_tpu_torch.ops import hopper_adjoint as ha
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  from qhbmlib_tpu_torch.ops import paulis
  from qhbmlib_tpu_torch.ops import statevector as sv
  pqc = long_diag_circuit(n, reps)
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


def phase_long_diag_batched(device, n=9, reps=10, batch=4):
  """The batched engine (`adjoint.batched_expectations`: K4 forward, K5
  sweep) through one diagonal segment of more parity factors than one
  `parity_bilinear` launch takes: value and gradient of the TFIM for
  `batch` basis states, kernels against plain; the sweep must split the
  segment's bilinears into launches of at most MAX_BILIN_K factors, the
  first of which also un-applies the segment, and launch `diag_rotate`
  once (the forward's segment).  Then `parity_bilinear` alone at that K
  against its plain version and its library einsum, and the fused stage
  (its planes given) against its plain version."""
  from qhbmlib_tpu_torch.ops import adjoint
  from qhbmlib_tpu_torch.ops import hopper_adjoint as ha
  from qhbmlib_tpu_torch.ops import hopper_sv as hs
  from qhbmlib_tpu_torch.ops import paulis
  from qhbmlib_tpu_torch.ops import statevector as sv
  pqc = long_diag_circuit(n, reps)
  gen = torch.Generator().manual_seed(SEED + 12)
  values = (torch.rand(pqc.num_symbols, generator=gen) * 2.0 - 1.0).to(
      device)
  bits = torch.randint(0, 2, (batch, n), generator=gen,
                       dtype=torch.int8).to(device)
  op = paulis.tfim_1d(n, device=device)

  def value_and_grad(plain):
    v = values.clone().requires_grad_(True)
    out = adjoint.batched_expectations(pqc, v, bits, (op,), plain=plain)
    out.sum().backward()
    return out.detach(), v.grad

  rms, cms = first_diag_factors(pqc)
  k = len(rms)
  before = ha.parity_bilinear.launches, hs.diag_rotate.launches
  val, grad = value_and_grad(False)
  launched = ha.parity_bilinear.launches - before[0]
  rotated = hs.diag_rotate.launches - before[1]
  want = -(-k // ha.MAX_BILIN_K)
  if (launched, rotated) != (want, 1):
    raise AssertionError(f"batched forward and sweep, K={k}: {launched} "
                         f"parity_bilinear launches, not {want}, and "
                         f"{rotated} diag_rotate launches, not 1")
  val_ref, grad_ref = value_and_grad(True)
  check(f"batched_expectations {n}q B={batch}, one diag segment of K={k} > "
        f"{ha.MAX_BILIN_K}: value", rel_err(val.cpu(), val_ref.cpu()),
        STATE_TOL)
  check(f"batched sweep {n}q B={batch}, K={k} ({launched} parity_bilinear "
        "launches): gradient", rel_err(grad.cpu(), grad_ref.cpu()),
        REDUCTION_TOL)
  r, c = sv.state_shape(n)
  dgen = torch.Generator(device=device).manual_seed(SEED + 13)
  planes = tuple(torch.randn((batch, r, c), generator=dgen, device=device)
                 for _ in range(4))
  check_bilinear(f"{n}q, one diag segment", planes, rms, cms, library=True)
  weights = torch.rand(k, generator=dgen, device=device) * 2.0 - 1.0
  rot = hs.rotation_planes(weights, rms, cms, (r, c))
  four = [t.clone() for t in planes]
  four_ref = [t.clone() for t in planes]
  check(f"fused diagonal stage {n}q B={batch}, K={k}: bilinears",
        rel_err(fused_diag_stage(four, rms, cms, *rot),
                fused_diag_stage_plain(four_ref, rms, cms, *rot)),
        REDUCTION_TOL)
  check(f"fused diagonal stage {n}q B={batch}, K={k}: a and lambda "
        "un-applied", rel_err(torch.cat(four), torch.cat(four_ref)),
        STATE_TOL)


def phase_small_qmhl(device):
  """The bench's QMHL train step (`bench.build_qmhl_step`: the 24q
  workload's model and r5's data, seeded) at 9q on the card against the
  same step on the CPU (plain versions), both EBMs on their exact support:
  loss and the model's gradient before the update."""
  from qhbmlib_tpu_torch import bench
  cfg = dict(n=9, layers=2, samples=SAMPLES, max_unique=None,
             **bench.QMHL_DATA)
  l_dev, g_dev = bench.build_qmhl_step(cfg, device, exact=True)[2]()
  l_cpu, g_cpu = bench.build_qmhl_step(cfg, "cpu", exact=True)[2]()
  check("9q QMHL loss, card vs CPU", rel_err(l_dev.cpu(), l_cpu), 1e-5)
  check("9q QMHL gradient, card vs CPU", rel_err(g_dev.cpu(), g_cpu),
        GRAD_TOL)


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


def phase_k6(device):
  """stream_scale (K6) against its plain version on the 24q plane at each
  tile size: exactly equal (one float32 multiply either way).  Its `ms` is
  the fastest tile size's."""
  from qhbmlib_tpu_torch.benchmarks import hbm_probe as hp
  shape = (2**(N24 - 7), hp.COLS)
  gen = torch.Generator(device=device).manual_seed(SEED + 9)
  x = torch.randn(shape, generator=gen, device=device)
  v = torch.tensor([1.0001], device=device)
  ref = hp.stream_scale_plain(x, v)
  times = {}
  err = 0.0
  for rpt in hp.ROWS_PER_TILE:
    got = hp.stream_scale(x, v, rpt)
    err = max(err, max_abs(got, ref))
    if err != 0.0:
      raise AssertionError(f"stream_scale rpt={rpt}: max abs err {err} != 0")
    times[rpt] = cuda_ms(lambda rpt=rpt: hp.stream_scale(x, v, rpt), reps=20)
  out = torch.empty_like(x)
  # x read once and o written once; one multiply an element.
  rec = dict(err=err, max_abs_err=err, ms=min(times.values()),
             plain_ms=cuda_ms(lambda: hp.stream_scale_plain(x, v), reps=20),
             library_ms=cuda_ms(lambda: torch.mul(x, v, out=out), reps=20),
             **bound(x.numel(), 8 * x.numel() + 4))
  log(f"[check] stream_scale (K6) 24q plane {shape}, rows per tile "
      f"{list(times)}: max abs err {err} (must be 0) ok")
  log(f"[kernels] stream_scale 24q: kernel "
      + ", ".join(f"{ms:.4f} ms (rpt {rpt}, "
                  f"{8 * x.numel() / ms / 1e6:.0f} GB/s)"
                  for rpt, ms in times.items())
      + f"; plain {rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f}"
      f" ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
  return rec


def chunk_peak(device, pqc, values, bits, ops, batch_chunk=None):
  """Peak bytes allocated during one batched_expectations forward and
  backward beyond what was allocated before it, with the call's plan."""
  from qhbmlib_tpu_torch.ops import adjoint
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  base = torch.cuda.memory_allocated(device)
  torch.cuda.reset_peak_memory_stats(device)
  v = values.clone().requires_grad_(True)
  out = adjoint.batched_expectations(pqc, v, bits, ops,
                                     batch_chunk=batch_chunk)
  out.sum().backward()
  torch.cuda.synchronize()
  peak = torch.cuda.max_memory_allocated(device) - base
  return peak, dict(adjoint.last_plan), out.detach(), v.grad


def phase_chunk_rule(device):
  """The batch-chunking rule of `adjoint.batched_expectations` on the card.

  Measures its LIVE_STATES count at 24q, B = 8, psi kept: the peak bytes of
  a forward and backward over one chunk of 8 and over chunks of 2 (the
  parity-sign caches warmed first), less the residual, per chunk element
  (the slope between the two) in states of S = 8 * 2^n bytes, and the
  part that does not grow with the chunk (the rotation planes, the
  intercept), for the TFIM and the Heisenberg chain (whose mixed terms
  take the per-term apply).  Then checks that the rule gives one chunk
  and keeps psi at the bench's 24q B = 8 and 20q B = 64, and that chunks
  of 3 with psi recomputed give one chunk's values and gradient (20q,
  B = 8) within 1e-5 relative L2."""
  from qhbmlib_tpu_torch.benchmarks import ladder
  from qhbmlib_tpu_torch.models import circuit_utils
  from qhbmlib_tpu_torch.ops import adjoint
  from qhbmlib_tpu_torch.ops import paulis
  n, batch = N24, BATCH
  s_bytes = adjoint.state_bytes(n)
  pqc = circuit_utils.hardware_efficient_ansatz(n, 2)
  gen = torch.Generator().manual_seed(SEED + 70)
  values = (torch.rand(pqc.num_symbols, generator=gen) * 2.0).to(device)
  bits = torch.randint(0, 2, (batch, n), generator=gen,
                       dtype=torch.int8).to(device)
  counts = []
  for name, op in (("TFIM", paulis.tfim_1d(n, device=device)),
                   ("Heisenberg", ladder.heisenberg(n, device=device))):
    chunk_peak(device, pqc, values, bits, (op,))  # warms the sign caches
    peaks = {}
    for chunk in (batch, 2):
      peak, plan, _, _ = chunk_peak(device, pqc, values, bits, (op,), chunk)
      if not plan["store_psi"]:
        raise AssertionError(f"{n}q B={batch}: psi not kept: {plan}")
      peaks[chunk] = (peak - batch * s_bytes) / s_bytes
    live = (peaks[batch] - peaks[2]) / (batch - 2)
    fixed = peaks[2] - 2 * live
    counts.append((name, live, fixed))
    log(f"[chunk] {n}q B={batch} {name}: peak beyond the residual "
        f"{peaks[batch]:.2f} states at one chunk of {batch}, "
        f"{peaks[2]:.2f} at chunks of 2: {live:.2f} states live per chunk "
        f"element, {fixed:.2f} fixed (LIVE_STATES {adjoint.LIVE_STATES}, "
        f"FIXED_STATES {adjoint.FIXED_STATES})")
  for name, live, fixed in counts:
    if live > adjoint.LIVE_STATES or fixed > adjoint.FIXED_STATES:
      raise AssertionError(
          f"{name}: {live:.2f} live and {fixed:.2f} fixed states > the "
          f"rule's {adjoint.LIVE_STATES} and {adjoint.FIXED_STATES}")
  free = adjoint.free_bytes(device)
  for label, (nq, b) in (("24q", (N24, BATCH)), ("20q", (N_QUBITS, 64)),
                         ("r5 28q", (R5_QUBITS, 4))):
    store = adjoint.store_psi(nq, b, free)
    chunk = adjoint.auto_chunk(nq, b, free, store)
    log(f"[chunk] rule at {label} B={b}, {free / 2**30:.1f} GiB free: "
        f"chunk {chunk}, psi {'kept' if store else 'recomputed'}")
    if nq != R5_QUBITS and not (store and chunk == b):
      raise AssertionError(f"{label}: the rule must keep one chunk and psi")
  pqc20 = circuit_utils.hardware_efficient_ansatz(N_QUBITS, LAYERS)
  v20 = (torch.rand(pqc20.num_symbols, generator=gen) * 2.0).to(device)
  b20 = torch.randint(0, 2, (BATCH, N_QUBITS), generator=gen,
                      dtype=torch.int8).to(device)
  op20 = (ladder.heisenberg(N_QUBITS, device=device),)
  _, _, want, want_g = chunk_peak(device, pqc20, v20, b20, op20)
  saved = adjoint.PSI_RESIDUAL_SHARE
  adjoint.PSI_RESIDUAL_SHARE = 0.0
  try:
    _, plan, got, got_g = chunk_peak(device, pqc20, v20, b20, op20, 3)
  finally:
    adjoint.PSI_RESIDUAL_SHARE = saved
  if plan["store_psi"] or plan["chunk"] != 3:
    raise AssertionError(f"recompute arm ran {plan}")
  check(f"{N_QUBITS}q B={BATCH} chunks of 3, psi recomputed, vs one chunk: "
        "values", rel_err(got, want), 1e-5)
  check(f"{N_QUBITS}q B={BATCH} chunks of 3, psi recomputed, vs one chunk: "
        "gradient", rel_err(got_g, want_g), 1e-5)


# The r5 rung (`ladder.build_rung("r5_gwg28_qmhl")`) at its own 28 qubits.
R5 = "r5_gwg28_qmhl"
R5_QUBITS = 28
# Kernels the r5 step launches: every 28q 1q segment is two axis2_apply
# passes, (0,7) x minor and (7,7) x (14,7), so no axis_apply runs.
TRAIN_R5 = ["axis2_apply", "diag_rotate", "qubit_transitions",
            "parity_bilinear"]


def z_moments_f64(p, n):
  """<Z_i> [n] and <Z_i Z_j> [n, n] of the float64 distribution p [2^n]
  (qubit 0 the top index bit), exact: p as a [2^(n-h), 2^h] matrix, the
  high qubits' signs constant along a row, the low ones' along a column."""
  import numpy as np
  h = n // 2
  mat = p.reshape(2**(n - h), 2**h)

  def signs(bits):
    x = np.arange(2**bits)[:, None] >> np.arange(bits - 1, -1, -1)
    return (1.0 - 2.0 * (x & 1)).astype(np.float64)  # [2^bits, bits]

  s_hi, s_lo = signs(n - h), signs(h)
  q_hi, q_lo = mat.sum(axis=1), mat.sum(axis=0)
  first = np.concatenate([q_hi @ s_hi, q_lo @ s_lo])
  cross = s_hi.T @ (mat @ s_lo)
  second = np.block([[s_hi.T @ (q_hi[:, None] * s_hi), cross],
                     [cross.T, s_lo.T @ (q_lo[:, None] * s_lo)]])
  return first, second


class R5Anchor:
  """The 28q forward anchor of r5: <K_model> of the first data bitstring
  through the composite circuit (the data ansatz, then the model's
  dagger) at the initial weights, in float64 on the host by the C++ oracle
  (`native_oracle.simulate`, 4 GB of complex128) and the exact Z moments
  of its distribution, in a thread started before the kernels build
  (ctypes releases the GIL)."""

  def __init__(self, device):
    import threading
    import numpy as np
    from qhbmlib_tpu_torch.benchmarks import ladder
    from qhbmlib_tpu_torch.ops import hopper_sv
    self.rung = ladder.build_rung(R5, qubits=R5_QUBITS, device=device)
    h, data, _ = self.rung
    self.k = h.modular_hamiltonian
    self.total = data.qhbm.q_inference.circuit + self.k.circuit_dagger
    gen = data.qhbm.e_inference.generator
    copy = torch.Generator(device=gen.device)
    copy.set_state(gen.get_state())
    support, _ = data.qhbm.e_inference.support_and_counts(copy)
    self.bits = support[:1].to(torch.int8)
    self.values = hopper_sv.host_values(self.total.resolved_values())
    self.kernel = self.k.energy.kernel.detach().cpu().double().numpy()
    self.result = {}
    self.thread = threading.Thread(target=self._run, args=(
        np.asarray(self.bits.cpu()[0]),), daemon=True)
    self.t0 = time.time()
    self.thread.start()

  def _run(self, bits):
    import numpy as np
    from qhbmlib_tpu_torch.ops import native_oracle
    try:
      psi = native_oracle.simulate(self.total.pqc,
                                   self.values.astype(np.float64), bits=bits)
      self.result["simulate_s"] = time.time() - self.t0
      p = psi.real**2 + psi.imag**2
      del psi
      first, second = z_moments_f64(p, self.total.pqc.num_qubits)
      self.result["shards"] = np.asarray(
          [first[c[0]] if len(c) == 1 else second[c[0], c[1]]
           for c in self.k.energy.indices])
      self.result["seconds"] = time.time() - self.t0
    except Exception as e:  # noqa: BLE001 -- raised again by check()
      self.result["error"] = e

  def check(self, got_shards):
    """Waits for the oracle; holds the card's shards and <K> to it."""
    import numpy as np
    t0 = time.time()
    self.thread.join()
    if "error" in self.result:
      raise self.result["error"]
    want = self.result["shards"]
    got = got_shards.detach().cpu().double().numpy()
    n = self.total.pqc.num_qubits
    log(f"[r5 {n}q] f64 oracle: {self.total.pqc.num_gates} gates simulated "
        f"in {self.result['simulate_s']:.1f} s, Z moments by "
        f"{self.result['seconds']:.1f} s after its start; waited "
        f"{time.time() - t0:.1f} s for it here")
    check(f"r5 {n}q forward shards <Z_c> ({len(want)}, first data "
          "bitstring through data ansatz + model dagger) vs f64 oracle",
          float(np.linalg.norm(got - want) / np.linalg.norm(want)),
          ORACLE_TOL)
    k_got, k_want = float(got @ self.kernel), float(want @ self.kernel)
    log(f"[r5 {n}q] <K_model> card {k_got:.8f}, f64 oracle {k_want:.8f}")
    check(f"r5 {n}q forward <K_model> vs f64 oracle",
          abs(k_got - k_want) / abs(k_want), ORACLE_TOL)


def r5_plain_loss(h, data):
  """The r5 step's loss through the kernels' plain versions: the data's
  QNN rebuilt with `plain=True`, the chain state threaded."""
  from qhbmlib_tpu_torch.data import qhbm_data
  from qhbmlib_tpu_torch.inference import qhbm, qmhl_loss, qnn
  d = data.qhbm
  plain = qhbm_data.QHBMData(qhbm.QHBM(d.e_inference,
                                       qnn.AnalyticQuantumInference(
                                           d.q_inference.circuit,
                                           plain=True)))
  return qmhl_loss.make_qmhl_with_state(plain, h)


def r5_steps(h, data, step, steps, snaps):
  """`steps` train steps of r5, each step's input (parameters, both EBM
  generators' states, the chain state) and output (loss, flat gradient)
  appended to `snaps`.  Returns the seconds they took, host clock ending
  in a synchronize."""
  from qhbmlib_tpu_torch import bench
  gens = bench.generators(h, data)
  t0 = time.perf_counter()
  for _ in range(steps):
    point = ([p.detach().clone() for p in h.parameters()],
             [g.get_state() for g in gens], step.ebm_state["model"].clone())
    loss, grad = step()
    snaps.append((point, loss, grad))
  torch.cuda.synchronize()
  return time.perf_counter() - t0


def r5_gate(h, data, snaps) -> float:
  """The largest relative L2 error of the model gradient through the
  kernels against the plain versions, recomputed at each recorded point
  (parameters, EBM generator states, chain state)."""
  from qhbmlib_tpu_torch import bench
  loss_fn = r5_plain_loss(h, data)
  gens = bench.generators(h, data)
  worst = 0.0
  for (params, states, chain), loss_k, grad_k in snaps:
    with torch.no_grad():
      for p, v in zip(h.parameters(), params):
        p.copy_(v)
    for gen, state in zip(gens, states):
      gen.set_state(state)
    for p in h.parameters() + data.qhbm.parameters():
      p.grad = None
    loss, _ = loss_fn(state=(None, chain))
    loss.backward()
    grad_p = bench.flat_grads(h)
    log(f"[r5 gate] loss kernels {float(loss_k):.8f}, plain "
        f"{float(loss.detach()):.8f}")
    worst = max(worst, rel_err(grad_k.cpu(), grad_p.cpu()))
  return worst


def phase_train_r5(device, anchor):
  """The JAX ladder's r5 rung at its own 28 qubits (`anchor.rung`, built
  at start-up): the forward anchor's card side at the initial weights
  (`R5Anchor.check`), then the main path "train r5 28q": a warm-up and
  STEPS timed steps with every count reset just before and read just
  after, steps/s on the host clock, peak device memory and the chunk plan
  of the last batched_expectations call; then the model's gradient
  through the kernels against the plain versions at each timed step's
  parameters, EBM draws and chain state.  Returns the launches."""
  from qhbmlib_tpu_torch.ops import adjoint
  h, data, step = anchor.rung
  n = R5_QUBITS
  with torch.no_grad():
    got = adjoint.batched_expectations(
        anchor.total.pqc, anchor.total.resolved_values(), anchor.bits,
        anchor.k.operator_shards)[0]
  log(f"[r5 {n}q] forward of the anchor state: plan {adjoint.last_plan}")
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats(device)
  path = f"train r5 {n}q"
  reset_launches()
  t0 = time.perf_counter()
  loss, _ = step()
  torch.cuda.synchronize()
  log(f"[{path}] warm-up step {time.perf_counter() - t0:.2f} s, loss "
      f"{float(loss):.6f}")
  snaps = []
  dt = r5_steps(h, data, step, STEPS, snaps)
  launches = read_launches(path, TRAIN_R5, paired=True)
  plan = dict(adjoint.last_plan)
  per_step = {k: v / (STEPS + 1) for k, v in launches.items() if v}
  log(f"[{path}] {STEPS / dt:.4f} steps/s ({STEPS} steps in {dt:.3f} s); "
      f"peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f}"
      f" GiB; batched_expectations plan {plan} (chunk {plan['chunk']} of "
      f"{plan['batch']}, psi {'kept' if plan['store_psi'] else 'recomputed'})"
      f"; launches per step (warm-up + {STEPS} steps): {per_step}")
  anchor.check(got)
  check(f"train r5 gradient at {n}q, kernels vs plain at {STEPS} steps",
        r5_gate(h, data, snaps), GRAD_TOL)
  return launches


def free_device_memory() -> None:
  """Drops what earlier phases left cached on the card: the parity-sign
  and Pauli-matrix caches and the allocator's free blocks."""
  import gc
  from qhbmlib_tpu_torch.ops import statevector as sv
  gc.collect()
  sv._parity_signs.cache_clear()
  sv._pauli_stack.cache_clear()
  torch.cuda.empty_cache()
  log(f"[memory] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
      "after freeing the caches")


def phase_kernels_28q(device):
  """The r5 path's kernels at their 28q shapes, B = the chunk the rule
  gives r5's 4 data states now (what its step runs with this much free
  memory): axis2_apply on both passes of a 1q segment (each pass also
  timed alone), qubit_transitions over
  its 28 qubits, diag_rotate and the fused diagonal stage over the parity
  factors of r5's composite diagonal segment (data ansatz + model dagger),
  each against its plain version, timed beside it, its library call and
  its bound (`check_axis2`, `check_transitions`, `check_diag`)."""
  from qhbmlib_tpu_torch.benchmarks import ladder
  from qhbmlib_tpu_torch.ops import adjoint
  from qhbmlib_tpu_torch.ops import statevector as sv
  n = R5_QUBITS
  free = adjoint.free_bytes(device)
  batch = adjoint.auto_chunk(n, 4, free, adjoint.store_psi(n, 4, free))
  log(f"[kernels] r5 {n}q shapes at B={batch}, the rule's chunk of 4 "
      f"states with {free / 2**30:.1f} GiB free")
  h, data, _ = ladder.build_rung(R5, qubits=n, device="cpu")
  total = data.qhbm.q_inference.circuit + h.modular_hamiltonian.circuit_dagger
  check_axis2(device, n, batch)
  r, c = sv.state_shape(n)
  dgen = torch.Generator(device=device).manual_seed(SEED + 80)
  planes = tuple(torch.randn((batch, r, c), generator=dgen, device=device)
                 for _ in range(4))
  check_transitions(f"{n}q", planes, list(range(n)))
  del planes
  torch.cuda.empty_cache()
  rms, cms = first_diag_factors(total.pqc)
  log(f"[kernels] r5 {n}q composite diagonal segment: K = {len(rms)}")
  check_diag(device, n, batch, rms, cms, dgen)


def vqt_oracle_path(device, path, cfg, build, required):
  """A warm-up and one step of the VQT workload `build` makes (`cfg`) with
  every count reset just before and read just after, that step's gradient
  against the plain versions within GRAD_TOL (`bench.precision_gate`), and
  <H> of one sampled bitstring against the f64 oracle within ORACLE_TOL.
  Returns the launches."""
  import numpy as np
  from qhbmlib_tpu_torch import bench
  from qhbmlib_tpu_torch.ops import adjoint
  from qhbmlib_tpu_torch.ops import hopper_sv
  from qhbmlib_tpu_torch.ops import native_oracle
  traj = {}
  reset_launches()
  sps = bench.run_workload(path, cfg, 1, device, traj, build=build)
  torch.cuda.synchronize()
  launches = read_launches(path, required, paired=True)
  log(f"[{path}] {sps:.4f} steps/s (one step after the warm-up, host "
      f"clock); launches per step (warm-up + 1 step): "
      f"{ {k: v / 2 for k, v in launches.items() if v} }")
  gate = bench.precision_gate(traj)
  check(f"{path} gradient, kernels vs plain at 1 step",
        gate["gate_grad_rel_err"], GRAD_TOL)
  h, target = traj["model"], traj["other"]
  circuit = h.q_inference.circuit
  bits = h.e_inference.sample(
      1, torch.Generator(device=device).manual_seed(SEED + 90))
  with torch.no_grad():
    values = circuit.resolved_values()
    got = float(adjoint.batched_expectations(circuit.pqc, values, bits,
                                             (target,))[0, 0])
  psi = native_oracle.simulate(
      circuit.pqc, hopper_sv.host_values(values).astype(np.float64),
      bits=bits.cpu().numpy()[0])
  want = native_oracle.expectation_f64(psi, target)
  log(f"[{path}] <H> of one sampled bitstring {got:.8f}, f64 oracle "
      f"{want:.8f}")
  check(f"{path} <H> vs f64 oracle", abs(got - want) / abs(want),
        ORACLE_TOL)
  return launches


def phase_vqt_heis20(device):
  """"vqt heis 20q": the bench's 20q workload (`bench.WORKLOADS["20q"]`)
  with the Heisenberg chain (`ladder.heisenberg`) as its target, whose
  XX / YY on (6, 7) span the row blocks (0,7), (7,6) and on (12, 13) mix
  row and column (`vqt_oracle_path`).  Returns the launches."""
  from qhbmlib_tpu_torch import bench
  from qhbmlib_tpu_torch.benchmarks import ladder
  cfg = bench.WORKLOADS["20q"]
  target = ladder.heisenberg(cfg["n"], device=device)
  return vqt_oracle_path(
      device, "vqt heis 20q", cfg,
      lambda cfg, dev: bench.build_train_step(cfg, dev, target=target),
      BENCH_PATHS["train 20q"])


# Kernels the QAIA paths must launch.  QAIA on the TFIM's shards: each
# layer's 20 X-field PROTs fold into one 1q segment (K1's pass and the
# (7,6) block's axis_apply; their transitions in the sweep), its ZZ and Z
# PROTs into one diagonal segment.  QAIA on the Heisenberg chain's shards:
# a layer's 19 XX and 19 YY PROTs are flip gates (one flip_apply each in
# the forward, one flip_bilinear each in the sweep), its ZZ and Z PROTs one
# diagonal segment; no 1q gate.
TRAIN_QAIA = ["axis_apply", "axis2_apply", "diag_rotate", "qubit_transitions",
              "parity_bilinear"]
QAIA_HEIS = ["flip_apply", "flip_bilinear", "diag_rotate", "parity_bilinear"]


def phase_train_qaia20(device):
  """"train qaia 20q": the bench's 20q workload with QAIA on the TFIM's
  shards, 4 layers (`bench.QAIA_WORKLOADS["qaia 20q"]`), a warm-up and
  STEPS steps with every count reset just before and read just after,
  steps/s; then the kernels' gradient against the plain versions at each
  timed step, within GRAD_TOL.  Returns the launches."""
  from qhbmlib_tpu_torch import bench
  from qhbmlib_tpu_torch.ops import paulis
  cfg = bench.QAIA_WORKLOADS["qaia 20q"]
  traj = {}
  reset_launches()
  sps = bench.run_workload(
      "qaia 20q", cfg, STEPS, device, traj,
      build=lambda cfg, dev: bench.build_qaia_step(
          cfg, dev, paulis.tfim_1d(cfg["n"], device=dev)))
  torch.cuda.synchronize()
  launches = read_launches("train qaia 20q", TRAIN_QAIA, paired=True)
  per_step = {k: v / (STEPS + 1) for k, v in launches.items() if v}
  log(f"[train qaia 20q] {sps:.4f} steps/s; launches per step (warm-up + "
      f"{STEPS} steps): {per_step}")
  gate = bench.precision_gate(traj)
  check(f"train qaia 20q gradient, kernels vs plain at {STEPS} steps",
        gate["gate_grad_rel_err"], GRAD_TOL)
  return launches


def phase_vqt_qaia_heis20(device):
  """"vqt qaia heis 20q": the 20q workload with the Heisenberg chain as
  target and QAIA on its XX, YY and ZZ shards, 2 layers
  (`bench.QAIA_WORKLOADS["qaia heis 20q"]`): its XX and YY PROTs on
  (6, 7) span the row blocks and on (12, 13) mix row and column, so
  flip_apply and flip_bilinear run at 20q B=64 (`vqt_oracle_path`).
  Returns the launches."""
  from qhbmlib_tpu_torch import bench
  from qhbmlib_tpu_torch.benchmarks import ladder
  cfg = bench.QAIA_WORKLOADS["qaia heis 20q"]
  target = ladder.heisenberg(cfg["n"], device=device)
  return vqt_oracle_path(
      device, "vqt qaia heis 20q", cfg,
      lambda cfg, dev: bench.build_qaia_step(cfg, dev, target), QAIA_HEIS)


# Kernels the r1 step (2q: no row qubit, the minor operator alone takes
# axis_apply at N = 4) must launch; a step runs one forward and one sweep.
TRAIN_R1 = ["axis_apply", "diag_rotate", "qubit_transitions",
            "parity_bilinear"]


def r1_oracle(h, target) -> float:
  """beta tr(rho H) - S of the r1 model in float64 without the port's
  engine: U column by column by the C++ oracle, p(x) the Bernoulli
  energy's exact distribution, rho = U diag(p) U^dagger."""
  import numpy as np
  from qhbmlib_tpu_torch.benchmarks import ladder
  from qhbmlib_tpu_torch.ops import hopper_sv
  from qhbmlib_tpu_torch.ops import native_oracle
  circuit = h.q_inference.circuit
  n = circuit.num_qubits
  values = hopper_sv.host_values(circuit.resolved_values()).astype(np.float64)
  bits = (np.arange(2**n)[:, None] >> np.arange(n - 1, -1, -1)) & 1
  u = np.stack([native_oracle.simulate(circuit.pqc, values, bits=b)
                for b in bits], axis=1)
  theta = h.e_inference.energy.kernel.detach().cpu().double().numpy()
  logits = -(1.0 - 2.0 * bits) @ theta
  p = np.exp(logits - logits.max())
  p /= p.sum()
  rho = u @ np.diag(p) @ u.conj().T
  return float(ladder.BETA * np.real(np.trace(rho @ target.dense())) +
               np.sum(p * np.log(p)))


def phase_train_r1(device):
  """"train r1 2q": the JAX ladder's r1 rung (`ladder.build_rung(
  "r1_tfim2_vqt")`: 2q TFIM VQT, Bernoulli EBM of 500 samples, HEA 2L) on
  the card, a warm-up and one step with every count reset just before and
  read just after.  Then, as the bench's gate does at the rung's own beta
  (TF32 off): the timed step's loss and gradient through the kernels
  against the plain versions (`AnalyticQuantumInference(plain=True)`) at
  its parameters and EBM draw, within GRAD_TOL -- this holds the sweep's
  kernels at 2q, where the minor operator is the whole state; and the rung
  with its exact EBM: its loss against the float64 free-energy oracle
  (`r1_oracle`) within ORACLE_TOL.  Returns the launches."""
  from qhbmlib_tpu_torch import bench
  from qhbmlib_tpu_torch.benchmarks import ladder
  from qhbmlib_tpu_torch.inference import qhbm, qnn, vqt_loss
  h, target, step = ladder.build_rung("r1_tfim2_vqt", device=device)
  reset_launches()
  step()
  params = [p.detach().clone() for p in h.parameters()]
  state = h.e_inference.generator.get_state()
  t0 = time.perf_counter()
  loss, grad = step()
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  launches = read_launches("train r1 2q", TRAIN_R1, paired=True)
  log(f"[train r1 2q] one step {dt * 1e3:.2f} ms (host clock), loss "
      f"{float(loss):.6f}; launches (warm-up + 1 step): "
      f"{ {k: v for k, v in launches.items() if v} }")
  with torch.no_grad():
    for p, v in zip(h.parameters(), params):
      p.copy_(v)
      p.grad = None
  h.e_inference.generator.set_state(state)
  plain = qhbm.QHBM(h.e_inference, qnn.AnalyticQuantumInference(
      h.q_inference.circuit, plain=True))
  loss_p = vqt_loss.make_vqt(plain, target)(ladder.BETA)
  loss_p.backward()
  grad_p = bench.flat_grads(h)
  log(f"[train r1 2q] timed step through the kernels: loss "
      f"{float(loss):.8f}, plain {float(loss_p.detach()):.8f}")
  check("train r1 2q gradient, kernels vs plain at 1 step",
        rel_err(grad.cpu(), grad_p.cpu()), GRAD_TOL)
  h, target, step = ladder.build_rung("r1_tfim2_vqt", exact=True,
                                      device=device)
  want = r1_oracle(h, target)
  got = float(step()[0])
  log(f"[train r1 2q] exact-EBM loss {got:.8f}, f64 oracle {want:.8f}")
  check("train r1 2q exact-EBM loss vs f64 free-energy oracle",
        abs(got - want) / abs(want), ORACLE_TOL)
  return launches


R3 = "r3_kobe16_vqt_shift"
# The r3 step launches the batched forward's kernels only: its 16q 1q
# segments take K1 on (0,7) x the minor and axis_apply at N = 4 on (7,2),
# its shift corrections axis_apply at N = 2 (an XP row) and diag_rotate (a
# ZP or CZ row).  A shift gradient runs no sweep.
TRAIN_R3 = ["axis_apply", "axis2_apply", "diag_rotate"]
NO_SWEEP = ["qubit_transitions", "parity_bilinear", "circuit_forward",
            "adjoint_sweep"]
# A sampled gradient component against the exact one, in standard errors.
SHIFT_SIGMAS = 6.0
# The sampled gradient's mean squared z over its P components (about 1 for
# an honest sampler; a chi-square of P degrees of freedom over P, standard
# deviation sqrt(2 / P)) may lie this many of its standard deviations from 1.
CHI2_SIGMAS = 5.0


def shot_variance(probs, masks, gk, states: int):
  """[rows] sum over a row's states b of Var_x(f_b(x)), x drawn from the
  row's group probabilities `probs` [rows * states, 2^n] and f_b(x) =
  sum_t gk[b, t] (-1)^popcount(x & mask_t) the group's weighted parity
  sum: one shot's variance of that state's group estimate.  float64."""
  from qhbmlib_tpu_torch.inference import qnn
  from qhbmlib_tpu_torch.ops import statevector
  dim = probs.shape[1]
  signs = statevector.parity_signs(qnn._flat_masks(masks), dim,
                                   probs.device).double()
  f = gk.double() @ signs  # [states, 2^n]
  p = probs.double().reshape(-1, states, dim)
  m1 = torch.einsum("rbx,bx->rb", p, f)
  m2 = torch.einsum("rbx,bx->rb", p, f * f)
  return (m2 - m1 * m1).sum(dim=1)


def shift_sigma(pqc, row_var, shots):
  """[num_symbols] standard errors of a sampled shift gradient: shifted row
  r (`shift.shift_plan` order) adds weights[r] times its groups' estimates
  to its slot, each a mean of `shots` draws of per-shot variance
  row_var[r] (`shot_variance`, summed over groups); the rows, states and
  groups draw independently."""
  import numpy as np
  from qhbmlib_tpu_torch.ops import shift
  _, weights, slots = shift.shift_plan(pqc)
  var = np.zeros(pqc.num_symbols)
  np.add.at(var, slots, weights.astype(np.float64)**2 *
            row_var.cpu().numpy() / shots)
  return np.sqrt(var)


def z_stats(z):
  """(worst |z|, its index, mean z^2) of standard scores `z`."""
  import numpy as np
  z = np.abs(np.asarray(z))
  return float(z.max()), int(z.argmax()), float(np.mean(z * z))


def r3_restore(h, snap):
  """Puts a recorded step's (parameters, EBM generator state) back into
  `h` and returns that step's EBM (support, counts)."""
  params, state = snap
  with torch.no_grad():
    for p, v in zip(h.parameters(), params):
      p.copy_(v)
  h.e_inference.generator.set_state(state)
  return h.e_inference.support_and_counts()


def phase_train_r3(device):
  """"train r3 16q": the JAX ladder's r3 rung (`ladder.build_rung(
  "r3_kobe16_vqt_shift")`) at its own 16q/2L: KOBE-2 under exact
  categorical inference (100 samples, 4 unique states), the HEA measured
  by `SampledQuantumInference` at 1000 shots with parameter-shift
  gradients (188 shifted rows of 4 states through the batched forward and
  its per-row corrections).  A warm-up and STEPS steps with every count
  reset just before and read just after: steps/s (host clock after a
  synchronize) and peak memory; axis2_apply, axis_apply and diag_rotate
  launched, and no sweep kernel.  Then:
    (iii) at each timed step's parameters and EBM support, its sampled
          gradient against the shot-free one (means from the kernels'
          probabilities), in standard errors from the exact per-shot
          variances of those probabilities (`shot_variance`,
          `shift_sigma`): over all STEPS x 94 components, each within
          SHIFT_SIGMAS and their mean squared z within CHI2_SIGMAS of 1; a
          control sampled at half the shots at the same points is read
          against the same standard errors and printed.
  At the last timed step's parameters and EBM support:
    (i)   every row's group probabilities (base + 188 shifted rows, 756
          states, both bases) through the kernels against the plain
          versions within STATE_TOL (relative L2 a row);
    (ii)  the shot-free shift gradient against the adjoint gradient
          (`batched_expectations`) within GRAD_TOL;
    (iv)  <H> of the first support state from exact probabilities against
          `native_oracle` in float64 within ORACLE_TOL.
  Returns the launches."""
  import numpy as np
  from qhbmlib_tpu_torch.benchmarks import ladder
  from qhbmlib_tpu_torch.inference import qnn
  from qhbmlib_tpu_torch.ops import adjoint
  from qhbmlib_tpu_torch.ops import hopper_sv
  from qhbmlib_tpu_torch.ops import native_oracle
  from qhbmlib_tpu_torch.ops import shift
  t0 = time.time()
  h, target, step = ladder.build_rung(R3, device=device)
  e_inf, q_inf = h.e_inference, h.q_inference
  circuit = q_inf.circuit
  pqc = circuit.pqc
  log(f"[train r3 16q] rung built in {time.time() - t0:.2f} s: "
      f"{pqc.num_gates} gates, {len(shift.shift_plan(pqc)[1])} shifted rows, "
      f"{q_inf.expectation_samples} shots, at most "
      f"{e_inf.max_unique_samples} states")
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats(device)
  reset_launches()
  t0 = time.perf_counter()
  step()
  torch.cuda.synchronize()
  log(f"[train r3 16q] warm-up step {time.perf_counter() - t0:.3f} s")
  snaps, grads = [], []
  t0 = time.perf_counter()
  for _ in range(STEPS):
    snaps.append(([p.detach().clone() for p in h.parameters()],
                  e_inf.generator.get_state()))
    loss, g = step()
    grads.append(g)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  peak = torch.cuda.max_memory_allocated(device)
  launches = read_launches("train r3 16q", TRAIN_R3)
  swept = {k: launches[k] for k in NO_SWEEP if launches[k]}
  if swept:
    raise AssertionError(f"train r3 16q: the shift gradient ran the adjoint "
                         f"path: {swept}")
  log(f"[train r3 16q] {STEPS / dt:.4f} steps/s ({STEPS} steps in "
      f"{dt:.3f} s, host clock), peak memory {peak / 2**30:.2f} GiB, final "
      f"loss {float(loss):.6f}; launches per step (warm-up + {STEPS} "
      f"steps): { {k: v / (STEPS + 1) for k, v in launches.items() if v} }")
  plan, _ = qnn.measurement_plan(pqc, (target,))
  offsets = shift.shift_plan(pqc)[0]
  rows = np.concatenate([np.zeros((1, pqc.num_gates), np.float32), offsets])
  shots = q_inf.expectation_samples
  perm = circuit._perm.cpu()
  half_gen = torch.Generator(device=device).manual_seed(SEED + 15)
  # (iii) each timed step's sampled gradient, and the half-shots control,
  # against the shot-free one in exact standard errors.
  zs, zs_half, sigmas = [], [], []
  for k, (snap, grad) in enumerate(zip(snaps, grads)):
    support, counts = r3_restore(h, snap)
    bits = support.to(torch.int8)
    values = circuit.resolved_values().detach()
    rowcol = adjoint.bits_to_rowcol(bits, pqc.num_qubits)
    w = (counts / counts.sum()).to(device)
    g = ladder.BETA * w[:, None] * target.coeffs[None, :]
    t0 = time.perf_counter()
    psi = hopper_sv.apply_circuit_shifted(pqc, values, rowcol, rows)
    torch.cuda.synchronize()
    if k == 0:
      log(f"[train r3 16q] shifted batch of {psi[0].shape[0]} states "
          f"through the kernels: {(time.perf_counter() - t0) * 1e3:.2f} ms "
          "(host clock, first call of these shapes)")
    row_var = torch.zeros(len(rows), dtype=torch.float64, device=device)
    for rotation, masks, idx in plan[0]:
      row_var += shot_variance(qnn.group_probabilities(psi, rotation), masks,
                               g[:, list(idx)], len(bits))
    sigma = shift_sigma(pqc, row_var[1:], shots)
    exact = qnn.term_means_gradient(pqc, values, rowcol, plan, g).double()
    sampled = grad[-circuit.values.numel():].double().cpu()[perm]  # slots
    half = qnn.term_means_gradient(pqc, values, rowcol, plan, g, shots // 2,
                                   half_gen).double().cpu()
    zs.append((sampled - exact.cpu()).numpy() / sigma)
    zs_half.append((half - exact.cpu()).numpy() / sigma)
    sigmas.append(sigma)
    if k < len(snaps) - 1:
      del psi
  worst, at, chi2 = z_stats(np.concatenate(zs))
  h_worst, h_at, h_chi2 = z_stats(np.concatenate(zs_half))
  num_z = sum(len(z) for z in zs)
  chi2_tol = CHI2_SIGMAS * np.sqrt(2.0 / num_z)
  per = pqc.num_symbols
  log(f"[train r3 16q] sampled gradients vs shot-free at {len(zs)} steps, "
      f"{num_z} components at {shots} shots: worst z {worst:.3f} (step "
      f"{at // per}, symbol {at % per}; limit {SHIFT_SIGMAS}), mean z^2 "
      f"{chi2:.3f} (limit 1 +/- {chi2_tol:.3f}); median standard error "
      f"{np.median(np.concatenate(sigmas)):.4e}; control at {shots // 2} "
      f"shots against the same standard errors: worst z {h_worst:.3f} (step "
      f"{h_at // per}, symbol {h_at % per}), mean z^2 {h_chi2:.3f}")
  if not worst < SHIFT_SIGMAS:
    raise AssertionError(f"train r3 16q: a sampled gradient component lies "
                         f"{worst:.2f} standard errors from the exact one")
  if not abs(chi2 - 1.0) < chi2_tol:
    raise AssertionError(f"train r3 16q: the sampled gradients' mean z^2 "
                         f"is {chi2:.3f}, not within {chi2_tol:.3f} of 1")
  # (i) at the last timed step: every row's group probabilities, kernels
  # against plain.
  psi_p = hopper_sv.apply_circuit_shifted(pqc, values, rowcol, rows,
                                          plain=True)
  err = 0.0
  for rotation, _, _ in plan[0]:
    got = qnn.group_probabilities(psi, rotation)
    want = qnn.group_probabilities(psi_p, rotation, plain=True)
    err = max(err, float((torch.linalg.vector_norm(got - want, dim=1) /
                          torch.linalg.vector_norm(want, dim=1)).max()))
    del got, want
  del psi, psi_p
  check(f"train r3 16q group probabilities of {len(rows)} rows x "
        f"{len(bits)} states ({len(plan[0])} bases), kernels vs plain",
        err, STATE_TOL)
  # (ii) the shot-free shift gradient against the adjoint one.
  leaf = values.clone().requires_grad_()
  adj = adjoint.batched_expectations(pqc, leaf, bits, (target,))[:, 0]
  (ladder.BETA * (w * adj).sum()).backward()
  check("train r3 16q shot-free shift gradient vs adjoint gradient",
        rel_err(exact.cpu(), leaf.grad.double().cpu()), GRAD_TOL)
  # (iv) <H> of the first support state against the f64 oracle.
  means = qnn.shifted_term_means(pqc, values, rowcol[:1],
                                 np.zeros([1, pqc.num_gates], np.float32),
                                 plan)[0, 0]
  got = float((means * target.coeffs).sum())
  psi0 = native_oracle.simulate(
      pqc, hopper_sv.host_values(values).astype(np.float64),
      bits=bits.cpu().numpy()[0])
  want = native_oracle.expectation_f64(psi0, target)
  log(f"[train r3 16q] <H> of the first support state {got:.8f}, f64 "
      f"oracle {want:.8f}")
  check("train r3 16q <H> vs f64 oracle", abs(got - want) / abs(want),
        ORACLE_TOL)
  return launches


# Kernels the harness's 8q VQT step must launch: as r2 8q's, the only row
# block of an 8q state pairs with the minor operator, so each 1q segment is
# one axis2_apply pass.
TRAIN_HARNESS = ["axis2_apply", "diag_rotate", "qubit_transitions",
                 "parity_bilinear"]
# Bounds on the harness's 8q beta sweep that hold across random streams,
# from the JAX package's harness (`baselines.train.run_experiment`) run once
# on a CPU at the same configuration with seed 42: beta 0.5's fidelity read
# 0.900-0.932 at every logged step from 100 on and its last relative
# entropy 0.1730; the later betas' relative entropies fell from 10.27,
# 19.10 and 24.07 at their step 0 to 0.45, 0.84 and 0.83.
HARNESS_FIDELITY_MIN = 0.88  # beta 0.5's last logged fidelity
HARNESS_REL_ENTROPY_MAX = 0.35  # beta 0.5's last relative entropy
HARNESS_REL_ENTROPY_FALL = 10.0  # later betas: last < step 0 / this
HARNESS_SEED = 42
# Float32 rounding alone puts both arms' gradients ~1e-4 from the float64
# one at the last beta's checkpoint (one state, a small gradient against
# beta <H>); there the kernels' error may be at most this many times the
# plain versions', or GRAD_TOL if larger.
HARNESS_F64_FACTOR = 2.0


def harness_config():
  """The harness's default config (KOBE-2, analytic EBM of 500 samples,
  HEA 7L, analytic QNN, Adam 0.1, 1000 steps at beta 0.5, then 100 at each
  of 1.083, 1.667, 2.25) on an 8-site TFIM ring, bias 1.0, with
  TensorBoard off and the fidelity and relative entropy every 100 steps."""
  from qhbmlib_tpu_torch.baselines import config as config_lib
  config = config_lib.get_config()
  config.dataset.num_rows = 8
  config.dataset.num_cols = 1
  config.logging.tensorboard = False
  config.logging.expensive_downsample = 100
  return config


def harness_metrics(results, label):
  """{tag: [(step, value)]} of a data point's train metrics."""
  path = os.path.join(results, "metrics", label, "train_model_trial_0",
                      "metrics.jsonl")
  out = {}
  with open(path) as f:
    for line in f:
      rec = json.loads(line)
      if "value" in rec:
        out.setdefault(rec["tag"], []).append((rec["step"], rec["value"]))
  return out


def harness_model(config, device, params):
  """(TFIM shards, modular Hamiltonian, QHBM): a fresh harness model on
  the card carrying `params` ({'theta': [...], 'phi': [...]})."""
  from qhbmlib_tpu_torch.baselines import train
  shards = train.get_tfim_hamiltonian(config.dataset.bias, config, device)
  mh, h = train.get_initial_qhbm(shards, config, "qhbm", seed=0,
                                 device=device)
  h.set_params(params)
  return shards, mh, h


def harness_restore(results, config, label, device):
  """(modular Hamiltonian, QHBM, beta, target) of data point `label`: a
  fresh model with the point's checkpointed parameters."""
  from qhbmlib_tpu_torch.baselines import train
  shards, mh, h = harness_model(config, device, train.load_params(
      os.path.join(results, "checkpoints", label, "trial_0"), device))
  return mh, h, float(label[5:].replace("p", ".")), shards[0] + shards[1]


def harness_grad(h, target, beta, gen, plain):
  """(loss, flat float64 CPU gradient [theta, phi]) of the harness's VQT
  loss at `beta`, its EBM draw from `gen` reseeded with SEED, through the
  kernels or (`plain`) their plain versions."""
  from qhbmlib_tpu_torch import bench
  from qhbmlib_tpu_torch.inference import qhbm, qnn, vqt_loss
  for p in h.parameters():
    p.grad = None
  gen.manual_seed(SEED)
  model = h if not plain else qhbm.QHBM(h.e_inference,
                                        qnn.AnalyticQuantumInference(
                                            h.q_inference.circuit,
                                            plain=True))
  loss, _ = vqt_loss.make_vqt_with_state(model, target)(beta, gen)
  loss.backward()
  torch.cuda.synchronize()
  return float(loss.detach()), bench.flat_grads(h).double().cpu()


def harness_phi_grad_f64(h, target, beta, support, counts):
  """(float64 gradient of the VQT loss in the circuit's parameters, states
  used): beta sum_x w_x d<H>_x / dphi over the draw's states x of weight
  w_x = counts / total, each derivative a central difference of step 1e-5
  of `native_oracle`'s float64 <H>, without the port's engine."""
  import numpy as np
  from qhbmlib_tpu_torch.ops import native_oracle
  circuit = h.q_inference.circuit
  values = circuit.values.detach().double().cpu().numpy()
  perm = circuit._perm.cpu().numpy()
  w = (counts / counts.sum()).double().cpu().numpy()
  bits = support.cpu().numpy().astype(np.int64)
  states = np.nonzero(w)[0]
  target = target.to("cpu")
  grad = np.zeros_like(values)
  for j in range(len(values)):
    for sign in (1.0, -1.0):
      v = values.copy()
      v[j] += sign * 1e-5
      grad[j] += sign * sum(
          w[i] * native_oracle.expectation_f64(
              native_oracle.simulate(circuit.pqc, v[perm], bits=bits[i]),
              target) for i in states)
  return torch.tensor(beta * grad / 2e-5), len(states)


def phase_harness(device):
  """"train harness 8q": the port's experiment harness
  (`baselines.train.run_experiment`) on `harness_config()`, its whole VQT
  beta sweep (1300 steps), into a temporary directory, with every launch
  count reset just before and read just after: steps/s over the sweep and
  over beta 0.5's steps after the first (host clock; a step includes its
  metrics), peak memory, each beta's first and last fidelity and relative
  entropy.  It fails unless every logged loss is finite, beta 0.5 ends at
  a fidelity of at least HARNESS_FIDELITY_MIN and a relative entropy of at
  most HARNESS_REL_ENTROPY_MAX, and each later beta's relative entropy
  falls below 1 / HARNESS_REL_ENTROPY_FALL of its step-0 value.  Then
  beta 0.5's and the last beta's checkpoints are restored into fresh
  models: the last one's fidelity against the logged one; at beta 0.5's,
  one step's gradient at a fixed EBM draw through the kernels against
  `AnalyticQuantumInference(plain=True)` within GRAD_TOL; at the last
  one, one step's launches (TRAIN_HARNESS, paired) and its circuit
  gradient through the kernels and plain against a float64 one
  (`harness_phi_grad_f64`), the kernels' error within GRAD_TOL or
  HARNESS_F64_FACTOR times the plain versions'.  Returns the launches."""
  import math
  import tempfile
  from qhbmlib_tpu_torch.baselines import train
  from qhbmlib_tpu_torch.inference import qhbm_utils
  config = harness_config()
  times = {}

  def on_step(label, step):
    del step
    times.setdefault(label, []).append(time.perf_counter())

  with tempfile.TemporaryDirectory() as out:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    results = train.run_experiment(config, out, seed=HARNESS_SEED,
                                   device=device, on_step=on_step)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    launches = read_launches("train harness 8q", TRAIN_HARNESS)
    steps = sum(len(t) for t in times.values())
    first = times["beta_0p5"]
    log(f"[train harness 8q] {steps} steps in {dt:.3f} s: {steps / dt:.4f} "
        f"steps/s over the sweep, {(len(first) - 1) / (first[-1] - first[0]):.4f}"
        f" over beta 0.5's steps after the first (host clock, metrics "
        f"included), peak memory {peak / 2**20:.1f} MiB; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    labels = list(times)
    for i, label in enumerate(labels):
      m = harness_metrics(results, label)
      losses = [v for _, v in m["loss"]]
      if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train harness 8q: a {label} loss is not "
                             "finite")
      (f0, fid0), (f1, fid1) = m["fidelity"][0], m["fidelity"][-1]
      rel0, rel1 = m["relative_entropy"][0][1], m["relative_entropy"][-1][1]
      log(f"[train harness 8q] {label}: {len(losses)} steps, loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f} (target "
          f"{m['target_loss'][0][1]:.6f}); fidelity {fid0:.6f} (step {f0}) "
          f"-> {fid1:.6f} (step {f1}); relative entropy {rel0:.6f} -> "
          f"{rel1:.6f}")
      if i == 0:
        if not (fid1 >= HARNESS_FIDELITY_MIN and
                rel1 <= HARNESS_REL_ENTROPY_MAX):
          raise AssertionError(
              f"train harness 8q: beta 0.5 ends at fidelity {fid1:.4f} "
              f"(limit >= {HARNESS_FIDELITY_MIN}), relative entropy "
              f"{rel1:.4f} (limit <= {HARNESS_REL_ENTROPY_MAX})")
      elif not rel1 < rel0 / HARNESS_REL_ENTROPY_FALL:
        raise AssertionError(
            f"train harness 8q: {label}'s relative entropy fell from "
            f"{rel0:.4f} only to {rel1:.4f}")
    # Beta 0.5's and the last beta's checkpoints, each in a fresh model.
    first = harness_restore(results, config, labels[0], device)
    last = harness_restore(results, config, labels[-1], device)
    logged = harness_metrics(results, labels[-1])["fidelity"][-1][1]
  mh, h, beta, target = last
  target_dm = train.compute_data_point_metrics(
      beta=beta, target_hamiltonian_matrix=target.dense())[0]
  fid = qhbm_utils.fidelity(mh, target_dm)
  log(f"[train harness 8q] {labels[-1]}'s checkpoint restored: fidelity "
      f"{fid:.8f}, logged {logged:.8f}")
  check(f"train harness 8q {labels[-1]} checkpoint's fidelity vs logged",
        abs(fid - logged) / logged, STATE_TOL)
  # One step at beta 0.5's trained parameters and a fixed EBM draw,
  # through the kernels against the plain versions.
  _, h0, beta0, target0 = first
  gen = torch.Generator(device=device).manual_seed(SEED)
  (loss_k, grad_k), (loss_p, grad_p) = (
      harness_grad(h0, target0, beta0, gen, plain) for plain in (False, True))
  log(f"[train harness 8q] one step at {labels[0]}'s checkpoint: loss "
      f"{loss_k:.8f} through the kernels, {loss_p:.8f} plain")
  check(f"train harness 8q gradient at {labels[0]}'s checkpoint, kernels vs "
        "plain", rel_err(grad_k, grad_p), GRAD_TOL)
  # At the last beta's, where the EBM holds few states and the gradient is
  # small against beta <H>: both arms against the float64 gradient.
  reset_launches()
  (loss_k, grad_k), (loss_p, grad_p) = (
      harness_grad(h, target, beta, gen, plain) for plain in (False, True))
  read_launches(f"train harness 8q, one step at {labels[-1]}'s checkpoint",
                TRAIN_HARNESS, paired=True)
  gen.manual_seed(SEED)
  support, counts, _ = h.e_inference.support_counts_state(gen)
  phi64, states = harness_phi_grad_f64(h, target, beta, support, counts)
  nphi = phi64.numel()
  err_k, err_p = rel_err(grad_k[-nphi:], phi64), rel_err(grad_p[-nphi:],
                                                          phi64)
  log(f"[train harness 8q] one step at {labels[-1]}'s checkpoint ({states} "
      f"states in its EBM draw): loss {loss_k:.8f} through the kernels, "
      f"{loss_p:.8f} plain; gradient kernels vs plain "
      f"{rel_err(grad_k, grad_p):.3e}; phi gradient (norm "
      f"{float(phi64.norm()):.4e}) vs float64: kernels {err_k:.3e}, plain "
      f"{err_p:.3e}")
  check(f"train harness 8q phi gradient at {labels[-1]}'s checkpoint, "
        f"kernels vs float64 (limit max(GRAD_TOL, {HARNESS_F64_FACTOR} x the "
        "plain versions' error))", err_k,
        max(GRAD_TOL, HARNESS_F64_FACTOR * err_p))
  return launches


@contextlib.contextmanager
def wrapped(module, name: str, wrapper):
  """`module.name` replaced by wrapper(original) inside the block."""
  original = getattr(module, name)
  setattr(module, name, wrapper(original))
  try:
    yield
  finally:
    setattr(module, name, original)


def harness_run(path, config, device):
  """`run_experiment(config)` of the harness into a temporary directory,
  every launch count reset just before and read just after (TRAIN_HARNESS
  required).  Returns (step_times {label: host clock at each step's end},
  metrics {label: harness_metrics}, inner {label: {tag: [(index, value)]}}
  of the mirror inner loop, launches, seconds, checkpoints {label:
  params} on the card)."""
  import tempfile
  from qhbmlib_tpu_torch.baselines import train
  times = {}

  def on_step(label, step):
    del step
    times.setdefault(label, []).append(time.perf_counter())

  with tempfile.TemporaryDirectory() as out:
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = train.run_experiment(config, out, seed=HARNESS_SEED,
                                   device=device, on_step=on_step)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches(path, TRAIN_HARNESS)
    metrics = {label: harness_metrics(results, label) for label in times}
    inner = {}
    for label in times:
      inner_file = os.path.join(results, "metrics", label,
                                "train_model_trial_0", "train_inner",
                                "metrics.jsonl")
      if os.path.exists(inner_file):
        with open(inner_file) as f:
          for rec in map(json.loads, f):
            if "value" in rec:
              inner.setdefault(label, {}).setdefault(rec["tag"], []).append(
                  (rec["step"], rec["value"]))
    ckpts = {label: train.load_params(os.path.join(
        results, "checkpoints", label, "trial_0"), device)
             for label in times}
  return times, metrics, inner, launches, dt, ckpts


def step_seconds(times) -> list:
  """Seconds of each step after the first (host clock at the steps' ends)."""
  return [round(b - a, 4) for a, b in zip(times, times[1:])]


def all_finite(values) -> bool:
  import math
  return all(math.isfinite(v) for v in values)


def harness_point_config(method, steps):
  """`harness_config()` at one beta, 0.5 (cut from four), for `steps`
  steps (cut from 1000) of `method`."""
  config = harness_config()
  config.training.method = method
  config.dataset.beta_steps = 1
  config.dataset.beta_min = config.dataset.beta_max = 0.5
  config.training.init_steps = steps
  return config


# Natural steps on "train harness natural 8q": each builds the information
# matrix from 4 Pp shifted <K_copy> evaluations (Pp = 161 at 8q/7L), row
# after row.
NATURAL_STEPS = 3


def phase_harness_natural(device):
  """"train harness natural 8q": `run_experiment` on `harness_config()`
  with the natural gradient (Adam 0.1, the harness's lstsq and
  regularizer defaults), one beta, 0.5, NATURAL_STEPS steps (cut from
  1000), the exact metrics every step.  Logs the seconds of each step
  after the first (host clock; a step includes its metrics) and the
  launches a step and of one information matrix; fails unless every loss
  is finite and K1, `diag_rotate`, K5 and `parity_bilinear` launched.  The
  first step's information matrix, recorded as the path built it (the
  initial parameters, the draw of the step's generator), must be finite
  and symmetric and agree within GRAD_TOL with one built through
  `AnalyticQuantumInference(plain=True)` at the same parameters, sampler
  state and generator state.  Returns the launches."""
  from qhbmlib_tpu_torch.baselines import train
  from qhbmlib_tpu_torch.inference import qhbm, qnn
  path = "train harness natural 8q"
  config = harness_point_config("natural", NATURAL_STEPS)
  config.logging.expensive_downsample = 1
  first = {}

  def recording(make):
    def make_recorded(qhbm_obj, mh_copy, num_samples):
      fn = make(qhbm_obj, mh_copy, num_samples)

      def info_matrix(generator=None, ebm_state=None):
        if first:
          return fn(generator, ebm_state)
        first.update(gen=generator.get_state(), state=ebm_state,
                     params={k: [p.detach().clone() for p in v]
                             for k, v in qhbm_obj.params.items()})
        before = {k: f.launches for k, f in kernel_wrappers().items()}
        t0 = time.perf_counter()
        first["im"] = fn(generator, ebm_state)
        torch.cuda.synchronize()
        first["seconds"] = time.perf_counter() - t0
        first["launches"] = {k: f.launches - before[k]
                             for k, f in kernel_wrappers().items()
                             if f.launches > before[k]}
        return first["im"]

      return info_matrix
    return make_recorded

  with wrapped(train, "make_information_matrix", recording):
    times, metrics, _, launches, dt, _ = harness_run(path, config, device)
  (label,) = times
  m = metrics[label]
  losses = [v for _, v in m["loss"]]
  if len(losses) != NATURAL_STEPS or not all_finite(losses):
    raise AssertionError(f"{path}: losses {losses}")
  log(f"[{path}] {NATURAL_STEPS} natural steps (cut from 1000 and four "
      f"betas to one: beta 0.5) in {dt:.3f} s; seconds of each step after "
      f"the first {step_seconds(times[label])} (host clock, its metrics "
      f"included); the first step's information matrix alone "
      f"{first['seconds']:.3f} s, launching {first['launches']}; launches "
      f"a step { {k: v / NATURAL_STEPS for k, v in launches.items() if v} }")
  log(f"[{path}] loss {losses[0]:.6f} -> {losses[-1]:.6f} (target "
      f"{m['target_loss'][0][1]:.6f}); fidelity {m['fidelity'][0][1]:.6f} "
      f"-> {m['fidelity'][-1][1]:.6f}; relative entropy "
      f"{m['relative_entropy'][0][1]:.6f} -> "
      f"{m['relative_entropy'][-1][1]:.6f}; reg {m['reg'][0][1]:.6f}; "
      f"information matrix eigenvalues {m['info_matrix_min_eigval'][0][1]:.4e}"
      f" .. {m['info_matrix_max_eigval'][0][1]:.4e}; natural gradient norm "
      f"{m['natural_grad_norm'][0][1]:.6f}")
  # The first step's matrix again, through the plain versions.
  shards, _, h = harness_model(config, device, first["params"])
  mh_copy, _ = train.get_initial_qhbm(shards, config, "qhbm_copy",
                                      device=device)
  plain = qhbm.QHBM(h.e_inference, qnn.AnalyticQuantumInference(
      h.q_inference.circuit, plain=True))
  gen = torch.Generator(device=device)
  gen.set_state(first["gen"])
  t0 = time.perf_counter()
  im_plain = train.make_information_matrix(
      plain, mh_copy, config.training.num_samples)(gen, first["state"])
  torch.cuda.synchronize()
  im = first["im"]
  pt = sum(p.numel() for p in h.params["theta"])
  log(f"[{path}] first step's information matrix {tuple(im.shape)} (Pt = "
      f"{pt}), plain versions in {time.perf_counter() - t0:.3f} s; largest "
      f"|entry| of the EBM block {float(im[:pt, :pt].abs().max()):.4e}, the "
      f"cross block {float(im[pt:, :pt].abs().max()):.4e}, the QNN block "
      f"{float(im[pt:, pt:].abs().max()):.4e}")
  if not (bool(torch.isfinite(im).all()) and torch.equal(im, im.T)):
    raise AssertionError(f"{path}: the information matrix is not finite "
                         "and symmetric")
  check(f"{path} first step's information matrix, kernels vs plain",
        rel_err(im.cpu(), im_plain.cpu()), GRAD_TOL)
  return launches


# Outer steps on "train harness mirror 8q", each of the default 100 inner
# steps.
MIRROR_STEPS = 2
# Inner step 0 starts at the anchor, where f_vqt = <K_anchor> - E_anchor is
# 0 on every state: div = -log Z of the anchor's EBM whatever the draw.
MIRROR_DIV_TOL = 1e-4


def phase_harness_mirror(device):
  """"train harness mirror 8q": `run_experiment` on `harness_config()`
  with mirror descent (Adam at `inner_learning_rate`, the default
  `num_inner_steps`), one beta, 0.5, MIRROR_STEPS outer steps (cut from
  1000).  Logs the outer and inner steps/s (host clock, metrics
  included); fails unless every loss and inner loss is finite, each outer
  step's inner step 0 `div` equals -log Z of the anchor's EBM (exact, read
  at the step's start) within MIRROR_DIV_TOL relative, and K1,
  `diag_rotate`, K5 and `parity_bilinear` launched.  Returns the
  launches."""
  from qhbmlib_tpu_torch.baselines import train
  path = "train harness mirror 8q"
  config = harness_point_config("mirror", MIRROR_STEPS)
  inner_steps = config.training.num_inner_steps
  anchors = []

  def recording(make):
    def make_recorded(qhbm_obj, *args, **kwargs):
      step = make(qhbm_obj, *args, **kwargs)

      def recorded(state, index):
        with torch.no_grad():
          anchors.append(float(qhbm_obj.e_inference.log_partition_forward()))
        return step(state, index)

      return recorded
    return make_recorded

  with wrapped(train, "make_train_step", recording):
    times, metrics, inner, launches, dt, _ = harness_run(path, config,
                                                         device)
  (label,) = times
  losses = [v for _, v in metrics[label]["loss"]]
  inner_losses = [v for _, v in inner[label]["inner_loss"]]
  divs = dict(inner[label]["div"])
  if (len(losses) != MIRROR_STEPS or not all_finite(losses) or
      len(inner_losses) != MIRROR_STEPS * inner_steps or
      not all_finite(inner_losses)):
    raise AssertionError(f"{path}: {len(losses)} losses, "
                         f"{len(inner_losses)} inner losses, not all finite")
  outer = step_seconds(times[label])
  log(f"[{path}] {MIRROR_STEPS} outer steps of {inner_steps} inner steps "
      f"(cut from 1000 outer steps and four betas to one: beta 0.5) in "
      f"{dt:.3f} s: {MIRROR_STEPS * inner_steps / dt:.4f} inner steps/s, "
      f"{MIRROR_STEPS / dt:.4f} outer steps/s over the path, the second "
      f"outer step {outer} s (host clock, metrics included); launches an "
      f"outer step { {k: v / MIRROR_STEPS for k, v in launches.items() if v} }")
  log(f"[{path}] loss {losses[0]:.6f} -> {losses[-1]:.6f}; inner loss "
      f"{inner_losses[0]:.6f} -> {inner_losses[-1]:.6f}; fidelity "
      f"{metrics[label]['fidelity'][-1][1]:.6f}")
  for s, lz in enumerate(anchors):
    div0 = divs[s * inner_steps]
    log(f"[{path}] outer step {s}: inner step 0's div {div0:.8f}, -log Z "
        f"of the anchor's EBM {-lz:.8f}")
    check(f"{path} outer step {s}: inner step 0's div vs -log Z",
          abs(div0 + lz) / abs(lz), MIRROR_DIV_TOL)
  return launches


# Bounds on the QVARTZ sequence's time points that hold across random
# streams, from the JAX package's harness (`baselines.train.run_experiment`)
# run once on a CPU at the same configuration (`harness_config()` with
# training.loss "qvartz", seed 42, no checkpoints; 889 s): beta 1.0 ended
# at fidelity 0.8498 and D(model || target) 0.3389; the time points 1.0,
# 2.0, 3.0 went from fidelity 0.0529, 0.0645, 0.0994 and D(target ||
# model) 23.63, 6.674, 4.980 at their step 0 (a fresh Adam a point) to
# 0.5859, 0.4664, 0.3237 and 1.267, 1.690, 2.193 at their last, a fall
# of 2.27x at the least.  The port's own CPU runs at seeds 42 and 43 (other
# streams) ended them at 0.4078, 0.4043, 0.3844 and 4.070, 2.733, 2.106
# (its beta 1.0 had spiked at step 900 and ended at 0.4625), and 0.6314,
# 0.4576, 0.3394 and 0.8041, 1.475, 1.882; falls of 2.75x at the least.
# A QMHL step that did not learn stays near its step 0.
QVARTZ_FIDELITY_MIN = 0.2
QVARTZ_REL_ENTROPY_MAX = 5.0
QVARTZ_REL_ENTROPY_FALL = 1.5  # last < step 0 / this


def qmhl_grad(h, data, gen, plain):
  """(loss, flat float64 CPU gradient [theta, phi]) of the QMHL loss of
  model `h` on `data`, both draws from `gen` reseeded with SEED, the
  data's circuit through the kernels or (`plain`) their plain versions."""
  from qhbmlib_tpu_torch.data import qhbm_data
  from qhbmlib_tpu_torch.inference import qhbm, qmhl_loss, qnn
  if plain:
    d = data.qhbm
    data = qhbm_data.QHBMData(qhbm.QHBM(d.e_inference,
                                        qnn.AnalyticQuantumInference(
                                            d.q_inference.circuit,
                                            plain=True)))
  gen.manual_seed(SEED)
  loss, _ = qmhl_loss.make_qmhl_with_state(data, h)((gen, gen))
  grads = torch.autograd.grad(loss, h.parameters())
  torch.cuda.synchronize()
  return float(loss.detach()), torch.cat(
      [g.reshape(-1) for g in grads]).double().cpu()


def phase_harness_qvartz(device):
  """"train harness qvartz 8q": `run_experiment` on `harness_config()`
  with the QVARTZ loss, uncut: beta 1.0 by VQT for 1000 steps, then three
  Trotter time steps of 100 vanilla QMHL steps each, the data of each the
  previous model followed by the Trotter channel (constant gates).  Logs
  steps/s for the beta point and the time points (host clock, metrics
  included); fails unless every loss is finite, each time point's last
  fidelity is at least QVARTZ_FIDELITY_MIN and its D(target || model) at
  most QVARTZ_REL_ENTROPY_MAX and below its step 0's over
  QVARTZ_REL_ENTROPY_FALL, and K1, `diag_rotate`, K5 and
  `parity_bilinear` launched.  Then at the last time point's checkpoint
  (its data from the one before): one QMHL step's gradient at a fixed
  draw through the kernels against the plain versions within GRAD_TOL, its
  launches paired.  Returns the launches."""
  from qhbmlib_tpu_torch.baselines import train
  path = "train harness qvartz 8q"
  config = harness_config()
  config.training.loss = "qvartz"
  times, metrics, _, launches, dt, ckpts = harness_run(path, config, device)
  labels = list(times)
  steps = sum(len(t) for t in times.values())
  beta_s = times[labels[0]][-1] - times[labels[0]][0]
  time_s = times[labels[-1]][-1] - times[labels[1]][0]
  log(f"[{path}] {steps} steps in {dt:.3f} s ({steps / dt:.4f} steps/s): "
      f"{labels[0]}'s VQT {(len(times[labels[0]]) - 1) / beta_s:.4f} steps/s "
      f"after the first, the time points' QMHL "
      f"{(sum(len(times[l]) for l in labels[1:]) - 1) / time_s:.4f} steps/s "
      f"(host clock, metrics included); launches "
      f"{ {k: v for k, v in launches.items() if v} }")
  for label in labels:
    m = metrics[label]
    losses = [v for _, v in m["loss"]]
    if not all_finite(losses):
      raise AssertionError(f"{path}: a {label} loss is not finite")
    fid, rel = m["fidelity"][-1][1], m["relative_entropy"][-1][1]
    log(f"[{path}] {label}: {len(losses)} steps, loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f} (target {m['target_loss'][0][1]:.6f}); fidelity "
        f"{m['fidelity'][0][1]:.6f} -> {fid:.6f}; relative entropy "
        f"{m['relative_entropy'][0][1]:.6f} -> {rel:.6f}")
    rel0 = m["relative_entropy"][0][1]
    if label.startswith("time_") and not (
        fid >= QVARTZ_FIDELITY_MIN and rel <= QVARTZ_REL_ENTROPY_MAX and
        rel < rel0 / QVARTZ_REL_ENTROPY_FALL):
      raise AssertionError(
          f"{path}: {label} ends at fidelity {fid:.4f} (limit >= "
          f"{QVARTZ_FIDELITY_MIN}), D(target || model) {rel:.4f} (limits <= "
          f"{QVARTZ_REL_ENTROPY_MAX} and < its step 0's {rel0:.4f} / "
          f"{QVARTZ_REL_ENTROPY_FALL})")
  # One QMHL step at the last checkpoint, its data from the one before.
  shards, _, h = harness_model(config, device, ckpts[labels[-1]])
  data = train.evolved_data(ckpts[labels[-2]],
                            train.get_tfim_unitary(*shards, config), shards,
                            config, device)
  gen = torch.Generator(device=device)
  reset_launches()
  loss_k, grad_k = qmhl_grad(h, data, gen, plain=False)
  read_launches(f"{path}, one QMHL step at {labels[-1]}'s checkpoint",
                TRAIN_HARNESS, paired=True)
  loss_p, grad_p = qmhl_grad(h, data, gen, plain=True)
  log(f"[{path}] one QMHL step at {labels[-1]}'s checkpoint: loss "
      f"{loss_k:.8f} through the kernels, {loss_p:.8f} plain; gradient norm "
      f"{float(grad_p.norm()):.4e}")
  check(f"{path} QMHL gradient at {labels[-1]}'s checkpoint, kernels vs "
        "plain", rel_err(grad_k, grad_p), GRAD_TOL)
  return launches


def phase_ladder_cli():
  """The ladder's command line (`benchmarks.run_ladder`) in subprocesses
  from the checkout's root: r2 at 8q for 3 steps must exit 0 with one
  JSON line whose steps/s is finite; r4 (which waits for parallel/) must
  print its error line and exit 1."""
  import math
  import subprocess
  root = os.path.dirname(os.path.abspath(__file__))

  def run(*args):
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "qhbmlib_tpu_torch.benchmarks.run_ladder",
         *args], cwd=root, capture_output=True, text=True, timeout=300,
        check=False)
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    log(f"[ladder cli] {' '.join(args)}: exit {out.returncode} in "
        f"{time.perf_counter() - t0:.1f} s: {lines}")
    return out, lines

  out, lines = run("--rung", "r2_heis8_qmhl", "--steps", "3")
  if (out.returncode != 0 or len(lines) != 1 or
      not math.isfinite(lines[0].get("steps_per_sec", math.nan))):
    raise AssertionError(f"ladder cli r2: exit {out.returncode}, {lines}; "
                         f"stderr {out.stderr[-2000:]}")
  out, lines = run("--rung", "r4_tfim24_sharded_vqt")
  if out.returncode != 1 or len(lines) != 1 or "error" not in lines[0]:
    raise AssertionError(f"ladder cli r4: exit {out.returncode}, {lines}")


SOURCES = {"stream_scale": "qhbmlib_tpu_torch/csrc/stream_kernels.cu"}
REPLACES = {
    "axis_apply": "qhbmlib_tpu/ops/pallas_sv.py:459",
    "diag_rotate": "qhbmlib_tpu/ops/pallas_sv.py:459",
    "qubit_transitions": "qhbmlib_tpu/ops/pallas_adjoint.py:540",
    "parity_bilinear": "qhbmlib_tpu/ops/pallas_adjoint.py:540",
    "axis2_apply": "qhbmlib_tpu/ops/pallas_sv.py:615",
    "circuit_forward": "qhbmlib_tpu/ops/pallas_sv.py:667",
    "adjoint_sweep": "qhbmlib_tpu/ops/pallas_adjoint.py:480",
    "stream_scale": "benchmarks/hbm_probe.py:65",
    "flip_apply": "qhbmlib_tpu/ops/statevector.py:604 apply_gate (XLA; no "
                  "Pallas kernel)",
    "flip_bilinear": "qhbmlib_tpu/ops/statevector.py:604 apply_gate (XLA; "
                     "no Pallas kernel)",
}


def kernel_name(entry: str, source: str) -> str:
  """`name<N>` of the kernel whose mangled symbol opens a ptxas entry: the
  source's *_kernel name that the symbol holds as <length><name>."""
  mangled = re.match(r"'(\w+)'", entry).group(1)
  for name in sorted(set(re.findall(r"\b([a-z]\w*_kernel)\b", source))):
    at = mangled.find(f"{len(name)}{name}")
    if at >= 0:
      tmpl = re.match(r"I((?:L[ib]\d+E)+)E",
                      mangled[at + len(str(len(name))) + len(name):])
      return name + (f"<{', '.join(re.findall(r'L[ib](\d+)E', tmpl.group(1)))}>"
                     if tmpl else "")
  return mangled


def main() -> int:
  if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
          "needs a CUDA device", file=sys.stderr)
    return 1
  from qhbmlib_tpu_torch import bench
  from qhbmlib_tpu_torch.ops import _cuda

  torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
  torch.backends.cudnn.allow_tf32 = False
  device = torch.device("cuda:0")
  card = bench.card(device)
  log(card)
  log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
      f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
      f"count {torch.cuda.device_count()}")

  # r5's 28q float64 anchor runs on the host from here on (minutes).
  anchor = R5Anchor(device)
  log(f"[r5 {R5_QUBITS}q] rung built on the card; its f64 oracle started "
      f"in a thread ({anchor.total.pqc.num_gates} gates, data bitstring "
      f"{anchor.bits.cpu().numpy()[0].tolist()})")
  t0 = time.time()
  _cuda.build(verbose=True)
  _cuda.library()
  log(f"[build] nvcc {' '.join(_cuda.NVCC_FLAGS)}: "
      f"{time.time() - t0:.1f} s -> {_cuda.library_path().name}")
  secs = _cuda.build_seconds
  log("[build] seconds, one nvcc process a source: " + ", ".join(
      f"{name} {t:.1f}" for name, t in secs.items()) + f"; the sources' sum "
      f"{sum(t for name, t in secs.items() if name != 'link'):.1f}")
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
  report["axis_apply"] = phase_k4(device)
  report["axis2_apply"] = phase_k1(device)
  report["qubit_transitions"] = phase_k5(device)
  report["circuit_forward"], report["adjoint_sweep"] = (
      phase_single_kernels(device))
  phase_bilinear_steps(device)
  phase_diag(device)
  report["stream_scale"] = phase_k6(device)
  report["flip_apply"], report["flip_bilinear"] = phase_flip(device)
  torch.cuda.empty_cache()
  phase_end_to_end(device)
  phase_small_reference(device)
  phase_small_qmhl(device)
  phase_small_r2(device)
  phase_single_small(device)
  phase_long_diag(device)
  phase_long_diag_batched(device)
  phase_tf32_pin(device)
  # The main paths, each driven with every count at 0 just before it.
  _, paths = phase_bench(device)
  paths["train 16q"] = phase_train_16q(device)
  for qubits in (8, 11):
    paths[f"train r2 {qubits}q"] = phase_train_r2(device, qubits)
  paths["single"] = phase_single_main(device)
  paths["vqt heis 20q"] = phase_vqt_heis20(device)
  paths["train qaia 20q"] = phase_train_qaia20(device)
  paths["vqt qaia heis 20q"] = phase_vqt_qaia_heis20(device)
  paths["train r1 2q"] = phase_train_r1(device)
  paths["train r3 16q"] = phase_train_r3(device)
  paths["train harness 8q"] = phase_harness(device)
  paths["train harness natural 8q"] = phase_harness_natural(device)
  paths["train harness mirror 8q"] = phase_harness_mirror(device)
  paths["train harness qvartz 8q"] = phase_harness_qvartz(device)
  phase_ladder_cli()
  free_device_memory()
  phase_kernels_28q(device)
  phase_chunk_rule(device)
  free_device_memory()
  # Last, so r5's f64 anchor (minutes of host work) is most likely done.
  paths[f"train r5 {R5_QUBITS}q"] = phase_train_r5(device, anchor)
  log(f"[done] on {card}, {time.time() - t0:.1f} s since the build started")
  kernels = [{
      "name": name, "route": "cuda",
      "source": SOURCES.get(name,
                            "qhbmlib_tpu_torch/csrc/statevector_kernels.cu"),
      "replaces": REPLACES[name],
      "launches": sum(path[name] for path in paths.values()),
      "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
      "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
      "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
             for name, rec in report.items()]
  idle = [k["name"] for k in kernels if k["launches"] <= 0]
  if idle:
    raise AssertionError(f"kernels never launched on a main path: {idle}")
  print(json.dumps({"kernels": kernels}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
