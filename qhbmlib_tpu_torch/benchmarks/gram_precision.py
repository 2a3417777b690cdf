"""Precision and time of the L3 expectation tiers' complex grams.

    python -m qhbmlib_tpu_torch.benchmarks.gram_precision [--qubits 24]
        [--batch 8] [--device cpu]

For a seeded batch of normalized states, each row block's transition and
the minor cross gram (`statevector.block_transition`, `cross_gram`: GEMMs
of at most `statevector.GRAM_CHUNK` products an entry, partials summed)
against the same gram as ONE complex64 einsum over the whole contraction,
both held to complex128: max abs error and ms (CUDA events, 5 calls after
a warm-up).  Then the r4 rung's first support state at its initial
parameters: every single-term <P_t> of the TFIM at the first step's 8
support states (`expectation_terms`), and each <X_q> also from its
block's gram as one einsum over the batch, against float64 numpy on the
oracle's states (`native_oracle.simulate`).  One JSON line each, the
card's name and power limit first.  Runs on the CUDA card unless
`--device` names another.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from qhbmlib_tpu_torch import bench
from qhbmlib_tpu_torch import device as device_lib
from qhbmlib_tpu_torch.benchmarks import ladder
from qhbmlib_tpu_torch.ops import adjoint, hopper_sv, native_oracle, paulis
from qhbmlib_tpu_torch.ops import statevector as sv


def _ms(fn, device, reps: int = 5):
  out = fn()
  if device.type != "cuda":
    t0 = time.perf_counter()
    for _ in range(reps):
      fn()
    return out, (time.perf_counter() - t0) / reps * 1e3
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize(device)
  return out, start.elapsed_time(end) / reps


def grams(n: int, batch: int, device) -> list:
  """One record a row block and the minor: both grams' errors and ms."""
  r, c = sv.state_shape(n)
  g = torch.Generator(device=device).manual_seed(0)
  x = torch.complex(*(torch.randn((batch, r, c), generator=g, device=device)
                      for _ in range(2)))
  x = x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
  nr = n - sv.minor_bits(n)
  cases = [((s, k), (batch, 2**s, 2**k, (r * c) >> (s + k)),
            lambda s=s, k=k: sv.block_transition(x, x, s, k))
           for s, k in sv._row_blocks(nr)]
  cases.append((("minor",), (batch, r, c, 1), lambda: sv.cross_gram(x, x)))
  out = []
  for name, view, chunked in cases:
    xv = x.reshape(view)
    one = lambda xv=xv: torch.einsum("...aIb,...aJb->...IJ", xv.conj(), xv)
    x64 = xv.to(torch.complex128)
    ref = torch.einsum("...aIb,...aJb->...IJ", x64.conj(), x64)
    rec = {"block": list(name), "qubits": n, "batch": batch}
    for key, fn in (("one_einsum", one), ("chunked", chunked)):
      got, ms = _ms(fn, device)
      rec[f"{key}_max_abs_err"] = float((got.to(torch.complex128) -
                                         ref).abs().max())
      rec[f"{key}_ms"] = ms
    out.append(rec)
  return out


def _x_one_einsum(state: torch.Tensor, n: int) -> torch.Tensor:
  """[B, n] <X_q> of [B, R, C] states from the 2x2 partial trace of the
  gram of the bits holding q, each gram ONE complex64 einsum over its
  whole contraction (batched over the states)."""
  m = sv.minor_bits(n)
  nr = n - m
  b, r, c = state.shape
  out = []
  for q in range(n):
    if q < nr:
      s, k = next(x for x in sv._row_blocks(nr) if x[0] <= q < x[0] + x[1])
      v = state.reshape(b, 2**s, 2**k, (r * c) >> (s + k))
      g, k, pos = torch.einsum("...aIb,...aJb->...IJ", v.conj(), v), k, q - s
    else:
      g = torch.einsum("...rc,...rd->...cd", state.conj(), state)
      k, pos = m, q - nr
    t = torch.stack([sv.partial_trace_1q(gb, k, pos) for gb in g])
    out.append((t[:, 0, 1] + t[:, 1, 0]).real)
  return torch.stack(out, dim=1).cpu().double()


def _tfim_f64(psi: np.ndarray, n: int) -> np.ndarray:
  """[2n - 1] <X_q> then <Z_q Z_q+1> of one float64 [2^n] state."""
  out = []
  for q in range(n):
    v = psi.reshape(2**q, 2, -1)
    out.append(2.0 * np.real(np.vdot(v[:, 0], v[:, 1])))
  p = (psi.real**2 + psi.imag**2)
  for q in range(n - 1):
    v = p.reshape(2**q, 2, 2, -1).sum(axis=(0, 3))
    out.append(v[0, 0] + v[1, 1] - v[0, 1] - v[1, 0])
  return np.asarray(out)


def r4_terms(n: int, device) -> dict:
  """max |<P_t> - f64| over the TFIM's terms (X and ZZ apart) at r4's
  first step's support states and initial parameters: through
  `expectation_terms`, and for the X terms through one einsum a gram."""
  h, target, _ = ladder.build_rung("r4_tfim24_sharded_vqt", qubits=n,
                                   device=device)
  bits = h.e_inference.support_and_counts()[0].to(torch.int8)
  pqc = h.q_inference.circuit.pqc
  values = h.q_inference.circuit.resolved_values().detach()
  ones = paulis.PauliSum(target.codes, torch.ones(target.num_terms,
                                                  device=device), n)
  with torch.no_grad():
    psi = hopper_sv.apply_circuit_batched(pqc, values,
                                          adjoint.bits_to_rowcol(bits, n))
    state = torch.complex(*psi)
    got = sv.expectation_terms(state, ones).cpu().double().numpy()
    x_one = _x_one_einsum(state, n).numpy()
  del psi, state
  angles = hopper_sv.host_values(values).astype(np.float64)
  want = np.stack([_tfim_f64(native_oracle.simulate(pqc, angles, bits=row),
                             n) for row in bits.cpu().numpy()])
  # tfim_1d's order: the n X terms, then the n - 1 ZZ terms.
  return {"r4_terms_qubits": n, "states": int(bits.shape[0]),
          "x_max_abs_err": float(np.abs(got[:, :n] - want[:, :n]).max()),
          "zz_max_abs_err": float(np.abs(got[:, n:] - want[:, n:]).max()),
          "x_one_einsum_max_abs_err": float(np.abs(x_one -
                                                   want[:, :n]).max())}


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--qubits", type=int, default=24)
  p.add_argument("--batch", type=int, default=8)
  p.add_argument("--device", default=None)
  args = p.parse_args(argv)
  device = device_lib.resolve(args.device)
  if device.type == "cuda":
    torch.backends.cuda.matmul.allow_tf32 = False
    print(bench.card(device), flush=True)
  for rec in grams(args.qubits, args.batch, device):
    print(json.dumps(rec), flush=True)
  print(json.dumps(r4_terms(args.qubits, device)), flush=True)


if __name__ == "__main__":
  main()
