"""Batched adjoint reverse sweep on Hopper: the port of K5.

`adjoint_sweep_batched` returns the batch-summed gradient of
sum_b <psi_b| sum_t g_bt P_t |psi_b> w.r.t. the circuit's symbols, given the
forward states psi and lambda = sum_t g_t P_t psi.  It computes what the
grid-over-batch Pallas kernel `adjoint_sweep_batched`
(qhbmlib_tpu/ops/pallas_adjoint.py:540) computes.  Per segment, in reverse:

  (1) gradient reductions from the current (a, lambda), summed over the
      batch:
        1q segment   -> `axis_gram` per row block holding a gradient qubit
                        (block_transition) and once for the minor cross
                        matrix kmat (cross_gram);
        diag segment -> one `parity_bilinear` over all K parity factors;
  (2) un-apply the segment to a and lambda: `axis_apply` with the inverse
      operators, or one `diag_rotate` with sign -1 over both.

The per-gate algebra on the reductions (2x2 partial traces, the
suffix-conjugated dU contractions, coefficient groupings) runs on the host
after the sweep, as `_assemble_grads` does outside the Pallas kernel.  A
Python loop over segments replaces the kernel's per-layer `fori_loop`, so
no period merge is needed.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import torch

from qhbmlib_tpu_torch.ops import _cuda
from qhbmlib_tpu_torch.ops import circuit_ir as ir
from qhbmlib_tpu_torch.ops import hopper_sv
from qhbmlib_tpu_torch.ops import statevector as sv

Planes = hopper_sv.Planes


# ---------------------------------------------------------------------------
# Kernel wrappers and their plain versions
# ---------------------------------------------------------------------------

def axis_gram_plain(l_re, l_im, a_re, a_im, p: int, n: int, q: int) -> Planes:
  """G[I, J] = sum_{p,q} conj(l[p, I, q]) a[p, J, q] on the [P, N, Q] view."""
  lr, li = l_re.reshape(p, n, q), l_im.reshape(p, n, q)
  ar, ai = a_re.reshape(p, n, q), a_im.reshape(p, n, q)
  prog = "pIq,pJq->IJ"
  g_re = torch.einsum(prog, lr, ar) + torch.einsum(prog, li, ai)
  g_im = torch.einsum(prog, lr, ai) - torch.einsum(prog, li, ar)
  return g_re, g_im


def axis_gram(l_re, l_im, a_re, a_im, p: int, n: int, q: int) -> Planes:
  """Split-complex transition matrix over the middle axis of a [P, N, Q]
  view, summed over P and Q (the batch included): returns [N, N] planes.

  Row block (start, k): P = B*2^start, N = 2^k, Q = R*C/2^(start+k)
  (block_transition).  Minor kmat: P = B*R, N = C, Q = 1 (cross_gram)."""
  if l_re.device.type == "cpu":
    return axis_gram_plain(l_re, l_im, a_re, a_im, p, n, q)
  if l_re.device.type != "cuda":
    raise ValueError(f"axis_gram: unsupported device {l_re.device}")
  if n not in (2, 4, 8, 16, 32, 64, 128):
    raise ValueError(f"axis_gram: N={n} is not a power of two in [2, 128]")
  _cuda.require([l_re, l_im, a_re, a_im], l_re.device, [l_re.shape] * 4)
  if l_re.numel() != p * n * q:
    raise ValueError(f"axis_gram: {l_re.numel()} elements != {p}*{n}*{q}")
  lib = _cuda.library()
  # Pass-1 partials: at most 4 blocks of 512 threads fit an SM.
  max_blocks = 4 * _cuda.sm_count(l_re.device)
  partial = torch.empty((max_blocks, 2, n, n), dtype=torch.float32,
                        device=l_re.device)
  g_re = torch.empty((n, n), dtype=torch.float32, device=l_re.device)
  g_im = torch.empty_like(g_re)
  _cuda.check(lib.qhbm_axis_gram(
      l_re.data_ptr(), l_im.data_ptr(), a_re.data_ptr(), a_im.data_ptr(),
      partial.data_ptr(), max_blocks, g_re.data_ptr(), g_im.data_ptr(), p, n,
      q, _cuda.stream_of(l_re)), "axis_gram")
  axis_gram.launches += 1
  return g_re, g_im


axis_gram.launches = 0


def parity_bilinear_plain(l_re, l_im, a_re, a_im, row_masks: Sequence[int],
                          col_masks: Sequence[int]) -> torch.Tensor:
  """[K] sum_b s_r_k^T P_b s_c_k with P = Im(conj(lam) * a) per state."""
  p = (l_re * a_im - l_im * a_re).sum(dim=0)
  return sv.parity_bilinear(row_masks, col_masks, p)


@functools.lru_cache(maxsize=64)
def _device_masks(row_masks, col_masks, device: str):
  """int32 [K] mask arrays on `device`; cached, as the masks are static."""
  return tuple(torch.tensor(m, dtype=torch.int32).to(device)
               for m in (row_masks, col_masks))


def parity_bilinear(l_re, l_im, a_re, a_im, row_masks: Sequence[int],
                    col_masks: Sequence[int]) -> torch.Tensor:
  """Batch-summed parity bilinears of P = l_re*a_im - l_im*a_re over
  [B, R, C] planes, one per (row_mask, col_mask) factor: returns [K]."""
  if l_re.device.type == "cpu":
    return parity_bilinear_plain(l_re, l_im, a_re, a_im, row_masks,
                                 col_masks)
  if l_re.device.type != "cuda":
    raise ValueError(f"parity_bilinear: unsupported device {l_re.device}")
  b, r, c = l_re.shape
  k = len(row_masks)
  if c > 256 or k > 1024 or len(col_masks) != k:
    raise ValueError(f"parity_bilinear: C={c} (<= 256) / K={k} (<= 1024)")
  _cuda.require([l_re, l_im, a_re, a_im], l_re.device, [(b, r, c)] * 4)
  dev = l_re.device
  rm, cm = _device_masks(tuple(row_masks), tuple(col_masks), str(dev))
  lib = _cuda.library()
  rows_per_block = 256 // c  # the kernel's 256 threads cover whole rows
  blocks = min(-(-r // rows_per_block), 4 * _cuda.sm_count(dev))
  partial = torch.empty((blocks, k), dtype=torch.float32, device=dev)
  out = torch.empty((k,), dtype=torch.float32, device=dev)
  _cuda.check(lib.qhbm_parity_bilinear(
      l_re.data_ptr(), l_im.data_ptr(), a_re.data_ptr(), a_im.data_ptr(),
      rm.data_ptr(), cm.data_ptr(), k, b, r, c, partial.data_ptr(),
      out.data_ptr(), blocks, _cuda.stream_of(l_re)), "parity_bilinear")
  parity_bilinear.launches += 1
  return out


parity_bilinear.launches = 0


# ---------------------------------------------------------------------------
# Reverse-stage preparation (mirrors pallas_adjoint._prepare_backward)
# ---------------------------------------------------------------------------

def _dagger(mat: torch.Tensor) -> torch.Tensor:
  return mat.mH.resolve_conj().contiguous()


def _backward_1q(seg_gates, seg_angles, nr: int, m: int):
  """One reversed 1q segment: (stage, plan), with host operator planes.

  stage = ("bwd1q", blocks, minor_grads, ops, has_minor): `blocks` lists
  (start, k, needs_grad) row blocks, `ops` their inverse operators as
  [re, im] host planes, then the minor inverse operator when present.
  plan holds the mg entries (qubit, slot, coeff, mg 2x2) for the host-side
  assembly."""
  mats = sv.segment_matrices(seg_gates, seg_angles)
  dmats = sv.segment_matrices(seg_gates, seg_angles, sv.gate_matrix_dangle)
  by_qubit = {}
  for gate, mat, dmat in zip(seg_gates, mats, dmats):
    by_qubit.setdefault(gate.qubits[0], []).append((gate, mat, dmat))
  grad_qubits = set(q for q, chain in by_qubit.items()
                    if any(g.slot >= 0 for g, _, _ in chain))
  inverses = {}
  mg_entries = []
  for q in sorted(by_qubit):
    suffix = torch.eye(2, dtype=sv.COMPLEX_DTYPE)
    for gate, mat, dmat in reversed(by_qubit[q]):
      if gate.slot >= 0:
        mg = suffix @ dmat @ _dagger(mat) @ _dagger(suffix)
        mg_entries.append((q, gate.slot, gate.coeff, mg))
      suffix = suffix @ mat
    inverses[q] = _dagger(suffix)
  minor_grads = tuple(sorted(q for q in grad_qubits if q >= nr))
  blocks = []
  ops = []
  for start, k in sv._row_blocks(nr):
    folded = sv._fold_block(inverses, start, k)
    needs_grad = any(start <= q < start + k for q in grad_qubits)
    if folded is None and not needs_grad:
      continue
    blocks.append((start, k, needs_grad))
    ops.append(hopper_sv.split(folded))
  # Minor inverse: kron of the per-qubit inverses over the column qubits.
  minor_inv = sv._fold_block({q - nr: v for q, v in inverses.items()
                              if q >= nr}, 0, m)
  if minor_inv is not None:
    ops.append(hopper_sv.split(minor_inv))
  stage = ("bwd1q", tuple(blocks), bool(minor_grads), ops,
           minor_inv is not None)
  plan = ("1q", {"blocks": tuple(blocks), "minor_grads": minor_grads,
                 "mg_entries": mg_entries, "nr": nr, "m": m})
  return stage, plan


def prepare_backward(circuit: ir.Circuit, symbol_values, device):
  """Reverse stages (consumed by the sweep in order) and the assembly plan.
  Host-built operators and weights cross to `device` in one copy."""
  n = circuit.num_qubits
  shape_rc = sv.state_shape(n)
  m = sv.minor_bits(n)
  nr = n - m
  angles = sv.resolve_angles(circuit, hopper_sv.host_values(symbol_values))
  stages, plan = [], []
  for cls, idxs in reversed(sv.segment_circuit(circuit.gates)):
    seg_gates = [circuit.gates[i] for i in idxs]
    seg_angles = angles[list(idxs)]
    if cls == "1q":
      stage, info = _backward_1q(seg_gates, seg_angles, nr, m)
      stages.append(stage)
      plan.append(info)
    elif cls == "diag":
      coeffs, _, _, owner = sv.diag_segment_triples(seg_gates, nr, m)
      weights, rms, cms = sv.diag_segment_weights(seg_gates, seg_angles, nr,
                                                  m)
      stages.append(("bwddiag", rms, cms, [torch.from_numpy(weights)]))
      plan.append(("diag", {
          "coeffs": tuple(float(x) for x in coeffs),
          "owner": tuple(owner),
          "grad_gates": tuple((g_idx, g.slot, g.coeff)
                              for g_idx, g in enumerate(seg_gates)
                              if g.slot >= 0),
      }))
    else:
      raise NotImplementedError(
          f"gate {circuit.gates[idxs[0]].kind!r} is neither a 1q dense nor a "
          "diagonal gate; the batched sweep does not take it yet")
  host = [t for st in stages
          for t in (sum(st[3], []) if st[0] == "bwd1q" else st[3])]
  moved = iter(hopper_sv.to_device(host, device))
  out = []
  for st in stages:
    if st[0] == "bwd1q":
      ops = [(next(moved), next(moved)) for _ in st[3]]
      out.append(st[:3] + (ops, st[4]))
    else:
      _, rms, cms, _ = st
      out.append(("bwddiag", rms, cms, hopper_sv.rotation_planes(
          next(moved), rms, cms, shape_rc)))
  return out, plan


def _assemble_grads(plan, outputs: List[torch.Tensor],
                    num_symbols: int) -> torch.Tensor:
  """Host-side per-gate gradient algebra on the sweep's reductions (CPU
  tensors, in stage order); mirrors pallas_adjoint._assemble_grads."""
  slots, contribs = [], []
  pos = 0
  for kind, info in plan:
    if kind == "1q":
      nr, m = info["nr"], info["m"]
      g_parts = {}
      for start, k, needs_grad in info["blocks"]:
        if needs_grad:
          g_parts[(start, k)] = outputs[pos]
          pos += 1
      if info["minor_grads"]:
        kmat = outputs[pos]
        pos += 1
      for q, slot, coeff, mg in info["mg_entries"]:
        if q >= nr:
          g = sv.partial_trace_1q(kmat, m, q - nr)
        else:
          start, k = next((s, kk) for s, kk, ng in info["blocks"]
                          if ng and s <= q < s + kk)
          g = sv.partial_trace_1q(g_parts[(start, k)], k, q - start)
        dangle = 2.0 * float(torch.sum(mg * g).real)
        slots.append(slot)
        contribs.append(coeff * dangle)
    else:
      row = outputs[pos].tolist()
      pos += 1
      coeffs, owner = info["coeffs"], info["owner"]
      for g_idx, slot, coeff in info["grad_gates"]:
        dangle = -2.0 * sum(coeffs[k] * row[k] for k in range(len(owner))
                            if owner[k] == g_idx)
        slots.append(slot)
        contribs.append(coeff * dangle)
  grad = torch.zeros(num_symbols, dtype=torch.float64)
  if slots:
    grad.index_add_(0, torch.tensor(slots),
                    torch.tensor(contribs, dtype=torch.float64))
  return grad.to(torch.float32)


def adjoint_sweep_batched(circuit: ir.Circuit, symbol_values, psi: Planes,
                          lam: Planes, plain: bool = False) -> torch.Tensor:
  """Batch-summed symbol gradient [num_symbols] from one reverse sweep over
  [B, R, C] planes psi = (re, im) and lam = (re, im), on their device.

  `symbol_values` is a tensor on any device or a host array; the operators
  are folded on the host from it.  The inputs are not modified.
  `plain=True` runs the kernels' plain versions (reference only)."""
  device = psi[0].device
  b, r, c = psi[0].shape
  gram = axis_gram_plain if plain else axis_gram
  bilin = parity_bilinear_plain if plain else parity_bilinear
  stages, plan = prepare_backward(circuit, symbol_values, device)
  # The diagonal un-applies rotate in place: work on contiguous copies.
  a, lm = [tuple(torch.clone(t, memory_format=torch.contiguous_format)
                 for t in pair) for pair in (psi, lam)]
  reductions = []  # [2, N, N] (re, im) grams or [K] bilinears, stage order
  for stage in stages:
    if stage[0] == "bwd1q":
      _, blocks, minor_grads, ops, has_minor = stage
      for start, k, needs_grad in blocks:
        if needs_grad:
          reductions.append(torch.stack(gram(
              *lm, *a, b << start, 2**k, (r * c) >> (start + k))))
      if minor_grads:
        reductions.append(torch.stack(gram(*lm, *a, b * r, c, 1)))
      for (start, k, _), op in zip(blocks, ops):
        a, lm = hopper_sv.apply_stage("rowblock", (start, k), op, [a, lm], -1,
                                      plain)
      if has_minor:
        a, lm = hopper_sv.apply_stage("minor", None, ops[-1], [a, lm], -1,
                                      plain)
    else:
      _, rms, cms, planes = stage
      reductions.append(bilin(*lm, *a, rms, cms))
      a, lm = hopper_sv.apply_stage("diag", None, planes, [a, lm], -1, plain)
  # One device->host copy for every reduction, then the tiny algebra.
  outputs = []
  if reductions:
    flat = torch.cat([t.reshape(-1) for t in reductions]).cpu()
    pos = 0
    for t in reductions:
      part = flat[pos:pos + t.numel()].reshape(t.shape)
      outputs.append(torch.complex(part[0], part[1]) if t.dim() == 3
                     else part)
      pos += t.numel()
  grad = _assemble_grads(plan, outputs, circuit.num_symbols)
  return grad.to(device)
