"""Adjoint reverse sweeps on Hopper: the ports of K5 and K2.

`adjoint_sweep_batched` returns the batch-summed gradient of
sum_b <psi_b| sum_t g_bt P_t |psi_b> w.r.t. the circuit's symbols, given the
forward states psi and lambda = sum_t g_t P_t psi.  It computes what the
grid-over-batch Pallas kernel `adjoint_sweep_batched`
(qhbmlib_tpu/ops/pallas_adjoint.py:540, K5) computes.  Per segment, in
reverse:

  (1) gradient reductions from the current (a, lambda), summed over the
      batch:
        1q segment   -> one `qubit_transitions`: the 2x2 transition of each
                        gradient qubit, the partial trace of the reference's
                        block_transition / minor cross_gram, without the
                        [N, N] grams;
        diag segment -> `parity_bilinear` over all K parity factors (one
                        launch for each MAX_BILIN_K of them);
  (2) un-apply the segment to a and lambda: the inverse operators as K1 /
      `axis_apply` passes (`hopper_sv.plan_passes`); a diagonal segment's
      un-apply runs in (1)'s first `parity_bilinear` launch, which reads
      each state once for both (Im(conj(lam) a) does not change under the
      common rotation exp(-i theta)).

`adjoint_sweep` (K2, pallas_adjoint.py:480) runs the same stages for ONE
state of 8 to 20 qubits in one cooperative launch over a stage table; its
1q reductions are the same per-qubit 2x2 transitions (kTrans records).

The per-gate algebra on the reductions (the suffix-conjugated dU
contractions, coefficient groupings) runs on the host after the sweep, as
`_assemble_grads` does outside the Pallas kernels.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
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


def _block_of(q: int, nr: int, m: int):
  """(start, k) of the bit range holding qubit q: its row block, or the
  minor bits (nr, m)."""
  if q >= nr:
    return nr, m
  return next((s, k) for s, k in sv._row_blocks(nr) if s <= q < s + k)


def gram_blocks(qubits: Sequence[int], nr: int, m: int):
  """The (start, k) ranges whose transition matrices hold the traces of
  `qubits`: each row block holding one of them, then the minor bits."""
  blocks = [(s, k) for s, k in sv._row_blocks(nr)
            if any(s <= q < s + k for q in qubits)]
  if any(q >= nr for q in qubits):
    blocks.append((nr, m))
  return blocks


def traces_of_grams(grams, qubits: Sequence[int], nr: int,
                    m: int) -> torch.Tensor:
  """[Q, 2, 2] complex: each qubit's 2x2 partial trace of the complex gram
  of the bit range holding it (`grams` keyed by `gram_blocks` range)."""
  out = []
  for q in qubits:
    start, k = _block_of(q, nr, m)
    out.append(sv.partial_trace_1q(grams[(start, k)], k, q - start))
  return torch.stack(out)


def qubit_transitions_plain(l_re, l_im, a_re, a_im,
                            qubits: Sequence[int]) -> torch.Tensor:
  """[Q, 2, 2, 2] (qubit, re/im, i, j): the batch-summed 2x2 transition
  T_q[i, j] = sum_{x: x_q = 0} conj(l[x ^ i e_q]) a[x ^ j e_q] of each
  qubit of [B, R, C] planes, as the partial trace of the gram over the bit
  range holding it (`axis_gram_plain`)."""
  b, r, c = l_re.shape
  if not qubits:
    return torch.zeros((0, 2, 2, 2), dtype=torch.float32, device=l_re.device)
  n = (r * c).bit_length() - 1
  m = c.bit_length() - 1
  grams = {(s, k): torch.complex(*axis_gram_plain(
      l_re, l_im, a_re, a_im, b << s, 2**k, 2**(n - s - k)))
           for s, k in gram_blocks(qubits, n - m, m)}
  t = traces_of_grams(grams, qubits, n - m, m)
  return torch.stack([t.real, t.imag], dim=1)


def qubit_transitions(l_re, l_im, a_re, a_im,
                      qubits: Sequence[int]) -> torch.Tensor:
  """The batch-summed 2x2 transitions of `qubits` (at most 32) over
  float32 [B, R, C] planes (l_re, l_im) and (a_re, a_im): [Q, 2, 2, 2]
  (qubit, re/im, i, j), T_q[i, j] = sum_{x: x_q = 0} conj(l[x ^ i e_q])
  a[x ^ j e_q].  On the card, every qubit in one launch for states of 2 to
  30 qubits; each pass of the kernel reads the planes once: one pass to 13
  qubits, two to 24, three to 30."""
  if l_re.device.type == "cpu":
    return qubit_transitions_plain(l_re, l_im, a_re, a_im, qubits)
  if l_re.device.type != "cuda":
    raise ValueError(f"qubit_transitions: unsupported device {l_re.device}")
  b, r, c = l_re.shape
  n = (r * c).bit_length() - 1
  _cuda.require([l_re, l_im, a_re, a_im], l_re.device, [(b, r, c)] * 4)
  if not qubits:
    return torch.zeros((0, 2, 2, 2), dtype=torch.float32, device=l_re.device)
  if not 2 <= n <= 30 or len(qubits) > 32:
    raise ValueError(f"qubit_transitions: {len(qubits)} qubits (<= 32) of "
                     f"{n}-qubit states (2 to 30)")
  if any(t.data_ptr() % 16 for t in (l_re, l_im, a_re, a_im)):
    raise ValueError("qubit_transitions: planes must be 16-byte aligned")
  lib = _cuda.library()
  dev = l_re.device
  max_blocks = 2 * _cuda.sm_count(dev)
  partial = torch.empty((max_blocks, lib.qhbm_transitions_scratch()),
                        dtype=torch.float32, device=dev)
  out = torch.empty((len(qubits), 2, 2, 2), dtype=torch.float32, device=dev)
  picked = np.asarray(qubits, dtype=np.int32)
  _cuda.check(lib.qhbm_qubit_transitions(
      l_re.data_ptr(), l_im.data_ptr(), a_re.data_ptr(), a_im.data_ptr(), b,
      n, picked.ctypes.data, len(picked), partial.data_ptr(), max_blocks,
      out.data_ptr(), _cuda.stream_of(l_re)),
              "qubit_transitions")
  qubit_transitions.launches += 1
  return out


qubit_transitions.launches = 0


def parity_bilinear_plain(l_re, l_im, a_re, a_im, row_masks: Sequence[int],
                          col_masks: Sequence[int],
                          planes: Optional[Planes] = None) -> torch.Tensor:
  """[K] sum_b s_r_k^T P_b s_c_k with P = Im(conj(lam) * a) per state; with
  the segment's (cos, sin) `planes`, then the un-apply of a and lambda in
  place (`diag_rotate_plain`, sign -1)."""
  p = (l_re * a_im - l_im * a_re).sum(dim=0)
  out = sv.parity_bilinear(row_masks, col_masks, p)
  if planes is not None:
    hopper_sv.diag_rotate_plain([(a_re, a_im), (l_re, l_im)], *planes, -1)
  return out


@functools.lru_cache(maxsize=64)
def _device_masks(row_masks, col_masks, device: str):
  """int32 [K] mask arrays on `device`; cached, as the masks are static."""
  return tuple(torch.tensor(m, dtype=torch.int32).to(device)
               for m in (row_masks, col_masks))


# Parity factors one `parity_bilinear` launch takes (the kernel's
# kBilinMaxK: its masks are staged in shared memory).
MAX_BILIN_K = 1024


def parity_bilinear(l_re, l_im, a_re, a_im, row_masks: Sequence[int],
                    col_masks: Sequence[int],
                    planes: Optional[Planes] = None) -> torch.Tensor:
  """Batch-summed parity bilinears of P = l_re*a_im - l_im*a_re over
  [B, R, C] planes, one per (row_mask, col_mask) factor: returns [K].

  With a diagonal segment's (cos, sin) [R, C] `planes` it is the batched
  sweep's whole diagonal stage: the bilinears, and a and lambda un-applied
  in place (multiplied by exp(-i theta)), in one pass that reads each
  state once (K5's "bwddiagrot"; Im(conj(lam) a) is the same after the
  rotation).  On the card, one launch for each run of at most MAX_BILIN_K
  factors, each writing its slice of the output, as the stage tables split
  bilinear records; only the first launch un-applies."""
  if l_re.device.type == "cpu":
    return parity_bilinear_plain(l_re, l_im, a_re, a_im, row_masks,
                                 col_masks, planes)
  if l_re.device.type != "cuda":
    raise ValueError(f"parity_bilinear: unsupported device {l_re.device}")
  b, r, c = l_re.shape
  k = len(row_masks)
  if not 4 <= c <= 256 or c & (c - 1) or len(col_masks) != k:
    raise ValueError(f"parity_bilinear: C={c} (a power of two in [4, 256]), "
                     f"{k} row masks and {len(col_masks)} column masks")
  states = [l_re, l_im, a_re, a_im]
  _cuda.require(states, l_re.device, [(b, r, c)] * 4)
  if any(t.data_ptr() % 16 for t in states):
    raise ValueError("parity_bilinear: planes must be 16-byte aligned")
  cos_ptr = sin_ptr = None
  if planes is not None:
    _cuda.require(list(planes), l_re.device, [(r, c)] * 2)
    if len({t.data_ptr() for t in states}) != 4:
      raise ValueError("parity_bilinear: the un-apply needs four distinct "
                       "planes")
    cos_ptr, sin_ptr = (t.data_ptr() for t in planes)
  dev = l_re.device
  rm, cm = _device_masks(tuple(row_masks), tuple(col_masks), str(dev))
  lib = _cuda.library()
  blocks = lib.qhbm_diag_blocks(b, r * c)
  partial = torch.empty((blocks, min(k, MAX_BILIN_K)), dtype=torch.float32,
                        device=dev)
  out = torch.empty((k,), dtype=torch.float32, device=dev)
  for lo in range(0, max(k, 1), MAX_BILIN_K):
    part = min(k - lo, MAX_BILIN_K)
    _cuda.check(lib.qhbm_parity_bilinear(
        l_re.data_ptr(), l_im.data_ptr(), a_re.data_ptr(), a_im.data_ptr(),
        rm[lo:].data_ptr(), cm[lo:].data_ptr(), part, b, r, c,
        cos_ptr if lo == 0 else None, sin_ptr if lo == 0 else None,
        partial.data_ptr(), blocks, out[lo:].data_ptr(),
        _cuda.stream_of(l_re)), "parity_bilinear")
    parity_bilinear.launches += 1
  return out


parity_bilinear.launches = 0


# ---------------------------------------------------------------------------
# Reverse-stage preparation (mirrors pallas_adjoint._prepare_backward)
# ---------------------------------------------------------------------------

def _dagger(mat: torch.Tensor) -> torch.Tensor:
  return mat.mH.resolve_conj().contiguous()


def one_qubit_algebra(seg_gates, seg_angles):
  """Host 2x2 algebra of one reversed 1q segment: ({qubit: inverse of its
  chain product}, [(qubit, slot, coeff, mg 2x2)], gradient qubits), with
  mg = suffix dU U^dagger suffix^dagger (adjoint.py `_bwd_1q_segment`)."""
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
  return inverses, mg_entries, grad_qubits


def _backward_1q(seg_gates, seg_angles, nr: int, m: int):
  """One reversed 1q segment: (host stage, assembly plan entry).

  stage = ("bwd1q", qubits, inverse ops): `qubits` are the segment's
  gradient qubits, ascending, whose 2x2 transitions the gradient reads;
  the inverse ops are `segment_ops` of the per-qubit inverses."""
  inverses, mg_entries, grad_qubits = one_qubit_algebra(seg_gates,
                                                        seg_angles)
  qubits = tuple(sorted(grad_qubits))
  majors = {q: v for q, v in inverses.items() if q < nr}
  minor_inv = sv._fold_block({q - nr: v for q, v in inverses.items()
                              if q >= nr}, 0, m)
  stage = ("bwd1q", qubits, hopper_sv.segment_ops(majors, minor_inv, nr, m))
  plan = ("1q", {"qubits": qubits, "mg_entries": mg_entries})
  return stage, plan


def backward_plan(circuit: ir.Circuit, symbol_values):
  """Host reverse stages, in sweep order, and the assembly plan:
  ("bwd1q", gradient qubits, inverse ops) or ("bwddiag", (weights, row_masks,
  col_masks)) with the FORWARD weights of the segment."""
  n = circuit.num_qubits
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
      stages.append(("bwddiag", sv.diag_segment_weights(seg_gates, seg_angles,
                                                        nr, m)))
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
          "diagonal gate; the adjoint sweeps do not take it yet")
  return stages, plan


def prepare_backward(circuit: ir.Circuit, symbol_values, device):
  """Reverse stages of the batched sweep and the assembly plan:
  ("bwd1q", gradient qubits, passes) with device operators (`plan_passes`), or
  ("bwddiag", row_masks, col_masks, (cos, sin)) with the segment's forward
  rotation planes.  Host operators and weights cross in one copy."""
  n = circuit.num_qubits
  shape_rc = sv.state_shape(n)
  nr = n - sv.minor_bits(n)
  host_stages, plan = backward_plan(circuit, symbol_values)
  host = []
  for st in host_stages:
    if st[0] == "bwd1q":
      host.extend(t for _, op in st[2] for t in hopper_sv.split(op))
    else:
      host.append(torch.from_numpy(st[1][0]))
  moved = iter(hopper_sv.to_device(host, device))
  out = []
  for st in host_stages:
    if st[0] == "bwd1q":
      ops = [(bits, (next(moved), next(moved))) for bits, _ in st[2]]
      out.append(("bwd1q", st[1], hopper_sv.plan_passes(ops, nr)))
    else:
      _, rms, cms = st[1]
      out.append(("bwddiag", rms, cms, hopper_sv.rotation_planes(
          next(moved), rms, cms, shape_rc)))
  return out, plan


def _assemble_grads(plan, outputs: List[torch.Tensor],
                    num_symbols: int) -> torch.Tensor:
  """Host-side per-gate gradient algebra on the sweep's reductions (CPU
  tensors, in stage order: a [Q, 2, 2] complex transition per gradient
  qubit of each 1q stage that has any, a [K] bilinear per diagonal stage);
  mirrors pallas_adjoint._assemble_grads."""
  slots, contribs = [], []
  pos = 0
  for kind, info in plan:
    if kind == "1q":
      if not info["qubits"]:
        continue
      traces = outputs[pos]
      pos += 1
      row = {q: i for i, q in enumerate(info["qubits"])}
      for q, slot, coeff, mg in info["mg_entries"]:
        dangle = 2.0 * float(torch.sum(mg * traces[row[q]]).real)
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


def _grads_from_flat(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
  """Splits one host copy of every reduction, in stage order: split-complex
  [Q, 2, 2, 2] transitions become complex [Q, 2, 2] tensors (re/im is axis
  -3), [K] bilinears stay real."""
  outputs, pos = [], 0
  for shape in shapes:
    size = int(np.prod(shape))
    part = flat[pos:pos + size].reshape(shape)
    outputs.append(torch.complex(*part.unbind(-3)) if len(shape) >= 3
                   else part)
    pos += size
  return outputs


def adjoint_sweep_batched(circuit: ir.Circuit, symbol_values, psi: Planes,
                          lam: Planes, plain: bool = False) -> torch.Tensor:
  """Batch-summed symbol gradient [num_symbols] from one reverse sweep over
  [B, R, C] planes psi = (re, im) and lam = (re, im), on their device.

  `symbol_values` is a tensor on any device or a host array; the operators
  are folded on the host from it.  The inputs are not modified.
  `plain=True` runs the kernels' plain versions (reference only)."""
  device = psi[0].device
  r, c = psi[0].shape[1:]
  n = (r * c).bit_length() - 1
  trans = qubit_transitions_plain if plain else qubit_transitions
  bilin = parity_bilinear_plain if plain else parity_bilinear
  stages, plan = prepare_backward(circuit, symbol_values, device)
  # The diagonal stages un-apply in place: work on contiguous copies.
  a, lm = [tuple(torch.clone(t, memory_format=torch.contiguous_format)
                 for t in pair) for pair in (psi, lam)]
  reductions = []  # [Q, 2, 2, 2] transitions or [K] bilinears, stage order
  for stage in stages:
    if stage[0] == "bwd1q":
      _, qubits, passes = stage
      if qubits:
        reductions.append(trans(*lm, *a, qubits))
      a, lm = hopper_sv.apply_passes(passes, [a, lm], n, plain)
    else:
      _, rms, cms, planes = stage
      reductions.append(bilin(*lm, *a, rms, cms, planes))
  # One device->host copy for every reduction, then the tiny algebra.
  outputs = []
  if reductions:
    flat = torch.cat([t.reshape(-1) for t in reductions]).cpu()
    outputs = _grads_from_flat(flat, [tuple(t.shape) for t in reductions])
  grad = _assemble_grads(plan, outputs, circuit.num_symbols)
  return grad.to(device)


# ---------------------------------------------------------------------------
# K2: the whole reverse sweep of one state, one cooperative launch
# ---------------------------------------------------------------------------

def sweep_table(circuit: ir.Circuit, symbol_values, device):
  """(stage table, reduction shapes, assembly plan) of `adjoint_sweep`: per
  reversed segment, the kTrans / kBilin reductions from the current states
  (the 2x2 transitions of a 1q segment's gradient qubits, if it has any),
  then the un-apply (kAxis records of the inverse operators, or kDiag with
  the negated weights)."""
  host_stages, plan = backward_plan(circuit, symbol_values)
  table = hopper_sv.StageTable(circuit.num_qubits, torch.device(device))
  shapes = []
  for st in host_stages:
    if st[0] == "bwd1q":
      if st[1]:
        table.transitions(st[1])
        shapes.append((len(st[1]), 2, 2, 2))
      for bits, op in st[2]:
        table.axis(bits, op)
    else:
      weights, rms, cms = st[1]
      table.bilinear(rms, cms)
      shapes.append((len(rms),))
      table.diag(weights, rms, cms, sign=-1)
  return table, shapes, plan


def sweep_grads(plan, flat: torch.Tensor, shapes,
                num_symbols: int) -> torch.Tensor:
  """The gradient from K2's reductions (one host copy, stage order, of the
  `sweep_table` shapes: [Q, 2, 2, 2] transitions and [K] bilinears), read
  by `_assemble_grads` as K5's are."""
  return _assemble_grads(plan, _grads_from_flat(flat, shapes), num_symbols)


def adjoint_sweep(circuit: ir.Circuit, symbol_values, psi: Planes,
                  lam: Planes, plain: bool = False) -> torch.Tensor:
  """K2: the symbol gradient [num_symbols] of <psi| sum_t g_t P_t |psi> from
  the reverse sweep of ONE [R, C] state psi and lam = sum_t g_t P_t psi
  (float32 planes), in one cooperative launch for a CUDA state of 8 to 20
  qubits (raises for other sizes).  For a CPU state or `plain=True` it runs
  the plain version, the per-state sweep of `ops/adjoint.py`.

  Reductions and un-applies run in stage order as in
  pallas_adjoint._make_bwd_kernel; the inverse operators and the negated
  diagonal weights are folded on the host, and every reduction returns in
  one device->host copy for `sweep_grads`."""
  dev = psi[0].device
  if plain or dev.type == "cpu":
    from qhbmlib_tpu_torch.ops import adjoint  # the plain sweep lives there
    return adjoint.reverse_sweep(circuit, symbol_values,
                                 torch.complex(*psi), torch.complex(*lam))
  if dev.type != "cuda":
    raise ValueError(f"adjoint_sweep: unsupported device {dev}")
  n = circuit.num_qubits
  if not hopper_sv.single_admits(n):
    raise ValueError(f"adjoint_sweep takes 8 <= n <= 20 qubits, not {n}")
  shape_rc = sv.state_shape(n)
  _cuda.require(list(psi) + list(lam), dev, [shape_rc] * 4)
  table, shapes, plan = sweep_table(circuit, symbol_values, dev)
  out = launch_adjoint_sweep(table, hopper_sv.state_buffer(psi),
                             hopper_sv.state_buffer(lam),
                             hopper_sv.sweep_blocks(dev, 2))
  return sweep_grads(plan, out[:table.out_len].cpu(), shapes,
                     circuit.num_symbols).to(dev)


adjoint_sweep.launches = 0


def launch_adjoint_sweep(table: hopper_sv.StageTable, a_buf: torch.Tensor,
                         l_buf: torch.Tensor, blocks: int) -> torch.Tensor:
  """The K2 launch alone: `table` (a `sweep_table`) on the states in rows
  0-1 of `a_buf` and `l_buf` (`hopper_sv.state_buffer`), in place; returns
  the device buffer of every reduction, in stage order."""
  dev = a_buf.device
  records, masks, data = table.pack()
  partial = torch.empty((blocks, table.widest()), dtype=torch.float32,
                        device=dev)
  out = torch.empty((max(table.out_len, 1),), dtype=torch.float32,
                    device=dev)
  _cuda.check(_cuda.library().qhbm_adjoint_sweep(
      a_buf.data_ptr(), l_buf.data_ptr(), table.n, table.m,
      records.data_ptr(), table.num_stages, data.data_ptr(),
      masks.data_ptr(), partial.data_ptr(), blocks, out.data_ptr(),
      _cuda.stream_of(a_buf)), "adjoint_sweep")
  adjoint_sweep.launches += 1
  return out
