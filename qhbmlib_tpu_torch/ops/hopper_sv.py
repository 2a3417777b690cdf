"""Batched circuit forward on Hopper: the port of K4.

`apply_circuit_batched` evolves B basis states through a circuit of 1q and
diagonal segments.  It computes what the grid-over-batch Pallas kernel
`apply_circuit_pallas_batched` (qhbmlib_tpu/ops/pallas_sv.py:459) computes:
the folded row-block / minor operators and the diagonal segments' cos/sin
planes are built once and shared by the whole batch.  On the TPU the whole
state sat in VMEM for the whole circuit; on the H100 a 20-qubit state does
not fit one SM, so every segment is one launch over the [B, R, C] batch:

  1q segment   -> one `axis_apply` per row block with an operator, plus one
                  for the combined [C, C] minor operator;
  diag segment -> one `diag_rotate` with the segment's shared planes.

Both kernels live in `csrc/statevector_kernels.cu`.  Each wrapper launches
its kernel for CUDA tensors (or raises) and runs its plain PyTorch version
only for CPU tensors.  `plain=True` runs the plain versions on any device;
tests and `chip_smoke.py` use it as the reference, the main path never does.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from qhbmlib_tpu_torch.ops import _cuda
from qhbmlib_tpu_torch.ops import circuit_ir as ir
from qhbmlib_tpu_torch.ops import statevector as sv

Planes = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# Kernel wrappers and their plain versions
# ---------------------------------------------------------------------------

def axis_apply_plain(x_re, x_im, op_re, op_im, p: int, n: int,
                     q: int) -> Planes:
  """y[p, M, q] = sum_N Op[M, N] x[p, N, q] on the [P, N, Q] view."""
  xr = x_re.reshape(p, n, q)
  xi = x_im.reshape(p, n, q)
  prog = "MN,pNq->pMq"
  y_re = torch.einsum(prog, op_re, xr) - torch.einsum(prog, op_im, xi)
  y_im = torch.einsum(prog, op_re, xi) + torch.einsum(prog, op_im, xr)
  return (y_re.reshape(x_re.shape).contiguous(),
          y_im.reshape(x_im.shape).contiguous())


def axis_apply(x_re, x_im, op_re, op_im, p: int, n: int, q: int) -> Planes:
  """Split-complex [N, N] operator on the middle axis of a [P, N, Q] view of
  the float32 planes (x_re, x_im); returns new planes of the same shape.

  Row block (start, k) of [B, R, C] states: P = B*2^start, N = 2^k,
  Q = R*C/2^(start+k).  Minor operator M (state @ M^T): P = B*R, N = C,
  Q = 1, Op = M."""
  if x_re.device.type == "cpu":
    return axis_apply_plain(x_re, x_im, op_re, op_im, p, n, q)
  if x_re.device.type != "cuda":
    raise ValueError(f"axis_apply: unsupported device {x_re.device}")
  if n not in (2, 4, 8, 16, 32, 64, 128):
    raise ValueError(f"axis_apply: N={n} is not a power of two in [2, 128]")
  _cuda.require([x_re, x_im], x_re.device, [x_re.shape] * 2)
  if x_re.numel() != p * n * q:
    raise ValueError(f"axis_apply: {x_re.numel()} elements != {p}*{n}*{q}")
  _cuda.require([op_re, op_im], x_re.device, [(n, n)] * 2)
  lib = _cuda.library()
  y_re = torch.empty_like(x_re)
  y_im = torch.empty_like(x_im)
  _cuda.check(lib.qhbm_axis_apply(
      x_re.data_ptr(), x_im.data_ptr(), op_re.data_ptr(), op_im.data_ptr(),
      y_re.data_ptr(), y_im.data_ptr(), p, n, q, _cuda.stream_of(x_re)),
              "axis_apply")
  axis_apply.launches += 1
  return y_re, y_im


axis_apply.launches = 0


def diag_rotate_plain(states: List[Planes], cos_t, sin_t, sign: int) -> None:
  """In place: every (re, im) [B, R, C] pair <- (cos + i*sign*sin) * x."""
  s = sin_t * sign
  for re, im in states:
    y_re = cos_t * re - s * im
    y_im = cos_t * im + s * re
    re.copy_(y_re)
    im.copy_(y_im)


def diag_rotate(states: List[Planes], cos_t, sin_t, sign: int) -> None:
  """Multiplies one or two state batches IN PLACE by exp(i*sign*theta),
  given the shared [R, C] planes cos(theta), sin(theta).  Sign +1 is the
  forward apply, -1 the adjoint un-apply (pallas_adjoint.py:345-357)."""
  re0, im0 = states[0]
  if re0.device.type == "cpu":
    diag_rotate_plain(states, cos_t, sin_t, sign)
    return
  if re0.device.type != "cuda":
    raise ValueError(f"diag_rotate: unsupported device {re0.device}")
  if len(states) not in (1, 2):
    raise ValueError("diag_rotate takes one or two state batches")
  b, r, c = re0.shape
  if (r * c) % 4:
    raise ValueError("diag_rotate needs R*C divisible by 4")
  flat = [t for pair in states for t in pair]
  _cuda.require(flat, re0.device, [(b, r, c)] * len(flat))
  _cuda.require([cos_t, sin_t], re0.device, [(r, c)] * 2)
  re1, im1 = states[1] if len(states) == 2 else (None, None)
  lib = _cuda.library()
  _cuda.check(lib.qhbm_diag_rotate(
      re0.data_ptr(), im0.data_ptr(),
      None if re1 is None else re1.data_ptr(),
      None if im1 is None else im1.data_ptr(), b, r * c, cos_t.data_ptr(),
      sin_t.data_ptr(), int(sign), _cuda.stream_of(re0)), "diag_rotate")
  diag_rotate.launches += 1


diag_rotate.launches = 0


# ---------------------------------------------------------------------------
# Segment preparation (mirrors pallas_sv._prepare_segments{,_rot})
# ---------------------------------------------------------------------------

def host_values(symbol_values) -> np.ndarray:
  """float32 host copy of the symbol values (a tensor on any device, or an
  array).  Operators are folded on the host from it."""
  if isinstance(symbol_values, torch.Tensor):
    symbol_values = symbol_values.detach().cpu()
  return np.asarray(symbol_values, np.float32)


def to_device(host: List[torch.Tensor], device) -> List[torch.Tensor]:
  """Moves float32 host tensors to `device` in ONE pinned, non-blocking
  copy (a blocking copy would wait for every kernel queued on the stream);
  returns contiguous views of the device buffer, in order."""
  if torch.device(device).type == "cpu" or not host:
    return host
  flat = torch.cat([t.reshape(-1) for t in host]).pin_memory()
  staged = flat.to(device, non_blocking=True)
  out, pos = [], 0
  for t in host:
    out.append(staged[pos:pos + t.numel()].view(t.shape))
    pos += t.numel()
  return out


def split(mat: torch.Tensor) -> List[torch.Tensor]:
  """complex64 -> [re, im] contiguous float32 host planes."""
  return [mat.real.to(torch.float32).contiguous(),
          mat.imag.to(torch.float32).contiguous()]


def fold_1q(seg_gates, seg_angles, nr: int, m: int):
  """Per-qubit products of a 1q segment, folded on the host in float32:
  ({row qubit: 2x2}, minor [C, C] operator or None).

  The minor operator is the kron of the per-qubit products over the column
  qubits (identity where a qubit has no gate) -- the reference's product of
  [C, C] embeddings, without its [C, C] matmuls."""
  by_qubit = {}
  for gate, mat in zip(seg_gates, sv.segment_matrices(seg_gates, seg_angles)):
    by_qubit.setdefault(gate.qubits[0], []).append(mat)
  folded = {}
  for q, chain in by_qubit.items():
    mat = chain[0]
    for nxt in chain[1:]:
      mat = nxt @ mat
    folded[q] = mat
  majors = {q: mat for q, mat in folded.items() if q < nr}
  minors = {q - nr: mat for q, mat in folded.items() if q >= nr}
  return majors, sv._fold_block(minors, 0, m)


def rotation_planes(weights: torch.Tensor, rms, cms, shape_rc) -> Planes:
  """cos/sin [R, C] planes of a diagonal segment's total phase, from its
  [K] factor weights (on the planes' device) and parity masks."""
  theta = sv.parity_outer_sum(weights, rms, cms, shape_rc)
  return torch.cos(theta).contiguous(), torch.sin(theta).contiguous()


def prepare_segments(circuit: ir.Circuit, symbol_values, device):
  """Forward stages, in circuit order:
    ("rowblock", (start, k), (op_re, op_im))
    ("minor", None, (op_re, op_im))          -- Op = M for state @ M^T
    ("diag", None, (cos, sin))
  Operators and diagonal weights are built on the host from the values
  (`host_values`) and cross to `device` in one copy; the rotation planes
  are then built on `device`."""
  n = circuit.num_qubits
  shape_rc = sv.state_shape(n)
  m = sv.minor_bits(n)
  nr = n - m
  angles = sv.resolve_angles(circuit, host_values(symbol_values))
  plan = []  # (kind, meta, host tensors)
  for cls, idxs in sv.segment_circuit(circuit.gates):
    seg_gates = [circuit.gates[i] for i in idxs]
    seg_angles = angles[list(idxs)]
    if cls == "1q":
      majors, minor = fold_1q(seg_gates, seg_angles, nr, m)
      for start, k in sv._row_blocks(nr):
        folded = sv._fold_block(majors, start, k)
        if folded is not None:
          plan.append(("rowblock", (start, k), split(folded)))
      if minor is not None:
        plan.append(("minor", None, split(minor)))
    elif cls == "diag":
      weights, rms, cms = sv.diag_segment_weights(seg_gates, seg_angles, nr,
                                                  m)
      plan.append(("diag", (rms, cms), [torch.from_numpy(weights)]))
    else:
      raise NotImplementedError(
          f"gate {circuit.gates[idxs[0]].kind!r} is neither a 1q dense nor a "
          "diagonal gate; the batched engine does not take it yet")
  moved = iter(to_device([t for _, _, ts in plan for t in ts], device))
  stages = []
  for kind, meta, ts in plan:
    ops = [next(moved) for _ in ts]
    if kind == "diag":
      stages.append(("diag", None, rotation_planes(ops[0], *meta, shape_rc)))
    else:
      stages.append((kind, meta, tuple(ops)))
  return stages


def apply_stage(kind, meta, ops, planes: List[Planes], sign: int,
                plain: bool = False) -> List[Planes]:
  """Applies one prepared stage to each [B, R, C] plane pair; diagonal
  stages rotate in place (sign +1 forward, -1 un-apply), operator stages
  return new planes."""
  apply_fn = axis_apply_plain if plain else axis_apply
  if kind == "diag":
    (diag_rotate_plain if plain else diag_rotate)(planes, ops[0], ops[1],
                                                  sign)
    return planes
  b, r, c = planes[0][0].shape
  if kind == "rowblock":
    start, k = meta
    p, nn, q = b << start, 2**k, (r * c) >> (start + k)
  else:
    p, nn, q = b * r, c, 1
  return [apply_fn(re, im, ops[0], ops[1], p, nn, q) for re, im in planes]


def basis_planes(rowcol: torch.Tensor, shape_rc) -> Planes:
  """[B, R, C] float32 planes of the basis states at (row, col)."""
  r, c = shape_rc
  b = rowcol.shape[0]
  re = torch.zeros((b, r, c), dtype=torch.float32, device=rowcol.device)
  im = torch.zeros_like(re)
  flat = rowcol[:, 0].to(torch.int64) * c + rowcol[:, 1].to(torch.int64)
  re.view(b, r * c)[torch.arange(b, device=rowcol.device), flat] = 1.0
  return re, im


def apply_circuit_batched(circuit: ir.Circuit, symbol_values,
                          init_rowcol: torch.Tensor,
                          plain: bool = False) -> Planes:
  """Evolves B basis states through the circuit.

  Args:
    circuit: circuit of 1q dense and diagonal gates.
    symbol_values: [num_symbols] parameters, a tensor on any device or a
      host array (the operators are folded on the host).
    init_rowcol: [B, 2] (row, col) indices of the basis states in the
      [R, C] layout, on the device the states should live on.
    plain: run the kernels' plain PyTorch versions (reference only).

  Returns:
    (re, im) float32 [B, R, C] planes of the final states.
  """
  shape_rc = sv.state_shape(circuit.num_qubits)
  planes = [basis_planes(init_rowcol, shape_rc)]
  for kind, meta, ops in prepare_segments(circuit, symbol_values,
                                          init_rowcol.device):
    planes = apply_stage(kind, meta, ops, planes, +1, plain)
  return planes[0]
