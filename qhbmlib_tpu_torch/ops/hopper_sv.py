"""Circuit forward on Hopper: the ports of K4, K1 and K3.

`apply_circuit_batched` evolves B basis states through a circuit of 1q and
diagonal segments.  It computes what the grid-over-batch Pallas kernel
`apply_circuit_pallas_batched` (qhbmlib_tpu/ops/pallas_sv.py:459, K4)
computes: the folded row-block / minor operators and the diagonal segments'
cos/sin planes are built once and shared by the whole batch.  On the TPU the
whole state sat in VMEM for the whole circuit; on the H100 a 20-qubit state
does not fit one SM, so every segment is one or two launches over the
[B, R, C] batch:

  1q segment   -> `axis2_apply` (K1, `fused_blocks_minor_apply`) on pairs of
                  its operators, `axis_apply` on an operator left unpaired
                  (`plan_passes`);
  diag segment -> one `diag_rotate` with the segment's shared planes (the
                  batched sweep un-applies it inside its diagonal stage's
                  `hopper_adjoint.parity_bilinear` launch).

`circuit_forward` (K3, `apply_circuit_pallas`, pallas_sv.py:667) runs the
whole circuit on ONE state of 8 to 20 qubits in one cooperative launch that
walks a stage table (`single_stages`); its axis stages of N >= 16 contract
on the tensor cores (3xTF32) as `axis_apply` does.

The kernels live in `csrc/statevector_kernels.cu`.  Each wrapper launches
its kernel for CUDA tensors (or raises) and runs its plain PyTorch version
only for CPU tensors.  `plain=True` runs the plain versions on any device;
tests and `chip_smoke.py` use it as the reference, the main path never does.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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
  forward apply, -1 an un-apply (pallas_adjoint.py:345-357; the batched
  sweep's runs fused with its bilinears, `hopper_adjoint.parity_bilinear`).
  On the card its grid spans amplitude tiles x batch chunks, so a batch of
  small states fills the card as one large state does."""
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


def _is_pow2(x: int) -> bool:
  return x >= 1 and x & (x - 1) == 0


def axis2_apply_plain(x_re, x_im, a_re, a_im, b_re, b_im, p: int, n1: int,
                      m: int, n2: int, q: int) -> Planes:
  """y[p, I, m, J, q] = sum_ij A[I, i] B[J, j] x[p, i, m, j, q]."""
  xr = x_re.reshape(p, n1, m, n2, q)
  xi = x_im.reshape(p, n1, m, n2, q)

  def cmul(prog, o_re, o_im, vr, vi):
    return (torch.einsum(prog, o_re, vr) - torch.einsum(prog, o_im, vi),
            torch.einsum(prog, o_re, vi) + torch.einsum(prog, o_im, vr))

  yr, yi = cmul("Ii,pimjq->pImjq", a_re, a_im, xr, xi)
  yr, yi = cmul("Jj,pImjq->pImJq", b_re, b_im, yr, yi)
  return (yr.reshape(x_re.shape).contiguous(),
          yi.reshape(x_im.shape).contiguous())


def axis2_apply(x_re, x_im, a_re, a_im, b_re, b_im, p: int, n1: int, m: int,
                n2: int, q: int) -> Planes:
  """Split-complex operators A [N1, N1] and B [N2, N2] on axes 1 and 3 of a
  [P, N1, M, N2, Q] view of the float32 planes, in one pass over the state
  (K1); returns new planes.  Operators on bits [s1, s1 + k1) and
  [s2, s2 + k2) of B n-qubit states: P = B*2^s1, N1 = 2^k1,
  M = 2^(s2-s1-k1), N2 = 2^k2, Q = 2^(n-s2-k2)."""
  if x_re.device.type == "cpu":
    return axis2_apply_plain(x_re, x_im, a_re, a_im, b_re, b_im, p, n1, m, n2,
                             q)
  if x_re.device.type != "cuda":
    raise ValueError(f"axis2_apply: unsupported device {x_re.device}")
  if not all(_is_pow2(v) for v in (n1, n2, q)) or not 2 <= min(n1, n2) or \
      max(n1, n2) > 128:
    raise ValueError(f"axis2_apply: N1={n1}, N2={n2} must be powers of two "
                     f"in [2, 128] and Q={q} a power of two")
  _cuda.require([x_re, x_im], x_re.device, [x_re.shape] * 2)
  if x_re.numel() != p * n1 * m * n2 * q:
    raise ValueError(f"axis2_apply: {x_re.numel()} elements != "
                     f"{p}*{n1}*{m}*{n2}*{q}")
  ops = [a_re, a_im, b_re, b_im]
  _cuda.require(ops, x_re.device, [(n1, n1)] * 2 + [(n2, n2)] * 2)
  lib = _cuda.library()
  y_re = torch.empty_like(x_re)
  y_im = torch.empty_like(x_im)
  _cuda.check(lib.qhbm_axis2_apply(
      x_re.data_ptr(), x_im.data_ptr(), *(t.data_ptr() for t in ops),
      y_re.data_ptr(), y_im.data_ptr(), p, n1.bit_length() - 1, m,
      n2.bit_length() - 1, q, _cuda.stream_of(x_re)), "axis2_apply")
  axis2_apply.launches += 1
  return y_re, y_im


axis2_apply.launches = 0


# ---------------------------------------------------------------------------
# Host preparation (mirrors pallas_sv._prepare_segments{,_rot})
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


def segment_ops(majors, minor, nr: int, m: int):
  """[((start, k), op)] of one 1q segment: the folded row blocks that hold
  an operator, in bit order, then the minor operator at (nr, m), whose
  Op = M applies as state @ M^T."""
  ops = []
  for start, k in sv._row_blocks(nr):
    folded = sv._fold_block(majors, start, k)
    if folded is not None:
      ops.append(((start, k), folded))
  if minor is not None:
    ops.append(((nr, m), minor))
  return ops


def forward_plan(circuit: ir.Circuit, symbol_values):
  """Host stages in circuit order, shared by the batched and single-state
  engines: ("1q", segment_ops) or ("diag", (weights [K] float32, row_masks,
  col_masks))."""
  n = circuit.num_qubits
  m = sv.minor_bits(n)
  nr = n - m
  angles = sv.resolve_angles(circuit, host_values(symbol_values))
  plan = []
  for cls, idxs in sv.segment_circuit(circuit.gates):
    seg_gates = [circuit.gates[i] for i in idxs]
    seg_angles = angles[list(idxs)]
    if cls == "1q":
      plan.append(("1q", segment_ops(*fold_1q(seg_gates, seg_angles, nr, m),
                                     nr, m)))
    elif cls == "diag":
      plan.append(("diag", sv.diag_segment_weights(seg_gates, seg_angles, nr,
                                                   m)))
    else:
      raise NotImplementedError(
          f"gate {circuit.gates[idxs[0]].kind!r} is neither a 1q dense nor a "
          "diagonal gate; the port's engines do not take it yet")
  return plan


def rotation_planes(weights: torch.Tensor, rms, cms, shape_rc) -> Planes:
  """cos/sin [R, C] planes of a diagonal segment's total phase, from its
  [K] factor weights (on the planes' device) and parity masks."""
  theta = sv.parity_outer_sum(weights, rms, cms, shape_rc)
  return torch.cos(theta).contiguous(), torch.sin(theta).contiguous()


# ---------------------------------------------------------------------------
# 1q segments as passes over the state (K1)
# ---------------------------------------------------------------------------

def plan_passes(ops, nr: int):
  """Pairs a segment's operators [((start, k), op)] (bit order, minor at
  start nr last) into passes: ((start, k), op) alone, or
  ((s1, k1), op1, (s2, k2), op2) for one `axis2_apply`.  The first row
  block goes with the minor operator (a slab's rows are then whole minor
  rows, 512 contiguous bytes), the other row blocks pair in order; an
  operator left over takes `axis_apply`.  Operators on disjoint bits
  commute, so every pairing computes the same product."""
  rows = [o for o in ops if o[0][0] < nr]
  minor = [o for o in ops if o[0][0] >= nr]
  passes = []
  if rows and minor:
    passes.append(rows.pop(0) + minor[0])
  else:
    passes.extend(minor)
  passes.extend(rows[i] + rows[i + 1] for i in range(0, len(rows) - 1, 2))
  if len(rows) % 2:
    passes.append(rows[-1])
  return passes


def apply_pass(pss, planes: List[Planes], n: int,
               plain: bool = False) -> List[Planes]:
  """Applies one pass to each [B, R, C] plane pair (new planes)."""
  b = planes[0][0].shape[0]
  if len(pss) == 2:
    (s, k), op = pss
    fn = axis_apply_plain if plain else axis_apply
    return [fn(re, im, op[0], op[1], b << s, 2**k, 2**(n - s - k))
            for re, im in planes]
  (s1, k1), op1, (s2, k2), op2 = pss
  fn = axis2_apply_plain if plain else axis2_apply
  return [fn(re, im, op1[0], op1[1], op2[0], op2[1], b << s1, 2**k1,
             2**(s2 - s1 - k1), 2**k2, 2**(n - s2 - k2)) for re, im in planes]


def device_passes(ops, nr: int, device):
  """plan_passes of host operators, each op moved to `device` as an
  (re, im) plane pair in one copy."""
  moved = iter(to_device([t for _, op in ops for t in split(op)], device))
  return plan_passes([(bits, (next(moved), next(moved))) for bits, _ in ops],
                     nr)


def apply_passes(passes, planes: List[Planes], n: int,
                 plain: bool = False) -> List[Planes]:
  for pss in passes:
    planes = apply_pass(pss, planes, n, plain)
  return planes


def fused_blocks_minor_apply(planes: Planes, k1: int, k2: int, m1, m2,
                             minor, plain: bool = False) -> Planes:
  """K1: (block 1 on row bits [0, k1)) x (block 2 on row bits
  [k1, k1 + k2)) x (minor operator M, applied as state @ M^T) on [B, R, C]
  planes, through `axis2_apply`.  Each operator is an (re, im) pair on the
  planes' device, or None (stage skipped), as in the reference's
  `fused_blocks_minor_apply` (which takes M pre-transposed)."""
  b, r, c = planes[0].shape
  n = (r * c).bit_length() - 1
  nr = n - (c.bit_length() - 1)
  ops = [o for o in (((0, k1), m1), ((k1, k2), m2),
                     ((nr, n - nr), minor)) if o[1] is not None]
  return apply_passes(plan_passes(ops, nr), [planes], n, plain)[0]


def prepare_segments(circuit: ir.Circuit, symbol_values, device):
  """Forward stages of the batched engine, in circuit order:
    ("1q", passes)       -- `plan_passes` with device operators
    ("diag", (cos, sin)) -- the segment's shared rotation planes
  Operators and diagonal weights are built on the host from the values
  (`host_values`) and cross to `device` in one copy; the rotation planes
  are then built on `device`."""
  n = circuit.num_qubits
  shape_rc = sv.state_shape(n)
  nr = n - sv.minor_bits(n)
  plan = forward_plan(circuit, symbol_values)
  host = []
  for kind, body in plan:
    if kind == "1q":
      host.extend(t for _, op in body for t in split(op))
    else:
      host.append(torch.from_numpy(body[0]))
  moved = iter(to_device(host, device))
  stages = []
  for kind, body in plan:
    if kind == "1q":
      stages.append(("1q", plan_passes(
          [(bits, (next(moved), next(moved))) for bits, _ in body], nr)))
    else:
      _, rms, cms = body
      stages.append(("diag", rotation_planes(next(moved), rms, cms,
                                             shape_rc)))
  return stages


def apply_stage(stage, planes: List[Planes],
                plain: bool = False) -> List[Planes]:
  """Applies one prepared forward stage to each [B, R, C] plane pair;
  diagonal stages rotate in place, 1q stages return new planes."""
  kind, body = stage
  if kind == "diag":
    (diag_rotate_plain if plain else diag_rotate)(planes, body[0], body[1],
                                                  +1)
    return planes
  b, r, c = planes[0][0].shape
  return apply_passes(body, planes, (r * c).bit_length() - 1, plain)


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
                          init_rowcol: Optional[torch.Tensor] = None,
                          plain: bool = False,
                          init_planes: Optional[Planes] = None) -> Planes:
  """Evolves B states through the circuit: basis states (`init_rowcol`) or
  states of any content (`init_planes`), exactly one of the two.

  Args:
    circuit: circuit of 1q dense and diagonal gates.
    symbol_values: [num_symbols] parameters, a tensor on any device or a
      host array (the operators are folded on the host).
    init_rowcol: [B, 2] (row, col) indices of the basis states in the
      [R, C] layout, on the device the states should live on.
    plain: run the kernels' plain PyTorch versions (reference only).
    init_planes: (re, im) float32 [B, R, C] planes of the initial states,
      on the device the states should live on; not modified (the diagonal
      stages rotate a contiguous copy in place).

  Returns:
    (re, im) float32 [B, R, C] planes of the final states.
  """
  if (init_rowcol is None) == (init_planes is None):
    raise ValueError("give exactly one of init_rowcol and init_planes")
  if init_planes is None:
    planes = [basis_planes(init_rowcol, sv.state_shape(circuit.num_qubits))]
  else:
    planes = [tuple(torch.clone(t, memory_format=torch.contiguous_format)
                    for t in init_planes)]
  for stage in prepare_segments(circuit, symbol_values, planes[0][0].device):
    planes = apply_stage(stage, planes, plain)
  return planes[0]


# ---------------------------------------------------------------------------
# K3: the whole circuit on one state, one cooperative launch
# ---------------------------------------------------------------------------

# Qubit counts the single-state kernels take, as the reference admits its
# VMEM-resident kernels (pallas_sv.supported): 8 <= n <= 20.
SINGLE_MIN_QUBITS = 8
SINGLE_MAX_QUBITS = 20

# Stage kinds, record width, most factors in a kDiag / kBilin record and
# most qubits in a kTrans record of the kernels' stage table
# (statevector_kernels.cu: kAxis, kDiag, kTrans, kBilin, kStageInts,
# kBilinMaxK, kSweepMaxTrans).
AXIS, DIAG, TRANS, BILIN = 0, 1, 2, 3
STAGE_INTS = 8
MAX_FACTORS = 1024
MAX_TRANS = 32


def single_admits(n: int) -> bool:
  return SINGLE_MIN_QUBITS <= n <= SINGLE_MAX_QUBITS


def single_stages(circuit: ir.Circuit, symbol_values):
  """Host stages of `circuit_forward`, in order: ("axis", (start, k), op)
  for every folded operator and ("diag", weights, row_masks, col_masks)
  for every diagonal segment (mirrors pallas_sv._prepare_segments)."""
  stages = []
  for kind, body in forward_plan(circuit, symbol_values):
    if kind == "1q":
      stages.extend(("axis", bits, op) for bits, op in body)
    else:
      stages.append(("diag",) + tuple(body))
  return stages


class StageTable:
  """A stage list packed for the cooperative kernels: int32 records
  [kind, start, k, K, data offset, mask offset, out offset, 0] (one per
  stage), an int32 mask array and a float32 data array, on `device`.  Diag
  masks are (row_mask << m) | col_mask, the amplitude's flat index bits;
  bilinear masks are the row masks then the column masks; a transition
  record's masks are its qubits' state-index bits (n - 1 - qubit).  A
  diagonal segment or bilinear of more than MAX_FACTORS factors takes
  several records (the rotations compose; the bilinears land side by side)."""

  def __init__(self, n: int, device):
    self.n = n
    self.m = sv.minor_bits(n)
    self.device = device
    self._records: List[List[int]] = []
    self._masks: List[int] = []
    self._data: List[torch.Tensor] = []
    self._data_len = 0
    self.out_len = 0
    self.axis_stages = 0
    self._packed = None

  def _add_data(self, t: torch.Tensor) -> int:
    off = self._data_len
    self._data.append(t.reshape(-1).to(torch.float32))
    self._data_len += t.numel()
    return off

  def _add(self, kind, start=0, k=0, count=0, data=0, masks=0, out=0):
    self._records.append([kind, start, k, count, data, masks, out, 0])

  def axis(self, bits, op: torch.Tensor) -> None:
    """An operator (complex [2^k, 2^k]) on bits [start, start + k)."""
    re, im = split(op)
    off = self._add_data(re)
    self._add_data(im)
    self._add(AXIS, bits[0], bits[1], data=off)
    self.axis_stages += 1

  def diag(self, weights, rms, cms, sign: int = 1) -> None:
    """A rotation by sign * sum_k w_k s(row & rm_k) s(col & cm_k)."""
    w = torch.from_numpy(np.asarray(weights, np.float32)) * sign
    for lo in range(0, len(rms), MAX_FACTORS):
      hi = lo + MAX_FACTORS
      off = self._add_data(w[lo:hi])
      moff = len(self._masks)
      self._masks.extend((int(rm) << self.m) | int(cm)
                         for rm, cm in zip(rms[lo:hi], cms[lo:hi]))
      self._add(DIAG, count=len(rms[lo:hi]), data=off, masks=moff)

  def transitions(self, qubits) -> int:
    """The [Q, 2, 2, 2] (qubit, re/im, i, j) 2x2 transitions
    T_q[i, j] = sum_{x: x_q = 0} conj(lam[x ^ i e_q]) a[x ^ j e_q] of
    `qubits`; returns their out offset."""
    if not 0 < len(qubits) <= MAX_TRANS:
      raise ValueError(f"a transition record takes 1 to {MAX_TRANS} qubits")
    out = self.out_len
    self.out_len += 8 * len(qubits)
    moff = len(self._masks)
    self._masks.extend(self.n - 1 - int(q) for q in qubits)
    self._add(TRANS, count=len(qubits), masks=moff, out=out)
    return out

  def bilinear(self, rms, cms) -> int:
    """The [K] parity bilinears of Im(conj(lam) a); returns their out
    offset."""
    first = self.out_len
    for lo in range(0, len(rms), MAX_FACTORS):
      part = (list(rms[lo:lo + MAX_FACTORS]), list(cms[lo:lo + MAX_FACTORS]))
      moff = len(self._masks)
      self._masks.extend(int(x) for x in part[0] + part[1])
      self._add(BILIN, count=len(part[0]), masks=moff, out=self.out_len)
      self.out_len += len(part[0])
    return first

  def widest(self) -> int:
    """Floats in the widest reduction (the per-block partials' width)."""
    return max([8 * r[3] if r[0] == TRANS else r[3]
                for r in self._records if r[0] in (TRANS, BILIN)] or [1])

  def pack(self):
    """(records [num_stages * STAGE_INTS], masks, data) on the device,
    moved there on the first call."""
    if self._packed is None:
      records = torch.tensor(self._records, dtype=torch.int32).reshape(-1)
      masks = torch.tensor(self._masks or [0], dtype=torch.int32)
      data = torch.cat(self._data) if self._data else torch.zeros(1)
      if self.device.type == "cuda":
        records, masks, data = (
            t.pin_memory().to(self.device, non_blocking=True)
            for t in (records, masks, data))
      self._packed = records, masks, data
    return self._packed

  @property
  def num_stages(self) -> int:
    return len(self._records)


def forward_table(circuit: ir.Circuit, symbol_values, device) -> StageTable:
  """The stage table of `circuit_forward`: one kAxis record per folded
  operator, one kDiag per diagonal segment."""
  table = StageTable(circuit.num_qubits, torch.device(device))
  for stage in single_stages(circuit, symbol_values):
    if stage[0] == "axis":
      table.axis(stage[1], stage[2])
    else:
      table.diag(*stage[1:])
  return table


def circuit_forward_plain(stages, x: Planes) -> Planes:
  """The stage list applied with plain PyTorch ops on one [R, C] state."""
  r, c = x[0].shape
  n = (r * c).bit_length() - 1
  planes = [tuple(t.reshape(1, r, c).contiguous().clone() for t in x)]
  dev = x[0].device
  for stage in stages:
    if stage[0] == "axis":
      _, (s, k), op = stage
      o_re, o_im = (t.to(dev) for t in split(op))
      planes = [axis_apply_plain(re, im, o_re, o_im, 1 << s, 2**k,
                                 2**(n - s - k)) for re, im in planes]
    else:
      # Summed in float64, as the kernel sums each amplitude's phase.
      _, weights, rms, cms = stage
      theta = sv.parity_outer_sum(torch.from_numpy(weights).double().to(dev),
                                  rms, cms, (r, c)).float()
      diag_rotate_plain(planes, torch.cos(theta), torch.sin(theta), +1)
  return tuple(t.reshape(r, c) for t in planes[0])


def sweep_blocks(device, states: int) -> int:
  """Blocks of one cooperative launch of `circuit_forward` (states = 1) or
  `adjoint_sweep` (states = 2) on `device` (one per SM); raises if the card
  cannot co-schedule them."""
  with torch.cuda.device(device):
    blocks = int(_cuda.library().qhbm_sweep_blocks(states))
  if blocks <= 0:
    raise RuntimeError("the single-state kernels cannot be launched "
                       "cooperatively on this device (no cooperative launch "
                       "or too little shared memory for one block per SM)")
  return blocks


def state_buffer(x: Planes) -> torch.Tensor:
  """[4, R*C] float32: the state in rows 0-1, ping-pong space in 2-3."""
  r, c = x[0].shape
  buf = torch.empty((4, r * c), dtype=torch.float32, device=x[0].device)
  buf[0].copy_(x[0].reshape(-1))
  buf[1].copy_(x[1].reshape(-1))
  return buf


def circuit_forward(circuit: ir.Circuit, symbol_values, x: Planes,
                    plain: bool = False) -> Planes:
  """K3: the whole circuit on one [R, C] state given as float32 planes, in
  ONE cooperative launch for a CUDA state of 8 to 20 qubits (raises for
  other sizes); the plain version for a CPU state or `plain=True`.
  Returns new planes."""
  n = circuit.num_qubits
  dev = x[0].device
  if plain or dev.type == "cpu":
    return circuit_forward_plain(single_stages(circuit, symbol_values), x)
  if dev.type != "cuda":
    raise ValueError(f"circuit_forward: unsupported device {dev}")
  if not single_admits(n):
    raise ValueError(f"circuit_forward takes 8 <= n <= 20 qubits, not {n}")
  shape_rc = sv.state_shape(n)
  _cuda.require(list(x), dev, [shape_rc] * 2)
  table = forward_table(circuit, symbol_values, dev)
  buf = state_buffer(x)
  launch_circuit_forward(table, buf, sweep_blocks(dev, 1))
  slot = 2 * (table.axis_stages % 2)
  return buf[slot].view(shape_rc), buf[slot + 1].view(shape_rc)


circuit_forward.launches = 0


def launch_circuit_forward(table: StageTable, buf: torch.Tensor,
                           blocks: int) -> None:
  """The K3 launch alone: `table` (a `forward_table`) on the state in rows
  0-1 of `buf` (`state_buffer`), in place; the result lands in rows 0-1 or
  2-3 by the parity of `table.axis_stages`."""
  records, masks, data = table.pack()
  _cuda.check(_cuda.library().qhbm_circuit_forward(
      buf.data_ptr(), table.n, table.m, records.data_ptr(), table.num_stages,
      data.data_ptr(), masks.data_ptr(), blocks, _cuda.stream_of(buf)),
              "circuit_forward")
  circuit_forward.launches += 1
