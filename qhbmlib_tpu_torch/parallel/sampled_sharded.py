"""Mesh-sharded sampled (shot-based) quantum inference (port of
`qhbmlib_tpu/parallel/sampled_sharded.py`).

`ShardedSampledQuantumInference` is a drop-in
`inference.qnn.SampledQuantumInference`: the same shot-sampling semantics
and parameter-shift gradients, with the unique-bitstring batch -- and with
it every parameter-shift evaluation of those states -- split over a mesh
axis.  The statevector itself stays whole on each rank (the sampled engine
targets sizes where 2^n fits one card).

Draws: every rank holds the same generator and draws the uniforms of the
WHOLE batch, as the one-rank engine does, and keeps its own rows
(`RowDraws`), so each row's shots are the ones the one-rank engine draws at
the same generator state, and the ranks' generators stay in step.  The
shift gradient's row chunks are sized from the whole batch and agreed over
the axis (their minimum), so the draws group as on one rank.  Results are
gathered over the axis (every rank gets the whole [B, ...]); the circuit's
gradient is all-reduced.  A general (non-Pauli) energy is evaluated on the
gathered samples on every rank, so its parameters' gradients are whole
without a collective.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from qhbmlib_tpu_torch.inference import qnn
from qhbmlib_tpu_torch.models import circuit as circuit_model
from qhbmlib_tpu_torch.ops import adjoint
from qhbmlib_tpu_torch.ops import hopper_sv
from qhbmlib_tpu_torch.ops import shift
from qhbmlib_tpu_torch.parallel import comm
from qhbmlib_tpu_torch.parallel import mesh as mesh_lib


class RowDraws:
  """This rank's rows of the draws of a batch of `states` states split
  into `axis.size` slices of `per` (the last padded): probabilities come
  as [rows * per, K], row r state j at r * per + j; the uniforms are drawn
  for rows * states rows from `generator`, as `utils.categorical_rows`
  draws them on one rank, and the slice [lo, lo + per) of each row kept
  (padding states take u = 0)."""

  def __init__(self, generator: torch.Generator, states: int, per: int,
               index: int):
    self.generator = generator
    self.states = states
    self.per = per
    self.lo = index * per

  def categorical_rows(self, probs: torch.Tensor, shots: int) -> torch.Tensor:
    rows = probs.shape[0] // self.per
    cdf = torch.cumsum(probs.to(torch.float32), 1)
    u = torch.rand((rows * self.states, shots), generator=self.generator,
                   device=cdf.device, dtype=torch.float32)
    u = u.reshape(rows, self.states, shots)
    pad = self.per * (-(-self.states // self.per)) - self.states
    if pad:
      u = torch.cat([u, u.new_zeros((rows, pad, shots))], dim=1)
    u = u[:, self.lo:self.lo + self.per].reshape(rows * self.per, shots)
    idx = torch.searchsorted(cdf, u * cdf[:, -1:], right=True)
    return torch.clamp(idx, max=cdf.shape[1] - 1)


def _pad_batch(bits: torch.Tensor, d: int):
  """(bits padded with zero rows to a multiple of `d`, the original B).
  Padding rows compute on the zero bitstring; their outputs are dropped and
  their cotangents are zero."""
  b = bits.shape[0]
  pad = (-b) % d
  if pad:
    bits = torch.cat([bits, bits.new_zeros((pad,) + tuple(bits.shape[1:]))])
  return bits, b


def _agreed_chunk(circuit, states: int, per: int, axis, device) -> int:
  """Shift rows a chunk for a batch of `states` states (as one rank sizes
  it), the minimum over the axis so every rank draws in the same groups."""
  rows = shift.shift_plan(circuit)[0].shape[0]
  chunk = shift.row_chunk(circuit.num_qubits, max(rows, 1), states, device)
  t = torch.tensor([chunk], dtype=torch.int64, device=device)
  return int(comm.all_reduce_sum(t, axis, dist.ReduceOp.MIN)[0])


def _gather_rows(x: torch.Tensor, axis, b: int) -> torch.Tensor:
  """Every rank's rows of `x`, in rank order, the padding dropped."""
  whole = comm.all_gather(x, axis)
  return whole.reshape((-1,) + tuple(x.shape[1:]))[:b]


class _TermMeans(torch.autograd.Function):
  """[B, T] sampled term means of the whole batch from this rank's rows
  (`qnn._SampledTermMeans` split over the axis)."""

  @staticmethod
  def forward(ctx, symbol_values, rowcol, circuit, plan, shots, draws, axis,
              b):
    values = hopper_sv.host_values(symbol_values)
    ctx.args = (values, rowcol, circuit, plan, shots, draws, axis, b)
    means = qnn.shifted_term_means(
        circuit, values, rowcol, np.zeros([1, circuit.num_gates], np.float32),
        plan, shots, draws)[0]
    return _gather_rows(means, axis, b)

  @staticmethod
  def backward(ctx, g):
    values, rowcol, circuit, plan, shots, draws, axis, b = ctx.args
    per = rowcol.shape[0]
    g = torch.cat([g, g.new_zeros((per * axis.size - b,) + g.shape[1:])])
    g = g[draws.lo:draws.lo + per]
    chunk = _agreed_chunk(circuit, b, per, axis, rowcol.device)
    grad = qnn.term_means_gradient(circuit, values, rowcol, plan, g, shots,
                                   draws, chunk)
    return (comm.all_reduce_sum(grad, axis), None, None, None, None, None,
            None, None)


class _EnergyShift(torch.autograd.Function):
  """Zero [B] whose gradient w.r.t. the circuit's values is the parameter
  shift of the sampled energy mean (`qnn._EnergyShift` split over the
  axis: this rank's states, then an all-reduce)."""

  @staticmethod
  def forward(ctx, symbol_values, rowcol, circuit, energy, shots, draws,
              axis, b):
    ctx.args = (hopper_sv.host_values(symbol_values), rowcol, circuit,
                energy, shots, draws, axis, b)
    return torch.zeros(b, dtype=torch.float32, device=rowcol.device)

  @staticmethod
  def backward(ctx, g):
    values, rowcol, circuit, energy, shots, draws, axis, b = ctx.args
    n = circuit.num_qubits
    per = rowcol.shape[0]
    g = torch.cat([g, g.new_zeros(per * axis.size - b)])[
        draws.lo:draws.lo + per]

    def eval_fn(rows):
      samples = qnn._sampled_states(circuit, values, rowcol, rows, shots,
                                    draws)
      with torch.no_grad():
        e = energy(samples.reshape(-1, n)).reshape(samples.shape[:3])
      return (e.mean(dim=2) * g[None]).sum(dim=1)

    grad = shift.shift_gradient(
        circuit, eval_fn, circuit.num_symbols,
        _agreed_chunk(circuit, b, per, axis, rowcol.device),
        device=rowcol.device)
    return (comm.all_reduce_sum(grad, axis), None, None, None, None, None,
            None, None)


class ShardedSampledQuantumInference(qnn.SampledQuantumInference):
  """Shot-based expectations with the state batch split over a mesh
  axis; on an axis of size 1 it is `SampledQuantumInference`."""

  def __init__(self, input_circuit: circuit_model.QuantumCircuit,
               expectation_samples: int, mesh: mesh_lib.Mesh,
               data_axis: str = mesh_lib.DATA_AXIS,
               name: Optional[str] = None,
               initial_seed: Optional[int] = None):
    if data_axis not in mesh.shape:
      raise ValueError(f"mesh {tuple(mesh.axis_names)} has no axis "
                       f"{data_axis!r}")
    super().__init__(input_circuit, expectation_samples, name, initial_seed)
    self._mesh = mesh
    self._data_axis = data_axis

  @property
  def mesh(self) -> mesh_lib.Mesh:
    return self._mesh

  def _split(self, pqc, values, bits, generator):
    """(this rank's rowcol, its RowDraws, the axis, B)."""
    axis = self._mesh.axis(self._data_axis)
    padded, b = _pad_batch(bits.to(values.device), axis.size)
    per = padded.shape[0] // axis.size
    mine = padded[axis.index * per:(axis.index + 1) * per]
    return (adjoint.bits_to_rowcol(mine, pqc.num_qubits),
            RowDraws(generator, b, per, axis.index), axis, b)

  def _term_expectations(self, pqc, values, bits, ops, generator):
    if self._mesh.shape[self._data_axis] == 1:
      return super()._term_expectations(pqc, values, bits, ops, generator)
    plan, slices = self._measurement_plan(pqc, ops)
    rowcol, draws, axis, b = self._split(pqc, values, bits, generator)
    means = _TermMeans.apply(values, rowcol, pqc, plan,
                             self.expectation_samples, draws, axis, b)
    coeffs = torch.cat([op.coeffs.reshape(-1) for op in ops]).to(means)
    weighted = means * coeffs[None, :]
    return torch.stack([weighted[:, lo:hi].sum(dim=1) for lo, hi in slices],
                       dim=1)

  def _energy_expectation(self, pqc, values, bits, energy, generator):
    if self._mesh.shape[self._data_axis] == 1:
      return super()._energy_expectation(pqc, values, bits, energy,
                                         generator)
    rowcol, draws, axis, b = self._split(pqc, values, bits, generator)
    shots = self.expectation_samples
    samples = qnn._sampled_states(pqc, values, rowcol,
                                  np.zeros([1, pqc.num_gates], np.float32),
                                  shots, draws)[0]
    samples = _gather_rows(samples, axis, b)
    e = energy(samples.reshape(-1, pqc.num_qubits)).reshape(
        samples.shape[:2]).mean(dim=1)
    return e + _EnergyShift.apply(values, rowcol, pqc, energy, shots, draws,
                                  axis, b)
