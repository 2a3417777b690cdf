"""Inference on parameterized quantum circuits (port of
`qhbmlib_tpu/inference/qnn.py`).

  * `AnalyticQuantumInference`: exact expectations of PauliSum observables
    or of Hamiltonians with a Pauli energy, with adjoint gradients through
    `ops.adjoint.batched_expectations`.
  * `SampledQuantumInference`: shot-based expectations by basis-rotated
    sampling with parameter-shift gradients (`ops.shift`): the forward
    simulates the base circuit once a state, the backward all 2P shifted
    circuits of every state in one batch (`hopper_sv.apply_circuit_shifted`),
    each measurement group a constant rotation suffix and one shot batch.
"""

from __future__ import annotations

import abc
import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from qhbmlib_tpu_torch import utils
from qhbmlib_tpu_torch.models import circuit as circuit_model
from qhbmlib_tpu_torch.models import energy as energy_model
from qhbmlib_tpu_torch.models import hamiltonian as hamiltonian_model
from qhbmlib_tpu_torch.ops import adjoint
from qhbmlib_tpu_torch.ops import circuit_ir as ir
from qhbmlib_tpu_torch.ops import hopper_sv
from qhbmlib_tpu_torch.ops import paulis
from qhbmlib_tpu_torch.ops import shift
from qhbmlib_tpu_torch.ops import statevector as sv

Observable = Union[paulis.PauliSum, Sequence[paulis.PauliSum],
                   hamiltonian_model.Hamiltonian]


class QuantumInference(abc.ABC):
  """Interface for inference on quantum circuits."""

  def __init__(self, input_circuit: circuit_model.QuantumCircuit,
               name: Optional[str] = None):
    self._circuit = input_circuit
    self.name = name or type(self).__name__
    self._total_cache = {}

  @property
  def circuit(self) -> circuit_model.QuantumCircuit:
    return self._circuit

  def _total_circuit(self, observable: hamiltonian_model.Hamiltonian
                     ) -> circuit_model.QuantumCircuit:
    """self.circuit + observable.circuit_dagger, cached per Hamiltonian.

    The entry pins the Hamiltonian: ids are unique only among live objects,
    so without it a recycled id could serve a stale circuit (reference
    qnn.py:68-81)."""
    key = id(observable)
    hit = self._total_cache.get(key)
    if hit is None or hit[0] is not observable:
      hit = utils.bounded_cache_put(
          self._total_cache, key,
          (observable, self._circuit + observable.circuit_dagger))
    return hit[1]

  def expectation(self, initial_states: torch.Tensor, observables: Observable,
                  dedup: bool = True,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """[batch, n_ops] expectations of U|b> for each bitstring b (n_ops = 1
    for a Hamiltonian).  With `dedup` each distinct bitstring is simulated
    once and the results expanded back (reference qnn.py:83-105); the
    estimators, whose supports are already deduplicated, pass False.  A
    sampling engine draws from `generator` when given, else its own."""
    if not dedup:
      return self._expectation(initial_states, observables, generator)
    unique_states, idx, _ = utils.unique_bitstrings_with_counts(
        initial_states)
    return utils.expand_unique_results(
        self._expectation(unique_states, observables, generator), idx)

  @abc.abstractmethod
  def _expectation(self, initial_states: torch.Tensor,
                   observables: Observable,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """[batch, n_ops] expectations, one simulation a row; `generator`
    overrides a sampling engine's own (the reference's `key`)."""


class AnalyticQuantumInference(QuantumInference):
  """Exact expectations with adjoint gradients (reference qnn.py:117-144).

  A Hamiltonian observable H = V E V^dagger is measured as its energy's
  operator shards on (U + V^dagger)|b>, then the energy's post-process:
  gradients reach U's, V's and E's parameters.

  `plain=True` runs the kernels' plain PyTorch versions on any device: the
  reference arm of the bench's precision gate (the counterpart of the JAX
  bench's `QHBM_MATMUL_PRECISION=highest` arm), never the main path."""

  def __init__(self, input_circuit: circuit_model.QuantumCircuit,
               name: Optional[str] = None, plain: bool = False):
    super().__init__(input_circuit, name)
    self.plain = plain

  def _expectation(self, initial_states, observables, generator=None):
    del generator  # exact: nothing is drawn
    if isinstance(observables, hamiltonian_model.Hamiltonian):
      if not isinstance(observables.energy, energy_model.PauliMixin):
        raise TypeError("General Hamiltonians not accepted: the energy must "
                        "be a PauliMixin.")
      total = self._total_circuit(observables)
      shards = adjoint.batched_expectations(
          total.pqc, total.resolved_values(), initial_states,
          observables.operator_shards, plain=self.plain)  # [B, S]
      return observables.energy.operator_expectation(shards)[:, None]
    return adjoint.batched_expectations(
        self._circuit.pqc, self._circuit.resolved_values(), initial_states,
        adjoint.as_pauli_tuple(observables), plain=self.plain)


# ---------------------------------------------------------------------------
# Sampled engine
# ---------------------------------------------------------------------------

# (index, mask) pairs a pass of `utils.parities` (int32 temporaries).
PARITY_CHUNK = 1 << 24


def _measurement_rotation(num_qubits: int, codes: Sequence[int]) -> ir.Circuit:
  """Basis-rotation suffix mapping each term's Paulis onto Z: H for X,
  Rx(pi/2) for Y (reference qnn.py:151-166).  A constant circuit, applied
  to the simulated states once a measurement group."""
  b = ir.CircuitBuilder(num_qubits)
  for q, c in enumerate(codes):
    if c == paulis.X:
      b.h(q)
    elif c == paulis.Y:
      b.rx(q, shift=np.pi / 2)  # Rx(pi/2): Y -> Z
  return b.build()


def _group_terms(ops: Sequence[paulis.PauliSum]):
  """Greedy qubit-wise-commuting grouping of all terms of all ops, in the
  reference's order (qnn.py:169-207): a term joins the first group whose
  basis agrees with it wherever both are non-identity, else opens one.

  Returns [(basis_codes, masks [Gt, n] np.int32, term_indices tuple)]."""
  groups = []
  t_global = 0
  for op in ops:
    for codes in op.code_rows():
      for g in groups:
        basis = g["basis"]
        if all(basis[q] in (paulis.I, c) for q, c in enumerate(codes)
               if c != paulis.I):
          for q, c in enumerate(codes):
            if c != paulis.I:
              basis[q] = c
          g["terms"].append((codes, t_global))
          break
      else:
        groups.append({"basis": list(codes), "terms": [(codes, t_global)]})
      t_global += 1
  out = []
  for g in groups:
    masks = np.asarray([[1 if c != paulis.I else 0 for c in codes]
                        for codes, _ in g["terms"]], np.int32)
    out.append((tuple(g["basis"]), masks,
                tuple(t for _, t in g["terms"])))
  return out


def _flat_masks(masks: np.ndarray) -> np.ndarray:
  """[Gt, n] 0/1 qubit masks -> int64 [Gt] masks of the flat basis index
  (qubit q is bit n - 1 - q)."""
  n = masks.shape[1]
  return (masks.astype(np.int64) << np.arange(n - 1, -1, -1)).sum(axis=1)


def group_probabilities(psi: hopper_sv.Planes, rotation: ir.Circuit,
                        plain: bool = False) -> torch.Tensor:
  """|R psi|^2 [S, 2^n] float32 of [S, R, C] planes after a group's
  rotation suffix R (`_measurement_rotation`, through the batched
  forward's kernels; none for the Z basis).  The suffix is one 1q segment
  (H and Rx gates), whose passes return new planes: psi is not
  modified."""
  planes = [psi]
  for stage in _suffix_stages(rotation, str(psi[0].device)):
    planes = hopper_sv.apply_stage(stage, planes, plain)
  re, im = planes[0]
  return (re * re + im * im).reshape(re.shape[0], -1)


@functools.lru_cache(maxsize=16)
def _suffix_stages(rotation: ir.Circuit, device: str):
  """The prepared stages of a constant rotation suffix on `device`,
  folded once (`hopper_sv.prepare_segments`)."""
  return hopper_sv.prepare_segments(rotation, np.zeros([0], np.float32),
                                    torch.device(device))


@sv.fp32_matmuls
def _exact_means(probs: torch.Tensor, masks: np.ndarray) -> torch.Tensor:
  """[S, Gt] sum_x p(x) (-1)^popcount(x & mask): the shot-free limit."""
  signs = sv.parity_signs(_flat_masks(masks), probs.shape[1], probs.device)
  return probs @ signs.T


def _sampled_means(probs: torch.Tensor, masks: np.ndarray, shots: int,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
  """[S, Gt] term means over `shots` draws a row of `probs`: the parities
  straight from the drawn indices (`utils.parities`), PARITY_CHUNK
  (index, mask) pairs at a time."""
  n = probs.shape[1].bit_length() - 1
  idx = utils.categorical_rows(probs, shots, generator)
  masks_t = torch.from_numpy(_flat_masks(masks)).to(probs.device)
  rows = max(1, PARITY_CHUNK // (shots * len(masks)))
  odd = torch.cat([utils.parities(idx[lo:lo + rows], masks_t, n).sum(dim=1)
                   for lo in range(0, idx.shape[0], rows)])
  return 1.0 - 2.0 * odd.to(torch.float32) / shots


def shifted_term_means(circuit: ir.Circuit, symbol_values,
                       rowcol: torch.Tensor, angle_offsets, plan,
                       shots: Optional[int] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
  """[rows, B, T] coefficient-free term means of every (offset row, basis
  state): each row's states simulated once (`apply_circuit_shifted`), then
  each measurement group's rotation suffix and one batch of `shots` draws
  a state from `generator` -- or with `shots` None the exact means from
  the same probabilities (the shot-free limit).  `plan` is (groups,
  num_terms) of `measurement_plan`."""
  groups, num_terms = plan
  offsets = np.asarray(angle_offsets, np.float32).reshape(
      -1, circuit.num_gates)
  psi = hopper_sv.apply_circuit_shifted(circuit, symbol_values, rowcol,
                                        offsets)
  out = torch.zeros((psi[0].shape[0], num_terms), dtype=torch.float32,
                    device=rowcol.device)
  for rotation, masks, term_idx in groups:
    probs = group_probabilities(psi, rotation)
    out[:, list(term_idx)] = (
        _exact_means(probs, masks) if shots is None else
        _sampled_means(probs, masks, shots, generator))
    del probs
  return out.reshape(offsets.shape[0], rowcol.shape[0], num_terms)


def term_means_gradient(circuit: ir.Circuit, symbol_values,
                        rowcol: torch.Tensor, plan, g: torch.Tensor,
                        shots: Optional[int] = None,
                        generator: Optional[torch.Generator] = None,
                        chunk: Optional[int] = None) -> torch.Tensor:
  """[num_symbols] sum_bt g[b, t] d<P_t>_b / d(symbol values) by the
  parameter shift: the 2P shifted circuits of every state
  (`shifted_term_means`, `shots` fresh draws a state and group, or the
  shot-free limit with `shots` None), in chunks of `chunk` rows (None:
  `shift.row_chunk`)."""

  def eval_fn(rows):
    evals = shifted_term_means(circuit, symbol_values, rowcol, rows, plan,
                               shots, generator)
    return (evals * g[None]).sum(dim=(1, 2))

  return shift.shift_gradient(circuit, eval_fn, circuit.num_symbols, chunk,
                              rowcol.shape[0], rowcol.device)


class _SampledTermMeans(torch.autograd.Function):
  """[B, T] sampled per-term means (coefficient-free) with parameter-shift
  gradients (reference `_sampled_term_means`, qnn.py:242-293): forward on
  the base circuit, backward on the 2P shifted circuits with fresh shots
  from the same generator, values_bar = scatter_add(slots,
  sum_bt evals[r, b, t] g[b, t] * weights)."""

  @staticmethod
  def forward(ctx, symbol_values, rowcol, circuit, plan, shots, generator):
    values = hopper_sv.host_values(symbol_values)
    ctx.args = (values, rowcol, circuit, plan, shots, generator)
    return shifted_term_means(circuit, values, rowcol,
                              np.zeros([1, circuit.num_gates], np.float32),
                              plan, shots, generator)[0]

  @staticmethod
  def backward(ctx, g):
    values, rowcol, circuit, plan, shots, generator = ctx.args
    grad = term_means_gradient(circuit, values, rowcol, plan, g, shots,
                               generator)
    return grad, None, None, None, None, None


def _sampled_states(circuit: ir.Circuit, symbol_values, rowcol, offsets,
                    shots: int, generator) -> torch.Tensor:
  """[rows, B, shots, n] int8 measurement bitstrings of each (offset row,
  basis state) in the computational basis."""
  with torch.no_grad():
    psi = hopper_sv.apply_circuit_shifted(circuit, symbol_values, rowcol,
                                          offsets)
    probs = group_probabilities(psi, ir.Circuit(circuit.num_qubits))
    idx = utils.categorical_rows(probs, shots, generator)
  return sv.index_to_bits(idx, circuit.num_qubits).reshape(
      offsets.shape[0], rowcol.shape[0], shots, circuit.num_qubits)


class _EnergyShift(torch.autograd.Function):
  """Zero [B] whose gradient w.r.t. the circuit's values is the parameter
  shift of the sampled energy mean, the energy frozen, with fresh shots a
  shifted circuit (reference `_see_bwd`, qnn.py:505-539); added to the
  energy's mean over the base circuit's samples, whose autograd gives the
  energy's own gradient on the same samples."""

  @staticmethod
  def forward(ctx, symbol_values, rowcol, circuit, energy, shots, generator):
    ctx.args = (hopper_sv.host_values(symbol_values), rowcol, circuit,
                energy, shots, generator)
    return torch.zeros(rowcol.shape[0], dtype=torch.float32,
                       device=rowcol.device)

  @staticmethod
  def backward(ctx, g):
    values, rowcol, circuit, energy, shots, generator = ctx.args
    n = circuit.num_qubits

    def eval_fn(rows):
      samples = _sampled_states(circuit, values, rowcol, rows, shots,
                                generator)
      with torch.no_grad():
        e = energy(samples.reshape(-1, n)).reshape(samples.shape[:3])
      return (e.mean(dim=2) * g[None]).sum(dim=1)

    grad = shift.shift_gradient(circuit, eval_fn, circuit.num_symbols,
                                states_per_row=rowcol.shape[0],
                                device=rowcol.device)
    return grad, None, None, None, None, None


def measurement_plan(pqc: ir.Circuit, ops: Sequence[paulis.PauliSum]):
  """((groups, num_terms), slices) of `ops` measured after `pqc`: groups
  are (rotation suffix, masks [Gt, n], term indices) of `_group_terms`,
  slices each op's term range (`paulis.op_slices`)."""
  groups = tuple((_measurement_rotation(pqc.num_qubits, basis), masks, idx)
                 for basis, masks, idx in _group_terms(ops))
  return ((groups, sum(op.num_terms for op in ops)),
          tuple(paulis.op_slices(ops)))


class SampledQuantumInference(QuantumInference):
  """Shot-based expectations with parameter-shift gradients (reference
  qnn.py:296-470).

  Each expectation simulates the circuit once a basis state and measures
  each qubit-wise-commuting group of terms (`_group_terms`) with its
  rotation suffix and `expectation_samples` shots; the backward evaluates
  the 2P shifted circuits (`ops.shift.shift_plan`) of every state in one
  batch through the batched forward's kernels
  (`hopper_sv.apply_circuit_shifted`), with fresh shots.  A Hamiltonian
  whose energy is no PauliMixin is measured by sampling bitstrings of the
  circuit + its dagger and averaging the energy over them.

  Randomness comes from an explicit `torch.Generator` on the circuit's
  device, seeded from `initial_seed` (a random seed if None).  Unlike the
  JAX package, whose pinned seed reuses one key for every call, the
  generator advances with every draw (the PyTorch convention, as the EBMs'
  `inference/ebm.py`); a call may pass its own (`expectation(...,
  generator=)`, `sample(..., generator=)`) to control it exactly."""

  def __init__(self, input_circuit: circuit_model.QuantumCircuit,
               expectation_samples: int, name: Optional[str] = None,
               initial_seed: Optional[int] = None):
    super().__init__(input_circuit, name)
    self.expectation_samples = int(expectation_samples)
    self.generator = torch.Generator(device=input_circuit._perm.device)
    if initial_seed is None:
      self.generator.seed()
    else:
      self.generator.manual_seed(initial_seed)
    self._plan_cache = {}

  def _measurement_plan(self, pqc: ir.Circuit,
                        ops: Tuple[paulis.PauliSum, ...]):
    """`measurement_plan(pqc, ops)`, cached; the entry pins (pqc, ops) so
    their ids stay unique while it lives."""
    key = (id(pqc),) + tuple(id(op) for op in ops)
    hit = self._plan_cache.get(key)
    if hit is None or hit[0] is not pqc or any(
        a is not b for a, b in zip(hit[1], ops)):
      hit = utils.bounded_cache_put(self._plan_cache, key,
                                    (pqc, tuple(ops),
                                     measurement_plan(pqc, ops)))
    return hit[2]

  def _term_expectations(self, pqc, values, bits, ops, generator):
    """[B, len(ops)] sampled expectations of PauliSums: the term means
    (shift gradients to `values`) times the coefficients (autograd)."""
    plan, slices = self._measurement_plan(pqc, ops)
    rowcol = adjoint.bits_to_rowcol(bits.to(values.device), pqc.num_qubits)
    means = _SampledTermMeans.apply(values, rowcol, pqc, plan,
                                    self.expectation_samples, generator)
    coeffs = torch.cat([op.coeffs.reshape(-1) for op in ops]).to(means)
    weighted = means * coeffs[None, :]
    return torch.stack([weighted[:, a:b].sum(dim=1) for a, b in slices],
                       dim=1)

  def _expectation(self, initial_states, observables, generator=None):
    generator = generator or self.generator
    if not isinstance(observables, hamiltonian_model.Hamiltonian):
      return self._term_expectations(
          self._circuit.pqc, self._circuit.resolved_values(), initial_states,
          adjoint.as_pauli_tuple(observables), generator)
    total = self._total_circuit(observables)
    values = total.resolved_values()
    if isinstance(observables.energy, energy_model.PauliMixin):
      shards = self._term_expectations(total.pqc, values, initial_states,
                                       observables.operator_shards, generator)
      return observables.energy.operator_expectation(shards)[:, None]
    return self._energy_expectation(total.pqc, values, initial_states,
                                    observables.energy, generator)[:, None]

  def _energy_expectation(self, pqc, values, bits, energy, generator):
    """[B] means of `energy` over the sampled measurement bitstrings of
    each state: the energy's gradient by autograd on those samples, the
    circuit's by parameter shift (`_EnergyShift`)."""
    rowcol = adjoint.bits_to_rowcol(bits.to(values.device), pqc.num_qubits)
    shots = self.expectation_samples
    samples = _sampled_states(pqc, values, rowcol,
                              np.zeros([1, pqc.num_gates], np.float32),
                              shots, generator)[0]
    e = energy(samples.reshape(-1, pqc.num_qubits)).reshape(
        samples.shape[:2]).mean(dim=1)
    return e + _EnergyShift.apply(values, rowcol, pqc, energy, shots,
                                  generator)

  def sample(self, initial_states: torch.Tensor, counts,
             max_count: Optional[int] = None,
             generator: Optional[torch.Generator] = None):
    """Measurement samples of the circuit applied to each initial state:
    (samples [B, max_count, n] int8, mask [B, max_count]) with
    mask[i, j] = j < counts[i] (reference qnn.py:421-470, eager).
    `max_count` defaults to max(counts); one smaller than max(counts)
    would truncate a state's draws while its mask marks them valid, so it
    raises."""
    counts = torch.as_tensor(counts)
    actual = int(torch.max(counts))
    if max_count is None:
      max_count = actual
    elif int(max_count) < actual:
      raise ValueError(
          f"max_count={int(max_count)} is smaller than max(counts)="
          f"{actual}: the per-state sample axis would silently truncate "
          "that state's draws. Pass max_count >= max(counts) (e.g. the "
          "total sample budget).")
    max_count = int(max_count)
    pqc = self._circuit.pqc
    values = self._circuit.resolved_values()
    rowcol = adjoint.bits_to_rowcol(
        torch.as_tensor(initial_states).to(values.device), pqc.num_qubits)
    samples = _sampled_states(pqc, values, rowcol,
                              np.zeros([1, pqc.num_gates], np.float32),
                              max_count, generator or self.generator)[0]
    mask = (torch.arange(max_count, device=samples.device)[None, :] <
            counts.to(samples.device)[:, None])
    return samples, mask
