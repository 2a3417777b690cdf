"""Exact expectations over a mesh of ranks (port of
`qhbmlib_tpu/parallel/qnn_sharded.py`).

`ShardedQuantumInference` is a drop-in `inference.qnn.QuantumInference`:
the `QHBM`, VQT and QMHL layers compose with it unchanged.  Its semantics
are `AnalyticQuantumInference`'s (exact expectations, adjoint gradients);
the unique bitstrings split over the mesh's 'data' axis and each state's
amplitudes over its 'state' axis (`parallel.sharded_sv`).  Every rank gets
the whole [B, n_ops] result and the whole gradient.
"""

from __future__ import annotations

from typing import Optional

from qhbmlib_tpu_torch.inference import qnn
from qhbmlib_tpu_torch.models import circuit as circuit_model
from qhbmlib_tpu_torch.models import energy as energy_model
from qhbmlib_tpu_torch.models import hamiltonian as hamiltonian_model
from qhbmlib_tpu_torch.ops import adjoint
from qhbmlib_tpu_torch.parallel import mesh as mesh_lib
from qhbmlib_tpu_torch.parallel import sharded_sv


class ShardedQuantumInference(qnn.QuantumInference):
  """Exact expectations over a mesh with adjoint gradients."""

  def __init__(self, input_circuit: circuit_model.QuantumCircuit,
               mesh: mesh_lib.Mesh,
               data_axis: Optional[str] = mesh_lib.DATA_AXIS,
               state_axis: str = mesh_lib.STATE_AXIS,
               name: Optional[str] = None):
    """Args:
      input_circuit: the parameterized circuit model.
      mesh: a mesh from `parallel.make_mesh`.
      data_axis: mesh axis to split the bitstring batch over (None turns
        data parallelism off, e.g. on a pure state-sharding mesh).
      state_axis: mesh axis to split the 2^n amplitudes over.
    """
    super().__init__(input_circuit, name)
    self._mesh = mesh
    # A named-but-absent axis is a caller error (a typo would otherwise
    # silently turn data parallelism off and run the batch replicated);
    # only an axis of size 1 legitimately collapses to None.
    if data_axis is not None and data_axis not in mesh.shape:
      raise ValueError(f"mesh {tuple(mesh.axis_names)} has no axis "
                       f"{data_axis!r}")
    if state_axis not in mesh.shape:
      raise ValueError(f"mesh {tuple(mesh.axis_names)} has no axis "
                       f"{state_axis!r}")
    self._data_axis = data_axis if (data_axis is not None and
                                    mesh.shape[data_axis] > 1) else None
    self._state_axis = state_axis

  @property
  def mesh(self) -> mesh_lib.Mesh:
    return self._mesh

  def _expectation(self, initial_states, observables, generator=None):
    del generator  # exact: nothing is drawn
    run = lambda pqc, values, ops: sharded_sv.batched_expectations(
        pqc, values, initial_states, ops, self._mesh, self._state_axis,
        self._data_axis)
    if isinstance(observables, hamiltonian_model.Hamiltonian):
      if not isinstance(observables.energy, energy_model.PauliMixin):
        raise TypeError("General Hamiltonians not accepted.  "
                        "Please use `SampledQuantumInference` instead.")
      total = self._total_circuit(observables)
      shards = run(total.pqc, total.resolved_values(),
                   observables.operator_shards)  # [B, S]
      return observables.energy.operator_expectation(shards)[:, None]
    return run(self._circuit.pqc, self._circuit.resolved_values(),
               adjoint.as_pauli_tuple(observables))
