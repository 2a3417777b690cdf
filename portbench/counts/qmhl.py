"""QMHL's operations a train step, from the configuration alone.

Counted on every amplitude of each data state the step evaluates (the
`max_unique` rows of the data's draws), each gate at its class's charge
(`flops`): the forward of the composite circuit, the data's circuit and
then the model's inverted; the adjoint sweep through the model's circuit
alone, twice its forward, with one inner product <lambda| dG |psi> for
each of its parameterized gates; one pass for each term of the model's
energy, the modular Hamiltonian's diagonal terms (one weight a term).
The chains, the energies, the Monte Carlo log Z and Adam touch a few
thousand numbers and are left out.
"""

from __future__ import annotations

from portbench import flops
from portbench.reference import qmhl as reference_qmhl


def _forward(counts) -> int:
  return (flops.DENSE_1Q * counts["dense_1q"] +
          flops.DIAGONAL * counts["diagonal"] +
          flops.FLIP_2Q * counts["flip_2q"])


def per_amplitude(config) -> int:
  """The flops a step spends on each amplitude of each evaluated state."""
  kind = reference_qmhl.kind
  data = reference_qmhl.data_config(config)
  model = kind(config["circuit"]["kind"]).gate_counts(config)
  data_gates = kind(data["circuit"]["kind"]).gate_counts(data)
  sweep = 2 * _forward(model) + flops.INNER_PRODUCT * model["parameterized"]
  (_, (terms,)), = kind(config["energy"]["kind"]).leaf_shapes(config)
  return (_forward(data_gates) + _forward(model) + sweep +
          flops.TERM_PASS * terms)


def step_flops(config, traffic) -> float:
  """The model's flops in one train step."""
  return float(per_amplitude(config) * 2**config["qubits"] *
               traffic["max_unique"])
