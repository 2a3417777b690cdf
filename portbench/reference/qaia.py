"""Reference of the quantum-classical ansatz QAIA (reference library
`models/circuit.py:226-276`): each of L layers applies exp(-i gamma_{l,k}
H_k) for each quantum term H_k, then exp(-i eta_l theta_j C_j) for each
classical term C_j.

The quantum terms are the target's sums of one Pauli letter each (X, Y,
Z), the classical terms the energy's Z_j on each qubit.  A sum of one
letter on a chain commutes term by term, so exp(-i gamma H_k) is exact as
the basis change of its letter, the phase -gamma sum_t c_t prod z, and the
change undone.  Parameters: etas [L], thetas [n], gammas [L, K].
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench import hamiltonian
from portbench.reference import statevector as sv


def leaf_shapes(config) -> List[Tuple[str, Tuple[int, ...]]]:
  n, layers = config["qubits"], config["circuit"]["layers"]
  k = len(hamiltonian.letter_shards(
      hamiltonian.chain_terms(config["target"], n)))
  return [("etas", (layers,)), ("thetas", (n,)), ("gammas", (layers, k))]


def gate_counts(config) -> Dict[str, int]:
  """Gates by class, one exponential of a Pauli string a gate: a string
  with an X or a Y flips amplitudes (two-qubit flip class), a Z string is
  diagonal; every gate is parameterized."""
  n, layers = config["qubits"], config["circuit"]["layers"]
  terms = hamiltonian.chain_terms(config["target"], n)
  flips = sum(1 for _, q in terms if set(q.values()) != {"Z"})
  diag = len(terms) - flips + n
  return {"dense_1q": 0, "diagonal": layers * diag,
          "flip_2q": layers * flips, "parameterized": layers * (diag + flips)}


def circuit(space: sv.Space, config, params: Dict[str, torch.Tensor],
            terms):
  """The circuit's steps for `statevector.run`; `terms` the target's."""
  n, layers = space.n, config["circuit"]["layers"]
  shards = hamiltonian.letter_shards(terms)
  z = [space.z(j) for j in range(n)]
  ops = []
  for layer in range(layers):
    for k, shard in enumerate(shards):
      ops += sv.pauli_exponential(space, shard, params["gammas"][layer, k])
    classical = 0.0
    for j in range(n):
      classical = classical + params["thetas"][j] * z[j]
    ops.append(("phase", -params["etas"][layer] * classical))
  return ops
