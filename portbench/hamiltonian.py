"""A configuration's target Hamiltonian as a list of Pauli terms.

The configuration states a chain: per-qubit fields and nearest-neighbour
couplings with their coefficients, e.g. the open transverse-field Ising
chain {"chain": "open", "fields": {"X": -1.0}, "couplings": {"ZZ": -1.0}}
or the open Heisenberg chain {"chain": "open", "couplings": {"XX": 1.0,
"YY": 1.0, "ZZ": 1.0}}.  Terms come fields first (letter by letter, qubit
by qubit), then bond by bond with each coupling, the order in which the
port's builders (`paulis.tfim_1d`, the ladder's `heisenberg`) list them.
Both the program's PauliSum and the reference's observable are made from
this one list.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

Term = Tuple[float, Dict[int, str]]


def chain_terms(spec: Mapping, n: int) -> List[Term]:
  """[(coeff, {qubit: letter})] of the chain `spec` on n qubits."""
  if spec["chain"] != "open":
    raise ValueError(f"chain must be open, not {spec['chain']!r}")
  terms: List[Term] = []
  for letter, coeff in spec.get("fields", {}).items():
    terms += [(float(coeff), {q: letter}) for q in range(n)]
  for q in range(n - 1):
    for pair, coeff in spec.get("couplings", {}).items():
      terms.append((float(coeff), {q: pair[0], q + 1: pair[1]}))
  return terms


def letter_shards(terms: List[Term]) -> List[List[Term]]:
  """The terms grouped by their one Pauli letter, X then Y then Z (a
  chain's X-field and ZZ sums, or XX, YY and ZZ sums), as QAIA takes its
  quantum terms; raises for a term of several letters."""
  shards = []
  for letter in "XYZ":
    shard = [t for t in terms if set(t[1].values()) == {letter}]
    if shard:
      shards.append(shard)
  if sum(map(len, shards)) != len(terms):
    raise ValueError("QAIA's quantum terms take one Pauli letter each")
  return shards
