"""The model's operations a train step, from the configuration alone.

Counted gate by gate as dense applications on every amplitude of each
state the step evaluates (the `max_unique` rows of its batch), whatever
implements them:

  * a dense one-qubit gate: an output amplitude is two complex products
    and a sum, 2 x 6 + 2 = 14 flops;
  * a diagonal gate: one complex product, 6 flops;
  * a two-qubit gate of the flip class (alpha s[x] + beta s[x ^ f]): two
    complex products and a sum, 14 flops;
  * a permutation: 0.

The adjoint sweep un-applies each gate from two states (the state and
lambda): twice the forward; each parameterized gate adds its inner
product <lambda| dG |psi>, a complex multiply-add, 8 flops an amplitude.
Each Pauli term of the target costs one pass, a complex multiply-add an
amplitude (8 flops), for <psi|P|psi> and its share of lambda.  The EBM,
the energy and Adam touch a few hundred numbers and are left out.
"""

from __future__ import annotations

from portbench import hamiltonian
from portbench.reference import vqt as reference_vqt

DENSE_1Q = 14
DIAGONAL = 6
FLIP_2Q = 14
INNER_PRODUCT = 8
TERM_PASS = 8


def per_amplitude(config) -> int:
  """The flops a step spends on each amplitude of each evaluated state."""
  g = reference_vqt.kind(config["circuit"]["kind"]).gate_counts(config)
  forward = (DENSE_1Q * g["dense_1q"] + DIAGONAL * g["diagonal"] +
             FLIP_2Q * g["flip_2q"])
  sweep = 2 * forward + INNER_PRODUCT * g["parameterized"]
  terms = len(hamiltonian.chain_terms(config["target"], config["qubits"]))
  return forward + sweep + TERM_PASS * terms


def step_flops(config, traffic) -> float:
  """The model's flops in one train step."""
  return float(per_amplitude(config) * 2**config["qubits"] *
               traffic["max_unique"])
