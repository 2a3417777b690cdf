"""VQT's operations a train step, from the configuration alone.

Counted on every amplitude of each state the step evaluates (the
`max_unique` rows of its batch), each gate at its class's charge
(`flops`).  The adjoint sweep un-applies each gate from two states (the
state and lambda): twice the forward; each parameterized gate adds its
inner product <lambda| dG |psi>.  Each Pauli term of the target costs
one pass, for <psi|P|psi> and its share of lambda.  The EBM, the energy
and Adam touch a few hundred numbers and are left out.
"""

from __future__ import annotations

from portbench import flops
from portbench import hamiltonian
from portbench.reference import vqt as reference_vqt


def per_amplitude(config) -> int:
  """The flops a step spends on each amplitude of each evaluated state."""
  g = reference_vqt.kind(config["circuit"]["kind"]).gate_counts(config)
  forward = (flops.DENSE_1Q * g["dense_1q"] + flops.DIAGONAL * g["diagonal"] +
             flops.FLIP_2Q * g["flip_2q"])
  sweep = 2 * forward + flops.INNER_PRODUCT * g["parameterized"]
  terms = len(hamiltonian.chain_terms(config["target"], config["qubits"]))
  return forward + sweep + flops.TERM_PASS * terms


def step_flops(config, traffic) -> float:
  """The model's flops in one train step."""
  return float(per_amplitude(config) * 2**config["qubits"] *
               traffic["max_unique"])
