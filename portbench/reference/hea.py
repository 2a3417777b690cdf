"""Reference of the hardware-efficient ansatz (reference library
`baselines/pqc.py:21-63`): each layer X^a then Z^b on every qubit, then
CZ^c on the even bonds and then the odd bonds, every exponent a symbol.

Gates in cirq's convention with global phase: X^t = e^{i pi t/2} (cos(pi
t/2) I - i sin(pi t/2) X), Z^t = diag(1, e^{i pi t}), CZ^t = diag(1, 1, 1,
e^{i pi t}).  The circuit's one parameter vector holds a value per symbol,
symbols sorted by name (the reference library's DirectQuantumCircuit).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.reference import statevector as sv


def symbols(n: int, layers: int):
  """[(name, kind, layer, qubit)] of every symbol, sorted by name (the
  ansatz's names, prefix "p")."""
  out = []
  for layer in range(layers):
    out += [(f"p_x_{layer}_{q}", "x", layer, q) for q in range(n)]
    out += [(f"p_z_{layer}_{q}", "z", layer, q) for q in range(n)]
    out += [(f"p_cz_e_{layer}_{q}", "cz", layer, q)
            for q in range(0, n - 1, 2)]
    out += [(f"p_cz_o_{layer}_{q}", "cz", layer, q)
            for q in range(1, n - 1, 2)]
  return sorted(out)


def leaf_shapes(config) -> List[Tuple[str, Tuple[int, ...]]]:
  c = config["circuit"]
  return [("phi", (len(symbols(config["qubits"], c["layers"])),))]


def gate_counts(config) -> Dict[str, int]:
  """Gates of the circuit by class: X^t dense, Z^t and CZ^t diagonal, all
  parameterized."""
  n, layers = config["qubits"], config["circuit"]["layers"]
  return {"dense_1q": layers * n, "diagonal": layers * (2 * n - 1),
          "flip_2q": 0, "parameterized": layers * (3 * n - 1)}


def _x_power(t: torch.Tensor) -> torch.Tensor:
  c, s = torch.cos(math.pi * t / 2), torch.sin(math.pi * t / 2)
  diag = torch.complex(c * c, s * c)  # e^{i pi t/2} cos(pi t/2)
  off = torch.complex(s * s, -s * c)  # e^{i pi t/2} (-i sin(pi t/2))
  return torch.stack([diag, off, off, diag]).reshape(2, 2)


def _z_power(t: torch.Tensor) -> torch.Tensor:
  one = torch.ones_like(t)
  zero = torch.zeros_like(t)
  return torch.stack([torch.complex(one, zero), torch.complex(zero, zero),
                      torch.complex(zero, zero),
                      torch.complex(torch.cos(math.pi * t),
                                    torch.sin(math.pi * t))]).reshape(2, 2)


def circuit(space: sv.Space, config, params: Dict[str, torch.Tensor],
            terms=None):
  """The circuit's steps for `statevector.run` at the values
  params["phi"] (`terms`, the target's, is not used)."""
  del terms
  n, layers = space.n, config["circuit"]["layers"]
  phi = params["phi"]
  where = {(kind, layer, q): i
           for i, (_, kind, layer, q) in enumerate(symbols(n, layers))}
  ops = []
  for layer in range(layers):
    ops.append(("layer", {
        q: _z_power(phi[where["z", layer, q]]) @
           _x_power(phi[where["x", layer, q]]) for q in range(n)}))
    phase = 0.0
    for q in range(n - 1):
      phase = phase + (math.pi * phi[where["cz", layer, q]]) * (
          space.bit(q) * space.bit(q + 1))
    ops.append(("phase", phase))
  return ops
