"""Array-native quantum circuit IR (numpy only).

A copy of `qhbmlib_tpu/ops/circuit_ir.py`: importing the reference module
would load `qhbmlib_tpu/__init__.py` and with it jax, which the PyTorch port
must run without.  Keep the two copies identical so both packages read one
circuit description the same way.

Replaces the reference's serialized-cirq-proto circuit tensors and the TFQ C++
composition ops (`tfq.convert_to_tensor`, `tfq.append_circuit`,
`tfq.resolve_parameters`; reference: qhbmlib/models/circuit.py:63,132-136,207)
with a static, hashable gate-sequence structure:

  * every gate is a frozen record (kind, qubits, symbol slot, coeff, shift),
  * circuits compose with pure Python (`append`, `inverse`),
  * parameter binding is a traced array op
    (angle = coeff * values[slot] + shift),

so circuits can be closed over by `jit`ted simulation functions, specialize the
compiler on circuit structure, and contain no strings or dynamic shapes.

Gate parameter conventions
--------------------------

Power gates (`XP`, `YP`, `ZP`, `HP`, `CZP`, `CXP`, `XXP`, `YYP`, `ZZP`) use the
cirq exponent convention *including global phase*: ``G**t`` for involution `G`
is ``exp(i*pi*t/2) * exp(-i*pi*t/2 * G)``.  Rotation gates (`RX`, `RY`, `RZ`)
are ``exp(-i*theta/2 * P)``.  `PROT` is ``exp(-i*theta*P)`` for a multi-qubit
Pauli string `P` (used for Trotter steps / QAIA layers; replaces
`tfq.util.exponential`, reference: qhbmlib/models/circuit.py:268-269).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# Gate kind names.  Static strings keep the IR hashable.
XP, YP, ZP, HP = "xp", "yp", "zp", "hp"
RX, RY, RZ = "rx", "ry", "rz"
CZP, CXP = "czp", "cxp"
XXP, YYP, ZZP = "xxp", "yyp", "zzp"
PROT = "prot"  # exp(-i * theta * PauliString)
GPHASE = "gphase"  # global phase exp(i * theta)

ONE_QUBIT_KINDS = frozenset({XP, YP, ZP, HP, RX, RY, RZ})
TWO_QUBIT_KINDS = frozenset({CZP, CXP, XXP, YYP, ZZP})

# d(rotation angle)/d(gate parameter) for the two-eigenvalue parameter-shift
# rule: every supported gate is phase * exp(-i*phi/2*G) with G an involution,
# where phi = _ANGLE_SCALE[kind] * param.
_ANGLE_SCALE = {
    XP: np.pi, YP: np.pi, ZP: np.pi, HP: np.pi,
    CZP: np.pi, CXP: np.pi, XXP: np.pi, YYP: np.pi, ZZP: np.pi,
    RX: 1.0, RY: 1.0, RZ: 1.0,
    PROT: 2.0,
    GPHASE: 0.0,
}


@dataclasses.dataclass(frozen=True)
class Gate:
  """One gate instance inside a circuit.

  The gate's angle parameter resolves to ``coeff * symbol_values[slot] + shift``
  (``slot == -1`` means a constant gate with angle ``shift``).
  """
  kind: str
  qubits: Tuple[int, ...]
  slot: int = -1
  coeff: float = 1.0
  shift: float = 0.0
  # For PROT gates only: pauli codes aligned with `qubits` (1=X, 2=Y, 3=Z).
  paulis: Tuple[int, ...] = ()

  def __post_init__(self):
    # Validate on EVERY construction path (builder, dataclasses.replace,
    # direct Gate(...), from_dict): consumers index `paulis` positionally
    # against `qubits` (the engines zip them; the native oracle packs
    # len(qubits) slots per gate), so a mismatch silently desynchronizes
    # simulators, and a wrong arity or negative qubit would index the
    # packed C arrays out of bounds.
    if self.kind not in _ANGLE_SCALE:
      raise ValueError(f"unknown gate kind {self.kind!r}")
    if any(q < 0 for q in self.qubits):
      raise ValueError(f"gate qubits must be non-negative: {self.qubits}")
    if len(set(self.qubits)) != len(self.qubits):
      # A duplicate qubit silently overwrites its PROT pauli code slot
      # (simulating X where X*X = I was written) or crashes deep inside
      # apply_dense for power gates -- reject on every construction path,
      # not just CircuitBuilder.add.
      raise ValueError(f"gate qubits must be distinct: {self.qubits}")
    if self.kind in ONE_QUBIT_KINDS and len(self.qubits) != 1:
      raise ValueError(f"{self.kind!r} takes 1 qubit, got {self.qubits}")
    if self.kind in TWO_QUBIT_KINDS and len(self.qubits) != 2:
      raise ValueError(f"{self.kind!r} takes 2 qubits, got {self.qubits}")
    if self.kind == GPHASE and self.qubits:
      raise ValueError(f"gphase takes no qubits, got {self.qubits}")
    if self.kind == PROT:
      if len(self.paulis) != len(self.qubits):
        raise ValueError(
            f"prot gate needs one pauli code per qubit: got "
            f"{len(self.paulis)} codes for {len(self.qubits)} qubits")
      if any(int(p) not in (1, 2, 3) for p in self.paulis):
        raise ValueError(
            f"prot pauli codes must be 1=X, 2=Y, 3=Z: {self.paulis}")
    elif self.paulis:
      raise ValueError(f"paulis only apply to prot gates, not {self.kind!r}")

  def inverse(self) -> "Gate":
    """All supported gates satisfy U(angle)^-1 == U(-angle)."""
    return dataclasses.replace(self, coeff=-self.coeff, shift=-self.shift)

  @property
  def angle_scale(self) -> float:
    return _ANGLE_SCALE[self.kind]


@dataclasses.dataclass(frozen=True)
class Circuit:
  """A static gate sequence over qubits [0, num_qubits).

  Hashable so it can be a static argument of jitted simulator entry points.
  ``symbol_names`` orders the free parameters; simulation functions take a
  matching `symbol_values` array.
  """
  num_qubits: int
  gates: Tuple[Gate, ...] = ()
  symbol_names: Tuple[str, ...] = ()

  def __post_init__(self):
    # Range-check on every construction path (builder, append, inverse,
    # from_dict/from_json of hand-written data): an out-of-range qubit or
    # slot would index simulator state / packed native arrays out of
    # bounds (heap corruption in the C oracle).
    for g in self.gates:
      for q in g.qubits:
        if q >= self.num_qubits:
          raise ValueError(
              f"gate {g.kind!r} touches qubit {q} but the circuit has "
              f"{self.num_qubits} qubits")
      if g.slot >= len(self.symbol_names):
        raise ValueError(
            f"gate {g.kind!r} references symbol slot {g.slot} but only "
            f"{len(self.symbol_names)} symbols exist")

  @property
  def num_symbols(self) -> int:
    return len(self.symbol_names)

  @property
  def num_gates(self) -> int:
    return len(self.gates)

  def append(self, other: "Circuit") -> "Circuit":
    """Circuit concatenation; shared symbol names map to shared slots.

    Replaces `tfq.append_circuit` (reference: qhbmlib/models/circuit.py:136).
    """
    num_qubits = max(self.num_qubits, other.num_qubits)
    names = list(self.symbol_names)
    index: Dict[str, int] = {s: i for i, s in enumerate(names)}
    remap = {}
    for j, s in enumerate(other.symbol_names):
      if s not in index:
        index[s] = len(names)
        names.append(s)
      remap[j] = index[s]
    new_gates = list(self.gates)
    for g in other.gates:
      if g.slot >= 0:
        g = dataclasses.replace(g, slot=remap[g.slot])
      new_gates.append(g)
    return Circuit(num_qubits, tuple(new_gates), tuple(names))

  def inverse(self) -> "Circuit":
    """Reversed gate order with inverted gates; same symbols/slots.

    Replaces `circuit**-1` via cirq inversion (reference:
    qhbmlib/models/circuit.py:164-178).
    """
    return Circuit(self.num_qubits,
                   tuple(g.inverse() for g in reversed(self.gates)),
                   self.symbol_names)

  def parameterized_gate_indices(self) -> Tuple[int, ...]:
    return tuple(i for i, g in enumerate(self.gates) if g.slot >= 0)

  # -- persistence ------------------------------------------------------------
  # The reference gets circuit serialization for free from cirq protobufs
  # (reference: qhbmlib/models/circuit.py:63 `tfq.convert_to_tensor`); the
  # array-native IR round-trips through plain JSON-able dicts instead.

  def to_dict(self) -> dict:
    """JSON-able representation; exact inverse of `Circuit.from_dict`."""
    return {
        "num_qubits": self.num_qubits,
        "symbol_names": list(self.symbol_names),
        "gates": [{
            "kind": g.kind,
            "qubits": list(g.qubits),
            "slot": g.slot,
            "coeff": g.coeff,
            "shift": g.shift,
            **({"paulis": list(g.paulis)} if g.paulis else {}),
        } for g in self.gates],
    }

  @staticmethod
  def from_dict(data: dict) -> "Circuit":
    gates = tuple(
        Gate(kind=d["kind"],
             qubits=tuple(int(q) for q in d["qubits"]),
             slot=int(d.get("slot", -1)),
             coeff=float(d.get("coeff", 1.0)),
             shift=float(d.get("shift", 0.0)),
             paulis=tuple(int(p) for p in d.get("paulis", ())))
        for d in data["gates"])
    return Circuit(int(data["num_qubits"]), gates,
                   tuple(data["symbol_names"]))

  def to_json(self) -> str:
    import json
    return json.dumps(self.to_dict())

  @staticmethod
  def from_json(text: str) -> "Circuit":
    import json
    return Circuit.from_dict(json.loads(text))


class CircuitBuilder:
  """Imperative builder producing an immutable Circuit."""

  def __init__(self, num_qubits: int):
    self.num_qubits = num_qubits
    self._gates = []
    self._names = []
    self._index: Dict[str, int] = {}

  def _slot(self, symbol: Optional[str]) -> int:
    if symbol is None:
      return -1
    if symbol not in self._index:
      self._index[symbol] = len(self._names)
      self._names.append(symbol)
    return self._index[symbol]

  def add(self,
          kind: str,
          qubits: Sequence[int],
          symbol: Optional[str] = None,
          coeff: float = 1.0,
          shift: float = 0.0,
          paulis: Sequence[int] = ()) -> "CircuitBuilder":
    for q in qubits:
      if not 0 <= q < self.num_qubits:
        raise ValueError(f"qubit {q} out of range")
    if len(set(qubits)) != len(qubits):
      raise ValueError("gate qubits must be distinct")
    if symbol is None and float(coeff) not in (0.0, 1.0):
      # Constant gates resolve to angle = shift; a non-trivial coeff here
      # would be silently ignored (the gate typically simulating as
      # identity).  The convenience wrappers pass coeff=0.0 deliberately.
      raise ValueError(
          f"coeff={coeff} has no effect on a constant gate (no symbol): "
          "the angle resolves to `shift` alone -- fold the factor into "
          "`shift` or parameterize the gate with a symbol")
    # Gate.__post_init__ validates PROT pauli/qubit alignment.
    self._gates.append(
        Gate(
            kind=kind,
            qubits=tuple(int(q) for q in qubits),
            slot=self._slot(symbol),
            coeff=float(coeff),
            shift=float(shift),
            paulis=tuple(int(p) for p in paulis)))
    return self

  # Convenience wrappers -----------------------------------------------------
  def xp(self, q, symbol=None, coeff=1.0, shift=0.0):
    return self.add(XP, [q], symbol, coeff, shift)

  def yp(self, q, symbol=None, coeff=1.0, shift=0.0):
    return self.add(YP, [q], symbol, coeff, shift)

  def zp(self, q, symbol=None, coeff=1.0, shift=0.0):
    return self.add(ZP, [q], symbol, coeff, shift)

  def hp(self, q, symbol=None, coeff=1.0, shift=0.0):
    return self.add(HP, [q], symbol, coeff, shift)

  def h(self, q):
    return self.add(HP, [q], None, 0.0, 1.0)

  def rx(self, q, symbol=None, coeff=1.0, shift=0.0):
    return self.add(RX, [q], symbol, coeff, shift)

  def ry(self, q, symbol=None, coeff=1.0, shift=0.0):
    return self.add(RY, [q], symbol, coeff, shift)

  def rz(self, q, symbol=None, coeff=1.0, shift=0.0):
    return self.add(RZ, [q], symbol, coeff, shift)

  def cz(self, q0, q1, symbol=None, coeff=1.0, shift=0.0):
    if symbol is None and coeff == 1.0 and shift == 0.0:
      shift = 1.0
      coeff = 0.0
    return self.add(CZP, [q0, q1], symbol, coeff, shift)

  def cnot(self, q0, q1):
    return self.add(CXP, [q0, q1], None, 0.0, 1.0)

  def prot(self, qubits, paulis, symbol=None, coeff=1.0, shift=0.0):
    """exp(-i * angle * PauliString) on the given qubits."""
    return self.add(PROT, qubits, symbol, coeff, shift, paulis=paulis)

  def build(self) -> Circuit:
    return Circuit(self.num_qubits, tuple(self._gates), tuple(self._names))


def exp_pauli_sum(paulisum,
                  symbol: Optional[str] = None,
                  coeff: float = 1.0,
                  shift: float = 0.0,
                  builder: Optional[CircuitBuilder] = None):
  """Appends exp(-i * angle * term) for each term of `paulisum`.

  Exact when the terms commute (the Trotter/TFIM and QAIA use cases).  The
  per-term coefficient multiplies the angle.  Replaces `tfq.util.exponential`
  (reference: qhbmlib/models/circuit.py:268-269, baselines/train.py:88-89).

  Returns a built `Circuit` when `builder` is None; otherwise appends into
  the caller's builder in place and returns THAT `CircuitBuilder` (so the
  caller keeps composing / calls `.build()` itself).
  """
  b = builder or CircuitBuilder(paulisum.num_qubits)
  coeffs = np.asarray(paulisum.coeffs)
  for t in range(paulisum.num_terms):
    qubits = [q for q, c in enumerate(paulisum.codes[t]) if c != 0]
    paulis = [c for c in paulisum.codes[t] if c != 0]
    # Constant gates (no symbol) resolve to angle = shift alone, so the
    # slope must not carry the term coefficient (the builder rejects a
    # non-trivial unused coeff).
    cf = coeff * float(coeffs[t]) if symbol is not None else 0.0
    if not qubits:  # identity term: global phase exp(-i*angle*coeff_t)
      b.add(GPHASE, [], symbol, -cf, -shift * float(coeffs[t]))
      continue
    b.prot(qubits, paulis, symbol, cf, shift * float(coeffs[t]))
  return b if builder is not None else b.build()
