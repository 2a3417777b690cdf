"""The batched sweep stops at its last reduction (`hopper_adjoint.trim_tail`),
on the CPU through the kernels' plain versions.

`adjoint_sweep_batched` returns only the gradient, so it drops the stages
past the last one that feeds the gradient and that stage's un-apply of a
and lambda.  Its gradient is held `torch.equal` to the full sweep's
(`prepare_backward` as the sharded sweep calls it, `sweep_stages`,
`_assemble_grads`) on circuits whose sweep ends on each kind of stage; the
un-apply passes it drops are counted; the span "qhbm.adjoint.trim_tail"
fires once a trimmed sweep and never for one with nothing to drop; the
sharded sweep, which carries a and lambda on, keeps every stage."""

import pytest
import torch

from qhbmlib_tpu_torch import tracing
from qhbmlib_tpu_torch.models import circuit_utils as tcu
from qhbmlib_tpu_torch.ops import circuit_ir as ir
from qhbmlib_tpu_torch.ops import hopper_adjoint
from qhbmlib_tpu_torch.ops import hopper_sv
from qhbmlib_tpu_torch.ops import statevector as sv
from qhbmlib_tpu_torch.parallel import mesh as mesh_lib
from qhbmlib_tpu_torch.parallel import sharded_sv

torch.set_num_threads(1)

N, BATCH = 9, 2  # two row blocks' worth of rows and a full minor block
X, Z = 1, 3  # PROT Pauli codes


def _rx_layer(b, name):
  for q in range(N):
    b.rx(q, f"{name}_{q}")


def _cz_chain(b, name=None):
  for q in range(N - 1):
    b.cz(q, q + 1, None if name is None else f"{name}_{q}")


def _free_1q_first():
  """A symbol-free 1q segment first: its stage is dropped whole, and the
  symbolic diagonal stage before it in the sweep loses its rotation."""
  b = ir.CircuitBuilder(N)
  for q in range(N):
    b.h(q)
  _cz_chain(b, "c")
  _rx_layer(b, "x")
  return b.build()


def _diag_first():
  b = ir.CircuitBuilder(N)
  _cz_chain(b, "c")
  b.prot([0, 4, 8], [Z, Z, Z], "zzz")
  _rx_layer(b, "x")
  return b.build()


def _fixed_diag_first():
  b = ir.CircuitBuilder(N)
  _cz_chain(b)
  _rx_layer(b, "x")
  return b.build()


def _flip_first(symbol):
  b = ir.CircuitBuilder(N)
  if symbol:
    b.prot([1, 6], [X, X], "xx")
  else:
    b.cnot(1, 6)
  return b.build().append(tcu.hardware_efficient_ansatz(N, 1))


def _no_symbols():
  b = ir.CircuitBuilder(N)
  for q in range(N):
    b.h(q)
  _cz_chain(b)
  b.cnot(0, 5)
  return b.build()


def _qmhl():
  """The QMHL step's composite: the data's ansatz under its own prefix,
  then the model's ansatz inverted."""
  return tcu.hardware_efficient_ansatz(N, 1, name="data_p").append(
      tcu.hardware_efficient_ansatz(N, 2).inverse())


# name -> (circuit, whether the trimmed sweep drops anything)
CIRCUITS = {
    "hea2": (lambda: tcu.hardware_efficient_ansatz(N, 2), True),
    "qmhl": (_qmhl, True),
    "free_1q_first": (_free_1q_first, True),
    "diag_first": (_diag_first, True),
    "fixed_diag_first": (_fixed_diag_first, True),
    "flip_with_symbol_first": (lambda: _flip_first(True), False),
    "flip_without_symbol_first": (lambda: _flip_first(False), True),
    "no_symbols": (_no_symbols, True),
}


def _values(circuit, seed=3):
  gen = torch.Generator().manual_seed(seed)
  return torch.rand(circuit.num_symbols, generator=gen) * 2 - 1


def _planes(seed):
  gen = torch.Generator().manual_seed(seed)
  shape = (BATCH,) + sv.state_shape(N)
  return tuple(torch.randn(shape, generator=gen) for _ in range(2))


def _full_sweep(circuit, values, a, lm):
  """The untrimmed sweep's (gradient, final a, final lambda), as the sharded
  sweep runs a local part."""
  stages, plan = hopper_adjoint.prepare_backward(circuit, values, "cpu")
  a, lm = ([t.clone() for t in p] for p in (a, lm))
  a, lm, red = hopper_adjoint.sweep_stages(stages, a, lm, plain=True)
  outputs = []
  if red:
    flat = torch.cat([t.reshape(-1) for t in red])
    outputs = hopper_adjoint._grads_from_flat(
        flat, [tuple(t.shape) for t in red])
  grad = hopper_adjoint._assemble_grads(plan, outputs, circuit.num_symbols)
  return grad, a, lm


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_trimmed_gradient_equals_the_full_sweep(name):
  circuit = CIRCUITS[name][0]()
  values = _values(circuit)
  psi, lam = _planes(1), _planes(2)
  want, _, _ = _full_sweep(circuit, values, psi, lam)
  got = hopper_adjoint.adjoint_sweep_batched(circuit, values, psi, lam,
                                             plain=True)
  assert torch.equal(got, want)
  if circuit.num_symbols:
    assert want.abs().max() > 1e-3  # a gradient worth comparing
  else:
    assert got.shape == (0,)


def _layout(plan):
  """The assembly plan without its 2x2 matrices: each entry's kind and
  what it reads (gradient qubits and slots, gates, flip slot)."""
  out = []
  for kind, info in plan:
    info = dict(info)
    if kind == "1q":
      info["mg_entries"] = [(q, slot, coeff)
                            for q, slot, coeff, _ in info["mg_entries"]]
    out.append((kind, info))
  return out


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_trim_keeps_the_feeding_stages_and_drops_the_tail(name):
  """The trimmed stages are the full ones up to the last stage that feeds
  the gradient, that stage without its un-apply (a flip gate with a symbol
  whole), and nothing after it."""
  circuit = CIRCUITS[name][0]()
  values = _values(circuit)
  full, full_plan = hopper_adjoint.prepare_backward(circuit, values, "cpu")
  got, plan = hopper_adjoint.prepare_backward(circuit, values, "cpu",
                                              keep_states=False)
  feeding = [i for i, (st, info) in enumerate(zip(full, full_plan))
             if (st[0] == "bwd1q" and st[1]) or
             (st[0] == "bwddiag" and info[1]["grad_gates"]) or
             (st[0] == "bwddense" and st[2] is not None)]
  keep = feeding[-1] + 1 if feeding else 0
  assert len(got) == len(plan) == keep
  assert _layout(plan) == _layout(full_plan[:keep])
  assert [st[:2] for st in got] == [st[:2] for st in full[:keep]]
  if keep:
    last = got[-1]
    if last[0] == "bwd1q":
      assert last[2] == [] and full[keep - 1][2]
    elif last[0] == "bwddiag":
      assert last[3] is None and full[keep - 1][3] is not None
    else:
      assert last[2] is not None and last == full[keep - 1]
  dropped = keep < len(full) or (keep > 0 and got[-1][0] != "bwddense")
  assert dropped == CIRCUITS[name][1]


@pytest.mark.parametrize("name", ["hea2", "qmhl"])
def test_trim_drops_the_last_1q_stage_s_passes_on_both_states(name,
                                                              monkeypatch):
  """The sweep of each circuit ends on a 1q stage (the QMHL composite's is
  the data's ansatz): the trimmed sweep runs every un-apply pass of the
  full sweep but that stage's, on a and on lambda."""
  calls = []

  def counting(fn):
    def call(*args, **kwargs):
      calls.append(fn.__name__)
      return fn(*args, **kwargs)
    return call

  for fn in ("axis_apply_plain", "axis2_apply_plain"):
    monkeypatch.setattr(hopper_sv, fn, counting(getattr(hopper_sv, fn)))
  circuit = CIRCUITS[name][0]()
  values = _values(circuit)
  psi, lam = _planes(4), _planes(5)
  full, _ = hopper_adjoint.prepare_backward(circuit, values, "cpu")
  assert full[-1][0] == "bwd1q"
  _full_sweep(circuit, values, psi, lam)
  untrimmed = len(calls)
  calls.clear()
  hopper_adjoint.adjoint_sweep_batched(circuit, values, psi, lam, plain=True)
  assert untrimmed - len(calls) == 2 * len(full[-1][2]) > 0
  all_passes = sum(len(st[2]) for st in full if st[0] == "bwd1q")
  assert untrimmed == 2 * all_passes


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_trim_span_fires_once_a_trimmed_sweep(name):
  circuit = CIRCUITS[name][0]()
  values = _values(circuit)
  psi, lam = _planes(6), _planes(7)
  tracing.reset()
  with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
    for _ in range(2):
      hopper_adjoint.adjoint_sweep_batched(circuit, values, psi, lam,
                                           plain=True)
    # The sharded sweep's call keeps its states: no trim.
    hopper_adjoint.prepare_backward(circuit, values, "cpu")
  totals = tracing.totals()
  assert totals["qhbm.adjoint.prepare_backward"]["calls"] == 3
  calls = totals.get("qhbm.adjoint.trim_tail", {"calls": 0})["calls"]
  assert calls == (2 if CIRCUITS[name][1] else 0)


@pytest.mark.parametrize("name", ["hea2", "qmhl", "diag_first",
                                  "flip_without_symbol_first"])
def test_sharded_sweep_keeps_every_stage(name, monkeypatch):
  """`sharded_sv.reverse_sweep_local` on one rank: its local part's stages
  are the full reverse circuit, so a returns to the basis state it started
  from; its gradient is the full sweep's, which the trimmed sweep gives
  too."""
  circuit = CIRCUITS[name][0]()
  values = _values(circuit)
  axis = mesh_lib.Axis(mesh_lib.STATE_AXIS, 1, 0, (0,))
  bits = torch.tensor([[0, 1, 1, 0, 1, 0, 0, 1, 1],
                       [1, 0, 0, 1, 1, 1, 0, 0, 0]], dtype=torch.int8)
  start = sharded_sv.basis_state_local(N, 0, bits, 0, "cpu")
  psi = sharded_sv.apply_circuit_local(circuit, values,
                                       [t.clone() for t in start], 0, axis)
  lam = _planes(8)
  seen = []
  real_prepare = hopper_adjoint.prepare_backward
  real_sweep = hopper_adjoint.sweep_stages

  def prepare(*args, **kwargs):
    out = real_prepare(*args, **kwargs)
    seen.append(out[0])
    return out

  def sweep(*args, **kwargs):
    out = real_sweep(*args, **kwargs)
    seen.append(out[:2])
    return out

  monkeypatch.setattr(hopper_adjoint, "prepare_backward", prepare)
  monkeypatch.setattr(hopper_adjoint, "sweep_stages", sweep)
  got = sharded_sv.reverse_sweep_local(
      circuit, values, [t.clone() for t in psi], [t.clone() for t in lam], 0,
      axis)
  stages, (a, _) = seen
  assert len(stages) == len(sv.segment_circuit(circuit.gates))
  torch.testing.assert_close(a[0], start[0], atol=1e-5, rtol=0)
  torch.testing.assert_close(a[1], start[1], atol=1e-5, rtol=0)
  monkeypatch.undo()
  want, _, _ = _full_sweep(circuit, values, psi, lam)
  assert torch.equal(got, want)
  assert torch.equal(hopper_adjoint.adjoint_sweep_batched(
      circuit, values, psi, lam, plain=True), want)
