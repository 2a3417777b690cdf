"""A cell of another loss needs new files alone.

A stand-in loss, registered inside this test only (its program, reference
and count modules, a configuration with no "target" and one drawn part
besides the model's energy and circuit, and the cell's files under
`tmp_path`), runs through `harness.measure` on the CPU.  And the two
cells' weights come out as they did when the harness drew the energy's
and the circuit's leaves alone."""

import contextlib
import json
import math
import sys
import time
import types

import numpy as np
import pytest
import torch

from portbench import compare
from portbench import harness
from portbench import registry
from portbench import roofline
from portbench import traffic
from portbench.reference import adam as adam_lib
from portbench.reference import bernoulli
from portbench.reference import vqt as reference_vqt

CPU = torch.device("cpu")
LOSS = "standin"
CELL = "standin5-s64"
CONFIG = {
    "name": "standin5",
    "qubits": 5,
    "energy": {"kind": "bernoulli", "init": {"uniform": [-0.05, 0.05]}},
    "circuit": {"kind": "hea", "layers": 1, "init": {"uniform": [0.0, 2.0]}},
    "data": {"energy": {"kind": "bernoulli", "init": {"normal": [0.0, 0.3]}}},
    "precision": {"dtype": "float32", "tf32": False},
}
WORKLOAD = {
    "name": CELL,
    "config": "standin5",
    "traffic": {"name": "standin-s64", "loss": LOSS, "samples": 64,
                "adam_lr": 0.01, "trace_steps": 1},
    "limits": {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4},
}
BENCH = {
    "configs": [{"name": "standin5", "file": "portbench/configs/standin5.json"}],
    "workloads": [{"name": CELL, "config": "standin5",
                   "traffic": "standin-s64", "chips": 1}],
    "end_to_end": [{"name": "steps_per_s", "unit": "steps/s"},
                   {"name": "setup_s", "unit": "s"}],
    "per_layer": [{"name": "step_mfu_pct", "unit": "%"},
                  {"name": "device_idle_pct", "unit": "%"}],
}


def standin_loss(theta, phi, bits):
  """The cross-entropy of the Bernoulli energy `theta` on the data's draws
  `bits` (up to a constant), and a term of the circuit's `phi`."""
  spins = 1.0 - 2.0 * bits.to(theta.dtype)
  return ((spins @ theta).mean() + torch.logaddexp(theta, -theta).sum() +
          (1.0 - torch.cos(math.pi * phi)).mean())


class StandInStep:
  """The stand-in's train step (float32, torch's Adam): the draws come from
  the data's energy, which is drawn and never trained."""

  def __init__(self, config, traffic_, weights, device, generator):
    named = dict(weights)
    self.data = named.pop("data.theta")
    self.params = {name: w.clone().requires_grad_(True)
                   for name, w in named.items()}
    self.opt = torch.optim.Adam(list(self.params.values()),
                                lr=traffic_["adam_lr"])
    self.samples = traffic_["samples"]
    self.generator = generator
    self.spans = False

  def span(self, part):
    return (torch.profiler.record_function(f"{LOSS}.{part}") if self.spans
            else contextlib.nullcontext())

  def __call__(self):
    with self.span("step"):
      with self.span("loss"):
        self.opt.zero_grad(set_to_none=True)
        u = torch.rand((self.samples, self.data.shape[0]),
                       generator=self.generator, device=self.data.device)
        loss = standin_loss(self.params["theta"], self.params["phi"],
                            u < torch.sigmoid(2.0 * self.data))
      with self.span("backward"):
        loss.backward()
      with self.span("adam"):
        self.opt.step()
    return loss.detach()

  def named_parameters(self):
    return dict(self.params)

  def first_gradient(self):
    beta1 = self.opt.param_groups[0]["betas"][0]
    return {name: self.opt.state[p]["exp_avg"] / (1.0 - beta1)
            for name, p in self.params.items()}


def parts(config):
  data = dict(config, **config["data"])
  return reference_vqt.parts(config) + [(data, "energy", "data.")]


def follow(config, traffic_, weights, states, device, dtype=torch.float64,
           tf32=False, points=None):
  """The stand-in's steps in float64, as `reference.vqt.follow` takes
  them."""
  del tf32
  names = [name for name, _ in reference_vqt.leaf_shapes(config)]
  own = {name: torch.tensor(weights[name], dtype=dtype, device=device)
         for name in names}
  data = torch.as_tensor(weights["data.theta"], device=device)
  opt = adam_lib.Adam([own[name] for name in names], traffic_["adam_lr"])
  losses, taken, grad1 = [], [], None
  for k, state in enumerate(states):
    at = own if points is None or k == 0 else {
        name: torch.as_tensor(points[k][name]) for name in names}
    params = {name: at[name].detach().to(device, dtype).clone()
              .requires_grad_(True) for name in names}
    taken.append({name: params[name].detach().double().cpu().numpy()
                  for name in names})
    bits = torch.as_tensor(
        bernoulli.sample(data, state, traffic_["samples"], device))
    loss = standin_loss(params["theta"], params["phi"], bits)
    grads = list(torch.autograd.grad(loss, [params[n] for n in names]))
    losses.append(float(loss.detach()))
    if grad1 is None:
      grad1 = reference_vqt.flat(grads)
    opt.step(grads)
  return {"losses": losses, "grad1": grad1,
          "params": reference_vqt.flat([own[name] for name in names]),
          "points": taken}


def step_flops(config, traffic_):
  return 1e9 * config["qubits"] * traffic_["samples"]


def module(name, **attrs):
  out = types.ModuleType(name)
  out.__dict__.update(attrs)
  return out


@pytest.fixture
def standin(tmp_path, monkeypatch):
  """The stand-in cell, loaded from its files under `tmp_path` with its
  modules registered."""
  for kind, attrs in (
      ("program", {"Step": StandInStep}),
      ("reference", {"parts": parts, "follow": follow,
                     "leaf_shapes": reference_vqt.leaf_shapes}),
      ("counts", {"step_flops": step_flops})):
    name = f"portbench.{kind}.{LOSS}"
    monkeypatch.setitem(sys.modules, name, module(name, **attrs))
  for path, data in (("BENCHMARK.json", BENCH),
                     ("portbench/configs/standin5.json", CONFIG),
                     (f"portbench/workloads/{CELL}.json", WORKLOAD)):
    (tmp_path / path).parent.mkdir(parents=True, exist_ok=True)
    (tmp_path / path).write_text(json.dumps(data))
  return registry.load_cell(CELL, root=tmp_path)


def test_a_cell_of_another_loss_runs_from_its_own_files(standin,
                                                         monkeypatch):
  assert "target" not in standin.config
  seen = {}

  def keep(name, fn):
    def kept(*args, **kwargs):
      seen[name] = args
      out = fn(*args, **kwargs)
      seen[name + ".out"] = out
      return out
    monkeypatch.setattr(harness if name != "readings" else compare, name,
                        kept)

  keep("Context", harness.Context)
  keep("check", harness.check)
  keep("readings", compare.readings)
  torch.set_num_threads(2)
  out = harness.measure(standin, 2**31 + 99, 0.2, True, CPU,
                        time.perf_counter())

  assert out["correct"], out["checks"]
  assert out["attempted"] >= 1 and out["failed"] == 0
  # The whole step's share of the peak reads from the stand-in's count.
  ctx = seen["Context.out"]
  assert ctx.step_flops == 1e9 * 5 * 64
  assert out["metrics"]["step_mfu_pct"]["value"] == pytest.approx(
      100.0 * ctx.step_flops * len(ctx.step_s) / ctx.window_s /
      roofline.PEAK_TF32_PER_S, rel=1e-12)
  assert set(out["metrics"]) == {"step_mfu_pct"}
  # The idle gaps are labelled by the stand-in's parts.
  gaps = out["breakdown"]["idle_gaps"]
  assert gaps and all(label.startswith(f"{LOSS}.") for label, _ in gaps)
  # The reference gets every drawn leaf; only the trained ones are
  # compared.
  _, record, _, initial, _ = seen["check"]
  assert set(initial) == {"theta", "phi", "data.theta"}
  assert [set(p) for p in record["points"]] == [{"theta", "phi"}] * 3
  program, reference, start = seen["readings"]
  trained = np.concatenate([initial["theta"], initial["phi"]])
  np.testing.assert_array_equal(start, trained)
  for side in (program, reference):
    assert side["params"].shape == side["grad1"].shape == trained.shape


@pytest.mark.parametrize("seed", [5, 2**31 + 1234567])
@pytest.mark.parametrize("name", ("tfim24-vqt-u8", "heis20-qaia-u64"))
def test_the_cells_weights_are_drawn_as_before(name, seed):
  cell = registry.load_cell(name)

  def energy_then_circuit(config, seed, device):
    # The draw before the parts were the loss's, kept as it was.
    gen = torch.Generator(device=device)
    gen.manual_seed(traffic.seeds(seed)["weights"])
    out = []
    for part in ("energy", "circuit"):
      kind = reference_vqt.kind(config[part]["kind"])
      for leaf, shape in kind.leaf_shapes(config):
        out.append((leaf, traffic._draw(config[part]["init"], shape, gen)))
    return out

  got = traffic.make_weights(cell.config, cell.traffic["loss"], seed, CPU)
  want = energy_then_circuit(cell.config, seed, CPU)
  assert [n for n, _ in got] == [n for n, _ in want]
  for (_, g), (_, w) in zip(got, want):
    assert g.dtype == w.dtype == torch.float32
    assert torch.equal(g, w)
