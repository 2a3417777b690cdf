"""The port's QMHL train step: `qmhl_loss.make_qmhl_with_state(QHBMData(the
data's QHBM), the model's QHBM)`, `.backward()`, then
`torch.optim.Adam(...).step()` on the model's parameters, the sampler's
chain carried from step to step (as the ladder's r5 rung,
`qhbmlib_tpu_torch/benchmarks/ladder.py` `_build_r5`)."""

from __future__ import annotations

import contextlib
import importlib

import torch

from qhbmlib_tpu_torch import models
from qhbmlib_tpu_torch import nn as port_nn
from qhbmlib_tpu_torch.data import qhbm_data
from qhbmlib_tpu_torch.inference import qhbm
from qhbmlib_tpu_torch.inference import qmhl_loss
from qhbmlib_tpu_torch.inference import qnn


def kind(name: str):
  return importlib.import_module(f"portbench.program.{name}")


def data_config(config):
  """The data's QHBM as a configuration of its own: config["data"]'s
  energy and circuit on the model's qubits."""
  return dict(config, **config["data"])


def data_circuit(config, device):
  """The data's circuit under its own symbol prefix, so that the composite
  circuit (the data's, then the model's inverted) keeps the two sets of
  angles apart."""
  spec = config["circuit"]
  if spec["kind"] != "hea":
    raise ValueError(f"no data circuit of kind {spec['kind']!r}")
  pqc = models.hardware_efficient_ansatz(config["qubits"], spec["layers"],
                                         name=spec["prefix"])
  return models.DirectQuantumCircuit(pqc, initializer=port_nn.Constant(0.0),
                                     device=device)


class Step:
  """One train step of the configuration under the cell's traffic;
  calling it takes the step and returns the loss (on the device).

  `weights` [(name, tensor)] hold the model's parameters ("theta", "phi":
  the optimizer's) and the data's ("data.theta", "data.phi": drawn, never
  trained); the data's draws, the chains and the Monte Carlo log Z all
  draw from `generator`.  The chains start at random bits drawn from it at
  the first call.  With `spans` set, the step's parts run inside profiler
  ranges named "qmhl.<part>"."""

  def __init__(self, config, traffic, weights, device, generator):
    energy, e_inf = kind(config["energy"]["kind"]).build(config, traffic,
                                                         device)
    circuit = kind(config["circuit"]["kind"]).build(config, energy, (),
                                                    device)
    self.model = qhbm.QHBM(e_inf, qnn.AnalyticQuantumInference(circuit))
    data = data_config(config)
    _, d_e_inf = kind(data["energy"]["kind"]).build(data, traffic, device)
    d_qhbm = qhbm.QHBM(d_e_inf, qnn.AnalyticQuantumInference(
        data_circuit(data, device)))
    self.data = qhbm_data.QHBMData(d_qhbm)
    named = dict(weights)
    self.names = ["theta", "phi"]
    self.data_params = d_qhbm.parameters()
    leaves = list(zip(self.names + ["data.theta", "data.phi"],
                      self.model.parameters() + self.data_params))
    if sorted(name for name, _ in leaves) != sorted(named):
      raise ValueError(f"the models take {[n for n, _ in leaves]}, the "
                       f"weights are {sorted(named)}")
    with torch.no_grad():
      for name, p in leaves:
        if tuple(p.shape) != tuple(named[name].shape):
          raise ValueError(f"{name}: the model's {tuple(p.shape)} does not "
                           f"take the weights' {tuple(named[name].shape)}")
        p.copy_(named[name])
    self.loss_fn = qmhl_loss.make_qmhl_with_state(self.data, self.model)
    self.opt = torch.optim.Adam(self.model.parameters(),
                                lr=traffic["adam_lr"])
    self.chains = (config["energy"]["sampler"]["chains"], config["qubits"])
    self.device = device
    self.generator = generator
    self.chain = None
    self.spans = False

  def span(self, part: str):
    return (torch.profiler.record_function(f"qmhl.{part}") if self.spans
            else contextlib.nullcontext())

  def __call__(self) -> torch.Tensor:
    with self.span("zero_grad"):
      self.opt.zero_grad(set_to_none=True)
      for p in self.data_params:  # filled by the backward, never read
        p.grad = None
    with self.span("loss"):
      if self.chain is None:
        self.chain = (torch.rand(self.chains, generator=self.generator,
                                 device=self.device) < 0.5).to(torch.int8)
      loss, (_, self.chain) = self.loss_fn(
          (self.generator, self.generator), (None, self.chain))
    with self.span("backward"):
      loss.backward()
    with self.span("adam"):
      self.opt.step()
    return loss.detach()

  def named_parameters(self):
    """{name: the parameter} of every trained leaf."""
    return dict(zip(self.names, self.model.parameters()))

  def first_gradient(self):
    """The gradient the optimizer took at its first step, from its state:
    {name: exp_avg / (1 - beta1)}."""
    beta1 = self.opt.param_groups[0]["betas"][0]
    return {name: self.opt.state[p]["exp_avg"] / (1.0 - beta1)
            for name, p in self.named_parameters().items()}
