"""The port's VQT train step: `vqt_loss.make_vqt(qhbm, target)` at the
cell's beta, `.backward()`, then `torch.optim.Adam(...).step()`."""

from __future__ import annotations

import contextlib
import importlib

import torch

from portbench import hamiltonian
from qhbmlib_tpu_torch.inference import qhbm
from qhbmlib_tpu_torch.inference import qnn
from qhbmlib_tpu_torch.inference import vqt_loss
from qhbmlib_tpu_torch.ops import paulis


def kind(name: str):
  return importlib.import_module(f"portbench.program.{name}")


class Step:
  """One train step of the configuration under the cell's traffic;
  calling it takes the step and returns the loss (on the device).

  `weights` [(name, tensor)] are the model's parameters in the
  optimizer's order (the energy's, then the circuit's), and keep their
  names here; the EBM draws from `generator`.  With `spans` set, the
  step's parts run inside profiler ranges named "vqt.<part>"."""

  def __init__(self, config, traffic, weights, device, generator):
    n = config["qubits"]
    terms = hamiltonian.chain_terms(config["target"], n)
    self.target = paulis.pauli_sum_from_strings(n, terms, device)
    shards = [paulis.pauli_sum_from_strings(n, shard, device)
              for shard in hamiltonian.letter_shards(terms)]
    energy, e_inf = kind(config["energy"]["kind"]).build(config, traffic,
                                                         device)
    circuit = kind(config["circuit"]["kind"]).build(config, energy, shards,
                                                    device)
    self.model = qhbm.QHBM(e_inf, qnn.AnalyticQuantumInference(circuit))
    params = self.model.parameters()
    if [tuple(p.shape) for p in params] != [tuple(w.shape)
                                            for _, w in weights]:
      raise ValueError("the model's parameters do not take the weights")
    with torch.no_grad():
      for p, (_, w) in zip(params, weights):
        p.copy_(w)
    self.names = [name for name, _ in weights]
    self.loss_fn = vqt_loss.make_vqt(self.model, self.target)
    self.opt = torch.optim.Adam(params, lr=traffic["adam_lr"])
    self.beta = traffic["beta"]
    self.generator = generator
    self.spans = False

  def span(self, part: str):
    return (torch.profiler.record_function(f"vqt.{part}") if self.spans
            else contextlib.nullcontext())

  def __call__(self) -> torch.Tensor:
    with self.span("zero_grad"):
      self.opt.zero_grad(set_to_none=True)
    with self.span("loss"):
      loss = self.loss_fn(self.beta, self.generator)
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
