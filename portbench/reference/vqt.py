"""Reference VQT train steps (arXiv:1910.02071; the reference library's
`inference/vqt_loss.py` and its eq. A5 estimator).

A step draws the energy's samples, keeps the most frequent distinct rows
x_u with weights w_u = count_u / sum(counts), evolves U|x_u>, and takes

  f_u   = beta <H>_u - E(x_u)
  loss  = sum_u w_u f_u - log Z
  dloss/dphi   = beta sum_u w_u d<H>_u/dphi          (autograd)
  dloss/dtheta = <dE/dtheta> <f> - <f dE/dtheta>     (the score term)

with <.> the w-weighted average; E and log Z carry no further gradient.
Then one Adam step on [theta, circuit leaves].  States are simulated a
block of at most BLOCK_AMPLITUDES amplitudes at a time, each block's
backward before the next block's forward.  Following another run, each
step after the first is taken at that run's parameters (`follow`).
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench import hamiltonian
from portbench.reference import adam as adam_lib
from portbench.reference import statevector as sv

BLOCK_AMPLITUDES = 2**24


def kind(name: str):
  return importlib.import_module(f"portbench.reference.{name}")


@contextlib.contextmanager
def matmul_tf32(on: bool):
  before = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = on
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = before


def parts(config):
  """The parts whose weights a run draws (`traffic.make_weights`), in
  order: the energy, then the circuit, both the model's, their leaf
  names as their kinds give them."""
  return [(config, "energy", ""), (config, "circuit", "")]


def leaf_shapes(config):
  """[(name, shape)] of the model's parameters, the trained leaves the
  check compares: the energy's, then the circuit's, in the order the
  optimizer takes them."""
  return (kind(config["energy"]["kind"]).leaf_shapes(config) +
          kind(config["circuit"]["kind"]).leaf_shapes(config))


class Model:
  """The reference model of a configuration, in one float dtype."""

  def __init__(self, config, traffic, device, dtype):
    n = config["qubits"]
    self.config = config
    self.traffic = traffic
    self.device = torch.device(device)
    self.space = sv.Space(n, dtype, device)
    self.terms = hamiltonian.chain_terms(config["target"], n)
    self.observable = sv.Observable(self.space, self.terms)
    self.energy = kind(config["energy"]["kind"])
    self.circuit = kind(config["circuit"]["kind"])
    self.block = max(1, BLOCK_AMPLITUDES >> n)

  def step(self, params: Dict[str, torch.Tensor], state: torch.Tensor):
    """(loss, [grad of each leaf]) of one step from generator `state`."""
    t = self.traffic
    theta = params["theta"]
    bits = self.energy.sample(theta, state, t["samples"], self.device)
    rows, counts = self.energy.top_unique(bits, t["max_unique"])
    w = torch.as_tensor(counts / counts.sum(), dtype=self.space.dtype,
                        device=self.device)
    circuit_leaves = [params[name] for name, _ in
                      self.circuit.leaf_shapes(self.config)]
    for p in circuit_leaves:
      p.grad = None
    h = []
    for lo in range(0, len(rows), self.block):
      psi = self.space.basis_states(rows[lo:lo + self.block])
      ops = self.circuit.circuit(self.space, self.config, params, self.terms)
      values = self.observable.expectation(sv.run(psi, ops, self.space))
      (t["beta"] * (w[lo:lo + self.block] * values).sum()).backward()
      h.append(values.detach())
    with torch.no_grad():
      f = t["beta"] * torch.cat(h) - self.energy.energy(theta, rows)
      loss = w @ f - self.energy.log_partition(theta)
      jac = self.energy.jacobian(theta, rows)
      g_theta = (w @ jac) * (w @ f) - (w * f) @ jac
    return float(loss), [g_theta] + [p.grad for p in circuit_leaves]


def follow(config, traffic, weights: Dict[str, np.ndarray],
           states: Sequence[torch.Tensor], device, dtype=torch.float64,
           tf32: bool = False, points=None) -> dict:
  """The reference's steps from the initial `weights`, one a generator
  state: {"losses": [...], "grad1": the first step's gradient, "params":
  the parameters after its own Adam steps (flat over the leaves in order,
  float64 numpy), "points": the parameters each step was taken at}.

  With `points` (the parameters {name: array} before each step of the run
  it follows) every step after the first is evaluated at the followed
  run's point instead of its own, while its own Adam still moves from
  `weights` by its own gradients: Adam moves a parameter whose gradient is
  nought by the sign of its round-off, and the next draws depend on the
  energy's parameters, so two sound runs part after one step."""
  with matmul_tf32(tf32):
    model = Model(config, traffic, device, dtype)
    names = [name for name, _ in leaf_shapes(config)]
    own = {name: torch.tensor(weights[name], dtype=dtype, device=device)
           for name in names}
    opt = adam_lib.Adam([own[name] for name in names],
                        traffic["adam_lr"])
    losses: List[float] = []
    taken = []
    grad1 = None
    for k, state in enumerate(states):
      at = own if points is None or k == 0 else {
          name: torch.as_tensor(points[k][name]) for name in names}
      params = {name: at[name].detach().to(device, dtype).clone()
                .requires_grad_(True) for name in names}
      taken.append({name: params[name].detach().double().cpu().numpy()
                    for name in names})
      loss, grads = model.step(params, state)
      losses.append(loss)
      if grad1 is None:
        grad1 = flat(grads)
      opt.step(grads)
    return {"losses": losses, "grad1": grad1,
            "params": flat([own[name] for name in names]), "points": taken}


def flat(tensors) -> np.ndarray:
  return np.concatenate([t.detach().double().cpu().numpy().reshape(-1)
                         for t in tensors])
