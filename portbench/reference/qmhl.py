"""Reference QMHL train steps (arXiv:1910.02071, quantum modular
Hamiltonian learning; the reference library's `inference/qmhl_loss.py`),
the model's energy sampled by Gibbs-With-Gradients chains carried from
step to step.

The data is a fixed QHBM (a Bernoulli energy, a circuit U_d), the model a
QHBM (a KOBE energy of weights theta, a circuit U of angles phi) whose
modular Hamiltonian is K = U E U^dagger.  A step draws from one generator,
in this order: at the first step only, the chains' start; the data's
draws, kept to their most frequent distinct rows x_u, weights w_u =
count_u / sum(counts); the chains' steps, whose draws are kept the same
way to rows y_v, weights g_v; the Monte Carlo log Z's uniform bitstrings.
Then

  loss          = sum_u w_u <K>_u + log Z
  dloss/dphi    = sum_u w_u d<K>_u/dphi                     (autograd)
  dloss/dtheta  = sum_u w_u m_u - sum_v g_v par(y_v)         (eq. C2)

with <K>_u = sum_t theta_t m_u,t, m_u,t = <Z_{c_t}> in U^dagger U_d |x_u>
(the data's circuit, then the model's inverted), and par(y) the terms'
parities; the Monte Carlo log Z carries no further gradient.  Then one
Adam step on [theta, phi]; the data's parameters are not trained.

One state is simulated at a time, its backward before the next state's
forward.  The model's circuit is the hardware-efficient ansatz; its
inverse's one-qubit matrices and phases are leaves of the states'
graphs, and the angles' gradient is taken from the leaves' at the end of
the step, so that no graph holds a state-sized tensor for each angle.
Following another run, each step after the first is taken at that run's
parameters (`follow`); the chain is the reference's own from the start it
draws.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import adam as adam_lib
from portbench.reference import bernoulli
from portbench.reference import hea
from portbench.reference import kobe
from portbench.reference import statevector as sv
from portbench.reference import vqt as reference_vqt


def kind(name: str):
  return importlib.import_module(f"portbench.reference.{name}")


def data_config(config):
  """The data's QHBM as a configuration of its own: config["data"]'s
  energy and circuit on the model's qubits."""
  return dict(config, **config["data"])


def parts(config):
  """The parts whose weights a run draws (`traffic.make_weights`), in
  order: the model's energy and circuit, then the data's, under the
  prefix "data."."""
  data = data_config(config)
  return [(config, "energy", ""), (config, "circuit", ""),
          (data, "energy", "data."), (data, "circuit", "data.")]


def leaf_shapes(config):
  """[(name, shape)] of the model's parameters, the trained leaves the
  check compares: the energy's, then the circuit's."""
  return (kind(config["energy"]["kind"]).leaf_shapes(config) +
          kind(config["circuit"]["kind"]).leaf_shapes(config))


def draw_bernoulli(theta: torch.Tensor, gen: torch.Generator,
                   count: int) -> np.ndarray:
  """[count, n] bits of the Bernoulli energy `theta` from `gen`, drawn as
  `bernoulli.sample` draws them."""
  p_one = torch.sigmoid(2.0 * theta.detach().to(torch.float32))
  u = torch.rand((count, theta.shape[0]), generator=gen, device=gen.device)
  return (u < p_one).to(torch.int64).cpu().numpy()


def _both(grid: torch.Tensor, q: int) -> torch.Tensor:
  """The entries of [2^n] `grid` whose qubits q and q + 1 are both 1."""
  return grid.view(2**q, 2, 2, -1)[:, 1, 1, :]


class InverseHEA:
  """U(phi)^dagger of the hardware-efficient ansatz as `statevector.run`
  steps, its last layer first: the layer's CZ phases negated, then each
  qubit's one-qubit matrix's dagger.  The matrices and the phases are
  leaves; after the states' backwards, `gradient()` takes the angles'
  gradient from theirs."""

  def __init__(self, space: sv.Space, config, phi: torch.Tensor):
    n, layers = space.n, config["circuit"]["layers"]
    self.n, self.layers, self.phi = n, layers, phi
    self.where = {(k, layer, q): i for i, (_, k, layer, q) in
                  enumerate(hea.symbols(n, layers))}
    at = lambda k, layer, q: phi[self.where[k, layer, q]]
    angles = phi.detach().cpu().numpy()
    with torch.enable_grad():
      self.mats = [{q: (hea._z_power(at("z", layer, q)) @
                        hea._x_power(at("x", layer, q))).conj().T
                    for q in range(n)} for layer in range(layers)]
    self.mat_leaves = [{q: m.detach().requires_grad_(True)
                        for q, m in mats.items()} for mats in self.mats]
    self.phase_leaves = []
    with torch.no_grad():
      for layer in range(layers):
        phase = torch.zeros(2**n, dtype=space.dtype, device=space.device)
        for q in range(n - 1):
          _both(phase, q).add_(-math.pi * angles[self.where["cz", layer, q]])
        self.phase_leaves.append(phase.requires_grad_(True))

  def ops(self):
    out = []
    for layer in reversed(range(self.layers)):
      out += [("phase", self.phase_leaves[layer]),
              ("layer", self.mat_leaves[layer])]
    return out

  def gradient(self) -> torch.Tensor:
    """d(what the states' backwards differentiated)/dphi."""
    mats = [m for layer in self.mats for m in layer.values()]
    grads = [m.grad for layer in self.mat_leaves for m in layer.values()]
    (out,) = torch.autograd.grad(mats, self.phi, grads)
    out = out.clone()
    for layer, leaf in enumerate(self.phase_leaves):
      for q in range(self.n - 1):
        # The negated phase holds -pi phi_cz on these entries.
        out[self.where["cz", layer, q]] -= math.pi * _both(leaf.grad, q).sum()
    return out


class Model:
  """The reference model of a configuration, in one float dtype, with the
  data's weights fixed."""

  def __init__(self, config, traffic, weights: Dict[str, np.ndarray],
               device, dtype):
    data = data_config(config)
    found = (config["energy"]["kind"], config["circuit"]["kind"],
             data["energy"]["kind"], data["circuit"]["kind"])
    if found != ("kobe", "hea", "bernoulli", "hea"):
      raise ValueError(f"no QMHL reference of the kinds {found}")
    self.config = config
    self.traffic = traffic
    self.device = torch.device(device)
    self.space = sv.Space(config["qubits"], dtype, device)
    self.order = config["energy"]["order"]
    self.chains = config["energy"]["sampler"]["chains"]
    self.data_theta = torch.as_tensor(weights["data.theta"],
                                      device=self.device)
    with torch.no_grad():
      self.data_ops = hea.circuit(self.space, data, {
          "phi": torch.as_tensor(weights["data.phi"], dtype=dtype,
                                 device=self.device)})

  def step(self, params: Dict[str, torch.Tensor], state: torch.Tensor,
           chain=None):
    """(loss, [grad of each leaf], the chain after the step) of one step
    from generator `state`, the chain from `chain` (None: from the start
    it draws)."""
    t, n, space = self.traffic, self.space.n, self.space
    theta, phi = params["theta"], params["phi"]
    gen = torch.Generator(device=self.device)
    gen.set_state(state)
    if chain is None:
      chain = kobe.chain_start(self.chains, n, gen)
    rows, counts = bernoulli.top_unique(
        draw_bernoulli(self.data_theta, gen, t["samples"]), t["max_unique"])
    steps = -(-t["samples"] // self.chains)
    drawn, chain = kobe.run_chains(theta, chain, steps, gen)
    support, chain_counts = bernoulli.top_unique(drawn[:t["samples"]],
                                                 t["max_unique"])
    log_z = kobe.mc_log_partition(theta.detach(), gen, t["samples"], n)
    w = torch.as_tensor(counts / counts.sum(), dtype=space.dtype,
                        device=self.device)
    g = torch.as_tensor(chain_counts / chain_counts.sum(),
                        dtype=space.dtype, device=self.device)
    with torch.no_grad():
      diag = kobe.diagonal(theta.detach(), n)
    inverse = InverseHEA(space, self.config, phi)
    values, terms = [], []
    for u in range(len(rows)):
      with torch.no_grad():
        psi = sv.run(space.basis_states(rows[u:u + 1]), self.data_ops,
                     space)
      out = sv.run(psi, inverse.ops(), space)
      probs = out[0, 0]**2 + out[0, 1]**2
      with torch.no_grad():
        terms.append(kobe.expectations(probs.detach(), self.order))
      value = probs @ diag
      (w[u] * value).backward()
      values.append(value.detach())
      del psi, out, probs, value
    with torch.no_grad():
      loss = w @ torch.stack(values) + log_z
      g_theta = (w @ torch.stack(terms) -
                 g @ kobe.jacobian(theta.detach(), support))
    return float(loss), [g_theta, inverse.gradient()], chain


def follow(config, traffic, weights: Dict[str, np.ndarray],
           states: Sequence[torch.Tensor], device, dtype=torch.float64,
           tf32: bool = False, points=None) -> dict:
  """The reference's steps from the initial `weights`, one a generator
  state, as `reference.vqt.follow` takes them (with `points`, every step
  after the first at the followed run's parameters), the chain carried
  from each step to the next."""
  with reference_vqt.matmul_tf32(tf32):
    model = Model(config, traffic, weights, device, dtype)
    names = [name for name, _ in leaf_shapes(config)]
    own = {name: torch.tensor(weights[name], dtype=dtype, device=device)
           for name in names}
    opt = adam_lib.Adam([own[name] for name in names], traffic["adam_lr"])
    losses: List[float] = []
    taken, grad1, chain = [], None, None
    for k, state in enumerate(states):
      at = own if points is None or k == 0 else {
          name: torch.as_tensor(points[k][name]) for name in names}
      params = {name: at[name].detach().to(device, dtype).clone()
                .requires_grad_(True) for name in names}
      taken.append({name: params[name].detach().double().cpu().numpy()
                    for name in names})
      loss, grads, chain = model.step(params, state, chain)
      losses.append(loss)
      if grad1 is None:
        grad1 = reference_vqt.flat(grads)
      opt.step(grads)
    return {"losses": losses, "grad1": grad1,
            "params": reference_vqt.flat([own[name] for name in names]),
            "points": taken}
