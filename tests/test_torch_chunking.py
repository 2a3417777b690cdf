"""Batch chunking with forward recompute in the port's
`adjoint.batched_expectations`, against one chunk and against the JAX
package's `batched_expectations(batch_chunk=...)`.

9 qubits (two row qubits), a 2-layer hardware-efficient ansatz, B = 7
bitstrings (chunks of 3 leave a short last chunk), the TFIM and the
Heisenberg chain (whose lambda takes the mixed tier) as observables.
Values and gradients (symbols and coefficients): every chunk size, psi kept
or recomputed, within 1e-6 relative L2 of one chunk; against JAX within
1e-5 (float32 on both sides, different contraction orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qhbmlib_tpu.models import circuit_utils as jcu
from qhbmlib_tpu.ops import adjoint as jadjoint
from qhbmlib_tpu.ops import paulis as jp
from qhbmlib_tpu_torch.benchmarks import ladder as tladder
from qhbmlib_tpu_torch.models import circuit_utils as tcu
from qhbmlib_tpu_torch.ops import adjoint as tadjoint
from qhbmlib_tpu_torch.ops import paulis as tp

torch.set_num_threads(1)

N = 9
BATCH = 7
SAME_TOL = 1e-6
JAX_TOL = 1e-5


def _inputs():
  rng = np.random.RandomState(4)
  pqc = tcu.hardware_efficient_ansatz(N, 2)
  values = rng.uniform(0, 2, pqc.num_symbols).astype(np.float32)
  bits = rng.randint(0, 2, size=(BATCH, N)).astype(np.int8)
  weights = rng.normal(size=(BATCH, 2)).astype(np.float32)
  return pqc, values, bits, weights


def _port(batch_chunk):
  """(values [B, 2], grad of symbols, grads of both ops' coefficients)."""
  pqc, values, bits, weights = _inputs()
  v = torch.tensor(values, requires_grad=True)
  ops = (tp.tfim_1d(N, device="cpu"), tladder.heisenberg(N, device="cpu"))
  for op in ops:
    op.coeffs.requires_grad_(True)
  out = tadjoint.batched_expectations(pqc, v, torch.tensor(bits), ops,
                                      batch_chunk=batch_chunk)
  (out * torch.tensor(weights)).sum().backward()
  return ([out.detach().numpy(), v.grad.numpy()] +
          [op.coeffs.grad.numpy() for op in ops])


def _rel(a, b):
  return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("store", [True, False])
@pytest.mark.parametrize("batch_chunk", [1, 3, BATCH])
def test_chunks_match_one_chunk(batch_chunk, store, monkeypatch):
  """psi kept (the default budget) or recomputed in the backward (the
  residual budget set to 0): values and gradients as one stored chunk."""
  want = _port(BATCH)
  assert tadjoint.last_plan["store_psi"]
  if not store:
    monkeypatch.setattr(tadjoint, "PSI_RESIDUAL_SHARE", 0.0)
  got = _port(batch_chunk)
  assert tadjoint.last_plan["chunk"] == batch_chunk
  assert tadjoint.last_plan["store_psi"] == store
  for g, w in zip(got, want):
    assert _rel(g, w) <= SAME_TOL


@pytest.mark.parametrize("batch_chunk", [1, 3, BATCH])
def test_chunks_match_jax(batch_chunk, monkeypatch):
  """The port (psi recomputed) against JAX's chunked scan."""
  monkeypatch.setattr(tadjoint, "PSI_RESIDUAL_SHARE", 0.0)
  got = _port(batch_chunk)
  _, values, bits, weights = _inputs()
  jpqc = jcu.hardware_efficient_ansatz(N, 2)
  heis = [(1.0, {q: p, q + 1: p}) for q in range(N - 1) for p in "XYZ"]
  codes = [jp.tfim_1d(N), jp.pauli_sum_from_strings(N, heis)]

  def fn(v, coeffs):
    ops = tuple(jp.PauliSum(c.codes, co, N) for c, co in zip(codes, coeffs))
    out = jadjoint.batched_expectations(jpqc, v, jnp.asarray(bits), ops,
                                        batch_chunk=batch_chunk)
    return jnp.sum(out * weights), out

  (_, out), (g_v, g_c) = jax.value_and_grad(fn, argnums=(0, 1),
                                            has_aux=True)(
      jnp.asarray(values), [jnp.asarray(c.coeffs) for c in codes])
  for g, w in zip(got, [out, g_v] + list(g_c)):
    assert _rel(g, np.real(np.asarray(w))) <= JAX_TOL


def test_auto_rule():
  """One chunk with psi kept at the bench's 24q B = 8 and 20q B = 64 on
  the card's ~75 GB free; at r5's 28q B = 4 psi kept, one state a chunk;
  the residual dropped once the batch's states pass PSI_RESIDUAL_SHARE."""
  free = 75 << 30
  for n, batch in ((24, 8), (20, 64)):
    assert tadjoint.store_psi(n, batch, free)
    assert tadjoint.auto_chunk(n, batch, free, True) == batch
  assert tadjoint.store_psi(28, 4, free)
  assert tadjoint.auto_chunk(28, 4, free, True) == 1
  assert not tadjoint.store_psi(28, 16, free)
  assert tadjoint.auto_chunk(28, 16, free, False) == 1
  assert tadjoint.auto_chunk(26, 4, free, True) == 4
  assert tadjoint.auto_chunk(30, 4, 1 << 30, False) == 1
  pqc, values, bits, _ = _inputs()
  tadjoint.batched_expectations(pqc, torch.tensor(values), torch.tensor(bits),
                                (tp.tfim_1d(N, device="cpu"),))
  assert tadjoint.last_plan == {
      "batch": BATCH, "chunk": BATCH, "store_psi": True,
      "free_bytes": tadjoint.HOST_FREE_BYTES}
