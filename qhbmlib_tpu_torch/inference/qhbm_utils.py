"""Metrics on Hamiltonian models: density matrix and fidelity (port of
`qhbmlib_tpu/inference/qhbm_utils.py`).

The complex64 products run on the model's device; the fidelity's
eigendecomposition runs on the host in float64, as the reference's does.
"""

from __future__ import annotations

import numpy as np
import torch

from qhbmlib_tpu_torch.inference import ebm_utils
from qhbmlib_tpu_torch.inference import qnn_utils
from qhbmlib_tpu_torch.models import hamiltonian as hamiltonian_model


def _spectrum(model: hamiltonian_model.Hamiltonian):
  """(probabilities as complex64 [2^n], U [2^n, 2^n]) without gradients."""
  with torch.no_grad():
    probs = ebm_utils.probabilities(model.energy).to(torch.complex64)
    return probs, qnn_utils.unitary(model.circuit)


def density_matrix(model: hamiltonian_model.Hamiltonian) -> np.ndarray:
  """The thermal state rho = U diag(p) U^dagger of a modular Hamiltonian,
  as a complex128 host array."""
  probs, u = _spectrum(model)
  rho = torch.einsum("k,ik,jk->ij", probs, u, u.conj())
  return rho.cpu().numpy().astype(np.complex128)


def fidelity(model: hamiltonian_model.Hamiltonian, sigma) -> float:
  """F(rho, sigma) = (tr sqrt(sqrt(rho) sigma sqrt(rho)))^2, from the
  eigenvalues of sqrt(p) U^dagger sigma U sqrt(p) (reference
  qhbm_utils.py:62-116); `sigma` is a host array."""
  probs, u = _spectrum(model)
  sig = torch.as_tensor(np.asarray(sigma, np.complex64), device=u.device)
  sqrt_k = torch.sqrt(probs)
  omega = torch.einsum("a,ba,bc,cd,d->ad", sqrt_k, u.conj(), sig, u, sqrt_k)
  eig = np.linalg.eigvalsh(omega.cpu().numpy().astype(np.complex128))
  return float(np.sum(np.sqrt(np.maximum(np.real(eig), 0.0)))**2)
