"""Exact density-matrix math and its rendering on the host, in numpy (the
port's copy of `baselines/utils.py`, which imports jax).

Every function works from Hermitian eigendecompositions in float64
(`_eigh_host`), as the reference's do (`baselines/utils.py:24-96`): the
thermal state, log Z, the matrix log of a PSD matrix and the relative
entropy.  They are metrics, never differentiated.
"""

from __future__ import annotations

import numpy as np


def _eigh_host(mat):
  """Hermitian eigendecomposition on the host in complex128: (eigenvalues
  ascending, eigenvectors as columns)."""
  return np.linalg.eigh(np.asarray(mat, np.complex128))


def _logm_psd(mat) -> np.ndarray:
  """Matrix log of a Hermitian PSD matrix from its eigendecomposition, the
  eigenvalues clipped at 1e-300 (reference `baselines/utils.py:34`)."""
  evals, evecs = _eigh_host(mat)
  log_evals = np.log(np.maximum(np.real(evals), 1e-300))
  return (evecs * log_evals.astype(np.complex128)) @ np.conj(evecs.T)


def optimized_trace_matmul(rho, sigma) -> complex:
  """tr[rho @ sigma] without forming the product: sum_ij rho_ij
  sigma_ji."""
  return np.sum(np.asarray(rho, np.complex128) *
                np.asarray(sigma, np.complex128).T)


def relative_entropy(rho, sigma) -> float:
  """D(rho || sigma) = tr[rho (log rho - log sigma)]."""
  log_rho = _logm_psd(rho)
  log_sigma = _logm_psd(sigma)
  return float(np.real(optimized_trace_matmul(rho, log_rho - log_sigma)))


def get_thermal_state(beta, h_num) -> np.ndarray:
  """exp(-beta h) / Z as a complex128 [2^n, 2^n] matrix: a softmax over
  -beta * the eigenvalues, in h's eigenbasis."""
  evals, evecs = _eigh_host(h_num)
  x = -float(beta) * np.real(evals)
  weights = np.exp(x - np.max(x))
  probs = (weights / np.sum(weights)).astype(np.complex128)
  return (evecs * probs) @ np.conj(evecs.T)


def log_partition_function(beta, h_num) -> float:
  """ln tr[exp(-beta h)], by a log-sum-exp over -beta * the eigenvalues."""
  evals, _ = _eigh_host(h_num)
  x = -float(beta) * np.real(evals)
  m = np.max(x)
  return float(m + np.log(np.sum(np.exp(x - m))))


def density_matrix_to_image(dm) -> np.ndarray:
  """A density matrix as a float32 [1, 512, 512, 3] RGB image: |Re| in the
  red channel, |Im| in the blue, both over their joint maximum, each entry
  a square of 512 / 2^n pixels; above 9 qubits one pixel an entry
  (reference `baselines/utils.py:75`)."""
  total_edge = 2**9
  dm = np.asarray(dm)
  dm_len = dm.shape[0]
  scale = max(1, total_edge // dm_len)
  edge = dm_len * scale
  dm_real = np.abs(np.real(dm))
  dm_imag = np.abs(np.imag(dm))
  max_dm = max(dm_real.max(), dm_imag.max(), 1e-30)
  block = np.ones((scale, scale), np.float32)
  dm_real = np.kron(dm_real / max_dm, block).astype(np.float32)
  dm_imag = np.kron(dm_imag / max_dm, block).astype(np.float32)
  zeros = np.zeros((edge, edge), np.float32)
  return np.stack([dm_real, zeros, dm_imag], axis=-1)[None]
