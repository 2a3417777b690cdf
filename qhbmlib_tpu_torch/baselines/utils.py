"""Exact density-matrix math on the host, in numpy (the port's copy of the
parts of `baselines/utils.py` it needs; that module imports jax).

`get_thermal_state` and `log_partition_function` come from one Hermitian
eigendecomposition in float64 (`_eigh_host`), as in the reference
(`baselines/utils.py:24-72`).
"""

from __future__ import annotations

import numpy as np


def _eigh_host(mat):
  """Hermitian eigendecomposition on the host in complex128: (eigenvalues
  ascending, eigenvectors as columns)."""
  return np.linalg.eigh(np.asarray(mat, np.complex128))


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
