"""The comparison that decides `correct`.

Both sides take the same first train steps from the same weights and the
same generator states: the program through its timed call, the reference
in float64.  Three numbers are compared, each against the cell's limit
(`workloads/<cell>.json`, "limits"):

  loss_gap    the worst step's |loss - reference loss| / |reference loss|;
  grad_gap    the first gradient as the optimizer holds it (exp_avg / (1 -
              beta1) after one step): the worst leaf's |g - g_ref| over
              the larger of |g_ref| and the median leaf's |g_ref|, signed
              values, so a gradient of the wrong sign reads 2;
  change_gap  the parameters' change after the steps, the same way.

Each scalar parameter is a leaf: the models keep their parameters as a few
vectors, and a parameter whose gradient is nought to rounding sits inside
one (QAIA's first-layer ZZ angle acts on a basis state as a global phase).
Adam moves such a parameter by its round-off alone, so the change leaves
out every leaf whose reference gradient is under QUIET times the median
leaf's.  A missing or non-finite reading is infinite.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

NAMES = ("loss_gap", "grad_gap", "change_gap")
QUIET = 1e-3


def _worst(values: np.ndarray) -> float:
  values = np.asarray(values, dtype=np.float64)
  if values.size == 0 or not np.all(np.isfinite(values)):
    return float("inf")
  return float(values.max())


def _leaf_gap(got: Optional[np.ndarray], want: np.ndarray,
              keep: Optional[np.ndarray] = None) -> float:
  if got is None or got.shape != want.shape:
    return float("inf")
  if keep is not None:
    got, want = got[keep], want[keep]
  scale = np.maximum(np.abs(want), np.median(np.abs(want)))
  return _worst(np.abs(got - want) / scale)


def readings(program: dict, reference: dict,
             initial: np.ndarray) -> Dict[str, float]:
  """The compared numbers, and how many leaves the change left out."""
  lp = np.asarray(program["losses"], dtype=np.float64)
  lr = np.asarray(reference["losses"], dtype=np.float64)
  loss_gap = (_worst(np.abs(lp - lr) / np.abs(lr)) if lp.shape == lr.shape
              else float("inf"))
  g_ref = reference["grad1"]
  keep = np.abs(g_ref) >= QUIET * np.median(np.abs(g_ref))
  change = (None if program["params"] is None
            else program["params"] - initial)
  return {"loss_gap": loss_gap,
          "grad_gap": _leaf_gap(program["grad1"], g_ref),
          "change_gap": _leaf_gap(change, reference["params"] - initial,
                                  keep),
          "left_out": int(np.size(keep) - np.count_nonzero(keep))}


def judge(values: Dict[str, float], limits: Dict[str, float]):
  """({name: {"value", "limit"}} for every compared number, correct)."""
  checks = {name: {"value": values[name], "limit": limits[name]}
            for name in NAMES}
  correct = all(c["value"] <= c["limit"] for c in checks.values())
  return checks, correct
