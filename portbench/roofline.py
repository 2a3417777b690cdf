"""The card's published peaks and a kernel call's least time.

NVIDIA H100 SXM data sheet, dense rates: 3.35 TB/s of HBM3, 67 TFLOP/s in
float32 outside the tensor cores, 495 TFLOP/s in TF32 on them.  A
contraction on the tensor cores in 3xTF32 (three TF32 products a float32
product: K1, and K4 from N = 16) is charged three times its operations
there.  A call's bound is the larger of its bytes over the bandwidth and
its operations over the rate that serves them; each input byte is counted
read once and each output byte written once.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12

RATES = {"fp32": PEAK_FP32_PER_S, "tf32x3": PEAK_TF32_PER_S / 3.0}


def bound_s(work: dict) -> float:
  """The least seconds for work {"flops", "bytes", "rate"}: the larger of
  flops / RATES[rate] and bytes / PEAK_BYTES_PER_S."""
  return max(work["flops"] / RATES[work["rate"]],
             work["bytes"] / PEAK_BYTES_PER_S)


def share_pct(traced, names=None):
  """Percent of the least time in the device time of the traced calls of
  the kernel wrappers `names` (all where None): the sum of each call's
  bound over the device time of the work launched inside those calls.
  None where no call was traced, a call has no formula, or the calls left
  no device time."""
  if traced is None:
    return None
  calls = [w for k, w in traced["calls"] if names is None or k in names]
  if not calls or any(w is None for w in calls):
    return None
  device_s = sum(s for k, s in traced["wrapper_s"].items()
                 if names is None or k in names)
  if device_s <= 0:
    return None
  return 100.0 * sum(bound_s(w) for w in calls) / device_s
