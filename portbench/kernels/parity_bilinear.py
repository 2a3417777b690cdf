"""K5's `parity_bilinear`: the batch-summed parity bilinears of a diagonal
segment; given the segment's (cos, sin) planes also the un-apply of a and
lambda in the same pass (the sweep's whole diagonal stage)."""

WRAPPER = ("qhbmlib_tpu_torch.ops.hopper_adjoint", "parity_bilinear")


def work(a):
  b, r, c = a["l_re"].shape
  amps = b * r * c
  k = len(a["row_masks"])
  if a["planes"] is None:
    # Im(conj(lam) a) summed over the batch (4 flops an amplitude), each
    # factor's signed sum over [R, C] (2 flops an entry) and a dot over R;
    # four planes read once.
    return {"flops": 4 * amps + 2 * r * c * k + 2 * r * k,
            "bytes": 16 * amps + 4 * k, "rate": "fp32"}
  # Im(conj(lam) a) and its batch sum (4 flops an amplitude), two complex
  # multiplies (12); each row's C log2 C butterflies and K signed adds; a
  # and lambda read and written once, the cos and sin planes and the masks
  # read once, K floats written.
  return {"flops": 16 * amps + r * c * (c.bit_length() - 1) + 2 * r * k,
          "bytes": 32 * amps + 8 * r * c + 12 * k, "rate": "fp32"}
