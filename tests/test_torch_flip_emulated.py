"""The flip kernels' CUDA source, run on the CPU.

`flip_apply_kernel` (the batched forward's stage for a gate of the flip
class: CXP, XXP, YYP, a PROT with X or Y factors on two or more qubits)
and `flip_bilinear_kernel` with `sum_partials_kernel` (the batched sweep's
stage: the un-apply of a and lambda and the gradient's reduction in one
pass) in qhbmlib_tpu_torch/csrc/statevector_kernels.cu run on the card
only, where `chip_smoke.py` holds them against their plain versions.  Here
the same source is compiled with g++ against the stand-in runtime of
`test_torch_k1_emulated.py` (a std::thread per CUDA thread, `__syncthreads`
a barrier, warp shuffles through exchange slots) and run block by block on
the grid the launcher computes (`qhbm_flip_blocks` for a given number of
SMs), on planes whose values are a hash of (plane, index), against float64
numpy of the record's flip form out[x] = alpha[c(x)] s[x] + beta[c(x)]
sigma(x) s[x ^ f].  The records are the port's own (`hopper_sv.flip_record`
of a gate at an angle), so the views also check the masks the host builds.

The views: a flip within the row bits, one across two row blocks, a PROT
spanning row and column bits, CXP with its control above and below its
target, the one-row state of 7 qubits (R = 1), and 3 qubits; batches that
leave the last block part-empty and grids that walk the pairs in a
grid-stride loop.

A mutation that the states check catches: a pair index that inserts its
zero one bit too low (`flip_pair`'s `(p >> top) << (top + 1)` made
`(p >> top) << top`).
"""

import json
import shutil
import subprocess

import numpy as np
import pytest

from qhbmlib_tpu_torch.ops import circuit_ir as ir
from qhbmlib_tpu_torch.ops import hopper_sv
from tests.test_torch_diag_emulated import _hash
from tests.test_torch_k1_emulated import (EMU_CUDA_H, EMU_RUNTIME_CC,
                                          SOURCE, emulable)

DRIVER_CC = r'''// Runs flip_apply_kernel or flip_bilinear_kernel + sum_partials_kernel
// from a preprocessed copy of qhbmlib_tpu_torch/csrc/statevector_kernels.cu
// (included as KERNEL_SOURCE) on the CPU, block by block, on the grid
// qhbm_flip_blocks gives for `sms` SMs:
//   flip_driver mode B n f ctrl z sms c0 ... c15 out.bin
// mode: apply1 (one batch, record c0..c7), apply2 (two batches) or
// bilinear (inverse record c0..c7, derivative record c8..c15).  Writes the
// four planes after the run, then the reduction, as float32 to out.bin;
// prints the grid as one JSON line.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

#include KERNEL_SOURCE
''' + EMU_RUNTIME_CC + r'''

// A float in [-1, 1) from a hash of (plane, index), as the diag driver's.
static float value(uint32_t plane, uint32_t i) {
  uint32_t h = i * 2654435761u ^ plane * 0x9E3779B9u;
  h ^= h >> 16;
  h *= 0x45d9f3bu;
  h ^= h >> 16;
  return (float)((h >> 8) & 0xffffu) / 32768.0f - 1.0f;
}

// The SM count the launcher asks the runtime for.
static int emu_sms = 1;
long long emu_wave() { return (long long)emu_sms * kDiagBlocksPerSm; }

int main(int argc, char** argv) {
  if (argc != 25) return 2;
  const std::string mode = argv[1];
  const int B = atoi(argv[2]), n = atoi(argv[3]);
  const int f = atoi(argv[4]), ctrl = atoi(argv[5]), z = atoi(argv[6]);
  emu_sms = atoi(argv[7]);
  float coeffs[16];
  for (int i = 0; i < 16; ++i) coeffs[i] = (float)atof(argv[8 + i]);
  const long long size = (long long)B << n;
  std::vector<float> planes[4];  // l_re, l_im, a_re, a_im
  for (int pl = 0; pl < 4; ++pl) {
    planes[pl].resize(size);
    for (long long i = 0; i < size; ++i) {
      planes[pl][i] = value(pl, (uint32_t)i);
    }
  }
  FlipMasks m;
  FlipCoeffs inv, d;
  if (!flip_args(n, f, ctrl, z, coeffs, &m, &inv) ||
      !flip_args(n, f, ctrl, z, coeffs + 8, &m, &d)) {
    return 3;
  }
  const int grid = qhbm_flip_blocks(B, n);
  std::vector<float> partial(grid, NAN), out(1, NAN);
  gridDim = dim3(grid);
  blockDim = dim3(kFlipThreads);
  for (int blk = 0; blk < grid; ++blk) {
    emu_run_block(blk, kFlipThreads, [&] {
      if (mode == "apply1") {
        flip_apply_kernel<false>(planes[0].data(), planes[1].data(), nullptr,
                                 nullptr, B, n, m, inv);
      } else if (mode == "apply2") {
        flip_apply_kernel<true>(planes[0].data(), planes[1].data(),
                                planes[2].data(), planes[3].data(), B, n, m,
                                inv);
      } else {
        flip_bilinear_kernel(planes[0].data(), planes[1].data(),
                             planes[2].data(), planes[3].data(), B, n, m,
                             inv, d, partial.data());
      }
    });
  }
  if (mode == "bilinear") {
    gridDim = dim3(1);
    blockDim = dim3(32);
    emu_run_block(0, 32, [&] {
      sum_partials_kernel(partial.data(), grid, 1, out.data());
    });
  }
  FILE* fp = fopen(argv[24], "wb");
  for (int pl = 0; pl < 4; ++pl) {
    fwrite(planes[pl].data(), sizeof(float), planes[pl].size(), fp);
  }
  fwrite(out.data(), sizeof(float), 1, fp);
  fclose(fp);
  printf("{\"blocks\": %d, \"top\": %d}\n", grid, m.top);
  return 0;
}
'''


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
  gxx = shutil.which("g++")
  assert gxx, "g++ builds the emulated kernel"
  tmp = tmp_path_factory.mktemp("flip_emu")
  (tmp / "emu_cuda.h").write_text(EMU_CUDA_H)
  (tmp / "flip_driver.cc").write_text(DRIVER_CC)
  kernel = tmp / "kernel.cpp"
  # The launcher's wave asks the runtime for the SM count: the driver's.
  source = "long long emu_wave();\n" + emulable(SOURCE.read_text()).replace(
      "long long diag_wave() { return (long long)sm_count() * "
      "kDiagBlocksPerSm; }",
      "long long diag_wave() { return ::emu_wave(); }")
  assert "return ::emu_wave();" in source
  kernel.write_text(source)
  exe = tmp / "flip_driver"
  subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-w", f"-I{tmp}",
                  f'-DKERNEL_SOURCE="{kernel}"', str(tmp / "flip_driver.cc"),
                  "-o", str(exe)], check=True, timeout=600)
  return exe, tmp


def _run(driver, mode, b, n, inv, d, sms):
  exe, tmp = driver
  path = tmp / f"{mode}_{b}_{n}_{inv.flip}_{inv.ctrl}_{sms}.bin"
  coeffs = np.concatenate([inv.coeffs(), d.coeffs()])
  grid = json.loads(subprocess.run(
      [str(exe), mode, *map(str, (b, n, inv.flip, inv.ctrl, inv.zmask, sms)),
       *[repr(float(x)) for x in coeffs], str(path)],
      capture_output=True, text=True, check=True, timeout=600).stdout)
  raw = np.fromfile(path, dtype=np.float32).astype(np.float64)
  size = b << n
  return grid, raw[:4 * size].reshape(4, b, 1 << n), raw[4 * size]


def _flip_form(rec, s):
  """The record's operator on complex [B, 2^n] states, in float64."""
  x = np.arange(s.shape[-1])
  c = ((x & rec.ctrl) != 0).astype(np.int64)
  parity = np.array([bin(int(v)).count("1") & 1 for v in x & rec.zmask])
  sigma = 1.0 - 2.0 * parity
  alpha = np.asarray(rec.alpha, np.complex64).astype(np.complex128)[c]
  beta = np.asarray(rec.beta, np.complex64).astype(np.complex128)[c]
  return alpha * s + beta * sigma * s[..., x ^ rec.flip]


def _rel(x, ref):
  return np.linalg.norm(x - ref) / np.linalg.norm(ref)


# (gate, angle, n, B, SMs).
VIEWS = {
    # 14q: rows are qubits 0-6; XX inside them.  3 * 2^13 pairs on 2 SMs:
    # 16 blocks walking 6 pairs a thread.
    "XX within the rows": (ir.Gate(ir.XXP, (2, 3)), 0.37, 14, 3, 2),
    # 16q: row blocks (0, 7), (7, 2); YY on (6, 7) spans the two.
    "YY across row blocks": (ir.Gate(ir.YYP, (6, 7)), -1.21, 16, 2, 1),
    # 13q: qubit 5 a row bit, 9 and 12 column bits; the top bit of the
    # flip is a row bit, the Y a column bit.
    "PROT XYZ spanning row and column": (
        ir.Gate(ir.PROT, (5, 9, 12), paulis=(1, 2, 3)), 0.83, 13, 3, 1),
    "CXP, control a row bit above its column target": (
        ir.Gate(ir.CXP, (3, 11)), 0.61, 12, 2, 1),
    "CXP, control a column bit below its row target": (
        ir.Gate(ir.CXP, (11, 3)), -0.44, 12, 2, 1),
    # 7q: R = 1, every qubit a column bit; 5 states leave the last of
    # three blocks part-empty.
    "R = 1: YY at 7q": (ir.Gate(ir.YYP, (0, 6)), 1.9, 7, 5, 2),
    "3q: PROT Y.X": (ir.Gate(ir.PROT, (0, 2), paulis=(2, 1)), 0.29, 3, 5,
                     1),
}


@pytest.mark.parametrize("mode", ["apply1", "apply2"])
@pytest.mark.parametrize("view", list(VIEWS))
def test_flip_apply_matches_float64(driver, view, mode):
  """flip_apply_kernel with the gate's record on one batch, or the inverse
  record on two: within 1e-6 relative L2 of float64 numpy; a batch it was
  not given stays as it was."""
  gate, angle, n, b, sms = VIEWS[view]
  rec = hopper_sv.flip_record(gate, angle if mode == "apply1" else -angle,
                              n)
  grid, got, _ = _run(driver, mode, b, n, rec, rec, sms)
  assert grid["top"] == rec.flip.bit_length() - 1
  assert grid["blocks"] == min(-(-(b << (n - 1)) // 256), 8 * sms)
  planes = np.stack([_hash(pl, np.arange(b << n)).reshape(b, 1 << n)
                     for pl in range(4)])
  for k in (0, 2) if mode == "apply2" else (0,):
    want = _flip_form(rec, planes[k] + 1j * planes[k + 1])
    assert _rel(got[k] + 1j * got[k + 1], want) < 1e-6, view
  if mode == "apply1":
    np.testing.assert_array_equal(got[2:], planes[2:].astype(np.float32))


@pytest.mark.parametrize("view", list(VIEWS))
def test_flip_bilinear_matches_float64(driver, view):
  """flip_bilinear_kernel + sum_partials_kernel: a and lambda un-applied
  by the inverse record within 1e-6 relative L2 of float64 numpy, and g =
  2 Re sum conj(lam) dU a_before over the batch within 1e-5 (float32
  sums of up to 10^5 products)."""
  gate, angle, n, b, sms = VIEWS[view]
  inv = hopper_sv.flip_record(gate, -angle, n)
  d = hopper_sv.flip_record(gate, angle, n, deriv=True)
  _, got, g = _run(driver, "bilinear", b, n, inv, d, sms)
  planes = np.stack([_hash(pl, np.arange(b << n)).reshape(b, 1 << n)
                     for pl in range(4)])
  lam = planes[0] + 1j * planes[1]
  a_before = _flip_form(inv, planes[2] + 1j * planes[3])
  assert _rel(got[2] + 1j * got[3], a_before) < 1e-6, view
  assert _rel(got[0] + 1j * got[1], _flip_form(inv, lam)) < 1e-6, view
  want = 2.0 * np.sum(np.conj(lam) * _flip_form(d, a_before)).real
  assert abs(g - want) <= 1e-5 * np.sum(np.abs(lam) *
                                        np.abs(_flip_form(d, a_before))), view
