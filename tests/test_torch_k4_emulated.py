"""K4's tensor-core `axis_apply` CUDA source, run on the CPU.

`axis_apply_mma_kernel` (qhbmlib_tpu_torch/csrc/statevector_kernels.cu), the
kernel behind `hopper_sv.axis_apply` for operators of N >= 16, runs on the
card only, where `chip_smoke.py` holds it against its plain version.  Here
the same source is compiled with g++ against the stand-in runtime of
`test_torch_k1_emulated.py` (a std::thread per CUDA thread, `__syncthreads`
a barrier, cp.async a copy, mma.sync.m16n8k8 tf32 emulated on the PTX ISA's
fragment layouts with the tensor cores' truncating accumulation) and run
block by block on views of `hopper_sv.apply_pass` cut to a few slabs.  That
checks the kernel's slabs (one p's q-run, whole p's, a ragged last slab),
both layouts (rows of columns at Q >= 4, whole p's at stride Q below), the
cp.async and scalar slab paths, the operator panels' stream across chunks
and slabs, and the 3xTF32 accumulation, against float64.
"""

import json
import shutil
import subprocess

import pytest

from tests.test_torch_k1_emulated import (EMU_CUDA_H, EMU_RUNTIME_CC,
                                          SOURCE, emulable)

DRIVER_CC = r'''// Runs axis_apply_mma_kernel from a preprocessed copy of
// qhbmlib_tpu_torch/csrc/statevector_kernels.cu (included as KERNEL_SOURCE)
// on the CPU, block by block, and prints its relative L2 error and its norm
// ratio against a float64 reference:
//   k4_driver P N Q grid op_offset state_offset truncate
// op_offset / state_offset shift the operator / the input planes by that
// many floats from 16-byte alignment.
#include <complex>
#include <cstdio>
#include <cstdlib>
#include <random>

#include KERNEL_SOURCE
''' + EMU_RUNTIME_CC + r'''
// Runs every block of the launch (the launch arithmetic of
// launch_axis_apply_mma, the grid capped at `grid`); returns the grid.
template <int N>
int run(const float* x_re, const float* x_im, const float* op_re,
        const float* op_im, float* y_re, float* y_im, long long cols,
        int log_q, int grid) {
  auto kernel = log_q >= 2 ? axis_apply_mma_kernel<N, 1>
                           : axis_apply_mma_kernel<N, 2>;
  const long long slabs = (cols + (1 << AxisMma<N>::kLogL) - 1) >>
                          AxisMma<N>::kLogL;
  if (grid > slabs) grid = (int)slabs;
  gridDim = dim3(grid);
  blockDim = dim3(kAxisMmaThreads);
  for (int blk = 0; blk < grid; ++blk) {
    emu_run_block(blk, kAxisMmaThreads, [&] {
      kernel(x_re, x_im, op_re, op_im, y_re, y_im, cols, log_q);
    });
  }
  return grid;
}

int main(int argc, char** argv) {
  if (argc != 8) return 2;
  const long long P = atoll(argv[1]);
  const int N = atoi(argv[2]), Q = atoi(argv[3]);
  const int grid = atoi(argv[4]);
  const int op_offset = atoi(argv[5]), state_offset = atoi(argv[6]);
  emu_truncate = atoi(argv[7]) != 0;
  const long long size = P * N * Q;
  std::mt19937 rng(P * 7 + N * 13 + Q);
  std::normal_distribution<float> normal;
  std::vector<float> xs(state_offset + 2 * size);
  std::vector<float> y_re(size, NAN), y_im(size, NAN);
  std::vector<float> ops(op_offset + 2 * N * N);
  for (auto& v : xs) v = normal(rng);
  for (auto& v : ops) v = normal(rng);
  const float* x_re = xs.data() + state_offset;
  const float* x_im = x_re + size;
  const float* op_re = ops.data() + op_offset;
  const float* op_im = op_re + N * N;
  int log_q = 0;
  while ((1 << log_q) < Q) ++log_q;
  int ran = 0;
  switch (N) {
    case 16: ran = run<16>(x_re, x_im, op_re, op_im, y_re.data(), y_im.data(),
                           P * Q, log_q, grid); break;
    case 32: ran = run<32>(x_re, x_im, op_re, op_im, y_re.data(), y_im.data(),
                           P * Q, log_q, grid); break;
    case 64: ran = run<64>(x_re, x_im, op_re, op_im, y_re.data(), y_im.data(),
                           P * Q, log_q, grid); break;
    case 128: ran = run<128>(x_re, x_im, op_re, op_im, y_re.data(),
                             y_im.data(), P * Q, log_q, grid); break;
    default: return 2;
  }
  // float64 reference: y[p, M, q] = sum_n Op[M, n] x[p, n, q].
  using C = std::complex<double>;
  double err = 0, norm = 0, got_norm = 0;
  for (long long p = 0; p < P; ++p)
    for (int m = 0; m < N; ++m)
      for (int q = 0; q < Q; ++q) {
        C s = 0;
        for (int n = 0; n < N; ++n) {
          const long long o = (p * N + n) * Q + q;
          s += C(op_re[m * N + n], op_im[m * N + n]) * C(x_re[o], x_im[o]);
        }
        const long long o = (p * N + m) * Q + q;
        const C got(y_re[o], y_im[o]);
        err += std::norm(got - s);
        norm += std::norm(s);
        got_norm += std::norm(got);
      }
  printf("{\"rel_err\": %.6e, \"norm_ratio\": %.10f, \"grid\": %d}\n",
         std::sqrt(err / norm), std::sqrt(got_norm / norm), ran);
  return 0;
}
'''


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
  gxx = shutil.which("g++")
  assert gxx, "g++ builds the emulated kernel"
  tmp = tmp_path_factory.mktemp("k4_emu")
  (tmp / "emu_cuda.h").write_text(EMU_CUDA_H)
  (tmp / "k4_driver.cc").write_text(DRIVER_CC)
  kernel = tmp / "kernel.cpp"
  kernel.write_text(emulable(SOURCE.read_text()))
  exe = tmp / "k4_driver"
  subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-w", f"-I{tmp}",
                  f'-DKERNEL_SOURCE="{kernel}"', str(tmp / "k4_driver.cc"),
                  "-o", str(exe)], check=True, timeout=600)
  return exe


# (P, N, Q, blocks, operator offset, state offset in floats): views of
# `hopper_sv.apply_pass` cut to a few slabs.  A slab is 2^13 amplitudes,
# L = 2^13 / N columns p * Q + q; N <= 64 keeps its operator resident,
# N = 128 streams it in panels.
VIEWS = {
    "20q block (7,6): N=64, Q=128, a slab a p": (3, 64, 128, 2, 0, 0),
    "the minor alone: N=128 at Q=1, 64 p's a slab": (192, 128, 1, 2, 0, 0),
    "N=16 at L=512 < Q=2048, 4 slabs a p, 2 chunks a slab":
        (1, 16, 2048, 3, 0, 0),
    "N=32 at L=256 < Q=512": (2, 32, 512, 2, 0, 0),
    "unaligned operator, N=64 (split once a block)": (2, 64, 256, 2, 3, 0),
    "unaligned operator, N=128: 4-byte panel copies": (1, 128, 128, 2, 3, 0),
    "unaligned state, the scalar slab path": (2, 64, 128, 2, 0, 1),
    "one block walks 3 slabs of N=128 (panel prefetch chain)":
        (192, 128, 1, 1, 0, 0),
    "one block walks 3 slabs of N=64 (slab double buffer)":
        (3, 64, 128, 1, 0, 0),
    "one block walks 3 slabs of N=64 at Q=1, 44 of 128 p's last":
        (300, 64, 1, 1, 0, 0),
    "ragged last slab, N=128 at Q=1, 8 of 64 p's": (72, 128, 1, 2, 0, 0),
    "N=64 at Q=8: 16 p's a slab, ragged last": (40, 64, 8, 2, 0, 0),
    "N=32 at Q=2 (stride 2): 128 p's a slab, ragged last":
        (300, 32, 2, 2, 0, 0),
}


@pytest.mark.parametrize("view", list(VIEWS))
def test_k4_source_matches_float64_under_truncating_accumulation(driver,
                                                                 view):
  """Within 1e-6 relative L2 of the float64 product (the card's gate
  against the fp32 plain version is 1e-5), and no shrink of the norm
  beyond 5e-7, as K1's views are held."""
  out = subprocess.run([str(driver), *map(str, VIEWS[view]), "1"],
                       capture_output=True, text=True, check=True,
                       timeout=600).stdout
  got = json.loads(out)
  assert got["rel_err"] < 1e-6, out
  assert abs(got["norm_ratio"] - 1) < 5e-7, out
