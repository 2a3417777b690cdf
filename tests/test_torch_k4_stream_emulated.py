"""K4's `axis_apply` stream route (N < 16) CUDA source, run on the CPU.

`axis_stream_kernel` (qhbmlib_tpu_torch/csrc/statevector_kernels.cu), the
kernel behind `hopper_sv.axis_apply` for operators of N = 2, 4 and 8, runs on
the card only, where `chip_smoke.py` holds it against its plain version.
Here the same source is compiled with g++ against the stand-in runtime of
`test_torch_k1_emulated.py` (a std::thread per CUDA thread, `__syncthreads`
a barrier) and run block by block on [P, N, Q] views.  The instance comes
from the launcher's own pick (`axis_stream_pick`: 16-byte accesses at Q >= 4
on aligned planes, 4-byte ones otherwise), and the grid is capped so that
threads walk the grid-stride loop.  That checks the kernel's group
arithmetic (four q of one p at Q >= 4, whole p's below), a last block the
groups do not fill, the scalar path on planes off 16-byte alignment, and
the operator's staging, against float64.
"""

import json
import shutil
import subprocess

import pytest

from tests.test_torch_k1_emulated import (EMU_CUDA_H, EMU_RUNTIME_CC,
                                          SOURCE, emulable)

DRIVER_CC = r'''// Runs axis_stream_kernel from a preprocessed copy of
// qhbmlib_tpu_torch/csrc/statevector_kernels.cu (included as KERNEL_SOURCE)
// on the CPU, block by block, and prints its relative L2 error against a
// float64 reference and whether it took the 16-byte path:
//   k4_stream_driver P N Q grid op_offset state_offset
// op_offset / state_offset shift the operator / the planes by that many
// floats from 16-byte alignment.
#include <complex>
#include <cstdio>
#include <cstdlib>
#include <random>

#include KERNEL_SOURCE
''' + EMU_RUNTIME_CC + r'''
// Every block of the launch: launch_axis_stream's arithmetic, the grid
// capped at `grid`.  Returns the grid.
template <int N>
int run(const float* x_re, const float* x_im, const float* op_re,
        const float* op_im, float* y_re, float* y_im, long long P, int log_q,
        int grid, bool* vec) {
  const AxisStreamKernel kernel =
      axis_stream_pick<N>(log_q, x_re, x_im, y_re, y_im);
  *vec = kernel == axis_stream_kernel<N, 4, true>;
  const int log_w = log_q < 2 ? log_q : 2;
  const long long groups = (P << log_q) >> log_w;
  const long long need = (groups + kStreamThreads - 1) / kStreamThreads;
  if (grid > need) grid = (int)need;
  gridDim = dim3(grid);
  blockDim = dim3(kStreamThreads);
  for (int blk = 0; blk < grid; ++blk) {
    emu_run_block(blk, kStreamThreads, [&] {
      kernel(x_re, x_im, op_re, op_im, y_re, y_im, groups, log_q);
    });
  }
  return grid;
}

int main(int argc, char** argv) {
  if (argc != 7) return 2;
  const long long P = atoll(argv[1]);
  const int N = atoi(argv[2]), Q = atoi(argv[3]);
  const int grid = atoi(argv[4]);
  const int op_offset = atoi(argv[5]), state_offset = atoi(argv[6]);
  const long long size = P * N * Q;
  std::mt19937 rng(P * 7 + N * 13 + Q);
  std::normal_distribution<float> normal;
  // Four planes, each 16-byte aligned before the offset.
  const long long stride = (state_offset + size + 3) / 4 * 4;
  std::vector<float4> planes(stride);  // 4 * stride floats
  float* base = reinterpret_cast<float*>(planes.data());
  std::vector<float> ops(op_offset + 2 * N * N);
  float* x_re = base + state_offset;
  float* x_im = x_re + stride;
  float* y_re = x_im + stride;
  float* y_im = y_re + stride;
  for (long long i = 0; i < size; ++i) {
    x_re[i] = normal(rng);
    x_im[i] = normal(rng);
    y_re[i] = y_im[i] = NAN;
  }
  for (auto& v : ops) v = normal(rng);
  const float* op_re = ops.data() + op_offset;
  const float* op_im = op_re + N * N;
  int log_q = 0;
  while ((1 << log_q) < Q) ++log_q;
  int ran = 0;
  bool vec = false;
  switch (N) {
    case 2: ran = run<2>(x_re, x_im, op_re, op_im, y_re, y_im, P, log_q,
                         grid, &vec); break;
    case 4: ran = run<4>(x_re, x_im, op_re, op_im, y_re, y_im, P, log_q,
                         grid, &vec); break;
    case 8: ran = run<8>(x_re, x_im, op_re, op_im, y_re, y_im, P, log_q,
                         grid, &vec); break;
    default: return 2;
  }
  // float64 reference: y[p, M, q] = sum_n Op[M, n] x[p, n, q].
  using C = std::complex<double>;
  double err = 0, norm = 0;
  for (long long p = 0; p < P; ++p)
    for (int m = 0; m < N; ++m)
      for (int q = 0; q < Q; ++q) {
        C s = 0;
        for (int n = 0; n < N; ++n) {
          const long long o = (p * N + n) * Q + q;
          s += C(op_re[m * N + n], op_im[m * N + n]) * C(x_re[o], x_im[o]);
        }
        const long long o = (p * N + m) * Q + q;
        err += std::norm(C(y_re[o], y_im[o]) - s);
        norm += std::norm(s);
      }
  printf("{\"rel_err\": %.6e, \"grid\": %d, \"vec\": %s}\n",
         std::sqrt(err / norm), ran, vec ? "true" : "false");
  return 0;
}
'''


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
  gxx = shutil.which("g++")
  assert gxx, "g++ builds the emulated kernel"
  tmp = tmp_path_factory.mktemp("k4_stream_emu")
  (tmp / "emu_cuda.h").write_text(EMU_CUDA_H)
  (tmp / "k4_stream_driver.cc").write_text(DRIVER_CC)
  kernel = tmp / "kernel.cpp"
  kernel.write_text(emulable(SOURCE.read_text()))
  exe = tmp / "k4_stream_driver"
  subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-w", f"-I{tmp}",
                  f'-DKERNEL_SOURCE="{kernel}"',
                  str(tmp / "k4_stream_driver.cc"), "-o", str(exe)],
                 check=True, timeout=600)
  return exe


# P for each Q: the groups (one a thread: P * Q / min(Q, 4)) leave the last
# 256-thread block part empty, and with a grid of 2 blocks the threads walk
# the grid-stride loop (Q = 128: 19 * 32 = 608 groups, three rounds).
P_OF_Q = {1: 300, 2: 300, 4: 300, 128: 19}
# (P, N, Q, grid, operator offset, state offset in floats).
VIEWS = {f"N={n}, Q={q}": (P_OF_Q[q], n, q, 2, 0, 0)
         for n in (2, 4, 8) for q in (1, 2, 4, 128)}
VIEWS.update({
    f"N={n}, Q=128, planes off 16-byte alignment (scalar path)":
        (P_OF_Q[128], n, 128, 2, 0, 1) for n in (2, 4, 8)})
VIEWS.update({
    "N=4, Q=4, planes off alignment, unaligned operator": (300, 4, 4, 2, 3, 2),
    "N=8, Q=128, one group a thread, 3 blocks": (19, 8, 128, 64, 0, 0),
})


@pytest.mark.parametrize("view", list(VIEWS))
def test_k4_stream_source_matches_float64(driver, view):
  """Within 1e-6 relative L2 of the float64 product (fp32 FMAs over N <= 8
  terms; the card's gate against the fp32 plain version is 1e-5), every
  output written, and the 16-byte path taken exactly where Q >= 4 and the
  planes are aligned."""
  p, n, q, grid, _, state_offset = VIEWS[view]
  out = subprocess.run([str(driver), *map(str, VIEWS[view])],
                       capture_output=True, text=True, check=True,
                       timeout=600).stdout
  got = json.loads(out)
  assert got["rel_err"] < 1e-6, out
  assert got["vec"] == (q >= 4 and state_offset % 4 == 0), out
  assert got["grid"] == min(grid, -(-p * q // min(q, 4) // 256)), out
