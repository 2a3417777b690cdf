"""K1's CUDA source, run on the CPU through an emulated thread block.

`axis2_apply_kernel` (qhbmlib_tpu_torch/csrc/statevector_kernels.cu) runs on
the card only, where `chip_smoke.py` holds it against its plain version.
Here the same source is compiled with g++ against the stand-in runtime
below (EMU_CUDA_H, DRIVER_CC): each CUDA thread is a std::thread,
`__syncthreads` a barrier, and the PTX helpers
(cp.async, mma.sync.m16n8k8 tf32) are replaced by emulations that follow the
PTX ISA's fragment layouts, with a model of the tensor cores' truncating
accumulation.  That checks the kernel's own index arithmetic (slab swizzle,
warp tiles, panel stream across contractions and slabs, the scalar and
cp.async slab paths) and its accumulation scheme at the main-path views
cut to a few slabs.  The fragment layouts themselves are the card's to
confirm.
"""

import pathlib
import re
import shutil
import subprocess

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = ROOT / "qhbmlib_tpu_torch" / "csrc" / "statevector_kernels.cu"

EMU_CUDA_H = r'''// A CPU stand-in for the CUDA runtime, to run a kernel source's device code
// on the host: one std::thread per CUDA thread of a block, __syncthreads a
// std::barrier over the block.  The PTX helpers that the test replaces
// (cp.async, mma.sync) are emulated below; nothing else of the device is.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __restrict__
#define __launch_bounds__(...)
#define __grid_constant__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern thread_local dim3 threadIdx, blockIdx;
extern dim3 gridDim, blockDim;
extern float emu_smem[];
void __syncthreads();

inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void sincosf(float a, float* s, float* c) {
  *s = std::sin(a);
  *c = std::cos(a);
}
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}

// Host-side API the source calls; never reached by the test's kernel runs.
typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorCooperativeLaunchTooLarge = 2,
  cudaDevAttrCooperativeLaunch = 3,
  cudaDevAttrMultiProcessorCount = 4,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 5,
  cudaOccupancyDefault = 6,
  cudaFuncAttributePreferredSharedMemoryCarveout = 7,
  cudaSharedmemCarveoutMaxShared = 100
};
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int*) { return 0; }
inline int cudaDeviceGetAttribute(int*, int, int) { return 0; }
template <class K>
int cudaFuncSetAttribute(K, int, int) { return 0; }
template <class K>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, K, int, size_t) {
  return 0;
}
template <class K>
int cudaOccupancyMaxActiveBlocksPerMultiprocessorWithFlags(int*, K, int,
                                                           size_t, int) {
  return 0;
}
inline int cudaLaunchCooperativeKernel(const void*, dim3, dim3, void**,
                                       size_t, cudaStream_t) {
  return 0;
}
namespace cooperative_groups {
struct grid_group {
  void sync() {}
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups

// d += a b for one warp's m16n8k8 TF32 fragments (the PTX ISA's layouts):
// the lanes trade fragments through shared arrays between warp barriers.
// Operands are read as TF32 (low 13 bits dropped); each product is exact and
// the sum is rounded to fp32 once, toward zero when `emu_truncate` is set,
// as a model of the tensor cores' truncating accumulation.
extern bool emu_truncate;
void emu_mma(float* d, const unsigned* a, const unsigned* b);
'''

EMU_RUNTIME_CC = r'''// The stand-in runtime's definitions, for a driver to put after the kernel
// source: block and thread indices, shared memory, the barriers, the
// emulated mma.sync and a runner of one block.
#include <barrier>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

thread_local dim3 threadIdx, blockIdx;
dim3 gridDim, blockDim;
alignas(16) float emu_smem[232448 / 4];
bool emu_truncate = false;
static std::unique_ptr<std::barrier<>> block_barrier;
static std::unique_ptr<std::barrier<>> warp_barrier[32];
static unsigned frag_a[32][32][4], frag_b[32][32][2];

void __syncthreads() { block_barrier->arrive_and_wait(); }

static float tf32(unsigned u) { return __uint_as_float(u & 0xffffe000u); }

void emu_mma(float* d, const unsigned* a, const unsigned* b) {
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  std::memcpy(frag_a[w][lane], a, sizeof(frag_a[w][lane]));
  std::memcpy(frag_b[w][lane], b, sizeof(frag_b[w][lane]));
  warp_barrier[w]->arrive_and_wait();
  const int g = lane >> 2;
  const int t = lane & 3;
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1);
    const int col = 2 * t + (e & 1);
    double sum = d[e];
    for (int k = 0; k < 8; ++k) {
      sum += (double)tf32(frag_a[w][(row & 7) * 4 + (k & 3)]
                                [(row >= 8) + 2 * (k >= 4)]) *
             tf32(frag_b[w][col * 4 + (k & 3)][k >= 4]);
    }
    float r = (float)sum;
    if (emu_truncate && std::fabs((double)r) > std::fabs(sum)) {
      r = std::nextafter(r, 0.f);
    }
    out[e] = r;
  }
  warp_barrier[w]->arrive_and_wait();
  std::memcpy(d, out, sizeof(out));
}

// Runs body() as block `blk` of `threads` CUDA threads, each a std::thread,
// on shared memory that reads NaN until written.
template <class Body>
void emu_run_block(int blk, int threads, Body body) {
  block_barrier = std::make_unique<std::barrier<>>(threads);
  for (auto& b : warp_barrier) b = std::make_unique<std::barrier<>>(32);
  std::memset(emu_smem, 0xff, sizeof(emu_smem));
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&, t] {
      threadIdx = dim3(t);
      blockIdx = dim3(blk);
      body();
    });
  }
  for (auto& th : pool) th.join();
}
'''

DRIVER_CC = r'''// Runs axis2_apply_kernel from a preprocessed copy of
// qhbmlib_tpu_torch/csrc/statevector_kernels.cu (included as KERNEL_SOURCE)
// on the CPU, block by block, and prints its relative L2 error and its norm
// ratio against a float64 reference:
//   k1_driver P k1 M k2 Q grid op_offset truncate
#include <complex>
#include <cstdio>
#include <cstdlib>
#include <random>

#include KERNEL_SOURCE
''' + EMU_RUNTIME_CC + r'''
int main(int argc, char** argv) {
  if (argc != 9) return 2;
  const int P = atoi(argv[1]), k1 = atoi(argv[2]), M = atoi(argv[3]);
  const int k2 = atoi(argv[4]), Q = atoi(argv[5]);
  int grid = atoi(argv[6]);
  const int op_offset = atoi(argv[7]);
  emu_truncate = atoi(argv[8]) != 0;
  const int n1 = 1 << k1, n2 = 1 << k2;
  const long long size = (long long)P * n1 * M * n2 * Q;
  std::mt19937 rng(P * 7 + k1 * 13 + M + k2 * 5 + Q);
  std::normal_distribution<float> normal;
  std::vector<float> x_re(size), x_im(size), y_re(size, NAN), y_im(size, NAN);
  std::vector<float> ops(op_offset + 2 * n1 * n1 + 2 * n2 * n2);
  for (auto& v : x_re) v = normal(rng);
  for (auto& v : x_im) v = normal(rng);
  for (auto& v : ops) v = normal(rng);
  const float* a_re = ops.data() + op_offset;  // op_offset 1: unaligned
  const float* a_im = a_re + n1 * n1;
  const float* b_re = a_im + n1 * n1;
  const float* b_im = b_re + n2 * n2;
  // The launch arithmetic of qhbm_axis2_apply.
  int log_q = 0;
  while ((1 << log_q) < Q) ++log_q;
  const int log_w = kLogSlab - k1 - k2 < log_q ? kLogSlab - k1 - k2 : log_q;
  const long long slabs = (long long)P * M * (Q >> log_w);
  if (grid > slabs) grid = (int)slabs;
  gridDim = dim3(grid);
  blockDim = dim3(kAxis2Threads);
  for (int blk = 0; blk < grid; ++blk) {
    emu_run_block(blk, kAxis2Threads, [&] {
      axis2_apply_kernel(x_re.data(), x_im.data(), a_re, a_im, b_re, b_im,
                         y_re.data(), y_im.data(), P, k1, M, k2, Q, log_w);
    });
  }
  // float64 reference: A on axis 1, then B on axis 3.
  using C = std::complex<double>;
  std::vector<C> mid(size);
  auto at = [&](long long p, int i, int m, int j, int q) {
    return (((p * n1 + i) * M + m) * n2 + j) * Q + q;
  };
  for (long long p = 0; p < P; ++p)
    for (int I = 0; I < n1; ++I)
      for (int m = 0; m < M; ++m)
        for (int j = 0; j < n2; ++j)
          for (int q = 0; q < Q; ++q) {
            C s = 0;
            for (int i = 0; i < n1; ++i) {
              const long long o = at(p, i, m, j, q);
              s += C(a_re[I * n1 + i], a_im[I * n1 + i]) * C(x_re[o], x_im[o]);
            }
            mid[at(p, I, m, j, q)] = s;
          }
  double err = 0, norm = 0, got_norm = 0;
  for (long long p = 0; p < P; ++p)
    for (int I = 0; I < n1; ++I)
      for (int m = 0; m < M; ++m)
        for (int J = 0; J < n2; ++J)
          for (int q = 0; q < Q; ++q) {
            C s = 0;
            for (int j = 0; j < n2; ++j) {
              s += C(b_re[J * n2 + j], b_im[J * n2 + j]) * mid[at(p, I, m, j, q)];
            }
            const long long o = at(p, I, m, J, q);
            const C got(y_re[o], y_im[o]);
            err += std::norm(got - s);
            norm += std::norm(s);
            got_norm += std::norm(got);
          }
  printf("{\"rel_err\": %.6e, \"norm_ratio\": %.10f, \"slabs\": %lld, "
         "\"grid\": %d}\n",
         std::sqrt(err / norm), std::sqrt(got_norm / norm), slabs, grid);
  return 0;
}
'''

# Bodies of the source's PTX helpers, replaced by their emulations.
EMULATED = {
    "cp_async_16": "std::memcpy(dst, src, 16);",
    "cp_async_4": "std::memcpy(dst, src, 4);",
    "cp_async_commit": "",
    "cp_async_wait_prior": "",
    "cp_async_wait_all": "",
    "mma_tf32": "emu_mma(d, a, b);",
    "mma_tf32_first": "for (int e = 0; e < 4; ++e) d[e] = 0.f;\n"
                      "  emu_mma(d, a, b);",
}


def body_span(source: str, name: str) -> tuple:
  """(start, end) of the body of device function `name`, inside its
  braces, found by the name and a balanced brace scan."""
  m = re.search(r"__device__[\w\s]*?\bvoid\s+" + name + r"\s*\(", source)
  assert m, f"no device function {name} in {SOURCE.name}"
  start = source.index("{", m.end()) + 1
  depth = 1
  for i in range(start, len(source)):
    depth += {"{": 1, "}": -1}.get(source[i], 0)
    if depth == 0:
      return start, i
  raise AssertionError(f"unbalanced braces in {name}")


def emulable(source: str) -> str:
  """The kernel source with the CUDA headers, launches and PTX replaced."""
  s = source.replace("#include <cooperative_groups.h>",
                     '#include "emu_cuda.h"')
  s = s.replace("#include <cuda_runtime.h>", "")
  s = re.sub(r"<<<.*?>>>", "", s, flags=re.S)
  s = s.replace("extern __shared__ float smem[];", "float* smem = emu_smem;")
  for name, body in EMULATED.items():
    start, end = body_span(s, name)
    s = s[:start] + "\n  " + body + "\n" + s[end:]
  assert not re.search(r"^\s*asm", s, flags=re.M), "PTX left unemulated"
  return s


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
  gxx = shutil.which("g++")
  assert gxx, "g++ builds the emulated kernel"
  tmp = tmp_path_factory.mktemp("k1_emu")
  (tmp / "emu_cuda.h").write_text(EMU_CUDA_H)
  (tmp / "k1_driver.cc").write_text(DRIVER_CC)
  kernel = tmp / "kernel.cpp"
  kernel.write_text(emulable(SOURCE.read_text()))
  exe = tmp / "k1_driver"
  subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-w", f"-I{tmp}",
                  f'-DKERNEL_SOURCE="{kernel}"', str(tmp / "k1_driver.cc"),
                  "-o", str(exe)], check=True, timeout=600)
  return exe


# (P, k1, M, k2, Q, blocks, operator offset in floats): views of
# `hopper_sv.apply_pass`, cut to a few slabs.
VIEWS = {
    "24q pass 1, (0,7) x minor, 2 slabs a block": (1, 7, 2, 7, 1, 1, 0),
    "24q pass 2, (7,7) x (14,3), W=16": (2, 7, 1, 3, 32, 2, 0),
    "N2=64 at W=2, the scalar slab path": (1, 7, 1, 6, 4, 2, 0),
    "N1=64 x N2=32 at W=8": (1, 6, 2, 5, 16, 3, 0),
    "N1=2 (FMA) x N2=16 (MMA)": (3, 1, 1, 4, 2, 2, 0),
    "unaligned operators, 4-byte copies": (1, 5, 2, 4, 8, 2, 3),
}


@pytest.mark.parametrize("view", list(VIEWS))
def test_k1_source_matches_float64_under_truncating_accumulation(driver,
                                                                 view):
  """Within 1e-6 relative L2 of the float64 product (the card's gate
  against the fp32 plain version is 1e-5; one accumulator over K = 128
  gave ~4e-6 here and 3.4e-6 on the card), and no shrink of the norm
  beyond 5e-7."""
  out = subprocess.run([str(driver), *map(str, VIEWS[view]), "1"],
                       capture_output=True, text=True, check=True,
                       timeout=600).stdout
  got = {k: float(v) for k, v in re.findall(r'"(\w+)": ([-\w.+]+)', out)}
  assert got["rel_err"] < 1e-6, out
  assert abs(got["norm_ratio"] - 1) < 5e-7, out
