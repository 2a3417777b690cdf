"""The kernel launchers' cached launch geometry, run on the CPU.

`csrc/statevector_kernels.cu` asks the CUDA runtime for a kernel's launch
geometry (the SM count, its dynamic shared-memory limit and carveout, its
occupancy) at the kernel's first launch on a device and caches it
(`sm_count`, `blocks_per_sm`, `persistent_grid`, `sweep_blocks`).  Here the
host code of that source is compiled with g++ against the stand-in runtime
of `test_torch_k1_emulated.py`, with the runtime's attribute and occupancy
calls replaced by recorders, and the launchers' helpers are called as a
train step calls them: one kernel at several shared-memory sizes in turn.
A launch is valid only if the kernel's shared-memory limit is at least the
launch's, so the cache may raise that limit but never lower it.
"""

import json
import shutil
import subprocess

import pytest

from tests.test_torch_k1_emulated import (EMU_CUDA_H, EMU_RUNTIME_CC,
                                          SOURCE, emulable)

# The stand-in runtime's host stubs, and the recorders that replace them.
STUBS = {
    "inline int cudaDeviceGetAttribute(int*, int, int) { return 0; }":
        "int emu_device_attribute(int* v, int attr, int dev);\n"
        "inline int cudaDeviceGetAttribute(int* v, int attr, int dev) {\n"
        "  return emu_device_attribute(v, attr, dev);\n}",
    "template <class K>\nint cudaFuncSetAttribute(K, int, int) { return 0; }":
        "int emu_set_attribute(const void* kernel, int attr, int value);\n"
        "template <class K>\nint cudaFuncSetAttribute(K k, int attr, int v) {\n"
        "  return emu_set_attribute((const void*)k, attr, v);\n}",
    "template <class K>\nint cudaOccupancyMaxActiveBlocksPerMultiprocessor("
    "int*, K, int, size_t) {\n  return 0;\n}":
        "int emu_occupancy(int* n, const void* k, int threads, size_t smem);\n"
        "template <class K>\nint cudaOccupancyMaxActiveBlocksPerMultiprocessor("
        "int* n, K k, int threads, size_t smem) {\n"
        "  return emu_occupancy(n, (const void*)k, threads, smem);\n}",
}

DRIVER_CC = r'''// Calls the launchers' geometry helpers of a preprocessed copy
// of qhbmlib_tpu_torch/csrc/statevector_kernels.cu (KERNEL_SOURCE) with the
// runtime's attribute and occupancy calls recorded, and prints one JSON
// line a call: the helper's answer, whether a launch of that size would be
// valid (the kernel's shared-memory limit >= its size), and the runtime
// calls made so far.
#include <cstdio>
#include <map>
#include <utility>

#include KERNEL_SOURCE
''' + EMU_RUNTIME_CC + r'''
std::map<std::pair<const void*, int>, int> attrs;  // (kernel, attr) -> value
int sets = 0, occupancy = 0, device_queries = 0;

int emu_set_attribute(const void* kernel, int attr, int value) {
  ++sets;
  attrs[{kernel, attr}] = value;
  return 0;
}
int emu_occupancy(int* n, const void*, int, size_t smem) {
  ++occupancy;
  *n = smem ? (int)(232448 / smem) : 8;
  return 0;
}
int emu_device_attribute(int* v, int attr, int) {
  ++device_queries;
  *v = attr == cudaDevAttrMultiProcessorCount ? 132 : 1;
  return 0;
}

void report(const char* what, long long answer, const void* kernel,
            size_t smem) {
  const int limit =
      attrs[{kernel, (int)cudaFuncAttributeMaxDynamicSharedMemorySize}];
  printf("{\"what\": \"%s\", \"smem\": %zu, \"answer\": %lld, "
         "\"valid\": %s, \"sets\": %d, \"occupancy\": %d, "
         "\"device_queries\": %d}\n",
         what, smem, answer, (size_t)limit >= smem ? "true" : "false", sets,
         occupancy, device_queries);
}

int main() {
  // K1's slab buffers at two sizes, larger first, as a 24q step's two
  // passes launch them, twice over.
  const size_t sizes[] = {131072 + Axis2Block::kPanelSmem,
                          65536 + Axis2Block::kPanelSmem};
  for (int i = 0; i < 4; ++i) {
    const size_t smem = sizes[i % 2];
    const int grid =
        persistent_grid(axis2_apply_kernel, kAxis2Threads, smem, 1 << 20);
    report("axis2_apply", grid, (const void*)axis2_apply_kernel, smem);
  }
  for (int i = 0; i < 2; ++i) {
    report("sweep_blocks", qhbm_sweep_blocks(2),
           (const void*)sweep_kernel<2>, kSweepSmem);
  }
  return 0;
}
'''


@pytest.fixture(scope="module")
def calls(tmp_path_factory):
  gxx = shutil.which("g++")
  assert gxx, "g++ builds the emulated launchers"
  header = EMU_CUDA_H
  for stub, recorder in STUBS.items():
    assert stub in header, f"stand-in runtime stub changed: {stub!r}"
    header = header.replace(stub, recorder)
  tmp = tmp_path_factory.mktemp("launch_cache")
  (tmp / "emu_cuda.h").write_text(header)
  (tmp / "driver.cc").write_text(DRIVER_CC)
  kernel = tmp / "kernel.cpp"
  kernel.write_text(emulable(SOURCE.read_text()))
  exe = tmp / "driver"
  subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-w", f"-I{tmp}",
                  f'-DKERNEL_SOURCE="{kernel}"', str(tmp / "driver.cc"),
                  "-o", str(exe)], check=True, timeout=600)
  out = subprocess.run([str(exe)], capture_output=True, text=True,
                       check=True, timeout=60).stdout
  return [json.loads(line) for line in out.splitlines()]


def test_shared_memory_limit_is_raised_never_lowered(calls):
  """Every launch, larger or smaller than the last, stays within the
  kernel's limit: the smaller size after the larger does not lower it."""
  assert [c["valid"] for c in calls] == [True] * 6, calls
  k1 = [c for c in calls if c["what"] == "axis2_apply"]
  assert k1[0]["smem"] > k1[1]["smem"], k1
  # One persistent block per resident slot: 132 SMs x the recorded fit.
  assert [c["answer"] for c in k1] == [132 * (232448 // c["smem"])
                                       for c in k1], k1


def test_launch_geometry_is_asked_once(calls):
  """The runtime is asked at each size's first launch and never after: two
  occupancy queries for K1's two sizes, one for the sweep kernel; one SM
  count and one cooperative-launch query a device."""
  k1 = [c for c in calls if c["what"] == "axis2_apply"]
  assert [c["occupancy"] for c in k1] == [1, 2, 2, 2], k1
  assert k1[-1]["sets"] == k1[1]["sets"] == 1, k1  # the larger size only
  assert k1[-1]["device_queries"] == 1, k1  # the SM count
  sweep = [c for c in calls if c["what"] == "sweep_blocks"]
  assert sweep[0]["answer"] == sweep[1]["answer"] > 0, sweep
  assert sweep[1]["occupancy"] == sweep[0]["occupancy"] == 3, sweep
  assert sweep[1]["sets"] == sweep[0]["sets"], sweep
  assert sweep[1]["device_queries"] == sweep[0]["device_queries"] == 2, sweep
