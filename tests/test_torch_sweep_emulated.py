"""K2 / K3's cooperative `sweep_kernel` CUDA source, run on the CPU.

`sweep_kernel<1>` (K3, `hopper_sv.circuit_forward`) and `sweep_kernel<2>`
(K2, `hopper_adjoint.adjoint_sweep`) in
qhbmlib_tpu_torch/csrc/statevector_kernels.cu run on the card only, where
`chip_smoke.py` holds them against their plain versions.  Here the same
source is compiled with g++ against the stand-in runtime of
`test_torch_k1_emulated.py` (a std::thread per CUDA thread, `__syncthreads`
a barrier, cp.async a copy, mma.sync.m16n8k8 tf32 emulated on the PTX
ISA's fragment layouts with the tensor cores' truncating accumulation, warp
shuffles through exchange slots) and run as a whole cooperative grid: every
block's threads at once, `grid.sync()` a barrier over all of them.  The
stage tables are the port's own (`hopper_sv.forward_table`,
`hopper_adjoint.sweep_table`), and the outputs are held against the numpy
model of the stage semantics in float64 (`test_torch_single_state.
_run_table`, itself held against the plain versions and the JAX package):
K3's state, and K2's transitions, bilinears and un-applied states.  The
views cover the axis stage's three routes (N = 64 with the operator split
once, N = 128 with it as fp32 planes, N = 4 on the FMA body), both slab
layouts (rows of columns; whole p's at Q = 1), a state of one slab (the
second block idle, or taking lambda's slab) and of two (a slab a block, or
one block walking both through its one buffer), and the kTrans stage's
one and two passes.
"""

import json
import shutil
import subprocess

import numpy as np
import pytest
import torch

from qhbmlib_tpu_torch.models import circuit_utils
from qhbmlib_tpu_torch.ops import hopper_adjoint
from qhbmlib_tpu_torch.ops import hopper_sv
from qhbmlib_tpu_torch.ops import statevector as sv
from tests.test_torch_k1_emulated import (EMU_CUDA_H, EMU_RUNTIME_CC,
                                          SOURCE, emulable)
from tests.test_torch_single_state import _run_table

torch.set_num_threads(1)

DRIVER_CC = r'''// Runs sweep_kernel<S> from a preprocessed copy of
// qhbmlib_tpu_torch/csrc/statevector_kernels.cu (included as KERNEL_SOURCE)
// on the CPU as one cooperative grid of `grid` blocks:
//   sweep_driver S n m grid num_stages widest out_len dir
// reads dir/{records,masks,data,a,lam}.bin (a and lam: the state's re and
// im planes; lam only for S = 2) and writes dir/{a,lam,out}_out.bin (each
// state's whole 4-plane buffer, the reductions).
#include <cstdio>
#include <cstdlib>
#include <string>

#include KERNEL_SOURCE
''' + EMU_RUNTIME_CC + r'''
template <class T>
static std::vector<T> read(const std::string& path, size_t count) {
  std::vector<T> v(count);
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f || std::fread(v.data(), sizeof(T), count, f) != count) std::exit(3);
  std::fclose(f);
  return v;
}

template <class T>
static void write(const std::string& path, const std::vector<T>& v) {
  FILE* f = std::fopen(path.c_str(), "wb");
  std::fwrite(v.data(), sizeof(T), v.size(), f);
  std::fclose(f);
}

static long long file_count(const std::string& path, size_t item) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) std::exit(3);
  std::fseek(f, 0, SEEK_END);
  const long long bytes = std::ftell(f);
  std::fclose(f);
  return bytes / (long long)item;
}

int main(int argc, char** argv) {
  if (argc != 9) return 2;
  const int S = atoi(argv[1]), n = atoi(argv[2]), m = atoi(argv[3]);
  const int grid = atoi(argv[4]), num_stages = atoi(argv[5]);
  const int widest = atoi(argv[6]), out_len = atoi(argv[7]);
  const std::string dir = argv[8];
  const long long size = 1LL << n;
  auto records = read<int>(dir + "/records.bin", num_stages * kStageInts);
  auto masks = read<int>(dir + "/masks.bin",
                         file_count(dir + "/masks.bin", sizeof(int)));
  auto data = read<float>(dir + "/data.bin",
                          file_count(dir + "/data.bin", sizeof(float)));
  // Each state buffer: the state in planes 0-1, NaN in the ping-pong pair.
  std::vector<float> a(4 * size, NAN), lam(S == 2 ? 4 * size : 0, NAN);
  auto a_in = read<float>(dir + "/a.bin", 2 * size);
  std::copy(a_in.begin(), a_in.end(), a.begin());
  if (S == 2) {
    auto l_in = read<float>(dir + "/lam.bin", 2 * size);
    std::copy(l_in.begin(), l_in.end(), lam.begin());
  }
  std::vector<float> partial((size_t)grid * widest, NAN);
  std::vector<float> out(out_len > 0 ? out_len : 1, NAN);
  gridDim = dim3(grid);
  blockDim = dim3(kApplyThreads);
  emu_run_grid(kApplyThreads, [&] {
    if (S == 1) {
      sweep_kernel<1>(a.data(), nullptr, n, m, records.data(), num_stages,
                      data.data(), masks.data(), nullptr, nullptr);
    } else {
      sweep_kernel<2>(a.data(), lam.data(), n, m, records.data(), num_stages,
                      data.data(), masks.data(), partial.data(), out.data());
    }
  });
  write(dir + "/a_out.bin", a);
  write(dir + "/lam_out.bin", lam);
  write(dir + "/out_out.bin", out);
  printf("{\"grid\": %d, \"stages\": %d}\n", grid, num_stages);
  return 0;
}
'''

@pytest.fixture(scope="module")
def driver(tmp_path_factory):
  gxx = shutil.which("g++")
  assert gxx, "g++ builds the emulated kernel"
  tmp = tmp_path_factory.mktemp("sweep_emu")
  (tmp / "emu_cuda.h").write_text(EMU_CUDA_H)
  (tmp / "sweep_driver.cc").write_text(DRIVER_CC)
  kernel = tmp / "kernel.cpp"
  kernel.write_text(emulable(SOURCE.read_text()))
  exe = tmp / "sweep_driver"
  subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-w", f"-I{tmp}",
                  f'-DKERNEL_SOURCE="{kernel}"', str(tmp / "sweep_driver.cc"),
                  "-o", str(exe)], check=True, timeout=600)
  return exe


# n, layers of the hardware-efficient ansatz (the stage tables' row blocks
# and minor operator (start, k)), blocks of the emulated cooperative launch.
VIEWS = {
    # (0,6) N=64, its operator split once; minor (6,7) N=128, its operator
    # as fp32 planes, at Q=1; one slab a state, so lambda's slab goes to
    # the block a's leaves idle.
    "13q: N=64 split once, N=128 at Q=1, one slab": (13, 1, 2),
    # (0,7) N=128 rows of columns, minor (7,7) at Q=1; two slabs a state;
    # the kTrans stage's second pass (state bit 13).
    "14q: two slabs a stage, two kTrans passes": (14, 1, 2),
    # One block walks both slabs of each stage through its one buffer.
    "14q on one block: two slabs a block": (14, 1, 1),
    # (0,2) N=4 on the FMA body; minor (2,7); a 2^9-amplitude kTrans tile.
    "9q: N=4 on the FMA body": (9, 1, 2),
}


def _case(n, layers, seed):
  pqc = circuit_utils.hardware_efficient_ansatz(n, layers)
  rng = np.random.RandomState(seed)
  values = rng.uniform(-1, 1, pqc.num_symbols).astype(np.float32)
  shape = sv.state_shape(n)

  def state():
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return (x / np.linalg.norm(x)).reshape(-1).astype(np.complex64)

  return pqc, values, state(), state()


def _run(driver, tmp_path, table, states, grid):
  """The emulated launch of `table` on `states` (one or two complex64
  vectors) on `grid` blocks: (each state as the launch leaves it, the
  reductions)."""
  records, masks, data = table.pack()
  records.numpy().astype(np.int32).tofile(tmp_path / "records.bin")
  masks.numpy().astype(np.int32).tofile(tmp_path / "masks.bin")
  data.numpy().astype(np.float32).tofile(tmp_path / "data.bin")
  for name, x in zip(("a", "lam"), states):
    np.concatenate([x.real, x.imag]).astype(np.float32).tofile(
        tmp_path / f"{name}.bin")
  res = subprocess.run(
      [str(driver), str(len(states)), str(table.n), str(table.m), str(grid),
       str(table.num_stages), str(table.widest()), str(table.out_len),
       str(tmp_path)], capture_output=True, text=True, check=True,
      timeout=600)
  assert json.loads(res.stdout)["grid"] == grid
  size = 1 << table.n
  slot = 2 * (table.axis_stages % 2)  # the plane pair the state ends in
  finals = []
  for name in ("a", "lam")[:len(states)]:
    buf = np.fromfile(tmp_path / f"{name}_out.bin", np.float32)
    finals.append(buf[slot * size:(slot + 1) * size] +
                  1j * buf[(slot + 1) * size:(slot + 2) * size])
  out = np.fromfile(tmp_path / "out_out.bin", np.float32)[:table.out_len]
  return finals, out


def _rel(got, ref):
  return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("view", list(VIEWS))
def test_k3_sweep_source_matches_float64(driver, tmp_path, view):
  """K3's state within 1e-6 relative L2 of the float64 model (the card's
  gate against the fp32 plain version is 1e-5), with no NaN: every
  amplitude was written by the stage that owns it."""
  n, layers, grid = VIEWS[view]
  pqc, values, x, _ = _case(n, layers, 70 + n)
  table = hopper_sv.forward_table(pqc, values, "cpu")
  (got,), _ = _run(driver, tmp_path, table, [x], grid)
  (ref,), _ = _run_table(table, [x.astype(np.complex128)])
  assert np.isfinite(got).all()
  assert _rel(got, ref) < 1e-6, _rel(got, ref)


@pytest.mark.parametrize("view", list(VIEWS))
def test_k2_sweep_source_matches_float64(driver, tmp_path, view):
  """K2's reductions, each within 2e-6 relative L2 of the float64 model
  (the card's gradient gate is 1e-4): every kTrans record's [Q, 2, 2, 2]
  transitions and every kBilin record's bilinears; and the un-applied
  states within 1e-6."""
  n, layers, grid = VIEWS[view]
  pqc, values, a, lam = _case(n, layers, 80 + n)
  table, shapes, _ = hopper_adjoint.sweep_table(pqc, values, "cpu")
  assert any(len(s) == 4 for s in shapes) and any(len(s) == 1
                                                  for s in shapes)
  (got_a, got_l), out = _run(driver, tmp_path, table, [a, lam], grid)
  (ref_a, ref_l), ref_out = _run_table(table, [a.astype(np.complex128),
                                               lam.astype(np.complex128)])
  pos = 0
  for shape in shapes:
    size = int(np.prod(shape))
    err = _rel(out[pos:pos + size], ref_out[pos:pos + size])
    assert err < 2e-6, (shape, err)
    pos += size
  assert pos == table.out_len
  for got, ref in ((got_a, ref_a), (got_l, ref_l)):
    assert np.isfinite(got).all()
    assert _rel(got, ref) < 1e-6, _rel(got, ref)
