"""K5's `qubit_transitions` CUDA source, run on the CPU.

`qubit_transitions_kernel` and `transitions_finish_kernel`
(qhbmlib_tpu_torch/csrc/statevector_kernels.cu) run on the card only, where
`chip_smoke.py` holds them against their plain version.  Here the same
source, with the pass planner `plan_transitions`, is compiled with g++
against the stand-in runtime of `test_torch_k1_emulated.py` (a std::thread
per CUDA thread, `__syncthreads` a barrier, cp.async a copy) and run block
by block on planes whose values are a hash of (plane, index), so numpy
computes the same float32 inputs.  Each pass is cut to its first few tiles
at the 24-, 25- and 20-qubit views (every tile at the small ones), and
each qubit's 2x2 transition is held against float64 numpy over the
amplitudes of the tiles that its pass ran: that checks the plan (which bits
each pass tiles, in how many passes), the tiles' origins and offsets, the
layouts' pairings, the partials and their sum.  The planner alone is
checked at every state size it takes.
"""

import json
import shutil
import subprocess

import numpy as np
import pytest

from tests.test_torch_k1_emulated import (EMU_CUDA_H, EMU_RUNTIME_CC,
                                          SOURCE, emulable)

DRIVER_CC = r'''// Runs qubit_transitions_kernel and transitions_finish_kernel from a
// preprocessed copy of qhbmlib_tpu_torch/csrc/statevector_kernels.cu
// (included as KERNEL_SOURCE) on the CPU, block by block, for every qubit
// of B states of n qubits, each pass cut to its first `cut` tiles (0: all),
// on `grid` blocks (0: the plan alone, no kernel run):
//   k5_driver n B cut grid
// Prints one JSON line: each pass's tile bits, tiles and layouts, and the
// transitions [n, 2, 2, 2] (none for the plan alone).  Exits 3 where the
// planner refuses n.
#include <cstdint>
#include <cstdio>
#include <cstdlib>

#include KERNEL_SOURCE
''' + EMU_RUNTIME_CC + r'''

// The input planes: a float in [-1, 1) from a hash of (plane, index).
static float value(uint32_t plane, uint32_t i) {
  uint32_t h = i * 2654435761u ^ plane * 0x9E3779B9u;
  h ^= h >> 16;
  h *= 0x45d9f3bu;
  h ^= h >> 16;
  return (float)((h >> 8) & 0xffffu) / 32768.0f - 1.0f;
}

// Runs the kernels block by block on `grid` blocks, each pass cut to its
// first `cut` tiles (0: all); returns the transitions of every qubit.
static std::vector<float> run(int n, int B, long long cut, int grid,
                              TransPlan& plan, const int* pass_of_bit,
                              const int* slot_of_bit,
                              const int* margin_of_bit) {
  long long most = 0;
  for (int p = 0; p < plan.passes; ++p) {
    if (cut > 0 && plan.pass[p].tiles > cut) plan.pass[p].tiles = cut;
    if (plan.pass[p].tiles > most) most = plan.pass[p].tiles;
  }
  if (grid > most) grid = (int)most;
  const long long size = (long long)B << n;
  std::vector<float> planes[4];
  for (int pl = 0; pl < 4; ++pl) {
    planes[pl].resize(size);
    for (long long i = 0; i < size; ++i) planes[pl][i] = value(pl, (uint32_t)i);
  }
  std::vector<float> partial((size_t)grid * kTransMaxPasses * kTransPartial,
                             NAN);
  gridDim = dim3(grid);
  blockDim = dim3(kTransThreads);
  for (int blk = 0; blk < grid; ++blk) {
    emu_run_block(blk, kTransThreads, [&] {
      qubit_transitions_kernel(planes[0].data(), planes[1].data(),
                               planes[2].data(), planes[3].data(), plan,
                               partial.data());
    });
  }
  TransPick pick;
  pick.count = n;
  for (int q = 0; q < n; ++q) {
    pick.pass[q] = pass_of_bit[n - 1 - q];
    pick.slot[q] = slot_of_bit[n - 1 - q];
    pick.margin[q] = margin_of_bit[n - 1 - q];
  }
  std::vector<float> out(8 * n, NAN);
  gridDim = dim3(1);
  blockDim = dim3(kTransMaxQubits * 8);
  for (int t = 0; t < kTransMaxQubits * 8; ++t) {
    threadIdx = dim3(t);
    blockIdx = dim3(0);
    transitions_finish_kernel(partial.data(), grid, pick, out.data());
  }
  return out;
}

int main(int argc, char** argv) {
  if (argc != 5) return 2;
  const int n = atoi(argv[1]), B = atoi(argv[2]);
  const long long cut = atoll(argv[3]);
  const int grid = atoi(argv[4]);
  TransPlan plan;
  int pass_of_bit[kTransMaxStateBits], slot_of_bit[kTransMaxStateBits];
  int margin_of_bit[kTransMaxStateBits];
  if (!plan_transitions(n, B, &plan, pass_of_bit, slot_of_bit,
                        margin_of_bit)) {
    return 3;
  }
  std::vector<float> out;
  if (grid > 0) {
    out = run(n, B, cut, grid, plan, pass_of_bit, slot_of_bit, margin_of_bit);
  }
  printf("{\"passes\": [");
  for (int p = 0; p < plan.passes; ++p) {
    const TransPass& ps = plan.pass[p];
    printf("%s{\"bits\": [", p ? ", " : "");
    for (int t = 0; t < ps.bits; ++t) printf("%s%d", t ? ", " : "", ps.tile_bit[t]);
    printf("], \"tiles\": %lld, \"layouts\": [", ps.tiles);
    for (int l = 0; l < ps.layouts; ++l) {
      printf("%s[%d, %d]", l ? ", " : "", ps.j1[l], ps.j2[l]);
    }
    printf("]}");
  }
  printf("], \"out\": [");
  for (size_t i = 0; i < out.size(); ++i) {
    printf("%s%.9e", i ? ", " : "", out[i]);
  }
  printf("]}\n");
  return 0;
}
'''


def _values(plane, idx):
  """The driver's `value` in numpy: the same float32 for each index."""
  h = idx.astype(np.uint32) * np.uint32(2654435761)
  h ^= np.uint32(plane * 0x9E3779B9 & 0xffffffff)
  h ^= h >> np.uint32(16)
  h *= np.uint32(0x45d9f3b)
  h ^= h >> np.uint32(16)
  return ((h >> np.uint32(8)) & np.uint32(0xffff)).astype(
      np.float64) / 32768.0 - 1.0


def _deposit(values, positions):
  """Each value's bits 0, 1, ... moved to bits positions[0], [1], ..."""
  out = np.zeros_like(values)
  for k, pos in enumerate(positions):
    out |= ((values >> k) & 1) << pos
  return out


def _reference(n, passes):
  """[n, 2, 2, 2] float64 transitions: qubit q (state-index bit n-1-q)
  from the first pass whose tile holds its bit, over that pass's tiles;
  tile u of a pass is state u >> len(rest), its rest bits (ascending) set
  from u's low bits."""
  out = np.full((n, 2, 2, 2), np.nan)
  for q in range(n):
    bit = n - 1 - q
    ps = next(p for p in passes if bit in p["bits"])
    tile_bits = ps["bits"]
    rest = [b for b in range(n) if b not in tile_bits]
    u = np.arange(ps["tiles"], dtype=np.int64)
    origin = ((u >> len(rest)) << n) | _deposit(u & ((1 << len(rest)) - 1),
                                                rest)
    t = np.arange(1 << len(tile_bits), dtype=np.int64)
    idx = (origin[:, None] | _deposit(t, tile_bits)[None, :]).ravel()
    x0 = idx[(idx >> bit) & 1 == 0]
    pair = (x0, x0 | (1 << bit))
    lam = [_values(0, x) + 1j * _values(1, x) for x in pair]
    a = [_values(2, x) + 1j * _values(3, x) for x in pair]
    t_q = np.array([[np.sum(lam[i].conj() * a[j]) for j in range(2)]
                    for i in range(2)])
    out[q] = np.stack([t_q.real, t_q.imag])
  return out


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
  gxx = shutil.which("g++")
  assert gxx, "g++ builds the emulated kernel"
  tmp = tmp_path_factory.mktemp("k5_emu")
  (tmp / "emu_cuda.h").write_text(EMU_CUDA_H)
  (tmp / "k5_driver.cc").write_text(DRIVER_CC)
  kernel = tmp / "kernel.cpp"
  kernel.write_text(emulable(SOURCE.read_text()))
  exe = tmp / "k5_driver"
  subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-w", f"-I{tmp}",
                  f'-DKERNEL_SOURCE="{kernel}"', str(tmp / "k5_driver.cc"),
                  "-o", str(exe)], check=True, timeout=600)
  return exe


# (n, B, tiles a pass (0: all), blocks, passes).  The 24q and 20q views are
# the main path's, cut to a few tiles; the 25q view is the three-pass plan
# of 25 to 30 qubits; then a batch over several tiles a state, a single
# pass, and a tile padded with zeros.
VIEWS = {
    "24q: two passes, the second in 16-byte runs": (24, 1, 3, 2, 2),
    "20q B=2: two passes, the second in 256-byte runs": (20, 2, 3, 2, 2),
    "25q: three passes, the third in 16-KB runs": (25, 1, 2, 2, 3),
    "14q B=3, every tile": (14, 3, 0, 4, 2),
    "9q B=2, one 9-bit pass": (9, 2, 0, 2, 1),
    "3q B=2, one tile padded with zeros": (3, 2, 0, 1, 1),
}
TILE_BITS = 13  # kTransMaxBits: 2^13 amplitudes of four planes, 128 KB
MIN_RUN = 2  # kTransMinRun: low bits each pass after the first keeps


def _check_plan(n, passes):
  """Every bit in some pass's tile, each pass's tile at most TILE_BITS bits
  with bits 0 and 1 in it, each later pass its lowest MIN_RUN or more bits
  and then bits no earlier pass took, and layouts that cover the float4
  index bits of a half-tile, none with two bits below 4 in a full tile
  (the conflict-free rule of `trans_swizzle`)."""
  taken = set()
  for p in passes:
    bits, width = p["bits"], len(p["bits"])
    fresh = [b for b in bits if b not in taken]
    run = width - len(fresh)
    assert width <= TILE_BITS and bits[:2] == [0, 1]
    assert bits[:run] == list(range(run)) and (not taken or run >= MIN_RUN)
    assert fresh == list(range(len(taken), len(taken) + len(fresh)))
    taken |= set(fresh)
    covered = {j for pair in p["layouts"] for j in pair}
    assert covered == set(range(max(width, 5) - 2))
    if width == TILE_BITS:
      assert all(min(pair) >= 4 or max(pair) >= 4 for pair in p["layouts"])
  assert taken == set(range(n))


@pytest.mark.parametrize("view", list(VIEWS))
def test_k5_source_matches_float64(driver, view):
  """Within 1e-6 relative L2 of float64 numpy (the card's gate against the
  plain version is 1e-4; float32 sums of a few thousand products here), in
  the expected number of passes (HBM reads of the planes), on a plan that
  `_check_plan` accepts."""
  n, b, cut, grid, passes = VIEWS[view]
  out = subprocess.run([str(driver), *map(str, (n, b, cut, grid))],
                       capture_output=True, text=True, check=True,
                       timeout=600).stdout
  got = json.loads(out)
  assert len(got["passes"]) == passes
  _check_plan(n, got["passes"])
  expected = _reference(n, got["passes"])
  result = np.array(got["out"]).reshape(n, 2, 2, 2)
  err = np.linalg.norm(result - expected) / np.linalg.norm(expected)
  assert err < 1e-6, (err, view)


def test_k5_plan_at_every_state_size(driver):
  """The planner alone at 2 to 30 qubits: one pass (one read of the
  planes) to 13 qubits, two to 24, three to 30, each plan as
  `_check_plan` wants; 1 and 31 qubits refused."""
  for n in range(2, 31):
    out = subprocess.run([str(driver), str(n), "64", "0", "0"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout
    passes = json.loads(out)["passes"]
    assert len(passes) == 1 + (n > TILE_BITS) + (n > 24), n
    _check_plan(n, passes)
  for n in (1, 31):
    assert subprocess.run([str(driver), str(n), "1", "0", "0"],
                          capture_output=True, timeout=60).returncode == 3
