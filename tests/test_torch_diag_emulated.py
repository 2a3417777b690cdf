"""The batched engine's diagonal kernels' CUDA source, run on the CPU.

`diag_rotate_kernel` (K4's diagonal stage) and `diag_bilinear_kernel` with
`sum_partials_kernel` (K5's diagonal stage: the parity bilinears and, in
the same pass, the un-apply of a and lambda) in
qhbmlib_tpu_torch/csrc/statevector_kernels.cu run on the card only, where
`chip_smoke.py` holds them against their plain versions.  Here the same
source is compiled with g++ against the stand-in runtime of
`test_torch_k1_emulated.py` (a std::thread per CUDA thread,
`__syncthreads` a barrier, warp shuffles through exchange slots) and run
block by block on the grid the launchers compute (`diag_grid`, for a given
number of SMs), on planes whose values are a hash of (plane, index), so
numpy computes the same float32 inputs.  The views: a cut r2 shape (a small
state, many batch chunks, a part-empty last chunk), a cut 11q one (two
tiles, chunks of 6 states), a cut 20q / 24q one (the whole batch in one
chunk, blocks walking several tiles), K > C factors, odd R (a tile of 96
float4s; a ragged last tile) and a state smaller than a warp's loads.

A mutation that the states check catches: a chunk that skips its last
state (`p.b_end = end < B ? (int)end : B;` made `... - 1`).
"""

import json
import shutil
import subprocess

import numpy as np
import pytest

from tests.test_torch_k1_emulated import (EMU_CUDA_H, EMU_RUNTIME_CC,
                                          SOURCE, emulable)

DRIVER_CC = r'''// Runs diag_rotate_kernel or diag_bilinear_kernel + sum_partials_kernel
// from a preprocessed copy of qhbmlib_tpu_torch/csrc/statevector_kernels.cu
// (included as KERNEL_SOURCE) on the CPU, block by block, on the grid
// diag_grid gives for `sms` SMs:
//   diag_driver mode B R C K sms out.bin
// mode: rotate1 (one batch, sign +1), rotate2 (two batches, sign -1),
// bilinear (no un-apply) or fused (bilinears and the un-apply).  Writes the
// four planes after the run, then the K bilinears, as float32 to out.bin;
// prints the grid as one JSON line.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

#include KERNEL_SOURCE
''' + EMU_RUNTIME_CC + r'''

// A float in [-1, 1) from a hash of (plane, index).
static float value(uint32_t plane, uint32_t i) {
  uint32_t h = i * 2654435761u ^ plane * 0x9E3779B9u;
  h ^= h >> 16;
  h *= 0x45d9f3bu;
  h ^= h >> 16;
  return (float)((h >> 8) & 0xffffu) / 32768.0f - 1.0f;
}

static uint32_t mask(uint32_t plane, uint32_t k) {
  uint32_t h = k * 0x85ebca6bu ^ plane * 0xc2b2ae35u;
  h ^= h >> 13;
  h *= 0x27d4eb2fu;
  h ^= h >> 15;
  return h;
}

int main(int argc, char** argv) {
  if (argc != 8) return 2;
  const std::string mode = argv[1];
  const int B = atoi(argv[2]), R = atoi(argv[3]), C = atoi(argv[4]);
  const int K = atoi(argv[5]), sms = atoi(argv[6]);
  const long long size = (long long)R * C;
  const long long size4 = size / 4;
  std::vector<float4> planes[4];  // l_re, l_im, a_re, a_im
  for (int pl = 0; pl < 4; ++pl) {
    planes[pl].resize(B * size4);
    float* f = reinterpret_cast<float*>(planes[pl].data());
    for (long long i = 0; i < B * size; ++i) f[i] = value(pl, (uint32_t)i);
  }
  std::vector<float4> cs(size4), sn(size4);
  for (long long i = 0; i < size; ++i) {
    reinterpret_cast<float*>(cs.data())[i] = value(4, (uint32_t)i);
    reinterpret_cast<float*>(sn.data())[i] = value(5, (uint32_t)i);
  }
  std::vector<int> rm(K), cm(K);
  for (int k = 0; k < K; ++k) {
    rm[k] = (int)(mask(6, k) & 0xffffu);
    cm[k] = (int)(mask(7, k) & (uint32_t)(C - 1));
  }
  const DiagGrid g = diag_grid(B, size4, (long long)sms * kDiagBlocksPerSm);
  std::vector<float> partial((size_t)g.blocks() * K, NAN), out(K, NAN);
  gridDim = dim3(g.blocks());
  blockDim = dim3(kDiagThreads);
  for (int blk = 0; blk < g.blocks(); ++blk) {
    emu_run_block(blk, kDiagThreads, [&] {
      if (mode == "rotate1") {
        diag_rotate_kernel<false>(planes[0].data(), planes[1].data(), nullptr,
                                  nullptr, B, size4, g, cs.data(), sn.data(),
                                  1.f);
      } else if (mode == "rotate2") {
        diag_rotate_kernel<true>(planes[0].data(), planes[1].data(),
                                 planes[2].data(), planes[3].data(), B, size4,
                                 g, cs.data(), sn.data(), -1.f);
      } else if (mode == "fused") {
        diag_bilinear_kernel<true>(planes[0].data(), planes[1].data(),
                                   planes[2].data(), planes[3].data(),
                                   cs.data(), sn.data(), rm.data(), cm.data(),
                                   K, B, R, C, g, partial.data());
      } else {
        diag_bilinear_kernel<false>(planes[0].data(), planes[1].data(),
                                    planes[2].data(), planes[3].data(),
                                    nullptr, nullptr, rm.data(), cm.data(), K,
                                    B, R, C, g, partial.data());
      }
    });
  }
  if (mode == "fused" || mode == "bilinear") {
    const int sum_blocks = (K + 7) / 8;
    gridDim = dim3(sum_blocks);
    blockDim = dim3(256);
    for (int blk = 0; blk < sum_blocks; ++blk) {
      emu_run_block(blk, 256, [&] {
        sum_partials_kernel(partial.data(), g.blocks(), K, out.data());
      });
    }
  }
  FILE* f = fopen(argv[7], "wb");
  for (int pl = 0; pl < 4; ++pl) {
    fwrite(planes[pl].data(), sizeof(float4), planes[pl].size(), f);
  }
  fwrite(out.data(), sizeof(float), out.size(), f);
  fclose(f);
  printf("{\"tile4\": %d, \"lanes\": %d, \"tiles\": %lld, \"tiles_grid\": %d, "
         "\"chunk\": %d, \"chunks\": %d, \"blocks\": %d}\n",
         g.tile4, g.lanes, g.tiles, g.tiles_grid, g.chunk, g.chunks,
         g.blocks());
  return 0;
}
'''


def _hash(plane, idx):
  """The driver's `value` in numpy: the same float32 for each index."""
  h = idx.astype(np.uint32) * np.uint32(2654435761)
  h ^= np.uint32(plane * 0x9E3779B9 & 0xffffffff)
  h ^= h >> np.uint32(16)
  h *= np.uint32(0x45d9f3b)
  h ^= h >> np.uint32(16)
  return ((h >> np.uint32(8)) & np.uint32(0xffff)).astype(
      np.float64) / 32768.0 - 1.0


def _mask(plane, k):
  """The driver's `mask` in numpy."""
  h = k.astype(np.uint32) * np.uint32(0x85ebca6b)
  h ^= np.uint32(plane * 0xc2b2ae35 & 0xffffffff)
  h ^= h >> np.uint32(13)
  h *= np.uint32(0x27d4eb2f)
  h ^= h >> np.uint32(15)
  return h.astype(np.int64)


def _signs(masks, size):
  """[K, size] float64 s(i & mask_k)."""
  bits = np.arange(size)[None, :] & masks[:, None]
  parity = np.array([[bin(int(x)).count("1") & 1 for x in row]
                     for row in bits])
  return 1.0 - 2.0 * parity


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
  gxx = shutil.which("g++")
  assert gxx, "g++ builds the emulated kernel"
  tmp = tmp_path_factory.mktemp("diag_emu")
  (tmp / "emu_cuda.h").write_text(EMU_CUDA_H)
  (tmp / "diag_driver.cc").write_text(DRIVER_CC)
  kernel = tmp / "kernel.cpp"
  kernel.write_text(emulable(SOURCE.read_text()))
  exe = tmp / "diag_driver"
  subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-w", f"-I{tmp}",
                  f'-DKERNEL_SOURCE="{kernel}"', str(tmp / "diag_driver.cc"),
                  "-o", str(exe)], check=True, timeout=600)
  return exe, tmp


def _run(driver, mode, b, r, c, k, sms):
  exe, tmp = driver
  path = tmp / f"{mode}_{b}_{r}_{c}_{k}_{sms}.bin"
  grid = json.loads(subprocess.run(
      [str(exe), mode, *map(str, (b, r, c, k, sms)), str(path)],
      capture_output=True, text=True, check=True, timeout=600).stdout)
  raw = np.fromfile(path, dtype=np.float32).astype(np.float64)
  size = b * r * c
  planes = raw[:4 * size].reshape(4, b, r, c)
  return grid, planes, raw[4 * size:]


def _inputs(b, r, c, k):
  """The driver's planes, cos/sin planes and masks in float64."""
  size = b * r * c
  planes = np.stack([_hash(pl, np.arange(size)).reshape(b, r, c)
                     for pl in range(4)])
  cos_t, sin_t = (_hash(pl, np.arange(r * c)).reshape(r, c)
                  for pl in (4, 5))
  ks = np.arange(k)
  return planes, cos_t, sin_t, _mask(6, ks) & 0xffff, _mask(7, ks) & (c - 1)


def _rotated(re, im, cos_t, sin_t, sign):
  s = sign * sin_t
  return cos_t * re - s * im, cos_t * im + s * re


def _rel(x, ref):
  return np.linalg.norm(x - ref) / np.linalg.norm(ref)


# (B, R, C, K, SMs): the grid each view must give.
VIEWS = {
    # 8q's (R, C) = (2, 128) at B = 37 on 4 SMs: a 64-float4 tile, 4 lanes,
    # chunks of 4 states, the last holding 1.
    "r2 8q, many chunks, a part-empty last": (37, 2, 128, 21, 4),
    # 11q's (16, 128) at B = 45 on 2 SMs: two tiles, chunks of 6 states
    # (two groups a lane), the last holding 3.
    "r2 11q, two tiles, chunks of 6 states": (45, 16, 128, 21, 2),
    # 14q's (128, 128) at B = 9 on 1 SM: 16 tiles >= a wave of 8 blocks,
    # so the chunk is the whole batch (three groups of states a lane) and
    # each block walks two tiles.
    "20q / 24q, the whole batch in one chunk": (9, 128, 128, 140, 1),
    "K = 300 > C = 128 factors": (5, 8, 128, 300, 2),
    "odd R = 3: a 96-float4 tile, two lanes": (6, 3, 128, 9, 2),
    "odd R = 11: a ragged last tile": (4, 11, 128, 33, 1),
    "3q: a state of two float4s": (9, 1, 8, 5, 1),
}


def _expected_grid(b, r, c, sms):
  size4 = r * c // 4
  tile4 = min(size4, 256)
  lanes = 256 // tile4
  tiles = -(-size4 // tile4)
  wave = 8 * sms
  want = wave // tiles
  if want <= 1:
    return dict(tile4=tile4, lanes=lanes, tiles=tiles,
                tiles_grid=min(tiles, wave), chunk=b, chunks=1)
  chunk = -(-b // (want * lanes)) * lanes
  return dict(tile4=tile4, lanes=lanes, tiles=tiles, tiles_grid=tiles,
              chunk=chunk, chunks=-(-b // chunk))


def test_views_cover_the_grid_regimes():
  """The views give what their names say: many chunks with a part-empty
  last one, two groups of states a lane, the whole batch in one chunk with
  blocks walking tiles, lanes over states, a ragged last tile."""
  grids = {v: _expected_grid(b, r, c, sms)
           for v, (b, r, c, _, sms) in VIEWS.items()}
  g = grids["r2 8q, many chunks, a part-empty last"]
  assert (g["lanes"], g["chunk"], g["chunks"]) == (4, 4, 10)
  assert 37 % g["chunk"] == 1
  g = grids["r2 11q, two tiles, chunks of 6 states"]
  assert (g["tiles"], g["lanes"], g["chunk"], g["chunks"]) == (2, 1, 6, 8)
  g = grids["20q / 24q, the whole batch in one chunk"]
  assert (g["chunks"], g["chunk"], g["tiles"], g["tiles_grid"]) == (1, 9,
                                                                    16, 8)
  assert grids["odd R = 3: a 96-float4 tile, two lanes"]["tile4"] == 96
  assert grids["odd R = 11: a ragged last tile"]["tiles"] == 2


@pytest.mark.parametrize("view", list(VIEWS))
def test_fused_stage_matches_float64(driver, view):
  """diag_bilinear_kernel with the un-apply: a and lambda rotated by
  exp(-i theta) within 1e-6 relative L2 of float64 numpy (a complex
  multiply each), the K batch-summed bilinears of the states BEFORE the
  rotation within 1e-5 (float32 sums of up to 10^4 products), on the
  launcher's grid."""
  b, r, c, k, sms = VIEWS[view]
  grid, got, bilin = _run(driver, "fused", b, r, c, k, sms)
  want = _expected_grid(b, r, c, sms)
  assert {key: grid[key] for key in want} == want
  (l_re, l_im, a_re, a_im), cos_t, sin_t, rms, cms = _inputs(b, r, c, k)
  for (re, im), (got_re, got_im) in (((l_re, l_im), got[:2]),
                                     ((a_re, a_im), got[2:])):
    ref = np.stack(_rotated(re, im, cos_t, sin_t, -1))
    assert _rel(np.stack([got_re, got_im]), ref) < 1e-6, view
  p = (l_re * a_im - l_im * a_re).sum(axis=0)
  expected = np.einsum("kr,rc,kc->k", _signs(rms, r), p, _signs(cms, c))
  assert _rel(bilin, expected) < 1e-5, view


@pytest.mark.parametrize("view", ["r2 8q, many chunks, a part-empty last",
                                  "20q / 24q, the whole batch in one chunk",
                                  "odd R = 11: a ragged last tile"])
def test_bilinear_alone_leaves_the_states(driver, view):
  """Without the cos/sin planes the kernel only reduces: the states come
  back bit for bit, the bilinears as with the un-apply."""
  b, r, c, k, sms = VIEWS[view]
  _, got, bilin = _run(driver, "bilinear", b, r, c, k, sms)
  planes, _, _, rms, cms = _inputs(b, r, c, k)
  np.testing.assert_array_equal(got, planes.astype(np.float32))
  p = (planes[0] * planes[3] - planes[1] * planes[2]).sum(axis=0)
  expected = np.einsum("kr,rc,kc->k", _signs(rms, r), p, _signs(cms, c))
  assert _rel(bilin, expected) < 1e-5, view


@pytest.mark.parametrize("mode,sign", [("rotate1", 1), ("rotate2", -1)])
@pytest.mark.parametrize("view", ["r2 8q, many chunks, a part-empty last",
                                  "r2 11q, two tiles, chunks of 6 states",
                                  "20q / 24q, the whole batch in one chunk",
                                  "odd R = 3: a 96-float4 tile, two lanes",
                                  "3q: a state of two float4s"])
def test_diag_rotate_matches_float64(driver, view, mode, sign):
  """diag_rotate_kernel on one batch (the forward, sign +1) or two (sign
  -1): within 1e-6 relative L2 of float64 numpy; a second batch it was not
  given stays as it was."""
  b, r, c, _, sms = VIEWS[view]
  _, got, _ = _run(driver, mode, b, r, c, 0, sms)
  planes, cos_t, sin_t, _, _ = _inputs(b, r, c, 0)
  ref = np.stack(_rotated(planes[0], planes[1], cos_t, sin_t, sign))
  assert _rel(got[:2], ref) < 1e-6, view
  if mode == "rotate2":
    ref = np.stack(_rotated(planes[2], planes[3], cos_t, sin_t, sign))
    assert _rel(got[2:], ref) < 1e-6, view
  else:
    np.testing.assert_array_equal(got[2:], planes[2:].astype(np.float32))
