"""HBM stream probe: what stream rate does the card reach?

The port of `benchmarks/hbm_probe.py`.  It times chained elementwise passes
o = x * v over a float32 [2^(n-7), 128] plane (24 qubits: 64 MB): the plain
PyTorch multiply (`torch_scale`, the counterpart of `xla_scale`) and the
hand-written kernel `stream_scale` (K6, `csrc/stream_kernels.cu`, the port
of `_pallas_scale`) at three tile sizes.  Each pass moves twice the plane's
bytes (one read, one write); the rate is that traffic over the best of 3
repeats of `iters` chained passes.  On the card each chain is captured once
in a CUDA graph (the counterpart of the reference's `jax.jit`) and timed
as one replay with CUDA events, so no host work falls between its passes:
the per-pass stream rate the circuit kernels compare against, beside the
card's 3.35 TB/s.

  python -m qhbmlib_tpu_torch.benchmarks.hbm_probe [--qubits 24] [--iters 32]

Prints one JSON line {"qubits", "traffic_gb", "results"}; progress goes to
stderr.  Runs on the CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from qhbmlib_tpu_torch import device as device_lib
from qhbmlib_tpu_torch.ops import _cuda

ROWS_PER_TILE = (512, 2048, 8192)
COLS = 128


def stream_scale_plain(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """o = x * v."""
  return x * v


def stream_scale(x: torch.Tensor, v: torch.Tensor,
                 rows_per_tile: int) -> torch.Tensor:
  """o = x * v for a float32 [R, 128] plane x and a one-element float32 v
  on x's device, as one launch of K6 with one block per tile of
  `rows_per_tile` rows; returns a new plane.  The plain version for a CPU
  tensor; raises for any other device than the CPU or CUDA."""
  if x.device.type == "cpu":
    return stream_scale_plain(x, v)
  if x.device.type != "cuda":
    raise ValueError(f"stream_scale: unsupported device {x.device}")
  if x.dim() != 2 or x.shape[1] != COLS:
    raise ValueError(f"stream_scale: x has shape {tuple(x.shape)}, expected "
                     f"[R, {COLS}]")
  if v.numel() != 1:
    raise ValueError(f"stream_scale: v has {v.numel()} elements, expected 1")
  if rows_per_tile < 1:
    raise ValueError(f"stream_scale: rows_per_tile={rows_per_tile} < 1")
  _cuda.require([x, v], x.device, [tuple(x.shape), tuple(v.shape)])
  if x.data_ptr() % 16:
    raise ValueError("stream_scale: x is not 16-byte aligned")
  o = torch.empty_like(x)
  _cuda.check(_cuda.library().qhbm_stream_scale(
      x.data_ptr(), v.data_ptr(), o.data_ptr(), x.shape[0], rows_per_tile,
      _cuda.stream_of(x)), "stream_scale")
  stream_scale.launches += 1
  return o


stream_scale.launches = 0


def chain(step, shape, iters):
  """run(v) for `iters` dependent passes x <- step(v, x), as the
  reference's `_chain`: x starts at zeros with x[0, 0] = 1, v grows by
  1e-6 * x[0, 0] after each pass, and run returns sum(x[0, 0] per pass) +
  x[0, 1], so no pass can be skipped.  Nothing leaves the device."""

  def run(v: torch.Tensor) -> torch.Tensor:
    x = torch.zeros(shape, dtype=torch.float32, device=v.device)
    x[0, 0].fill_(1.0)  # a device fill: no host copy, so it can be captured
    ps = []
    for _ in range(iters):
      x = step(v, x)
      p = x.reshape(-1)[0]
      v = v + 1e-6 * p
      ps.append(p)
    return torch.stack(ps).sum() + x.reshape(-1)[1]

  return run


def graphed(run, v: torch.Tensor):
  """`run` captured once in a CUDA graph on v's card: returns replay(v),
  which copies v into the graph's input, replays the graph on the current
  stream and returns its (static) output.  The K6 launches recorded in the
  capture are counted at each replay, where they run."""
  dev = v.device
  static_v = v.clone()
  side = torch.cuda.Stream(dev)
  side.wait_stream(torch.cuda.current_stream(dev))
  with torch.cuda.stream(side):
    run(static_v)  # warm-up off the capture, as torch.cuda.graph asks
  torch.cuda.current_stream(dev).wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  before = stream_scale.launches
  with torch.cuda.graph(graph):
    out = run(static_v)
  captured, stream_scale.launches = stream_scale.launches - before, before

  def replay(v: torch.Tensor) -> torch.Tensor:
    static_v.copy_(v)
    graph.replay()
    stream_scale.launches += captured
    return out

  return replay


def _elapsed_ms(fn, device: torch.device) -> float:
  if device.type == "cuda":
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)
  t0 = time.perf_counter()
  fn()
  return (time.perf_counter() - t0) * 1e3


def time_chain(name, run, iters: int, traffic_gb: float, device,
               repeats: int = 3):
  """(ms per pass, GB/s): the best of `repeats` timed runs after one
  warm-up, each from a slightly different v; on the card each run is one
  replay of the chain's CUDA graph."""
  v = torch.tensor(1.0001, dtype=torch.float32, device=device)
  if device.type == "cuda":
    run = graphed(run, v)
  float(run(v))
  best = float("inf")
  for r in range(repeats):
    best = min(best, _elapsed_ms(lambda: run(v + 1e-5 * r), device) / iters)
  rate = traffic_gb / (best / 1e3)
  print(f"[hbm_probe] {name}: {best:.4f} ms -> {rate:.0f} GB/s",
        file=sys.stderr, flush=True)
  return best, rate


def measure(qubits: int = 24, iters: int = 32, device=None) -> dict:
  """The probe's result {"qubits", "traffic_gb", "results"}: per pass ms
  and GB/s of `torch_scale` and, on the card, of `stream_scale_rpt<T>` for
  each tile size T."""
  device = device_lib.resolve(device)
  shape = (2**(qubits - 7), COLS)
  traffic = 2 * shape[0] * shape[1] * 4 / 1e9  # read + write, GB
  runs = {"torch_scale": chain(stream_scale_plain, shape, iters)}
  if device.type == "cuda":
    for rpt in ROWS_PER_TILE:
      runs[f"stream_scale_rpt{rpt}"] = chain(
          lambda v, x, rpt=rpt: stream_scale(x, v, rpt), shape, iters)
  results = {}
  for name, run in runs.items():
    ms, rate = time_chain(name, run, iters, traffic, device)
    results[name] = {"ms": ms, "gb_per_s": rate}
  return {"qubits": qubits, "traffic_gb": traffic, "results": results}


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--qubits", type=int, default=24)
  p.add_argument("--iters", type=int, default=32)
  args = p.parse_args(argv)
  print(json.dumps(measure(args.qubits, args.iters)))


if __name__ == "__main__":
  main()
