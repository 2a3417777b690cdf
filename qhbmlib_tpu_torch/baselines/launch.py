"""Local multi-run sweep launcher (port of `baselines/launch.py`): one
`qhbmlib_tpu_torch.baselines.train` process a sweep point of the config
module's `get_sweep()`, each with its own output directory, at most
`--max_parallel` at once.

    python -m qhbmlib_tpu_torch.baselines.launch --output_dir DIR \\
        [--config qhbmlib_tpu_torch/baselines/config.py] [--max_parallel 2] \\
        [--sweep_filter training.method=vanilla ...] [--retries 1] \\
        [--device cuda|cpu] [--dry_run]

Every point of the sweep (the losses "vqt" and "qvartz" by the methods
"vanilla", "natural" and "mirror") runs; `--sweep_filter` picks a subset.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

from qhbmlib_tpu_torch.baselines import train


def build_jobs(config_path: str, output_dir: str, sweep, seed: int,
               device=None):
  """[(job directory, command)] a sweep point: the trainer with the config,
  the job's output directory, the seed, the device if given, and the
  point's `--config.a.b=value` overrides."""
  jobs = []
  for i, point in enumerate(sweep):
    label = "_".join(str(v) for v in point.values()) or f"point_{i}"
    job_dir = os.path.join(output_dir, f"{i:03d}_{label}")
    cmd = [
        sys.executable, "-m", "qhbmlib_tpu_torch.baselines.train",
        f"--config={config_path}",
        f"--output_dir={job_dir}",
        f"--seed={seed}",
    ]
    if device is not None:
      cmd.append(f"--device={device}")
    for flag, value in point.items():
      cmd.append(f"--{flag}={value}")
    jobs.append((job_dir, cmd))
  return jobs


def run_jobs(jobs, max_parallel: int, retries: int) -> dict:
  """Runs the jobs at most `max_parallel` at once, each one's output in
  `<job dir>/stdout_attempt<k>.log`, a failed job again up to `retries`
  times; returns {job dir: last exit code}."""
  running, results, attempts = [], {}, {}
  queue = list(jobs)
  while queue or running:
    while queue and len(running) < max_parallel:
      job_dir, cmd = queue.pop(0)
      os.makedirs(job_dir, exist_ok=True)
      attempt = attempts.get(job_dir, 0)
      log = open(os.path.join(job_dir, f"stdout_attempt{attempt}.log"), "w")
      proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
      running.append((job_dir, cmd, proc, log))
      print(f"launched {job_dir} (pid {proc.pid}, attempt {attempt})")
    still = []
    for job_dir, cmd, proc, log in running:
      code = proc.poll()
      if code is None:
        still.append((job_dir, cmd, proc, log))
        continue
      log.close()
      if code != 0 and attempts.get(job_dir, 0) < retries:
        attempts[job_dir] = attempts.get(job_dir, 0) + 1
        print(f"retrying {job_dir} (exit {code}, attempt "
              f"{attempts[job_dir]})")
        queue.append((job_dir, cmd))
      else:
        results[job_dir] = code
        print(f"finished {job_dir} (exit {code})")
    running = still
    if running:
      time.sleep(2.0)
  return results


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--config", default=train.DEFAULT_CONFIG,
                 help="path of a config module with get_config() and "
                 "get_sweep()")
  p.add_argument("--output_dir", default="/tmp/qhbm_sweep",
                 help="root output directory of all jobs")
  p.add_argument("--max_parallel", type=int, default=1,
                 help="concurrent training processes")
  p.add_argument("--dry_run", action="store_true",
                 help="print the job commands without running them")
  p.add_argument("--sweep_filter", action="append", default=[],
                 help="key=value filter on sweep points, e.g. "
                 "training.method=vanilla (repeatable)")
  p.add_argument("--seed", type=int, default=42)
  p.add_argument("--retries", type=int, default=0,
                 help="automatic retries of a failed job")
  p.add_argument("--device", default=None,
                 help="the jobs' torch device (default: the CUDA card)")
  args = p.parse_args(argv)

  spec = importlib.util.spec_from_file_location("sweep_config", args.config)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  sweep = mod.get_sweep()
  for f in args.sweep_filter:
    k, v = f.split("=", 1)
    sweep = [pt for pt in sweep if str(pt.get(f"config.{k}", "")) == v]
  os.makedirs(args.output_dir, exist_ok=True)
  jobs = build_jobs(args.config, args.output_dir, sweep, args.seed,
                    args.device)
  with open(os.path.join(args.output_dir, "sweep_manifest.json"), "w") as fp:
    json.dump([{"dir": d, "cmd": c} for d, c in jobs], fp, indent=2)
  print(f"{len(jobs)} sweep points")
  if args.dry_run:
    for _, c in jobs:
      print(" ", " ".join(c))
    return
  results = run_jobs(jobs, args.max_parallel, args.retries)
  failures = {d: c for d, c in results.items() if c != 0}
  if failures:
    print(f"FAILED jobs: {json.dumps(failures, indent=2)}")
    sys.exit(1)
  print("all jobs succeeded")


if __name__ == "__main__":
  main()
