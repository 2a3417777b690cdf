"""The benchmark of the PyTorch / CUDA port (`qhbmlib_tpu_torch`).

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One run is one cell of `BENCHMARK.json` in a fresh process: set-up (the
weights of every part the cell's loss draws, made on the card from the
seed; the port's train step of that loss built through its public API;
its first steps recorded), a window of
back-to-back train steps, then the check of those first steps against a
plain reference.  It prints one JSON line.

Everything is found by name, so a later cell, configuration, loss, energy,
circuit, per-layer metric or kernel is a new file:

  configs/<config>.json      model sizes, weight distributions, precision
  workloads/<cell>.json      the traffic (loss, beta, draws a step,
                             Adam's rate, traced steps), its source and
                             what it assumed, correctness limits
  program/<kind>.py          builds the port's objects for a kind named in
                             a configuration (circuit, energy) or a cell
                             (loss); imports `qhbmlib_tpu_torch`
  reference/<kind>.py        the plain reference of the same kind (torch
                             and numpy only, nothing of the port); a
                             loss's lists the parts whose weights are
                             drawn and the trained leaves it compares
  counts/<loss>.py           the model's operations a step of the loss
  metrics/<metric>.py        one per-layer metric: read(ctx) -> number or
                             None
  kernels/<wrapper>.py       one kernel wrapper of the port: where it
                             lives and the work of one call (roofline)

The yardstick lives here too: the seeds (`traffic`), the profiler
arithmetic (`trace`), the peaks (`roofline`), the model's operation count
(`flops`, `counts/`) and the comparison that decides `correct` (`compare`).
"""
