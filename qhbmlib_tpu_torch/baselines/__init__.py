"""The port's jax-free experiment harness (`baselines/`): the TFIM VQT
trainer (`train`), its configuration (`config`), the sweep launcher
(`launch`), the ansatz (`pqc`) and the exact density-matrix metrics
(`utils`)."""
