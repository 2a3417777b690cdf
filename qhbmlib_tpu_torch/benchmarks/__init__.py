"""Measurement tools of the port (counterparts of the repo's `benchmarks/`):
`hbm_probe`, the HBM stream probe with its kernel (K6); `ladder`, the JAX
scale ladder's rungs; `step_profile` and `compare_trees`."""
