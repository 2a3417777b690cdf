"""Measurement tools of the port (counterparts of the repo's `benchmarks/`):
`hbm_probe`, the HBM stream probe with its kernel (K6)."""
