"""The port's jax-free copies of the experiment harness's helpers
(`baselines/`)."""
