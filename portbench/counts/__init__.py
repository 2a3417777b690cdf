"""The model's operations a train step, one module a loss: `<loss>.py`
with `step_flops(config, traffic)`, found by `flops.step_flops` from the
cell's `traffic["loss"]`."""
