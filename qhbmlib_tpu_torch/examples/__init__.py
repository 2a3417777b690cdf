"""The library's three core workflows as runnable scripts (port of the
repo's `examples/`), on the CUDA card unless `--device` names another:

  * `vqt_thermal_state`        -- VQT learns the thermal state of a 4-qubit
    TFIM; fidelity to the exact Gibbs state.
  * `qmhl_modular_hamiltonian` -- QMHL learns a 3-qubit Heisenberg thermal
    state served exactly by `ThermalStateData`; the loss approaches the
    data's entropy.
  * `multichip_sharded_vqt`    -- VQT at 8 qubits through
    `ShardedQuantumInference` on a ('data', 'state') mesh of every rank.

    python -m qhbmlib_tpu_torch.examples.vqt_thermal_state [--steps N]
        [--device cpu]

Each module splits into `build(device)` (the model, the loss and the
target from the example's seeds), `make_step` (one Adam step), `train`
(the loop; returns the per-step losses) and `main(steps, device)`.
"""
