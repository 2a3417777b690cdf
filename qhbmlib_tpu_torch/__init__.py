"""qhbmlib_tpu_torch: the PyTorch / CUDA port of qhbmlib_tpu.

A second package beside the JAX one, which stays the reference it is held
against.  It imports torch and never jax:

  * ops/        circuit IR copy, Pauli sums, the statevector engine and the
                hand-written Hopper kernels (csrc/) of the batched and
                single-state forward and adjoint sweep
  * models/     energy functions, parameterized circuits (nn.Modules) and
                Hamiltonians
  * inference/  EBM and QNN inference, the eq. A5/C2 estimators, QHBM, the
                VQT and QMHL losses and their metrics
  * data/       quantum data (QHBM data, exact thermal-state data) for the
                QMHL loss
  * baselines/  numpy copies of the harness's exact density-matrix helpers
  * benchmarks/ the bench's tools and the JAX ladder's rungs (`ladder`)
  * convert.py  carries JAX parameter trees into the port's modules
"""

__version__ = "0.1.0"
