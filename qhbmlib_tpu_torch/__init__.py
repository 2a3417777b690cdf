"""qhbmlib_tpu_torch: the PyTorch / CUDA port of qhbmlib_tpu.

A second package beside the JAX one, which stays the reference it is held
against.  It imports torch and never jax:

  * ops/        circuit IR copy, Pauli sums, the statevector engine and the
                hand-written Hopper kernels (csrc/) of the batched forward
                and adjoint sweep
  * models/     energy functions and parameterized circuits (nn.Modules)
  * inference/  EBM and QNN inference, the eq. A5/C2 estimators, QHBM and
                the VQT loss
  * convert.py  carries JAX QHBM parameters into the port's modules
"""

__version__ = "0.1.0"
