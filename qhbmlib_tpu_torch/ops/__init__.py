"""Circuit IR, Pauli sums, the statevector engine and its CUDA kernels.

Kernel modules build their library only when a kernel first launches on a
CUDA tensor, never at import.
"""
