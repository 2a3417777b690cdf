"""The plain reference: torch and numpy only, nothing of the port.

States are real tensors [S, 2, 2^n] (real and imaginary planes) of S basis
states evolved together; qubit q is bit n-1-q of the amplitude index (qubit
0 the most significant, the order of a bitstring row).  Every operator is
built from the parameters with autograd, so the reference's gradients are
torch's own.
"""
