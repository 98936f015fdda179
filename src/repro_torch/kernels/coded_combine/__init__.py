"""Coded-multicast combine kernels: the paper's f(.) and its GF(2) variant."""
