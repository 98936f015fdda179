"""Hand-written Hopper kernels and their build-and-load code."""
