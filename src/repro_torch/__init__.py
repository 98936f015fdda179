"""PyTorch/CUDA port of the Hybrid Coded MapReduce system.

Mirrors the JAX reference package ``repro`` module for module; imports
``torch``, NumPy and the standard library, and nothing of ``repro`` or
``jax``.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
