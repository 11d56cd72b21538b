"""PyTorch + CUDA port of the ``repro`` package (the JAX reference).

Mirrors ``repro``'s layout; imports neither JAX nor ``repro``.  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``.
"""
