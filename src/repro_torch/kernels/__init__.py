"""Kernels of the port: CUDA sources under csrc/, their wrappers, and the plain PyTorch versions they are held against."""
