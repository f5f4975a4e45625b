"""Crypto primitives: host NumPy parts, plain PyTorch versions and the CUDA kernel wrappers."""
