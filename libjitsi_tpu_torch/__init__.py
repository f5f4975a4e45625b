"""libjitsi-tpu ported to PyTorch and CUDA (NVIDIA Hopper).

A package beside `libjitsi_tpu` (the JAX reference): host control planes
stay NumPy, tensors appear at the crypto boundary, and every TPU kernel
on a ported path is a hand-written CUDA kernel (`csrc/`) with a plain
PyTorch version beside it.  Entry points run on the card unless the
caller passes `device="cpu"`.  See ROADMAP.md for what is ported.
"""
