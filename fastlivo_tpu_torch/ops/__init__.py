"""Batched tensor operations and the hand-written CUDA kernels."""
