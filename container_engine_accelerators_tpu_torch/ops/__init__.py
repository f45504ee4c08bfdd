"""Tensor ops of the PyTorch port; hand-written CUDA kernels live in csrc/."""
