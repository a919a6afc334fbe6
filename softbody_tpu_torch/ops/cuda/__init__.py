"""Wrappers of the hand-written Hopper kernels (``csrc/``): each launches
its CUDA kernel on CUDA tensors and runs its plain torch version on CPU
tensors."""
