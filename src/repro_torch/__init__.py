"""PyTorch/CUDA port of the HiCR reproduction.

A package of its own beside the JAX reference (`repro`): it imports torch,
never jax, and nothing of `repro`. Its entry points run on the CUDA device
unless the caller asks for the CPU.
"""
