"""The plain PyTorch reference that decides `correct`: torch operations in
float32 (TF32 off), no kernel, cache or batching of the port's. It imports
nothing of `repro_torch`, `repro` or `jax`."""
