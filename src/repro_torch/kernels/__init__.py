"""Kernel layer of the port: plain PyTorch versions (`ref`), hand-written
CUDA kernels for Hopper (`flash_attention`, `paged_decode_attention`, built
by `build`), and the device dispatch the models call (`ops`)."""
