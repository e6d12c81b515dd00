"""Kernel layer of the port: plain PyTorch versions (`ref`, and
`fused_linear.fused_linear_ref`), hand-written CUDA kernels for Hopper
(`flash_attention`, `paged_decode_attention`, `decode_attention`,
`fused_linear`, `linear_scan`; built by `build`), and the device dispatch
the models and apps call (`ops`)."""
