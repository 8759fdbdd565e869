"""PyTorch/CUDA port of MLA for NVIDIA Hopper (H100).

A second package beside the JAX reference `mla_tpu`: same module names,
same parameter layout (dicts of tensors with [in, out] weights, stacked
[L, ...] decoder leaves, int8 {'w_q','w_scale'} leaves), plain functions on
tensors. Every Pallas TPU kernel on the ported path is a hand-written CUDA
kernel under `csrc/`, built with nvcc for sm_90a at first use; each sits
beside its plain PyTorch version, which the CPU runs.
"""
