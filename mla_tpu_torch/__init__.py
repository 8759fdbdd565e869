"""PyTorch/CUDA port of MLA for NVIDIA Hopper (H100).

A second package beside the JAX reference `mla_tpu`: same module names,
same parameter layout (dicts of tensors with [in, out] weights, stacked
[L, ...] decoder leaves, int8 {'w_q','w_scale'} and int4
{'w_q4','w_scale4'} leaves), plain functions on tensors. Every Pallas TPU
kernel on the ported path is a hand-written CUDA kernel under `csrc/`,
built with nvcc for sm_90a at first use; each sits beside its plain
PyTorch version, which the CPU runs.
"""

__version__ = "0.1.0"


def load_vla(*args, **kwargs):
    """models/load.load_vla, imported when called."""
    from mla_tpu_torch.models.load import load_vla as _load_vla

    return _load_vla(*args, **kwargs)


def available_models():
    """The model presets of conf/models.py, sorted."""
    from mla_tpu_torch.conf.models import MODEL_REGISTRY

    return sorted(MODEL_REGISTRY)
