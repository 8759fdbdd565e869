"""The per-dataset OXE standardization layer under its earlier module name
(mla_tpu/vla/rlds/oxe_transforms.py's shim); it lives in
`mla_tpu_torch.vla.rlds.oxe.transforms`."""

from mla_tpu_torch.vla.rlds.oxe.transforms import (  # noqa: F401
    FRAME_FILTERS,
    OXE_STANDARDIZATION_TRANSFORMS,
    get_standardization_transform,
    identity_transform,
)
