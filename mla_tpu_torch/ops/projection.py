"""3D->2D camera projection and the camera registry.

Counterpart of mla_tpu/ops/projection.py: maps point-cloud centers (world
frame) to patch indices on the vision tokenizer's 16x16 grid over the 672 px
frame, per camera. The contrastive loss pairs each point token with the
image token at its patch. The calibration constants are copied from the JAX
package (rlbench_front, franka_right, franka_front).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch


@dataclass(frozen=True, eq=False)  # hashed by identity: a key of _camera_tensors' cache
class CameraParams:
    K: np.ndarray  # [3, 3] intrinsics
    R: np.ndarray  # [3, 3] camera -> world rotation
    t: np.ndarray  # [3] camera position in the world
    image_size_orig: Tuple[int, int]  # (H, W) of the raw camera frame


CAMERA_CONFIGS: Dict[str, CameraParams] = {
    "rlbench_front": CameraParams(
        K=np.array(
            [[-307.7174807, 0.0, 112.0], [0.0, -307.7174807, 112.0], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        ),
        R=np.array(
            [
                [1.19209290e-07, -4.22617942e-01, -9.06307936e-01],
                [-1.00000000e00, -5.96046448e-07, 1.49011612e-07],
                [-5.66244125e-07, 9.06307936e-01, -4.22617912e-01],
            ],
            dtype=np.float32,
        ),
        t=np.array([1.34999919e00, 3.71546562e-08, 1.57999933e00], dtype=np.float32),
        image_size_orig=(224, 224),
    ),
    "franka_right": CameraParams(
        K=np.array(
            [
                [387.414794921875, 0.0, 319.47052001953125],
                [0.0, 386.8714904785156, 241.13287353515625],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float32,
        ),
        R=np.array(
            [
                [0.91300858, 0.26157042, -0.31304353],
                [0.39730357, -0.7442472, 0.53688545],
                [-0.09254842, -0.61455433, -0.78342694],
            ],
            dtype=np.float32,
        ),
        t=np.array([0.8591219242556176, -0.5851783639922448, 0.7535876808722389], dtype=np.float32),
        image_size_orig=(480, 640),
    ),
    "franka_front": CameraParams(
        K=np.array(
            [
                [388.2638244628906, 0.0, 328.3757019042969],
                [0.0, 387.84130859375, 240.24295043945312],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float32,
        ),
        R=np.array(
            [
                [-0.01750229, 0.95018522, -0.31119403],
                [0.99984609, 0.01625676, -0.00659609],
                [-0.0012085, -0.31126158, -0.95032351],
            ],
            dtype=np.float32,
        ),
        t=np.array([0.8545415959817313, 0.5748472977587156, 1.0411478820663598], dtype=np.float32),
        image_size_orig=(720, 1280),
    ),
}


def get_camera_params(name: str) -> CameraParams:
    if name not in CAMERA_CONFIGS:
        raise ValueError(f"Unknown camera config: {name}. Available: {list(CAMERA_CONFIGS)}")
    return CAMERA_CONFIGS[name]


@functools.lru_cache(maxsize=16)
def _camera_tensors(camera: CameraParams, image_size_resize: Tuple[int, int], device: str) -> Tuple[torch.Tensor, ...]:
    """(R_w2c^T, t_w2c, K^T) fp32 on `device` for the resized frame: K scaled
    to it in float64 on the host, as in JAX. Copied to the device once per
    (camera, size, device), outside inference mode, so a serving call makes
    no host-to-device copy that waits."""
    K = np.array(camera.K, dtype=np.float64)
    sx = image_size_resize[1] / camera.image_size_orig[1]
    sy = image_size_resize[0] / camera.image_size_orig[0]
    K[0, 0] *= sx
    K[1, 1] *= sy
    K[0, 2] *= sx
    K[1, 2] *= sy
    R_w2c = np.array(camera.R, dtype=np.float64).T
    t_w2c = -R_w2c @ np.array(camera.t, dtype=np.float64)
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(a, dtype=torch.float32, device=device) for a in (R_w2c.T, t_w2c, K.T))


def project_3d_to_2d(
    xyz_3d: torch.Tensor, camera: CameraParams, image_size_resize: Tuple[int, int] = (672, 672),
    patch_stride: int = 14, conv_stride: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points [..., N, 3] -> (patch indices int32 [..., N, 2] as
    (row, col), valid bool [..., N]). K is scaled to the resized frame (in
    float64 on the host, as in JAX), points go world -> camera through R^T
    and -R^T t, then through the pinhole; the pixel is floor-divided by the
    total stride (14 * 3 = 42). Valid means in front of the camera and
    inside the frame; indices are clamped into the grid."""
    rot, trans, intr = _camera_tensors(camera, tuple(image_size_resize), str(xyz_3d.device))
    xyz_cam = xyz_3d.float() @ rot + trans
    uvw = xyz_cam @ intr
    z = uvw[..., 2:]
    xy = uvw[..., :2] / (z + 1e-6)

    stride = patch_stride * conv_stride
    row = torch.floor(xy[..., 1] / stride).to(torch.int32)
    col = torch.floor(xy[..., 0] / stride).to(torch.int32)
    H, W = image_size_resize
    valid = (z[..., 0] > 0) & (xy[..., 0] >= 0) & (xy[..., 0] < W) & (xy[..., 1] >= 0) & (xy[..., 1] < H)
    row = row.clamp(0, H // stride - 1)
    col = col.clamp(0, W // stride - 1)
    return torch.stack([row, col], dim=-1), valid
