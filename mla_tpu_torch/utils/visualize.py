"""Training-time visualization of the generation heads' outputs.

Counterpart of mla_tpu/utils/visualize.py, with the same files: the
predicted next image beside the ground truth as a PNG (the CLIP
normalization undone), the point clouds as NPZ, the tactile prediction as
NPY. The PNG is written with zlib and struct, so no imaging package is
needed.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
# panels written per head: the batch's first rows
MAX_SAMPLES = 2


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _denorm_to_uint8(chw: np.ndarray) -> np.ndarray:
    hwc = np.transpose(np.asarray(chw, np.float32), (1, 2, 0))
    hwc = hwc * CLIP_STD + CLIP_MEAN
    return np.clip(hwc * 255.0, 0, 255).astype(np.uint8)


def write_png(path, rgb: np.ndarray) -> None:
    """An [H, W, 3] uint8 array as an 8-bit RGB PNG (filter 0 on every row)."""
    h, w, c = rgb.shape
    if c != 3 or rgb.dtype != np.uint8:
        raise ValueError(f"write_png takes [H, W, 3] uint8, got {rgb.shape} {rgb.dtype}")

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    raw = b"".join(b"\x00" + row.tobytes() for row in np.ascontiguousarray(rgb))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_generation_visualization(
    generation_outputs: Dict,
    next_images: Optional[np.ndarray],
    next_point_cloud: Optional[np.ndarray],
    out_dir,
    *,
    step: int = 0,
    image_patch_size: int = 42,
) -> None:
    """Write pred-vs-gt panels for whichever heads produced outputs; the
    outputs may be tensors on any device or numpy arrays."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if next_images is not None and "image_generation" in generation_outputs:
        from mla_tpu_torch.models.generation import patches_to_images

        patches = torch.from_numpy(_host(generation_outputs["image_generation"]))
        pred = patches_to_images(patches, image_patch_size).numpy()
        gt = _host(next_images)
        for b in range(min(pred.shape[0], MAX_SAMPLES)):
            panel = np.concatenate([_denorm_to_uint8(pred[b]), _denorm_to_uint8(gt[b])], axis=1)
            write_png(out_dir / f"step{step:06d}_img{b}.png", panel)

    if next_point_cloud is not None and "pointcloud_coord_generation" in generation_outputs:
        pred_pc = _host(generation_outputs["pointcloud_coord_generation"])
        gt_pc = _host(next_point_cloud)
        np.savez(out_dir / f"step{step:06d}_pc.npz", pred=pred_pc[:MAX_SAMPLES], gt=gt_pc[:MAX_SAMPLES])

    if "tactile_generation" in generation_outputs:
        np.save(out_dir / f"step{step:06d}_tactile.npy", _host(generation_outputs["tactile_generation"])[:MAX_SAMPLES])
