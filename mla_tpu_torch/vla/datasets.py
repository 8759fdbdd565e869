"""The frame transform of the data pipeline: shortest-side bicubic resize and
center crop.

Counterpart of `resize_center_crop` in mla_tpu/vla/datasets.py, which calls
Pillow's Image.resize(BICUBIC). The port needs no imaging package: this is a
numpy copy of Pillow's 8-bit resampler (libImaging/Resample.c), pixel for
pixel. Each axis that changes size is a separable pass, horizontal first:
the bicubic kernel (a = -0.5) widened by the scale when shrinking, its taps
normalized in float64 and rounded to 22-bit fixed point, each output the
rounded integer sum of its taps, clamped to 0..255, so the vertical pass
reads the horizontal pass's uint8 image, as Pillow's does.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit images
_SUPPORT = 2.0  # the bicubic kernel's half-width


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic_filter (a = -0.5), in its evaluation order."""
    x = np.abs(x)
    near = ((-0.5 + 2.0) * x - (-0.5 + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for the box [0,
    in_size): (first tap index [out], fixed-point taps [out, ksize], zero
    past each output's tap count)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero; the clamp at 0 follows
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)[None, :]
    live = taps < xmax[:, None]
    w = np.where(live, _bicubic(((taps + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale)), 0.0)
    total = np.zeros(out_size)
    for x in range(ksize):  # summed tap by tap, in Pillow's order
        total = total + w[:, x]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    one = float(1 << _PRECISION_BITS)
    k = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one)).astype(np.int64)
    return xmin, k


def _resample_axis(img: np.ndarray, out_size: int, axis: int, lo: int = 0, hi: int = None) -> np.ndarray:
    """One 8-bit pass of Pillow's resampler along `axis` of a uint8 image,
    outputs lo..hi of out_size only (each output is its own sum, so a crop
    can skip the rest). int32 sums, as Pillow's."""
    xmin, k = _coeffs(img.shape[axis], out_size)
    xmin, k = xmin[lo:hi], k[lo:hi].astype(np.int32)
    src = np.moveaxis(img, axis, 0).astype(np.int32)
    acc = np.full((len(xmin),) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int32)
    kshape = (len(xmin),) + (1,) * (src.ndim - 1)
    for tap in range(k.shape[1]):  # a tap past an output's count has weight 0
        acc += src[np.minimum(xmin + tap, src.shape[0] - 1)] * k[:, tap].reshape(kshape)
    return np.moveaxis(np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8), 0, axis)


def resize_bicubic(image: np.ndarray, width: int, height: int, crop: Tuple[int, int, int, int] = None) -> np.ndarray:
    """uint8 HWC -> uint8 [height, width, C], as Pillow's
    Image.resize((width, height), BICUBIC) gives it; with crop (left, top,
    right, bottom), that window of the result only."""
    left, top, right, bottom = crop or (0, 0, width, height)
    out = np.asarray(image, np.uint8)
    if width != out.shape[1]:
        out = _resample_axis(out, width, 1, left, right)
    else:
        out = out[:, left:right]
    if height != out.shape[0]:
        out = _resample_axis(out, height, 0, top, bottom)
    else:
        out = out[top:bottom]
    return out


def resize_center_crop(image: np.ndarray, size: int) -> np.ndarray:
    """uint8 HWC -> uint8 [size, size, C]: shortest-side bicubic scale, then
    a center crop to `size` (the geometric half of CLIPImageProcessor), the
    arithmetic of the training transform, so the serving host sees what the
    model was trained on."""
    h, w = image.shape[:2]
    scale = size / min(w, h)
    w2, h2 = round(w * scale), round(h * scale)
    left, top = (w2 - size) // 2, (h2 - size) // 2
    return resize_bicubic(image, w2, h2, (left, top, left + size, top + size))
