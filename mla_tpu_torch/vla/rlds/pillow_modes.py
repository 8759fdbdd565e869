"""Pillow's convert("RGB") for each image mode its decoders give, in one
place: the last step of every decoder's "pillow" flavour (PNG, GIF, BMP,
JPEG, TIFF and the simpler formats), which hands its pixels here as
(mode, samples). Alpha is dropped, never composited.

- "1" (0 or 1, or 0 / 255), "L", "LA": the grey value repeated.
- "P" and "PA": the index through the palette, black past its end.
- "I;16" (and "I;16B", "I;16L"): clipped to 255, not scaled.
- "I": clipped to 0..255.
- "F": NaN to 0, then clipped to 0..255 and truncated toward zero.
- "RGB", "RGBX", "RGBA": the first three channels.
- "RGBa" (premultiplied alpha): each colour times 255 over alpha, floored
  and clipped to 255; alpha 0 gives black (Pillow's RGBa unpacker).
- "CMYK": Pillow's cmyk2rgb, r = (255 - k) - (c * (255 - k)) / 255 with
  its rounding, and likewise g and b.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def cmyk(px: np.ndarray) -> np.ndarray:
    """uint8 [..., 4] CMYK -> uint8 [..., 3] RGB by Pillow's cmyk2rgb."""
    px = px.astype(np.int32)
    nk = 255 - px[..., 3:]
    return np.clip(nk - _muldiv255(px[..., :3], nk), 0, 255).astype(np.uint8)


def palette(idx: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Indices -> RGB through `table` ([n, 3]), black past its end."""
    full = np.zeros((256, 3), np.uint8)
    table = np.asarray(table, np.uint8)[:256]
    full[:len(table)] = table
    return full[idx]


def unpremultiply(px: np.ndarray) -> np.ndarray:
    """uint8 [..., 4] premultiplied RGBa -> uint8 [..., 3] straight RGB."""
    c, a = px[..., :3].astype(np.int32), px[..., 3:].astype(np.int32)
    out = np.where(a == 255, c, np.minimum(255, c * 255 // np.maximum(a, 1)))
    return np.where(a == 0, 0, out).astype(np.uint8)


def to_l(mode: str, px: np.ndarray) -> np.ndarray:
    """The grey modes' samples -> uint8 [H, W]."""
    if mode == "1":
        return np.where(px != 0, 255, 0).astype(np.uint8)
    if mode in ("L", "LA"):
        return np.asarray(px if px.ndim == 2 else px[..., 0], np.uint8)
    if mode.startswith("I;16"):
        return np.minimum(px, 255).astype(np.uint8)
    if mode == "I":
        return np.clip(px, 0, 255).astype(np.uint8)
    if mode == "F":
        px = np.asarray(px, np.float64)
        return np.clip(np.where(np.isnan(px), 0, px), 0, 255).astype(np.uint8)
    raise ValueError(f"mode {mode!r} is not a grey mode")


def to_rgb(mode: str, px: np.ndarray, table: Optional[np.ndarray] = None) -> np.ndarray:
    """A decoded image of Pillow mode `mode` (samples [H, W] or [H, W, C];
    for "P" and "PA" the indices and `table`) -> uint8 [H, W, 3] as
    convert("RGB") gives it."""
    if mode in ("P", "PA"):
        return palette(px if px.ndim == 2 else px[..., 0], table)
    if mode in ("RGB", "RGBX", "RGBA"):
        return np.ascontiguousarray(px[..., :3], np.uint8)
    if mode == "RGBa":
        return unpremultiply(px)
    if mode == "CMYK":
        return cmyk(px)
    return np.repeat(to_l(mode, px)[..., None], 3, axis=2)
