"""One entry for every frame format the JAX data paths decode.

`decode(data, flavour)` sniffs the stream's signature, as TensorFlow's
decode_image does, and hands it to the port's own decoder: PNG
(`png.py`), JPEG (`jpeg.py`), GIF (`gif.py`), BMP (`bmp.py`) and WebP
(`webp.py`). flavour "tf" gives tf.io.decode_image(channels=3,
expand_animations=False)'s pixels, the JAX RLDS path's
(`transforms.decode_image`); "pillow" gives Pillow's convert("RGB")
pixels, the JAX VLM path's (`vla/vlm_datasets._load_image`). JPEG XL, which
TensorFlow also reads, raises NotImplementedError citing ROADMAP.md item
2; a stream of no known signature raises ValueError.
"""

from __future__ import annotations

import hashlib

import numpy as np

from mla_tpu_torch.native import jpeg_host, rlds_host, webp_host
from mla_tpu_torch.vla.rlds import bmp, gif, jpeg, png, webp

ROADMAP_FRAMES = "ROADMAP.md queue 1, item 2 (frame formats)"
FLAVOURS = ("tf", "pillow")
_JXL = (b"\xff\x0a", b"\x00\x00\x00\x0cJXL \r\n\x87\n")


def format_of(data) -> str:
    """The format a stream's first bytes name: png, jpeg, gif, bmp, webp,
    jxl or unknown."""
    head = bytes(data[:12])
    if head.startswith(png.SIGNATURE):
        return "png"
    if head.startswith(jpeg.SIGNATURE):
        return "jpeg"
    if head[:6] in gif.SIGNATURES:
        return "gif"
    if head.startswith(bmp.SIGNATURE):
        return "bmp"
    if webp.is_webp(head):
        return "webp"
    if head.startswith(_JXL):
        return "jxl"
    return "unknown"


def decode(data, flavour: str = "tf", plain: bool = False) -> np.ndarray:
    """Encoded bytes -> uint8 [H, W, 3], as `flavour`'s reference decodes
    them; `plain` runs the plain Python versions of the host loops (the C++
    ones by default)."""
    if flavour not in FLAVOURS:
        raise ValueError(f"flavour {flavour!r} is not one of {FLAVOURS}")
    kind = format_of(data)
    if kind == "png":
        return png.decode(data, flavour, rlds_host.png_unfilter_plain if plain else rlds_host.png_unfilter)
    if kind == "jpeg":
        return jpeg.decode(data, "ifast" if flavour == "tf" else "islow", jpeg_host.PLAIN if plain else jpeg_host.NATIVE)
    if kind == "gif":
        return gif.decode(data, flavour, rlds_host.gif_lzw_plain if plain else rlds_host.gif_lzw)
    if kind == "bmp":
        return bmp.decode(data, flavour)
    if kind == "webp":
        return webp.decode(data, flavour, webp_host.PLAIN if plain else webp_host.NATIVE)
    if kind == "jxl":
        raise NotImplementedError(f"JPEG XL frames are not decoded ({ROADMAP_FRAMES})")
    raise ValueError(f"an image of an unknown format (it starts {bytes(data[:8]).hex()}): the port reads PNG, JPEG, "
                     f"GIF, BMP and WebP ({ROADMAP_FRAMES})")


def digest(px: np.ndarray) -> str:
    """SHA-256 of decoded pixels with their shape: what the golden streams
    under tests/data/frames/ record."""
    px = np.ascontiguousarray(px, np.uint8)
    return hashlib.sha256(px.tobytes() + repr(px.shape).encode()).hexdigest()
