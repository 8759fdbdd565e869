"""PNG decoding and encoding without an imaging package.

The JAX pipeline decodes frames with TensorFlow's `tf.io.decode_image(...,
channels=3)` (libpng). The port reads the chunks itself, inflates the image
data with zlib and un-filters it through the host helper
(`native/rlds_host.py`). It decodes 8-bit grey, grey with alpha, RGB, RGBA
and palette images, non-interlaced, into uint8 [H, W, 3] as libpng's
channels=3 decode gives them: grey repeated into three channels, alpha
dropped, the palette expanded. 16-bit, sub-byte and interlaced images raise.

`encode` writes RGB images with zlib, each row filtered by the usual
heuristic (the filter type whose output has the least sum of absolute
values) or by one forced filter type; the fixtures and the tests' filter
cases use it.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from mla_tpu_torch.native import rlds_host

SIGNATURE = b"\x89PNG\r\n\x1a\n"
ROADMAP_PNG = "ROADMAP.md queue 1, item 2 (frame formats: PNG variants)"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # by colour type
_CRITICAL = (b"IHDR", b"PLTE", b"IDAT", b"IEND")


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG image (bad signature)")
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"PNG chunk {kind!r} runs past the end of the image")
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if kind in _CRITICAL and zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG image ends without an IEND chunk")


def decode(data) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3]."""
    data = bytes(data)
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG image without an IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not valid")
    if depth != 8:
        raise NotImplementedError(f"{depth}-bit PNG images are not decoded ({ROADMAP_PNG}); only 8-bit ones are")
    if interlace:
        raise NotImplementedError(f"interlaced PNG images are not decoded ({ROADMAP_PNG})")
    ch = _CHANNELS[ctype]
    rows = rlds_host.png_unfilter(zlib.decompress(b"".join(idat)), height, width * ch, ch)
    px = rows.reshape(height, width, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG image without a PLTE chunk")
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index past the palette")
        return palette[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filtered(x: np.ndarray, bpp: int, kinds) -> np.ndarray:
    """Filter types `kinds`' outputs of scanlines x [H, stride] -> [len(kinds),
    H, stride] uint8."""
    x = x.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]

    def pred(kind):
        if kind == 0:
            return 0
        if kind == 1:
            return a
        if kind == 2:
            return b
        if kind == 3:
            return (a + b) >> 1
        c = np.zeros_like(x)
        c[1:, bpp:] = x[:-1, :-bpp]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))

    return np.stack([(x - pred(k)) & 0xFF for k in kinds]).astype(np.uint8)


def encode(img: np.ndarray, filter_type: Optional[int] = None, level: int = 6) -> bytes:
    """uint8 [H, W, 3] -> PNG bytes (8-bit RGB, not interlaced). Each row is
    filtered by `filter_type` (0..4) where given, else by the type whose
    output has the least sum of absolute values as signed bytes."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode takes uint8 [H, W, 3], got {img.shape}")
    if filter_type is not None and filter_type not in range(5):
        raise ValueError(f"PNG filter type {filter_type} is not 0..4")
    h, w, _ = img.shape
    if filter_type is None:
        outs = _filtered(img.reshape(h, w * 3), 3, range(5))
        kinds = np.abs(outs.view(np.int8).astype(np.int64)).sum(-1).argmin(0)
        rows = outs[kinds, np.arange(h)]
    else:
        kinds = np.full(h, filter_type)
        rows = _filtered(img.reshape(h, w * 3), 3, (filter_type,))[0]
    raw = np.concatenate([kinds.astype(np.uint8)[:, None], rows], axis=1).tobytes()
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, level)) + _chunk(b"IEND", b""))
