"""ICO (Windows icon) decoding as Pillow's convert("RGB") reads it.

Pillow picks one entry of the directory: the largest (width x height, a 0
meaning 256), and among entries of that size the one of the fewest bits a
pixel (its colour depth: the entry's bit count, or the log2 of its colour
count). A PNG payload decodes through `png.py`. A BMP payload is a DIB (an
info header with no file header) whose height counts the colour rows and
the AND mask's together: its colour half decodes through `bmp.py`; the AND
mask (or, at 32 bits, the colour rows' alpha bytes) only becomes alpha,
which convert("RGB") drops, but a mask that the data cannot hold is
refused, as Pillow refuses it.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from mla_tpu_torch.vla.rlds import bmp, png

SIGNATURE = b"\x00\x00\x01\x00"


def _corrupt(msg: str) -> ValueError:
    return ValueError(f"corrupt ICO data: {msg}")


def _entry(data: bytes):
    """The directory entry Pillow loads -> (width, height, bpp, size, offset)."""
    n = struct.unpack_from("<H", data, 4)[0] if len(data) >= 6 else 0
    entries = []
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise _corrupt("the directory runs past the end (truncated)")
        w, h, colours = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (colours != 0 and math.ceil(math.log(colours, 2))) or 256
        entries.append((w * h, depth, w, h, bpp, size, offset))
    if not entries:
        raise _corrupt("an icon without images")
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    return entries[0][2:]


def decode(data) -> np.ndarray:
    """ICO bytes -> uint8 [H, W, 3] of the entry Pillow picks."""
    data = bytes(data)
    if data[:4] != SIGNATURE:
        raise ValueError("not an ICO image (bad signature)")
    _, _, bpp, size, offset = _entry(data)
    body = data[offset:]
    if body[:8] == png.SIGNATURE:
        return png.decode(body, "pillow")
    if len(body) < 16:
        raise _corrupt("the image's header runs past the end (truncated)")
    hsize = struct.unpack_from("<I", body, 0)[0]
    if hsize == 12:
        w, h2, _, bits = struct.unpack_from("<HHHH", body, 4)
        h2, comp, colours = int(np.int16(h2)), 0, 0
    elif hsize in (40, 52, 56, 64, 108, 124) and len(body) >= 36:
        w, h2, _, bits, comp = struct.unpack_from("<iiHHI", body, 4)
        colours = struct.unpack_from("<I", body, 32)[0]
    else:
        raise _corrupt(f"an image header of {hsize} bytes")
    h = int(abs(h2) / 2)
    # where Pillow's reader stands after the header, any bit-field masks and the palette
    pixels = hsize + (12 if comp == 3 and hsize == 40 else 0)
    if bits <= 8:
        pixels += (3 if hsize == 12 else 4) * (colours or 1 << bits)
    pixels = min(pixels, len(body))
    if bpp == 32:
        alpha = body[pixels:pixels + 4 * w * h][3::4]
        if len(alpha) < w * h:
            raise _corrupt("the alpha bytes run past the end (not enough image data)")
    else:
        row = (w + 31) // 32 * 4
        at = offset + size - row * h
        # Pillow's raw reader needs only the pixels' bytes of the last row
        if at < 0 or len(data[at:at + row * h]) < row * (h - 1) + (w + 7) // 8:
            raise _corrupt("the AND mask runs past the end (not enough image data)")
    half = bytearray(body)
    if hsize == 12:
        struct.pack_into("<h", half, 6, h if h2 > 0 else -h)
    else:
        struct.pack_into("<i", half, 8, h if h2 > 0 else -h)
    head = bmp.SIGNATURE + struct.pack("<IHHI", 14 + len(half), 0, 0, 14 + pixels)
    return bmp.decode(head + bytes(half), "pillow")
