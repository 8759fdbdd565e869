"""QOI ("Quite OK Image") decoding as Pillow's convert("RGB") reads it.

The ops are Pillow's QoiDecoder's: RGB (keeps the previous alpha), RGBA,
INDEX into the 64 pixels last seen by their hash (a slot never written is
transparent black), DIFF, LUMA and RUN (which repeats the previous pixel
and does not enter the index), from an opaque black previous pixel; the
end marker is not read. The channel count only names the mode (RGB or
RGBA), and convert("RGB") drops alpha. Data that ends before the last pixel raises
ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"qoif"


def _truncated() -> ValueError:
    return ValueError("corrupt QOI data: the ops end before the last pixel (truncated)")


def decode(data) -> np.ndarray:
    """QOI bytes -> uint8 [H, W, 3]."""
    data = bytes(data)
    if data[:4] != SIGNATURE or len(data) < 14:
        raise ValueError("not a QOI image (bad signature or a short header)")
    w, h = struct.unpack_from(">II", data, 4)
    need = w * h
    seen = [None] * 64
    r, g, b, a = 0, 0, 0, 255
    out = bytearray()
    pos, n = 14, len(data)
    while len(out) < need * 4:
        if pos >= n:
            raise _truncated()
        op = data[pos]
        pos += 1
        if op == 0xFE:
            if pos + 3 > n:
                raise _truncated()
            r, g, b = data[pos], data[pos + 1], data[pos + 2]
            pos += 3
        elif op == 0xFF:
            if pos + 4 > n:
                raise _truncated()
            r, g, b, a = data[pos], data[pos + 1], data[pos + 2], data[pos + 3]
            pos += 4
        elif op >> 6 == 0:
            r, g, b, a = seen[op] or (0, 0, 0, 0)
        elif op >> 6 == 1:
            r, g, b = (r + ((op >> 4) & 3) - 2) % 256, (g + ((op >> 2) & 3) - 2) % 256, (b + (op & 3) - 2) % 256
        elif op >> 6 == 2:
            if pos >= n:
                raise _truncated()
            second = data[pos]
            pos += 1
            dg = (op & 0x3F) - 32
            r, g, b = (r + dg + (second >> 4) - 8) % 256, (g + dg) % 256, (b + dg + (second & 15) - 8) % 256
        else:
            out += bytes((r, g, b, a)) * ((op & 0x3F) + 1)
            continue
        seen[(r * 3 + g * 5 + b * 7 + a * 11) % 64] = (r, g, b, a)
        out += bytes((r, g, b, a))
    px = np.frombuffer(bytes(out[:need * 4]), np.uint8).reshape(h, w, 4)
    return np.ascontiguousarray(px[..., :3])
