"""PCX decoding as Pillow's convert("RGB") reads it.

Pillow reads 1 bit in 1 plane (black and white), 1 bit in 2 or 4 planes
(16 colours from the header's palette), and with version 5 8 bits in 1
plane (grey, or a palette where the 769 bytes before the end start with 12
and do not list the grey ramp) or in 3 planes (RGB); it refuses any other
layout. Each line is RLE-coded (a byte of the two top bits set repeats the
next byte its low six bits' count of times) to `planes` x the line stride,
the header's where it matches the width's bytes, else those rounded up to
an even count. A run past the line's end and data that ends before the
last line are refused.
"""

from __future__ import annotations

import struct

import numpy as np

from mla_tpu_torch.vla.rlds import pillow_modes


def _corrupt(msg: str) -> ValueError:
    return ValueError(f"corrupt PCX data: {msg}")


def valid_header(data) -> bool:
    """Whether Pillow's PCX reader takes the stream: its signature (10 and a
    version of 0, 2, 3 or 5), then the header's size check (a stream that
    fails either goes on to the formats after PCX)."""
    s = bytes(data[:68])
    if len(s) < 68 or s[0] != 10 or s[1] not in (0, 2, 3, 5):
        return False
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", s, 4)
    return x1 + 1 > x0 and y1 + 1 > y0


def _lines(data: bytes, pos: int, nbytes: int, nlines: int) -> np.ndarray:
    """The RLE data from pos -> nlines lines of nbytes."""
    out = np.empty((nlines, nbytes), np.uint8)
    n = len(data)
    for y in range(nlines):
        line, x = out[y], 0
        while x < nbytes:
            if pos >= n:
                raise _corrupt("the data ends before the last line (image file is truncated)")
            b = data[pos]
            if b & 0xC0 == 0xC0:
                if pos + 1 >= n:
                    raise _corrupt("the data ends inside a run (image file is truncated)")
                count = b & 0x3F
                if x + count > nbytes:
                    raise _corrupt("a run past the end of its line (buffer overrun)")
                line[x:x + count] = data[pos + 1]
                x += count
                pos += 2
            else:
                line[x] = b
                x += 1
                pos += 1
    return out


def decode(data) -> np.ndarray:
    """PCX bytes -> uint8 [H, W, 3]."""
    data = bytes(data)
    if not valid_header(data):
        raise ValueError("not a PCX image (bad signature or image size)")
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", data, 4)
    w, h = x1 + 1 - x0, y1 + 1 - y0
    version, bits, planes = data[1], data[3], data[65]
    stride_given = struct.unpack_from("<H", data, 66)[0]
    table = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, table = "P", np.frombuffer(data, np.uint8, 48, 16).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        if len(data) < 769:  # Pillow seeks 769 bytes back from the end
            raise _corrupt(f"{len(data)} bytes, fewer than the 769 a palette's place needs")
        tail = data[-769:]
        if len(tail) == 769 and tail[0] == 12:
            pal = np.frombuffer(tail, np.uint8, 768, 1).reshape(256, 3)
            if not (pal == np.arange(256, dtype=np.uint8)[:, None]).all():
                mode, table = "P", pal
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise ValueError(f"a PCX of version {version}, {bits} bits in {planes} planes (unknown PCX mode)")
    stride = (w * bits + 7) // 8
    if stride_given != stride:
        stride += stride % 2
    nbytes = planes * stride
    lines = _lines(data, 128, nbytes, h)
    if nbytes % w and nbytes > w:  # Pillow's decoder packs the planes to `w` bytes apart
        bands = nbytes // w
        step = nbytes // bands
        for i in range(1, bands):
            lines[:, i * w:(i + 1) * w] = lines[:, i * step:i * step + w].copy()
    if mode == "1":
        bitsrow = np.unpackbits(lines, axis=1)[:, :w]
        return pillow_modes.to_rgb("1", bitsrow)
    if mode == "P" and bits == 1:  # P;2L / P;4L: plane k's bit is bit k of the index
        s = (w + 7) // 8
        idx = np.zeros((h, w), np.uint8)
        for k in range(planes):
            idx |= np.unpackbits(lines[:, k * s:(k + 1) * s], axis=1)[:, :w] << k
        return pillow_modes.to_rgb("P", idx, table)
    if mode == "RGB":
        return np.ascontiguousarray(lines[:, :3 * w].reshape(h, 3, w).transpose(0, 2, 1))
    return pillow_modes.to_rgb(mode, lines[:, :w], table)
