"""SGI image decoding as Pillow's convert("RGB") reads it.

One channel (grey), three (RGB) or four (RGBA, alpha dropped) of 8 or 16
bits; a 16-bit sample gives its high byte. Uncompressed channels lie one
after another; RLE rows are found through the offset and length tables
after the 512-byte header (a count byte, or 16-bit word, whose top bit
says copy and whose low seven bits count the samples, 0 ending the row).
Rows are stored bottom-up. Dimension and channel counts outside Pillow's
table are refused; so are a row that runs past its width or its data, and
data that ends early.
"""

from __future__ import annotations

import struct

import numpy as np

# (bytes a sample, dimension, channels) -> Pillow's mode
_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L", (1, 3, 3): "RGB", (2, 3, 3): "RGB",
          (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}


def claims(data) -> bool:
    """Pillow's SGI signature: the big-endian magic 474."""
    return len(data) >= 2 and struct.unpack_from(">H", bytes(data[:2]))[0] == 474


def _corrupt(msg: str) -> ValueError:
    return ValueError(f"corrupt SGI data: {msg}")


def _row(data: bytes, start: int, length: int, width: int, size: int) -> np.ndarray:
    """One RLE row of `length` bytes at `start` -> its `width` samples."""
    if start < 512 or start + length > len(data):
        raise _corrupt("an RLE row past the data (buffer overrun)")
    fmt = ">H" if size == 2 else "B"
    vals = np.frombuffer(data, fmt, length // size, start).astype(np.int64) if length // size else []
    out, x, i, n = np.zeros(width, np.int64), 0, 0, len(vals)
    while i < n:
        v = int(vals[i])
        i += 1
        count = v & 0x7F
        if not count:
            break
        if x + count > width:
            raise _corrupt("an RLE row longer than the image (buffer overrun)")
        if v & 0x80:
            if i + count > n:
                raise _corrupt("an RLE copy past its row's data (buffer overrun)")
            out[x:x + count] = vals[i:i + count]
            i += count
        else:
            if i >= n:
                raise _corrupt("an RLE run past its row's data (buffer overrun)")
            out[x:x + count] = vals[i]
            i += 1
        x += count
    else:
        raise _corrupt("an RLE row without its terminating 0")
    return out


def decode(data) -> np.ndarray:
    """SGI bytes -> uint8 [H, W, 3]."""
    data = bytes(data)
    if not claims(data) or len(data) < 512:
        raise ValueError("not an SGI image (bad magic or a short header)")
    comp, size = data[2], data[3]
    dim, w, h, z = struct.unpack_from(">HHHH", data, 4)
    mode = _MODES.get((size, dim, z))
    if mode is None:
        raise ValueError(f"an SGI of {size}-byte samples, dimension {dim}, {z} channels (unsupported SGI mode)")
    if comp == 0:
        need = w * h * z * size
        if 512 + need > len(data):
            raise _corrupt("the image data ends early (image file is truncated)")
        px = np.frombuffer(data, ">u2" if size == 2 else np.uint8, w * h * z, 512).reshape(z, h, w)
    elif comp == 1:
        n = h * z
        if 512 + 8 * n > len(data):
            raise _corrupt("the RLE tables run past the end (truncated)")
        starts = struct.unpack_from(f">{n}I", data, 512)
        lengths = struct.unpack_from(f">{n}I", data, 512 + 4 * n)
        px = np.stack([np.stack([_row(data, starts[c * h + y], lengths[c * h + y], w, size) for y in range(h)])
                       for c in range(z)])
    else:
        raise ValueError(f"SGI compression {comp}, which Pillow does not read")
    px = px.astype(np.int64)
    if size == 2:
        px = px >> 8
    px = px.astype(np.uint8)[:, ::-1].transpose(1, 2, 0)
    return np.ascontiguousarray(np.repeat(px, 3, axis=2) if z == 1 else px[..., :3])
