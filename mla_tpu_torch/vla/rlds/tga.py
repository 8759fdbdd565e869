"""TGA (Targa) decoding as Pillow's convert("RGB") reads it.

TGA has no signature: Pillow tries it after every other format and takes a
stream whose 18-byte header is plausible (`claims`): a colour-map type of 0
or 1, a width and height above 0, a depth of 1, 8, 16, 24 or 32 bits.
Image types 1 and 9 (colour-mapped; grey without a colour map, which Pillow
cannot unpack), 2 and 10 (true colour: 24 bits RGB, 16 bits 5-5-5 and 32
bits RGBA, alpha dropped), 3 and 11 (grey: 1 bit, 8 bits, 16 bits grey and
alpha); types 9 to 11 are run-length coded, a run or a raw packet of up to
128 pixels, across rows (at 1 bit Pillow never fills the image, and refuses
it). The colour map is 16 or 24 bits an entry from its first index (Pillow
cannot unpack one of 32). Rows are bottom-up unless the origin bit 0x20 is
set, and mirrored where 0x10 is. A depth that suits no layout of its type,
and data that ends early, raise ValueError, as Pillow refuses them.
"""

from __future__ import annotations

import struct

import numpy as np

from mla_tpu_torch.vla.rlds import pillow_modes

# (image type & 7, depth) -> the bytes a pixel of the layout Pillow unpacks
_LAYOUTS = {(1, 8): 1, (3, 1): 1, (3, 8): 1, (3, 16): 2, (2, 16): 2, (2, 24): 3, (2, 32): 4}


def claims(data) -> bool:
    """Whether Pillow's TGA reader accepts the header."""
    s = bytes(data[:18])
    if len(s) < 18:
        return False
    w, h = struct.unpack_from("<HH", s, 12)
    return s[1] in (0, 1) and w > 0 and h > 0 and s[16] in (1, 8, 16, 24, 32)


def _corrupt(msg: str) -> ValueError:
    return ValueError(f"corrupt TGA data: {msg}")


def _bgr15(v: np.ndarray) -> np.ndarray:
    """16-bit little-endian 5-5-5 pixels [...] -> RGB [..., 3]."""
    return np.stack([((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)], -1).astype(np.uint8)


def _rle(data: bytes, pos: int, n: int, size: int) -> bytes:
    """Run-length packets from pos -> n pixels of `size` bytes."""
    out, need = bytearray(), n * size
    while len(out) < need:
        if pos >= len(data):
            raise _corrupt("the run-length data ends before the last pixel (image file is truncated)")
        head = data[pos]
        count = (head & 0x7F) + 1
        if head & 0x80:
            px = data[pos + 1:pos + 1 + size]
            pos += 1 + size
            if len(px) < size:
                raise _corrupt("the run-length data ends inside a run (image file is truncated)")
            out += px * count
        else:
            px = data[pos + 1:pos + 1 + size * count]
            pos += 1 + size * count
            if len(px) < size * count:
                raise _corrupt("the run-length data ends inside a packet (image file is truncated)")
            out += px
    return bytes(out[:need])


def decode(data) -> np.ndarray:
    """TGA bytes -> uint8 [H, W, 3], as Pillow's convert("RGB") gives
    them."""
    data = bytes(data)
    if not claims(data):
        raise ValueError("not a TGA image (an implausible header)")
    id_len, cmap_type, itype = data[0], data[1], data[2]
    w, h = struct.unpack_from("<HH", data, 12)
    depth, flags = data[16], data[17]
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        mode = "P" if cmap_type else "L"
    elif itype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise ValueError(f"a TGA of image type {itype}, which Pillow does not read (unknown TGA mode)")
    origin = flags & 0x30
    pos = 18 + id_len
    table = None
    if cmap_type:
        start, size, map_depth = struct.unpack_from("<HHB", data, 3)
        entry = {16: 2, 24: 3}.get(map_depth)
        if map_depth == 32:  # Pillow reads the map as "BGRA", a palette layout it cannot unpack
            raise ValueError("a TGA colour map of 32 bits (unrecognized raw mode)")
        if entry is None:
            raise ValueError(f"a TGA colour map of {map_depth} bits (unknown TGA map depth)")
        raw = data[pos:pos + entry * size]
        pos += entry * size
        raw = raw[:len(raw) // entry * entry]
        if entry == 2:
            cols = _bgr15(np.frombuffer(raw, "<u2").astype(np.int64))
        else:
            cols = np.frombuffer(raw, np.uint8).reshape(-1, 3)[:, ::-1]
        table = np.concatenate([np.zeros((start, 3), np.uint8), cols])
    layout = _LAYOUTS.get((itype & 7, depth))
    if layout is None:  # Pillow sets no tile and cannot load the image
        raise ValueError(f"a TGA of image type {itype} at {depth} bits (cannot load this image)")
    if mode == "L" and itype & 7 == 1:
        raise ValueError("a colour-mapped TGA without a colour map (unknown raw mode)")
    if depth == 1:
        row = (w + 7) // 8
        need, size = row * h, 1
    else:
        size = layout
        need, row = w * h * size, w * size
    if itype & 8:
        if depth == 1:  # Pillow's run-length decoder takes depth // 8 bytes a pixel: none
            raise _corrupt("1-bit run-length data, which Pillow never fills (image file is truncated)")
        buf = _rle(data, pos, need // size, size)
    else:
        if pos + need > len(data):
            raise _corrupt("the image data ends before the last row (image file is truncated)")
        buf = data[pos:pos + need]
    rows = np.frombuffer(buf, np.uint8).reshape(h, row)
    if origin not in (0x20, 0x30):  # bottom-up
        rows = rows[::-1]
    if depth == 1:
        px = np.unpackbits(rows, axis=1)[:, :w]
    elif depth == 16 and mode == "RGBA":
        px = _bgr15(rows.view("<u2").astype(np.int64))
    elif mode in ("RGB", "RGBA"):
        px = rows.reshape(h, w, size)[..., 2::-1]
    else:
        px = rows.reshape(h, w, size)[..., 0]
    if origin in (0x10, 0x30):
        px = px[:, ::-1]
    if mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(px)
    return pillow_modes.to_rgb(mode, px, table)
