"""GIF decoding and encoding without an imaging package.

`decode(data, flavour)` gives the first frame of a GIF as uint8 [H, W, 3],
as each reference composes it (`expand_animations=False` in the JAX RLDS
path): flavour "tf" as TensorFlow's decode_image (giflib), "pillow" as
Pillow's convert("RGB"). The blocks are read here, the first image's LZW
data decoded through the host helper (`native/rlds_host.gif_lzw`),
interlaced rows put in order, and the frame drawn on its canvas with its
local or the global colour table:

- TensorFlow sizes the canvas by the largest frame of the file, fills it
  with black where the first frame does not cover it and where a pixel is
  the frame's transparent index, and refuses an index past the colour
  table.
- Pillow sizes it by the logical screen, grown to hold the first frame
  where that reaches past it, fills it with the transparent index (or
  index 0 without one) and maps every index, the transparent one too,
  through the colour table (black past its end).

Both read the whole file: a block structure cut short raises ValueError (a
file that ends where its trailer would start is read as complete), as do
bad LZW data and a frame without a colour table.

`encode` is the fixture writer: one or more frames, their offsets, local
or global tables, interlacing and a transparent index.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mla_tpu_torch.native import rlds_host
from mla_tpu_torch.vla.rlds import pillow_modes

SIGNATURES = (b"GIF87a", b"GIF89a")
FLAVOURS = ("tf", "pillow")


@dataclass
class _Frame:
    left: int
    top: int
    width: int
    height: int
    interlace: bool
    table: Optional[np.ndarray]
    transparent: Optional[int]
    min_code: int = 0
    data: bytes = b""


@dataclass
class _File:
    width: int
    height: int
    table: Optional[np.ndarray]
    frames: List[_Frame] = field(default_factory=list)


def _corrupt(msg: str) -> ValueError:
    return ValueError(f"corrupt GIF data: {msg}")


def _sub_blocks(data: bytes, pos: int) -> Tuple[bytes, int]:
    """The data sub-blocks at `pos` joined, and where the terminator ends."""
    parts = []
    while True:
        if pos >= len(data):
            raise _corrupt("the data ends inside a block (truncated)")
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(parts), pos
        if pos + n > len(data):
            raise _corrupt("the data ends inside a block (truncated)")
        parts.append(data[pos:pos + n])
        pos += n


def _table(data: bytes, pos: int, flags: int) -> Tuple[Optional[np.ndarray], int]:
    if not flags & 0x80:
        return None, pos
    n = 2 << (flags & 7)
    if pos + 3 * n > len(data):
        raise _corrupt("the data ends inside a colour table (truncated)")
    return np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3), pos + 3 * n


def _parse(data: bytes) -> _File:
    if data[:6] not in SIGNATURES:
        raise ValueError("not a GIF image (bad signature)")
    if len(data) < 13:
        raise _corrupt("a short screen descriptor (truncated)")
    width, height, flags = struct.unpack("<HHB", data[6:11])
    table, pos = _table(data, 13, flags)
    f = _File(width, height, table)
    transparent = None
    while pos < len(data):  # both references accept a file that ends where its trailer would be
        kind = data[pos]
        pos += 1
        if kind == 0x3B:
            break
        if kind == 0x21:
            if pos >= len(data):
                raise _corrupt("the data ends inside an extension (truncated)")
            label = data[pos]
            body, pos = _sub_blocks(data, pos + 1)
            if label == 0xF9 and len(body) >= 4:  # graphic control: applies to the next image
                transparent = body[3] if body[0] & 1 else None
        elif kind == 0x2C:
            if pos + 9 > len(data):
                raise _corrupt("the data ends inside an image descriptor (truncated)")
            left, top, w, h, iflags = struct.unpack("<HHHHB", data[pos:pos + 9])
            local, pos = _table(data, pos + 9, iflags)
            if pos >= len(data):
                raise _corrupt("the data ends before the image data (truncated)")
            frame = _Frame(left, top, w, h, bool(iflags & 0x40), local, transparent, data[pos])
            frame.data, pos = _sub_blocks(data, pos + 1)
            f.frames.append(frame)
            transparent = None
        else:
            raise _corrupt(f"an unknown block type {kind:#04x}")
    if not f.frames:
        raise _corrupt("a file without an image")
    return f


def _deinterlace(px: np.ndarray) -> np.ndarray:
    """Rows stored in the four interlace passes -> rows in order."""
    h = px.shape[0]
    order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4), np.arange(1, h, 2)])
    out = np.empty_like(px)
    out[order] = px
    return out


def decode(data, flavour: str = "tf", lzw=rlds_host.gif_lzw) -> np.ndarray:
    """GIF bytes -> the first frame, uint8 [H, W, 3], as `flavour`'s
    reference composes it. `lzw` is the host loop (rlds_host.gif_lzw_plain
    in the tests)."""
    if flavour not in FLAVOURS:
        raise ValueError(f"flavour {flavour!r} is not one of {FLAVOURS}")
    f = _parse(bytes(data))
    fr = f.frames[0]
    table = fr.table if fr.table is not None else f.table
    if table is None:
        raise _corrupt("a frame without a colour table")
    if not 2 <= fr.min_code <= 11:
        raise _corrupt(f"an LZW minimum code size of {fr.min_code}")
    px = lzw(fr.data, fr.min_code, fr.width * fr.height).reshape(fr.height, fr.width)
    if fr.interlace:
        px = _deinterlace(px)
    if flavour == "tf":
        width, height = max(g.width for g in f.frames), max(g.height for g in f.frames)
        if width == 0 or height == 0:
            raise _corrupt("a frame of no pixels")
        out = np.zeros((height, width, 3), np.uint8)
        x0, y0 = min(fr.left, width), min(fr.top, height)
        x1, y1 = min(fr.left + fr.width, width), min(fr.top + fr.height, height)
        idx = px[y0 - fr.top:y1 - fr.top, x0 - fr.left:x1 - fr.left]
        shown = idx != fr.transparent if fr.transparent is not None else np.ones(idx.shape, bool)
        if (idx[shown] >= len(table)).any():
            raise _corrupt(f"a colour index outside the colour table of {len(table)}")
        out[y0:y1, x0:x1] = np.where(shown[..., None], table[np.minimum(idx, len(table) - 1)], 0)
        return out
    x1, y1 = fr.left + fr.width, fr.top + fr.height
    canvas = np.full((max(f.height, y1), max(f.width, x1)), fr.transparent or 0, np.uint8)
    canvas[fr.top:y1, fr.left:x1] = px
    return pillow_modes.palette(canvas, table)


# --------------------------------------------------------------------------- #
# encoding: the fixture writer
# --------------------------------------------------------------------------- #


def _lzw_encode(indices: np.ndarray, min_code: int) -> bytes:
    """Colour indices -> LZW code stream, a clear code first and whenever
    the table fills."""
    clear, eoi = 1 << min_code, (1 << min_code) + 1
    codes: List[Tuple[int, int]] = [(clear, min_code + 1)]
    table, size, cur = {}, min_code + 1, None
    nxt = clear + 2
    for b in indices.tobytes():
        if cur is None:
            cur = b
            continue
        key = (cur, b)
        if key in table:
            cur = table[key]
            continue
        codes.append((cur, size))
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            if nxt == (1 << size) + 1 and size < 12:  # the decoder widens as it adds code 1 << size
                size += 1
        else:
            codes.append((clear, size))
            table, size, nxt = {}, min_code + 1, clear + 2
        cur = b
    if cur is not None:
        codes.append((cur, size))
    codes.append((eoi, size))
    acc = bits = 0
    out = bytearray()
    for code, n in codes:
        acc |= code << bits
        bits += n
        while bits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            bits -= 8
    if bits:
        out.append(acc & 0xFF)
    return bytes(out)


def _blocks(body: bytes) -> bytes:
    return b"".join(bytes([len(body[i:i + 255])]) + body[i:i + 255] for i in range(0, len(body), 255)) + b"\x00"


def _table_bytes(table: np.ndarray) -> Tuple[bytes, int]:
    table = np.asarray(table, np.uint8).reshape(-1, 3)
    bits = max(1, int(np.ceil(np.log2(max(len(table), 2)))))
    full = np.zeros((1 << bits, 3), np.uint8)
    full[:len(table)] = table
    return full.tobytes(), 0x80 | (bits - 1)


def encode(frames: Sequence[np.ndarray], table: Optional[np.ndarray] = None, screen: Optional[Tuple[int, int]] = None,
           offsets: Optional[Sequence[Tuple[int, int]]] = None, local_tables: Optional[Sequence] = None,
           interlace: bool = False, transparent: Optional[int] = None, min_code: int = 8) -> bytes:
    """Frames of colour indices (uint8 [h, w] each) -> GIF89a bytes:
    `table` the global colour table ([n, 3]), `screen` the logical
    screen's (width, height) (default the first frame's), `offsets` each
    frame's (left, top), `local_tables` each frame's own table or None,
    `transparent` the index every frame's graphic control block names."""
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    h0, w0 = frames[0].shape
    sw, sh = screen or (w0, h0)
    out = bytearray(b"GIF89a")
    gtab, gflags = _table_bytes(table) if table is not None else (b"", 0)
    out += struct.pack("<HHBBB", sw, sh, gflags, 0, 0) + gtab
    for i, px in enumerate(frames):
        left, top = offsets[i] if offsets else (0, 0)
        if transparent is not None:
            out += b"\x21\xf9\x04" + struct.pack("<BHB", 1, 0, transparent) + b"\x00"
        local = local_tables[i] if local_tables else None
        ltab, lflags = _table_bytes(local) if local is not None else (b"", 0)
        rows = px
        if interlace:
            h = px.shape[0]
            rows = px[np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4), np.arange(1, h, 2)])]
        out += b"\x2c" + struct.pack("<HHHHB", left, top, px.shape[1], px.shape[0],
                                     lflags | (0x40 if interlace else 0)) + ltab
        out += bytes([min_code]) + _blocks(_lzw_encode(rows, min_code))
    return bytes(out + b"\x3b")
