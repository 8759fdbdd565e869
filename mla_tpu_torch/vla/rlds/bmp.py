"""BMP decoding and encoding without an imaging package.

`decode(data, flavour)` gives a BMP as uint8 [H, W, 3]:

- flavour "tf", as TensorFlow's decode_bmp under decode_image(channels=3):
  it reads only the pixel offset, width, height and bit count of the
  headers, takes 8 bits a pixel as grey (a palette is not applied), 24 as
  BGR and 32 as BGRA (alpha dropped), ignores the compression field, and
  refuses other bit counts, a width or height of 0 and a file whose size is
  not the pixel offset plus its padded rows.
- flavour "pillow", as Pillow's convert("RGB"): the core (12-byte) and
  the 40- to 124-byte info headers; 1, 4 and 8 bits a pixel through the
  palette (black past its end; 2 bits are refused), 16 bits as 5-5-5 or by 5-6-5 bit fields,
  24 bits, 32 bits as BGRX or by the bit-field layouts Pillow reads; RLE8
  and RLE4 compression as Pillow's own decoder reads them (`_rle`).

Rows are bottom-up, or top-down for a negative height. A malformed file
raises ValueError; a layout the reference refuses too raises ValueError
with its reason.

`encode` is the fixture writer: any of those layouts from raw rows.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from mla_tpu_torch.vla.rlds import pillow_modes

SIGNATURE = b"BM"
FLAVOURS = ("tf", "pillow")
_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
# Pillow's bit-field layouts (r, g, b, a masks) -> the channel order and
# bits of each: 32 bits a pixel of four bytes, 16 as BGR;16 or BGR;15
_FIELDS32 = {(0xFF0000, 0xFF00, 0xFF, 0): "BGRX", (0xFF000000, 0xFF0000, 0xFF00, 0): "XBGR",
             (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA", (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
             (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR", (0, 0, 0, 0): "BGRA"}
_FIELDS16 = {(0xF800, 0x7E0, 0x1F): (11, 5, 0, 31, 63, 31), (0x7C00, 0x3E0, 0x1F): (10, 5, 0, 31, 31, 31)}


def _corrupt(msg: str) -> ValueError:
    return ValueError(f"corrupt BMP data: {msg}")


def _i32(data: bytes, pos: int) -> int:
    return struct.unpack_from("<i", data, pos)[0]


def _decode_tf(data: bytes) -> np.ndarray:
    if len(data) < 32:
        raise _corrupt(f"{len(data)} bytes, fewer than the 32 the headers need")
    offset, width, height = _i32(data, 10), _i32(data, 18), _i32(data, 22)
    bpp = struct.unpack_from("<h", data, 28)[0]
    ch = bpp // 8
    if ch not in (1, 3, 4):
        raise ValueError(f"a BMP of {bpp} bits a pixel: TensorFlow reads 8, 24 and 32")
    if width <= 0 or height == 0 or offset < 0:
        raise _corrupt(f"width {width}, height {height}, pixel offset {offset}")
    row = (ch * width + 3) // 4 * 4
    if len(data) - offset - row * abs(height) != 0:
        raise _corrupt(f"{len(data)} bytes, not the pixel offset {offset} + {abs(height)} rows of {row}")
    px = np.frombuffer(data, np.uint8, row * abs(height), offset).reshape(abs(height), row)[:, :ch * width]
    px = px.reshape(abs(height), width, ch)
    if height > 0:
        px = px[::-1]
    if ch == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., 2::-1])


def _rle(data: bytes, start: int, width: int, height: int, four: bool) -> np.ndarray:
    """An RLE8 or RLE4 stream at data[start:] -> indices [height, width] in
    stored row order, as Pillow's BmpRleDecoder writes them: one running
    buffer, an encoded run cut at its row's end, an absolute RLE4 run of
    n // 2 bytes giving two pixels each, a delta that skips two bytes and
    reads its offsets from the next two, word alignment by the position in
    the file. A stream that ends before the last pixel raises."""
    need = width * height
    out = bytearray()
    x, pos, n = 0, start, len(data)
    while len(out) < need:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = min(count, max(0, width - x))
            out += bytes([byte >> 4, byte & 15] * count)[:count] if four else bytes([byte]) * count
            x += count
        elif byte == 0:
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if pos + 4 > n:
                raise _corrupt("the data ends inside an RLE delta (truncated)")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * width)
            x = len(out) % width
        else:
            nbytes = byte // 2 if four else byte
            got = data[pos:pos + nbytes]
            pos += len(got)
            out += bytes(v for b in got for v in (b >> 4, b & 15)) if four else got
            if len(got) < nbytes:
                break
            x += byte
            pos += pos % 2
    if len(out) < need:
        raise _corrupt("the RLE data ends before the last pixel (not enough image data)")
    return np.frombuffer(bytes(out[:need]), np.uint8).reshape(height, width)


def _decode_pillow(data: bytes) -> np.ndarray:
    if len(data) < 26:
        raise _corrupt("a short header (truncated)")
    offset, hsize = _i32(data, 10), _i32(data, 14)
    if hsize == 12:
        width, height, _, bpp = struct.unpack_from("<HHHH", data, 18)
        height, comp, colours, pal_entry = int(np.int16(height)), _RAW, 0, 3
    elif hsize in (40, 52, 56, 64, 108, 124):
        if len(data) < 14 + hsize:
            raise _corrupt("a short header (truncated)")
        width, height, _, bpp, comp = struct.unpack_from("<iiHHI", data, 18)
        colours, pal_entry = struct.unpack_from("<I", data, 46)[0], 4
    else:
        raise ValueError(f"a BMP info header of {hsize} bytes, which Pillow does not read")
    if width <= 0 or height == 0:
        raise _corrupt(f"width {width}, height {height}")
    top_down, height = height < 0, abs(height)
    if comp == _BITFIELDS:  # a 40-byte header's three masks follow it; a longer one holds them
        masks = struct.unpack_from("<III", data, 54) + (struct.unpack_from("<I", data, 66) if hsize >= 56 else (0,))
    if bpp <= 8:
        pal_at = 14 + hsize
        n = min(colours or (1 << bpp), max(0, len(data) - pal_at) // pal_entry)  # as much as the file holds
        table = np.frombuffer(data, np.uint8, n * pal_entry, pal_at).reshape(n, pal_entry)[:, 2::-1]
    if comp in (_RLE8, _RLE4):
        if (comp, bpp) not in ((_RLE8, 8), (_RLE4, 4)):
            raise ValueError(f"a BMP of compression {comp} at {bpp} bits a pixel")
        idx = _rle(data, offset, width, height, comp == _RLE4)
        return pillow_modes.palette(idx if top_down else idx[::-1], table)
    if comp not in (_RAW, _BITFIELDS) or bpp not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"a BMP of compression {comp} at {bpp} bits a pixel, which Pillow does not read")
    row = (bpp * width + 31) // 32 * 4
    if offset + row * (height - 1) + (bpp * width + 7) // 8 > len(data):  # the last row's padding may be missing
        raise _corrupt("the data ends before the last row (truncated)")
    rows = np.frombuffer(data + bytes(row), np.uint8, row * height, offset).reshape(height, row)
    if not top_down:
        rows = rows[::-1]
    if bpp <= 8:
        bits = np.unpackbits(rows, axis=1)[:, :width * bpp].reshape(height, width, bpp)
        idx = (bits << np.arange(bpp - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)
        return pillow_modes.palette(idx, table)
    if bpp == 24:
        return np.ascontiguousarray(rows[:, :3 * width].reshape(height, width, 3)[..., ::-1])
    if bpp == 16:
        layout = _FIELDS16.get(tuple(masks[:3])) if comp == _BITFIELDS else _FIELDS16[(0x7C00, 0x3E0, 0x1F)]
        if layout is None:
            raise ValueError(f"BMP bit fields {[hex(m) for m in masks[:3]]}, which Pillow does not read")
        v = rows[:, :2 * width].reshape(height, width, 2).astype(np.int32)
        v = v[..., 0] | (v[..., 1] << 8)
        rs, gs, bs, rm, gm, bm = layout
        return np.stack([((v >> s) & m) * 255 // m for s, m in ((rs, rm), (gs, gm), (bs, bm))], -1).astype(np.uint8)
    order = "BGRX"
    if comp == _BITFIELDS:
        order = _FIELDS32.get(masks)
        if order is None:
            raise ValueError(f"BMP bit fields {[hex(m) for m in masks]}, which Pillow does not read")
    px = rows[:, :4 * width].reshape(height, width, 4)
    return np.ascontiguousarray(px[..., [order.index(c) for c in "RGB"]])


def decode(data, flavour: str = "tf") -> np.ndarray:
    """BMP bytes -> uint8 [H, W, 3], as `flavour`'s reference decodes
    them."""
    if flavour not in FLAVOURS:
        raise ValueError(f"flavour {flavour!r} is not one of {FLAVOURS}")
    data = bytes(data)
    if data[:2] != SIGNATURE:
        raise ValueError("not a BMP image (bad signature)")
    return _decode_tf(data) if flavour == "tf" else _decode_pillow(data)


# --------------------------------------------------------------------------- #
# encoding: the fixture writer
# --------------------------------------------------------------------------- #


def encode(pixels: bytes, width: int, height: int, bpp: int, palette: Optional[np.ndarray] = None,
           compression: int = _RAW, masks: Optional[Tuple[int, ...]] = None, header_size: int = 40,
           top_down: bool = False) -> bytes:
    """`pixels` (rows as stored: padded to 4 bytes, bottom-up unless
    `top_down`, or an RLE stream) -> BMP bytes with a `header_size` info
    header, `palette` ([n, 3] RGB) and bit-field `masks` where given."""
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]
        if header_size != 12:
            p = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], axis=1)
        pal = p.tobytes()
    extra = b"".join(struct.pack("<I", m) for m in masks) if masks and header_size == 40 else b""
    if header_size == 12:
        info = struct.pack("<IHHHH", 12, width, height & 0xFFFF, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", header_size, width, -height if top_down else height, 1, bpp,
                           compression, len(pixels), 2835, 2835, len(palette) if palette is not None else 0, 0)
        tail = b"".join(struct.pack("<I", m) for m in (masks or ())) if header_size > 40 else b""
        info += (tail + bytes(header_size))[:header_size - 40]
    offset = 14 + len(info) + len(extra) + len(pal)
    return SIGNATURE + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + extra + pal + bytes(pixels)
