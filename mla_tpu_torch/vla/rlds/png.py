"""PNG decoding and encoding without an imaging package.

The JAX pipeline decodes frames with TensorFlow's `tf.io.decode_image(...,
channels=3)` (libpng). The port reads the chunks itself, inflates the image
data with zlib and un-filters it through the host helper
(`native/rlds_host.py`). It decodes every colour type (grey, grey with
alpha, RGB, RGBA, palette) at every bit depth PNG allows (1, 2, 4, 8, 16),
plain or Adam7-interlaced, into uint8 [H, W, 3]: grey repeated into three
channels, alpha and tRNS dropped, the palette expanded. The two references
differ in how 16-bit grey becomes bytes (`_to_uint8`): libpng under
TensorFlow keeps the high byte, as both do for 16-bit colour; Pillow clips
it to 255. They differ too in how much of the stream they read: libpng
checks every critical chunk's CRC up to IEND, while Pillow reads the run
of IDAT chunks, unchecked, only until its last row inflates, so a stream
cut after that still decodes.

`encode` writes RGB images with zlib, each row filtered by the usual
heuristic (the filter type whose output has the least sum of absolute
values) or by one forced filter type; `encode_samples` writes any colour
type, depth and interlacing, for the fixtures and the tests.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from mla_tpu_torch.native import rlds_host
from mla_tpu_torch.vla.rlds import pillow_modes

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # by colour type
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_CRITICAL = (b"IHDR", b"PLTE", b"IDAT", b"IEND")


def _chunks(data: bytes, lenient: bool = False):
    """The chunks in order, each critical one's CRC checked, to IEND. With
    `lenient` (Pillow's reading) the run of IDAT chunks ends the walk: their
    CRCs go unchecked, and the last may be cut short by the end of the data;
    nothing after them is needed."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG image (bad signature)")
    pos, seen_idat = len(SIGNATURE), False
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if lenient and seen_idat and kind != b"IDAT":
            return
        body = data[pos + 8:pos + 8 + n]
        if lenient and kind == b"IDAT":
            seen_idat = True
            yield kind, body
            pos += 12 + n
            continue
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"PNG chunk {kind!r} runs past the end of the image")
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if kind in _CRITICAL and zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    if not (lenient and seen_idat):
        raise ValueError("PNG image ends without an IEND chunk")


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
FLAVOURS = ("tf", "pillow")


def _unpack(rows: np.ndarray, width: int, ch: int, depth: int) -> np.ndarray:
    """Un-filtered scanlines [h, stride] -> the samples [h, width, ch]
    (uint8, or uint16 at depth 16)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :width * ch].reshape(h, width, ch)
    if depth == 16:
        return rows[:, :2 * width * ch].reshape(h, width * ch, 2).view(">u2")[..., 0].astype(np.uint16).reshape(
            h, width, ch)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth].reshape(h, width, depth)
    return (bits.astype(np.uint8) << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)[..., None]


def _samples(data: bytes, width: int, height: int, ch: int, depth: int, interlace: int, unfilter) -> np.ndarray:
    """The image data -> its samples [height, width, ch]: one pass, or the
    seven Adam7 passes each un-filtered as an image of its own and
    scattered to its pixels."""
    def rows_of(w, h, pos):
        stride = -(-w * ch * depth // 8)
        n = h * (stride + 1)
        if pos + n > len(data):
            raise ValueError(f"PNG image data holds {len(data)} bytes, fewer than its rows need")
        return _unpack(unfilter(data[pos:pos + n], h, stride, max(1, ch * depth // 8)), w, ch, depth), pos + n

    if not interlace:
        if len(data) != height * (-(-width * ch * depth // 8) + 1):
            raise ValueError(f"PNG image data holds {len(data)} bytes, expected {height} rows")
        return rows_of(width, height, 0)[0]
    out = np.zeros((height, width, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in ADAM7:
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w <= 0 or h <= 0:
            continue
        out[y0::dy, x0::dx], pos = rows_of(w, h, pos)
    if pos != len(data):
        raise ValueError(f"PNG image data holds {len(data)} bytes, expected {pos}")
    return out


def _passes(width: int, height: int, interlace: int):
    """(width, height) of each pass that holds pixels: the image, or Adam7's."""
    if not interlace:
        return [(width, height)]
    sizes = [(-(-(width - x0) // dx), -(-(height - y0) // dy)) for x0, y0, dx, dy in ADAM7]
    return [(w, h) for w, h in sizes if w > 0 and h > 0]


def _to_uint8(px: np.ndarray, depth: int, ctype: int, flavour: str) -> np.ndarray:
    """Grey or colour samples of `depth` bits -> uint8, as each reference
    reduces them: both scale sub-byte grey to 0..255; libpng under
    TensorFlow keeps the high byte of every 16-bit sample
    (png_set_strip_16), Pillow that of colour and grey with alpha, and
    clips 16-bit grey ("I;16") to 255."""
    if depth == 8:
        return px
    if depth < 8:
        return (px * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if flavour == "pillow" and ctype == 0:
        return pillow_modes.to_l("I;16", px)
    return (px >> 8).astype(np.uint8)


def decode(data, flavour: str = "tf", unfilter=rlds_host.png_unfilter) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3]: flavour "tf" gives
    tf.io.decode_image(channels=3)'s pixels, "pillow" Pillow's
    convert("RGB") pixels. Every colour type, bit depth and Adam7
    interlacing; tRNS and alpha are dropped, grey repeated, a palette
    expanded. `unfilter` is the host loop (rlds_host.png_unfilter_plain
    in the tests)."""
    if flavour not in FLAVOURS:
        raise ValueError(f"flavour {flavour!r} is not one of {FLAVOURS}")
    data = bytes(data)
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, lenient=flavour == "pillow"):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("PNG IHDR chunk of a bad length")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG image without an IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not valid")
    if depth not in _DEPTHS[ctype] or interlace > 1 or width == 0 or height == 0:
        raise ValueError(f"PNG header: {width} x {height}, colour type {ctype}, bit depth {depth}, "
                         f"interlace {interlace}")
    ch = _CHANNELS[ctype]
    try:
        if flavour == "tf":
            raw = zlib.decompress(b"".join(idat))
        else:  # Pillow inflates only as far as the last row and needs no end to the stream
            need = sum(h * (-(-w * ch * depth // 8) + 1) for w, h in _passes(width, height, interlace))
            raw = zlib.decompressobj().decompress(b"".join(idat), need)
            if len(raw) < need:
                raise ValueError(f"PNG image data ends after {len(raw)} of its {need} bytes (truncated)")
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from None
    px = _samples(raw, width, height, ch, depth, interlace, unfilter)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG image without a PLTE chunk")
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index past the palette")
        return palette[px[..., 0]]
    px = _to_uint8(px, depth, ctype, flavour)
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


def _pack(px: np.ndarray, depth: int) -> np.ndarray:
    """Samples [h, w, ch] of `depth` bits -> scanline bytes [h, stride]."""
    h, w, ch = px.shape
    if depth == 8:
        return px.astype(np.uint8).reshape(h, w * ch)
    if depth == 16:
        return px.astype(">u2").reshape(h, w * ch).view(np.uint8)
    bits = (px.reshape(h, w, 1).astype(np.uint8) >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1
    return np.packbits(bits.reshape(h, w * depth), axis=1)


def _filter_rows(lines: np.ndarray, bpp: int, filter_type: Optional[int]) -> bytes:
    h = lines.shape[0]
    if filter_type is None:
        outs = _filtered(lines, bpp, range(5))
        kinds = np.abs(outs.view(np.int8).astype(np.int64)).sum(-1).argmin(0)
        rows = outs[kinds, np.arange(h)]
    else:
        kinds = np.full(h, filter_type)
        rows = _filtered(lines, bpp, (filter_type,))[0]
    return np.concatenate([kinds.astype(np.uint8)[:, None], rows], axis=1).tobytes()


def encode_samples(px: np.ndarray, ctype: int, depth: int, interlace: bool = False, palette=None, trns=None,
                   filter_type: Optional[int] = None, level: int = 6) -> bytes:
    """Raw samples [H, W, channels of `ctype`] of `depth` bits -> PNG
    bytes of that colour type and depth, Adam7-interlaced when asked, with
    a PLTE (palette [n, 3] uint8) and a tRNS (`trns`, its body) where
    given. Rows are filtered as in `encode`."""
    px = np.asarray(px)
    if px.ndim == 2:
        px = px[..., None]
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or px.ndim != 3 or px.shape[2] != _CHANNELS[ctype]:
        raise ValueError(f"samples {px.shape} for colour type {ctype} at depth {depth}")
    if filter_type is not None and filter_type not in range(5):
        raise ValueError(f"PNG filter type {filter_type} is not 0..4")
    h, w, ch = px.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b"".join(_filter_rows(_pack(px[y0::dy, x0::dx], depth), bpp, filter_type)
                   for x0, y0, dx, dy in passes if x0 < w and y0 < h)
    out = SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", bytes(trns))
    return out + _chunk(b"IDAT", zlib.compress(raw, level)) + _chunk(b"IEND", b"")


def encode(img: np.ndarray, filter_type: Optional[int] = None, level: int = 6) -> bytes:
    """uint8 [H, W, 3] -> PNG bytes (8-bit RGB, not interlaced). Each row is
    filtered by `filter_type` (0..4) where given, else by the type whose
    output has the least sum of absolute values as signed bytes."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode takes uint8 [H, W, 3], got {img.shape}")
    return encode_samples(img, 2, 8, filter_type=filter_type, level=level)
