"""TIFF decoding without an imaging package, as Pillow's convert("RGB")
reads a TIFF (the JAX VLM stage's `_load_image`).

The first IFD is read (Pillow opens page 0 of a multi-page file): classic
TIFF in either byte order and BigTIFF. Pillow picks the image mode from
the photometric interpretation, sample format, fill order, bits per sample
and extra samples (its OPEN_INFO table, `_MODES` here) and refuses any
other combination. It then reads the pixels one of two ways, and so does
this module:

- uncompressed: Pillow's own raw reader. Each strip or tile is read from
  its offset with the row size of the mode's raw layout (StripByteCounts
  are ignored), bit-reversed where FillOrder is 2, and no predictor is
  applied.
- compressed: libtiff. Each strip or tile is bit-reversed where FillOrder
  is 2 (but for JPEG), decoded (LZW, PackBits and the CCITT fax codes by the host loops of
  `native/rlds_host.py`, Deflate by zlib, LZMA by lzma, JPEG by `jpeg.py`
  with the JPEGTables tag), undone by Predictor 2 or 3 and given in the
  machine's (little-endian) byte order; Pillow then reads those bytes with
  the raw layout of the file's byte order except for 16-bit unsigned and
  colour samples, so a big-endian file's signed 16-bit, 32-bit and float
  samples come out byte-swapped, as Pillow's do. YCbCr that is not JPEG
  goes through libtiff's RGBA interface (`_ycbcr_rgba`): the subsampled
  blocks and libtiff's fixed-point YCbCr -> RGB. JPEG YCbCr is converted
  by libjpeg (fancy upsampling, the accurate IDCT).

Strips and tiles, PlanarConfiguration 1 and 2, Photometric 0, 1, 2, 3, 5
and 6, associated and unassociated alpha are read. The Orientation tag is
applied after decoding, as Pillow's load_end transposes a TIFF. The mode goes to
RGB by `pillow_modes`. ZSTD, WebP, old-style JPEG (6) and the other codecs
Pillow knows raise NotImplementedError citing ROADMAP.md item 2; what
Pillow refuses raises ValueError.
"""

from __future__ import annotations

import lzma
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from mla_tpu_torch.native import jpeg_host, rlds_host
from mla_tpu_torch.vla.rlds import jpeg, pillow_modes

ROADMAP_TIFF = "ROADMAP.md queue 1, item 2 (frame formats: TIFF codecs)"
SIGNATURES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")
# the codecs Pillow names (its COMPRESSION_INFO); the ones decoded here
_CODECS = {1: "raw", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG",
           7: "JPEG", 8: "Adobe Deflate", 32771: "CCITT RLEW", 32773: "PackBits", 32809: "ThunderScan",
           32946: "Deflate", 34676: "SGILog", 34677: "SGILog24", 34925: "LZMA", 50000: "ZSTD", 50001: "WebP"}
_DECODED = (1, 2, 3, 4, 5, 7, 8, 32773, 32946, 34925)
_PREDICTED = (5, 8, 32946, 34925)  # the codecs libtiff runs the predictor after
# tag numbers
(_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC, _FILL, _OFFSETS, _ORIENTATION, _SPP, _ROWS, _COUNTS,
 _PLANAR, _T4, _PREDICTOR, _COLORMAP, _TILE_W, _TILE_L, _TILE_OFFSETS, _TILE_COUNTS, _EXTRA, _FORMAT,
 _JPEG_TABLES, _YCC_COEFFS, _YCC_SUB, _REF_BW) = (256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 292,
                                                  317, 320, 322, 323, 324, 325, 338, 339, 347, 529, 530, 532)
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d",
          13: "I", 16: "Q", 17: "q", 18: "Q"}


def _modes() -> Dict[tuple, Tuple[str, str]]:
    """Pillow's OPEN_INFO: (byte order, photometric, sample format, fill
    order, bits per sample, extra samples) -> (mode, raw layout)."""
    t = {}

    def both(key, mode, raw):
        for order in ("II", "MM"):
            t[(order,) + key] = (mode, raw)

    for fill, r in ((1, ""), (2, "R")):
        both((0, (1,), fill, (1,), ()), "1", "1;I" + r)
        both((1, (1,), fill, (1,), ()), "1", "1;" + r if r else "1")
        for bits in (2, 4):
            both((0, (1,), fill, (bits,), ()), "L", f"L;{bits}I{r}")
            both((1, (1,), fill, (bits,), ()), "L", f"L;{bits}{r}")
            both((3, (1,), fill, (bits,), ()), "P", f"P;{bits}{r}")
        both((0, (1,), fill, (8,), ()), "L", "L;I" + r)
        both((1, (1,), fill, (8,), ()), "L", "L;" + r if r else "L")
        both((3, (1,), fill, (1,), ()), "P", "P;1" + r)
        both((2, (1,), fill, (8, 8, 8), ()), "RGB", "RGB;" + r if r else "RGB")
        both((3, (1,), fill, (8,), ()), "P", "P;" + r if r else "P")
    both((1, (2,), 1, (8,), ()), "L", "L")
    t[("II", 1, (1,), 1, (12,), ())] = ("I;16", "I;12")
    t[("II", 0, (1,), 1, (16,), ())] = t[("II", 1, (1,), 1, (16,), ())] = ("I;16", "I;16")
    t[("MM", 1, (1,), 1, (16,), ())] = ("I;16B", "I;16B")
    t[("II", 1, (1,), 2, (16,), ())] = ("I;16", "I;16R")
    t[("II", 1, (2,), 1, (16,), ())], t[("MM", 1, (2,), 1, (16,), ())] = ("I", "I;16S"), ("I", "I;16BS")
    t[("II", 0, (3,), 1, (32,), ())], t[("MM", 0, (3,), 1, (32,), ())] = ("F", "F;32F"), ("F", "F;32BF")
    t[("II", 1, (1,), 1, (32,), ())] = ("I", "I;32N")
    t[("II", 1, (2,), 1, (32,), ())], t[("MM", 1, (2,), 1, (32,), ())] = ("I", "I;32S"), ("I", "I;32BS")
    t[("II", 1, (3,), 1, (32,), ())], t[("MM", 1, (3,), 1, (32,), ())] = ("F", "F;32F"), ("F", "F;32BF")
    both((1, (1,), 1, (8, 8), (2,)), "LA", "LA")
    for extra, mode, raw in (((), "RGBA", "RGBA"), ((0,), "RGB", "RGBX"), ((0, 0), "RGB", "RGBXX"),
                             ((0, 0, 0), "RGB", "RGBXXX"), ((1,), "RGBA", "RGBa"), ((1, 0), "RGBA", "RGBaX"),
                             ((1, 0, 0), "RGBA", "RGBaXX"), ((2,), "RGBA", "RGBA"), ((2, 0), "RGBA", "RGBAX"),
                             ((2, 0, 0), "RGBA", "RGBAXX"), ((999,), "RGBA", "RGBA")):
        both((2, (1,), 1, (8,) * (3 + max(1, len(extra))), extra), mode, raw)
    for order, e in (("II", "L"), ("MM", "B")):
        t[(order, 2, (1,), 1, (16,) * 3, ())] = ("RGB", "RGB;16" + e)
        for extra, mode, raw in (((), "RGBA", "RGBA"), ((0,), "RGB", "RGBX"), ((1,), "RGBA", "RGBa"),
                                 ((2,), "RGBA", "RGBA")):
            t[(order, 2, (1,), 1, (16,) * 4, extra)] = (mode, raw + ";16" + e)
        t[(order, 5, (1,), 1, (16,) * 4, ())] = ("CMYK", "CMYK;16" + e)
    both((3, (1,), 1, (8, 8), (0,)), "P", "PX")
    both((3, (1,), 1, (8, 8), (2,)), "PA", "PA")
    both((5, (1,), 1, (8,) * 4, ()), "CMYK", "CMYK")
    both((5, (1,), 1, (8,) * 5, (0,)), "CMYK", "CMYKX")
    both((5, (1,), 1, (8,) * 6, (0, 0)), "CMYK", "CMYKXX")
    both((6, (1,), 1, (8,), ()), "L", "L")
    both((6, (1,), 1, (8, 8, 8), ()), "RGB", "RGBX")
    both((8, (1,), 1, (8, 8, 8), ()), "LAB", "LAB")
    return t


_OPEN_INFO = _modes()


def _refused(msg: str) -> ValueError:
    return ValueError(f"{msg}: Pillow refuses such a TIFF")


def _unsupported(msg: str) -> NotImplementedError:
    return NotImplementedError(f"{msg} is not decoded ({ROADMAP_TIFF})")


def _corrupt(msg: str) -> ValueError:
    return ValueError(f"corrupt TIFF data: {msg}")


def _ifd(data: bytes) -> Tuple[str, Dict[int, tuple]]:
    """The header and the first IFD, as Pillow's ImageFileDirectory_v2
    loads it -> (byte order "II" or "MM", tag -> tuple of values). A tag of
    an unknown type, or whose data lies past the end, is skipped."""
    if not data.startswith(SIGNATURES):
        raise ValueError("not a TIFF image (bad signature)")
    end = "<" if data[:2] == b"II" else ">"
    big = data[2] == 43
    if len(data) < (16 if big else 8):
        raise _corrupt("a short header (truncated)")
    pos = struct.unpack_from(end + ("Q" if big else "I"), data, 8 if big else 4)[0]
    head = struct.Struct(end + ("HHQ8s" if big else "HHI4s"))
    try:
        n = struct.unpack_from(end + ("Q" if big else "H"), data, pos)[0]
    except struct.error:
        raise _corrupt("the first IFD lies past the end (truncated)") from None
    pos += 8 if big else 2
    tags: Dict[int, tuple] = {}
    for _ in range(n):
        if pos + head.size > len(data):  # Pillow keeps the tags read before the end
            break
        tag, typ, count, inline = head.unpack_from(data, pos)
        pos += head.size
        fmt = _TYPES.get(typ)
        if fmt is None:
            continue
        size = count * struct.calcsize(end + fmt)
        if size > len(inline):
            at = struct.unpack(end + ("Q" if big else "I"), inline)[0]
            raw = data[at:at + size]
        else:
            raw = inline[:size]
        if len(raw) != size or not raw:
            continue
        vals = struct.unpack(end + fmt * count, raw)
        if typ in (5, 10):  # rationals
            vals = tuple(a / b if b else float("nan") for a, b in zip(vals[::2], vals[1::2]))
        tags[tag] = bytes(raw) if typ in (2, 7) else vals
    return data[:2].decode(), tags


def _one(tags, tag, default=None):
    v = tags.get(tag)
    if v is None:
        return default
    return v[0] if isinstance(v, tuple) else v


_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


# --------------------------------------------------------------------------- #
# raw layouts: Pillow's unpackers
# --------------------------------------------------------------------------- #


def _raw_bits(raw: str) -> int:
    """Bits a pixel of a raw layout."""
    if raw in ("1", "1;I", "1;R", "1;IR", "P;1", "P;1R"):
        return 1
    if raw[:3] in ("L;2", "P;2"):
        return 2
    if raw[:3] in ("L;4", "P;4"):
        return 4
    if raw in ("I;16", "I;16N", "I;16B", "I;16R", "I;16S", "I;16BS", "I;12"):
        return 16
    if raw in ("I;32N", "I;32S", "I;32BS", "F;32F", "F;32BF"):
        return 32
    base, _, depth = raw.partition(";")
    per = 16 if depth.startswith("16") else 8
    return per * len(base) if base not in ("L", "P") else 8


_NO_UNPACKER = ("L;IR", "P;1R", "P;2R", "P;4R")  # layouts of OPEN_INFO that Pillow has no unpacker for


def _unpack(raw: str, rows: np.ndarray, width: int) -> np.ndarray:
    """Byte rows [h, >= row bytes] read by Pillow's unpacker `raw` -> the
    mode's samples [h, width] or [h, width, bands]."""
    if raw in _NO_UNPACKER:
        raise _refused(f"raw layout {raw} (unknown raw mode)")
    h = rows.shape[0]
    bits = _raw_bits(raw)
    nbytes = (bits * width + 7) // 8
    rows = np.ascontiguousarray(rows[:, :nbytes])
    if raw.endswith("R"):  # the fill order's reversed bits
        rows = _REVERSED[rows]
        raw = raw[:-1].rstrip(";")
    if bits < 8:
        v = np.unpackbits(rows, axis=1)[:, :width * bits].reshape(h, width, bits)
        v = (v << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)
        if raw.startswith("P"):
            return v
        if raw.startswith("1"):
            v = v * 255
        else:
            v = (v * (255 // ((1 << bits) - 1))).astype(np.uint8)
        return (255 - v).astype(np.uint8) if "I" in raw[1:] else v.astype(np.uint8)
    if raw in ("L", "L;I", "P"):
        return 255 - rows if raw == "L;I" else rows
    if raw.startswith(("I;", "F;")):
        dt = {"I;16": "<u2", "I;16N": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I;16S": "<i2", "I;16BS": ">i2",
              "I;32N": "<i4", "I;32S": "<i4", "I;32BS": ">i4", "F;32F": "<f4", "F;32BF": ">f4"}.get(raw)
        if dt is None:
            raise _unsupported(f"raw layout {raw}")
        return rows.view(dt).astype(np.float32 if dt.endswith("f4") else np.int64)
    base, _, depth = raw.partition(";")
    px = rows.reshape(h, width, len(base), 2 if depth else 1)
    px = px[..., 0 if depth.startswith("16B") else -1] if depth else px[..., 0]
    keep = [i for i, c in enumerate(base) if c != "X"]
    px = px[..., keep]
    if "a" in base:  # premultiplied: Pillow's RGBa unpackers give straight RGBA
        return np.concatenate([pillow_modes.unpremultiply(px), px[..., 3:]], axis=-1)
    return px


# --------------------------------------------------------------------------- #
# codecs and predictors
# --------------------------------------------------------------------------- #


def _inflate(blob: bytes, n: int, what: str) -> bytes:
    d = zlib.decompressobj() if what == "Deflate" else lzma.LZMADecompressor()
    try:
        out = d.decompress(blob, n)
    except (zlib.error, lzma.LZMAError) as e:
        raise _corrupt(f"the {what} data does not decompress: {e}") from None
    if len(out) < n:
        raise _corrupt(f"the {what} data ends before the strip's last byte")
    return out


def _predict(buf: np.ndarray, predictor: int, bits: int, spp: int, width: int, fmt: int) -> np.ndarray:
    """libtiff's predictors on decoded rows [h, row bytes] (little-endian
    samples): 2 sums each sample with the one spp before it along the row;
    3 sums the row's bytes spp apart, then regathers each float's bytes
    from the row's byte planes."""
    h = buf.shape[0]
    if predictor == 2:
        if bits not in (8, 16, 32):
            raise _refused(f"Predictor 2 with {bits}-bit samples (libtiff refuses it)")
        dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]
        v = buf.view(dt).reshape(h, width, spp)
        return np.cumsum(v, axis=1, dtype=dt).reshape(h, -1).view(np.uint8)
    if fmt != 3 or bits not in (16, 32, 64):
        raise _refused(f"Predictor 3 with {bits}-bit samples of format {fmt} (libtiff refuses it)")
    acc = np.cumsum(buf.reshape(h, -1, spp), axis=1, dtype=np.uint8).reshape(h, -1)
    nb = bits // 8
    # byte k of a sample (most significant first) sits in plane k; little-endian bytes reverse that order
    return np.ascontiguousarray(acc.reshape(h, nb, -1).transpose(0, 2, 1)[..., ::-1]).reshape(h, -1)


def _swab(buf: np.ndarray, bits: int) -> np.ndarray:
    """Big-endian samples -> little-endian, as libtiff's post-decode swab."""
    if bits not in (16, 32, 64):
        return buf
    nb = bits // 8
    return np.ascontiguousarray(buf.reshape(buf.shape[0], -1, nb)[..., ::-1]).reshape(buf.shape[0], -1)


# --------------------------------------------------------------------------- #
# libtiff's YCbCr -> RGB (its RGBA interface)
# --------------------------------------------------------------------------- #


def _ycbcr_tables(luma, ref_bw):
    """TIFFYCbCrToRGBInit's tables, float32 as libtiff computes them."""
    f32 = np.float32
    lr, lg, lb = (f32(x) for x in luma)
    fix = lambda x: np.int64(np.floor(np.float64(x) * 65536 + 0.5))  # noqa: E731 - FIX(x)
    clampw = lambda f, lo, hi: np.clip(f, lo, hi)  # noqa: E731
    f1 = f32(2) - f32(2) * lr
    d1 = fix(min(max(f1, 0), 2))
    f2 = lr * f1 / lg
    d2 = -fix(min(max(f2, 0), 2))
    f3 = f32(2) - f32(2) * lb
    d3 = fix(min(max(f3, 0), 2))
    f4 = lb * f3 / lg
    d4 = -fix(min(max(f4, 0), 2))
    x = np.arange(-128, 128, dtype=np.int64)
    rb = [f32(v) for v in ref_bw]

    def code2v(c, black, white, cr):  # Code2V: the black point cast to an integer first
        den = (white - black) if white - black != 0 else f32(1)
        return (c - np.int64(np.trunc(black))).astype(f32) * f32(cr) / den

    cr = clampw(code2v(x, rb[4] - f32(128), rb[5] - f32(128), 127), -128 * 32, 128 * 32).astype(np.int64)
    cb = clampw(code2v(x, rb[2] - f32(128), rb[3] - f32(128), 127), -128 * 32, 128 * 32).astype(np.int64)
    y = clampw(code2v(x + 128, rb[0], rb[1], 255), -128 * 32, 128 * 32).astype(np.int64)
    half = 1 << 15
    return ((d1 * cr + half) >> 16, (d3 * cb + half) >> 16, d2 * cr, d4 * cb + half, y)


def _ycbcr_rgba(planes: np.ndarray, tags, width: int, height: int) -> np.ndarray:
    """YCbCr samples (contig: subsampled blocks of h x v Y then Cb, Cr, in
    rows of blocks, one strip after another, as `planes` [bytes]) ->
    uint8 [height, width, 3] by libtiff's TIFFYCbCrtoRGB."""
    sh, sv = tags.get(_YCC_SUB, (2, 2))[:2]
    if (sh, sv) not in ((1, 1), (2, 1), (2, 2), (1, 2), (4, 1), (4, 2), (4, 4)):
        raise _refused(f"YCbCr subsampling {sh} x {sv}")
    luma = tags.get(_YCC_COEFFS, (0.299, 0.587, 0.114))
    ref_bw = tags.get(_REF_BW, (0, 255, 128, 255, 128, 255))
    cr_r, cb_b, cr_g, cb_g, y_tab = _ycbcr_tables(luma, ref_bw)
    bw, bh = -(-width // sh), -(-height // sv)
    blocks = planes[:bw * bh * (sh * sv + 2)].reshape(bh, bw, sh * sv + 2)
    yy = blocks[..., :sh * sv].reshape(bh, bw, sv, sh).transpose(0, 2, 1, 3).reshape(bh * sv, bw * sh)
    cb = np.repeat(np.repeat(blocks[..., sh * sv], sv, 0), sh, 1)
    cr = np.repeat(np.repeat(blocks[..., sh * sv + 1], sv, 0), sh, 1)
    yy, cb, cr = (a[:height, :width].astype(np.int64) for a in (yy, cb, cr))
    yv = y_tab[yy]
    r = yv + cr_r[cr]
    g = yv + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yv + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------- #
# the image
# --------------------------------------------------------------------------- #


@dataclass
class _Layout:
    """Where the image's strips or tiles lie: `w` x `h` pieces (a strip is
    the image's width and RowsPerStrip rows), `planes` sets of them."""
    offsets: tuple
    counts: Optional[tuple]
    w: int
    h: int
    tiled: bool
    planes: int


def _layout(tags, width: int, height: int, planar: int, spp: int) -> _Layout:
    if _TILE_OFFSETS in tags:
        tw, tl = _one(tags, _TILE_W), _one(tags, _TILE_L)
        if not isinstance(tw, int) or not isinstance(tl, int) or tw <= 0 or tl <= 0:
            raise _refused("invalid tile dimensions")
        return _Layout(tags[_TILE_OFFSETS], tags.get(_TILE_COUNTS), tw, tl, True, spp if planar == 2 else 1)
    if _OFFSETS in tags:
        rows = min(_one(tags, _ROWS, height), height) or height
        return _Layout(tags[_OFFSETS], tags.get(_COUNTS), width, rows, False, spp if planar == 2 else 1)
    raise _refused("an image without strips or tiles (unknown data organization)")


def _pieces(lay: _Layout, width: int, height: int):
    """(plane, x, y, w, h, index) of each strip or tile in file order."""
    across, down = -(-width // lay.w), -(-height // lay.h)
    k = 0
    for plane in range(lay.planes):
        for ty in range(down):
            for tx in range(across):
                y, x = ty * lay.h, tx * lay.w
                yield plane, x, y, min(lay.w, width - x), min(lay.h, height - y), k
                k += 1


def _planar_band(mode: str, char: str) -> int:
    """The band that Pillow's one-letter unpacker `char` fills in `mode`
    (-1: the whole of a one-band mode); an unknown pair raises."""
    if (mode, char) in (("1", "1"), ("L", "L"), ("P", "P"), ("I", "I"), ("F", "F")):
        return -1
    if mode in ("RGB", "RGBA", "CMYK") and char in mode:
        return mode.index(char)
    raise _refused(f"raw layout {char!r} of a planar {mode} image (unknown raw mode)")


def _read_raw(data: bytes, mode: str, raw: str, lay: _Layout, width: int, height: int, planar: int,
              nbands: int, bps: tuple) -> np.ndarray:
    """Pillow's raw reader: each piece's rows from its offset, with the row
    size of the raw layout, then unpacked into the image. Where planar,
    the pieces of plane k are read with the k-th letter of the raw layout
    as a one-band layout, whatever the samples' bits."""
    offsets = lay.offsets
    if lay.w == width and lay.h == height and planar != 2:
        offsets = offsets[-1:]  # one piece covers the image: Pillow reads the last offset
    out = None
    x = y = layer = 0
    for off in offsets:
        w, h = min(lay.w, width - x), min(lay.h, height - y)
        piece_raw = raw[layer] if planar == 2 else raw
        band = _planar_band(mode, piece_raw) if planar == 2 else -1
        bits = {"1": 1, "I": 32, "F": 32}.get(piece_raw, 8) if planar == 2 else _raw_bits(piece_raw)
        stride = (bits * w + 7) // 8
        if x + lay.w > width:  # a tile at the right edge: Pillow's row size from the file's bits
            stride = int(lay.w * sum(bps) / 8 / (nbands if planar == 2 else 1))
        if stride < (bits * w + 7) // 8:
            raise _refused("a tile row shorter than its pixels (codec configuration error)")
        need = stride * (h - 1) + (bits * w + 7) // 8
        if off + need > len(data):
            raise _corrupt("the image data ends before the last row (image file is truncated)")
        rows = np.frombuffer(data + bytes(stride), np.uint8, h * stride, off).reshape(h, stride)
        px = _unpack({"I": "I;32N", "F": "F;32F"}.get(piece_raw, piece_raw) if band < 0 else "L", rows, w)
        if out is None:
            shape = (height, width, len(mode)) if band >= 0 else (height, width) + px.shape[2:]
            out = np.zeros(shape, px.dtype)
        if band >= 0:
            out[y:y + h, x:x + w, band] = px
        else:
            out[y:y + h, x:x + w] = px
        x += lay.w
        if x >= width:
            x, y = 0, y + lay.h
            if y >= height:
                y, layer = 0, layer + 1
                if layer >= (len(raw) if planar == 2 else 1):
                    break
    if out is None:
        raise _corrupt("no image data")
    return out


def _decode_piece(blob: bytes, comp: int, n_out: int, w: int, h: int, tags, plain: bool, ycc: bool,
                  spp: int) -> np.ndarray:
    """One strip or tile's data -> its decoded bytes (n_out of them, or the
    JPEG's samples [h, w, components])."""
    if comp == 5:
        return (rlds_host.tiff_lzw_plain if plain else rlds_host.tiff_lzw)(blob, n_out)
    if comp == 32773:
        return (rlds_host.packbits_plain if plain else rlds_host.packbits)(blob, n_out)
    if comp in (8, 32946):
        return np.frombuffer(_inflate(blob, n_out, "Deflate"), np.uint8)
    if comp == 34925:
        return np.frombuffer(_inflate(blob, n_out, "LZMA"), np.uint8)
    if comp in (2, 3, 4):
        kind = {2: "mh", 3: "t4", 4: "t6"}[comp]
        t4 = _one(tags, _T4, 0)
        if comp == 3 and t4 & 2:
            raise _unsupported("fax uncompressed mode (T4Options bit 1)")
        if comp == 3 and t4 & 1:
            kind = "t4-2d"
        return (rlds_host.ccitt_plain if plain else rlds_host.ccitt)(blob, kind, w, h).reshape(-1)
    px = jpeg.decode_abbreviated(blob, tags.get(_JPEG_TABLES), ycc, jpeg_host.PLAIN if plain else jpeg_host.NATIVE)
    if px.shape[0] < h or px.shape[1] < w or px.shape[2] != spp:
        raise _corrupt(f"a JPEG strip of {px.shape[1]} x {px.shape[0]} x {px.shape[2]} where "
                       f"{w} x {h} x {spp} was expected")
    return px[:h, :w]


def _read_libtiff(data: bytes, comp: int, lay: _Layout, tags, width: int, height: int, spp: int, bps: tuple,
                  fill: int, order: str, plain: bool, ycc_jpeg: bool, ycc_rgba: bool, bands: int) -> np.ndarray:
    """libtiff's reading: each piece decoded, predicted and swabbed ->
    the image's bytes as Pillow's unpacker sees them, [height, row bytes]
    (planes interleaved), or for YCbCr through the RGBA interface its
    blocks' bytes in file order [n]."""
    bits = bps[0]
    planes = lay.planes
    per = spp // planes  # samples a pixel in each plane
    predictor = _one(tags, _PREDICTOR, 1)
    fmt = _one(tags, _FORMAT, 1)
    counts = lay.counts
    n_pieces = -(-width // lay.w) * -(-height // lay.h) * planes
    if len(lay.offsets) < n_pieces:
        raise _corrupt(f"{len(lay.offsets)} strip or tile offsets for {n_pieces} pieces")
    if ycc_rgba:
        sh, sv = tags.get(_YCC_SUB, (2, 2))[:2]
        if planes != 1 or lay.tiled:
            raise _unsupported("a tiled or planar YCbCr TIFF")
    if planes > 1 and bits % 8:
        raise _unsupported(f"a planar TIFF of {bits}-bit samples")
    if planes > bands and not lay.tiled:  # Pillow's strip reader refuses them; its tile reader drops them
        raise _refused(f"{planes} planes for an image of {bands} bands (decoder error)")
    planes_out = [] if ycc_rgba else None
    full = np.zeros((planes, height, -(-width * per * bits // 8)), np.uint8) if not ycc_rgba else None
    for plane, x, y, w, h, k in _pieces(lay, width, height):
        off = lay.offsets[k]
        cnt = counts[k] if counts is not None and k < len(counts) else len(data) - off
        blob = data[off:off + cnt]
        if off + cnt > len(data):
            raise _corrupt("a strip or tile runs past the end of the file (truncated)")
        if fill == 2 and comp != 7:  # libtiff's JPEG codec asks for no bit reversal
            blob = _REVERSED[np.frombuffer(blob, np.uint8)].tobytes()
        pw, ph = (lay.w, lay.h) if lay.tiled else (width, h)  # a tile is decoded whole, a strip to its rows
        if ycc_rgba:
            n_out = -(-pw // sh) * (sh * sv + 2) * -(-ph // sv)
            planes_out.append(np.asarray(_decode_piece(blob, comp, n_out, pw, ph, tags, plain, False, spp)))
            continue
        row_bytes = -(-pw * per * bits // 8)
        if comp == 7:
            px = _decode_piece(blob, comp, 0, pw, ph, tags, plain, ycc_jpeg, per)
            buf = px.reshape(ph, -1)
        else:
            buf = np.asarray(_decode_piece(blob, comp, row_bytes * ph, pw, ph, tags, plain, False, per))
            buf = buf[:row_bytes * ph].reshape(ph, row_bytes)
            if comp in _PREDICTED and predictor != 1:
                if predictor not in (2, 3):
                    raise _refused(f"Predictor {predictor} (libtiff refuses it)")
                if order == "MM" and predictor == 2:
                    buf = _swab(buf, bits)
                buf = _predict(buf, predictor, bits, per, pw, fmt)
            elif order == "MM":
                buf = _swab(buf, bits)
        xb = x * per * bits // 8
        wb = -(-w * per * bits // 8)
        full[plane, y:y + h, xb:xb + wb] = buf[:h, :wb]
    if ycc_rgba:
        return np.concatenate(planes_out)
    if planes == 1:
        return full[0]
    nb = bits // 8
    # planar: interleave the planes' samples into contiguous pixels
    return np.ascontiguousarray(full.reshape(planes, height, width, nb).transpose(1, 2, 0, 3)).reshape(height, -1)


def _orient(px: np.ndarray, orientation) -> np.ndarray:
    """Pillow's exif_transpose of a loaded TIFF."""
    if orientation == 2:
        return px[:, ::-1]
    if orientation == 3:
        return px[::-1, ::-1]
    if orientation == 4:
        return px[::-1]
    if orientation == 5:
        return px.swapaxes(0, 1)
    if orientation == 6:
        return np.rot90(px, -1)
    if orientation == 7:
        return np.rot90(px, 2).swapaxes(0, 1)
    if orientation == 8:
        return np.rot90(px, 1)
    return px


def decode(data, plain: bool = False) -> np.ndarray:
    """TIFF bytes -> uint8 [H, W, 3], as Pillow's convert("RGB") reads the
    first page. `plain` runs the plain Python versions of the host loops."""
    data = bytes(data)
    order, tags = _ifd(data)
    if 0xBC01 in tags:
        raise _refused("a Windows Media Photo image")
    comp = _one(tags, _COMPRESSION, 1)
    if comp not in _CODECS:
        raise _refused(f"compression {comp}")
    if comp not in _DECODED:
        raise _unsupported(f"TIFF compression {comp} ({_CODECS[comp]})")
    planar = _one(tags, _PLANAR, 1)
    photo = _one(tags, _PHOTOMETRIC, 0)
    fill = _one(tags, _FILL, 1)
    width, height = _one(tags, _WIDTH), _one(tags, _LENGTH)
    if not isinstance(width, int) or not isinstance(height, int):
        raise _refused("missing or invalid dimensions")
    if width <= 0 or height <= 0:
        raise _refused(f"an image of {width} x {height}")
    fmt = tags.get(_FORMAT, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = tags.get(_BITS, (1,))
    extra = tags.get(_EXTRA, ())
    spp = _one(tags, _SPP, 1)
    if spp > 6:
        raise _refused(f"{spp} samples a pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise _refused("bits per sample that do not match the samples a pixel")
    key = (order, photo, tuple(fmt), fill, tuple(bps), tuple(extra))
    if key not in _OPEN_INFO:
        raise _refused(f"photometric {photo}, sample format {fmt}, fill order {fill}, bits {bps}, extra "
                       f"samples {extra} (unknown pixel mode)")
    mode, raw = _OPEN_INFO[key]
    if mode == "LAB" or raw == "I;12":
        raise _unsupported(f"a TIFF of mode {mode} ({raw})")
    lay = _layout(tags, width, height, planar, spp)
    table = None
    if mode in ("P", "PA"):
        cmap = tags.get(_COLORMAP)
        if cmap is None:
            raise _refused("a palette image without a ColorMap")
        cm = np.array(cmap, np.int64) // 256
        n = len(cm) // 3
        table = np.stack([cm[:n], cm[n:2 * n], cm[2 * n:3 * n]], -1)
    if comp == 1:
        nbands = {2: 3, 6: 3, 8: 3, 5: 4}.get(photo, 1) + len(extra)
        px = _read_raw(data, mode, raw, lay, width, height, planar, nbands, bps)
    else:
        ycc_jpeg = photo == 6 and comp == 7 and planar == 1
        ycc_rgba = photo == 6 and not ycc_jpeg and spp == 3
        if ycc_rgba:
            blob = _read_libtiff(data, comp, lay, tags, width, height, spp, bps, fill, order, plain, False, True, 3)
            px = _ycbcr_rgba(blob, tags, width, height)
            return np.ascontiguousarray(_orient(px, _one(tags, _ORIENTATION, 1)))
        if fill == 2:
            key = key[:3] + (1,) + key[4:]
            mode, raw = _OPEN_INFO[key]
        if ycc_jpeg:
            raw = "RGB"
        elif raw == "I;16":
            raw = "I;16N"
        elif raw.endswith((";16B", ";16L")):
            raw = raw[:-1] + "N"
        bands = len(mode) if mode in ("LA", "PA", "RGB", "RGBA", "CMYK") else 1
        rows = _read_libtiff(data, comp, lay, tags, width, height, spp, bps, fill, order, plain, ycc_jpeg, False,
                             bands)
        px = _unpack(raw.replace(";16N", ";16L"), rows, width)
    px = _orient(px, _one(tags, _ORIENTATION, 1))
    return pillow_modes.to_rgb(mode, px, table)
