"""ctypes wrapper and build at first use of the data pipeline's host loops.

`csrc/rlds_host.cpp` holds the loops that are sequential and too slow in
Python: TFRecord's masked CRC-32C, PNG un-filtering (the five filter
types; Paeth depends on the left pixel and the row above), GIF's LZW and the two
passes of TensorFlow's ScaleAndTranslate resampling, each a float32 sum in
its tap order; and the C library's float sine, which TensorFlow's Lanczos
kernel calls (numpy's float32 sine differs from it in the last bit). It is
built at first use (`native/build.py`); a failed build raises: nothing
falls back to the plain versions, which stand beside each function for the
tests.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from mla_tpu_torch.native.build import CSRC, load_library

SRC = CSRC / "rlds_host.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The helper library, built first where it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            lib = load_library("rlds_host")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.rlds_masked_crc32c.argtypes, lib.rlds_masked_crc32c.restype = [p, ctypes.c_size_t], ctypes.c_uint32
            lib.rlds_png_unfilter.argtypes, lib.rlds_png_unfilter.restype = [p, i, i, i, p], i
            lib.rlds_gif_lzw.argtypes, lib.rlds_gif_lzw.restype = [p, ctypes.c_int64, i, p, ctypes.c_int64], i
            lib.rlds_sinf.argtypes, lib.rlds_sinf.restype = [p, ctypes.c_size_t, p], None
            lib.rlds_resample_rows.argtypes, lib.rlds_resample_rows.restype = [p, i, i, p, p, i, i, p], None
            lib.rlds_resample_cols.argtypes, lib.rlds_resample_cols.restype = [p, i, i, i, p, p, i, i, p], None
            _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# --------------------------------------------------------------------------- #
# masked CRC-32C
# --------------------------------------------------------------------------- #


def masked_crc32c(data) -> int:
    """TFRecord's masked CRC-32C of a bytes-like object."""
    buf = np.frombuffer(data, np.uint8)
    return int(load().rlds_masked_crc32c(_ptr(buf) if buf.size else None, buf.size))


def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def masked_crc32c_plain(data) -> int:
    """The plain version: CRC-32C byte by byte, then TFRecord's mask."""
    c = 0xFFFFFFFF
    for b in bytes(data):
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    c ^= 0xFFFFFFFF
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# PNG un-filtering
# --------------------------------------------------------------------------- #


def _check_filtered(raw, height: int, stride: int) -> np.ndarray:
    buf = np.frombuffer(raw, np.uint8)
    if buf.size != height * (stride + 1):
        raise ValueError(f"PNG image data holds {buf.size} bytes, expected {height} rows of 1 + {stride}")
    return buf


def png_unfilter(raw, height: int, stride: int, bpp: int) -> np.ndarray:
    """Decompressed PNG image data (`height` rows, each a filter-type byte
    and `stride` bytes) -> the uint8 [height, stride] scanlines; bpp is the
    bytes per complete pixel."""
    buf = _check_filtered(raw, height, stride)
    out = np.empty((height, stride), np.uint8)
    bad = load().rlds_png_unfilter(_ptr(buf), height, stride, bpp, _ptr(out))
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type {buf[(bad - 1) * (stride + 1)]}")
    return out


def png_unfilter_plain(raw, height: int, stride: int, bpp: int) -> np.ndarray:
    """The plain version: PNG's filter definitions, byte by byte."""
    buf = _check_filtered(raw, height, stride).reshape(height, stride + 1).astype(np.int64)
    out = np.zeros((height, stride), np.int64)
    for y in range(height):
        ftype, src = int(buf[y, 0]), buf[y, 1:]
        up = out[y - 1] if y else np.zeros(stride, np.int64)
        row = out[y]
        for i in range(stride):
            left = row[i - bpp] if i >= bpp else 0
            corner = up[i - bpp] if i >= bpp else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = left
            elif ftype == 2:
                pred = up[i]
            elif ftype == 3:
                pred = (left + up[i]) >> 1
            elif ftype == 4:
                p = left + up[i] - corner
                pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - corner)
                pred = left if pa <= pb and pa <= pc else (up[i] if pb <= pc else corner)
            else:
                raise ValueError(f"PNG row {y} has an unknown filter type {ftype}")
            row[i] = (src[i] + pred) & 0xFF
    return out.astype(np.uint8)


# --------------------------------------------------------------------------- #
# GIF's LZW
# --------------------------------------------------------------------------- #

_LZW_ERRORS = {1: "the GIF image data ends before its last pixel", 2: "a GIF LZW code past its table"}


def _check_lzw(min_code: int, npix: int) -> None:
    if not 2 <= min_code <= 11 or npix < 0:
        raise ValueError(f"GIF LZW minimum code size {min_code} (2..11), {npix} pixels")


def gif_lzw(data, min_code: int, npix: int) -> np.ndarray:
    """GIF image data (its sub-blocks joined) -> the first `npix` colour
    indices, uint8; corrupt or short data raises ValueError."""
    _check_lzw(min_code, npix)
    buf = np.frombuffer(bytes(data), np.uint8)
    out = np.empty(npix, np.uint8)
    err = load().rlds_gif_lzw(_ptr(buf) if buf.size else None, buf.size, min_code, _ptr(out), npix)
    if err:
        raise ValueError(_LZW_ERRORS[err])
    return out


def gif_lzw_plain(data, min_code: int, npix: int) -> np.ndarray:
    """The plain version: the code table as a list of byte strings."""
    _check_lzw(min_code, npix)
    data = bytes(data)
    clear, eoi = 1 << min_code, (1 << min_code) + 1
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    size, prev, out = min_code + 1, None, bytearray()
    acc = bits = pos = 0
    while len(out) < npix:
        while bits < size:
            if pos >= len(data):
                raise ValueError(_LZW_ERRORS[1])
            acc |= data[pos] << bits
            pos += 1
            bits += 8
        code = acc & ((1 << size) - 1)
        acc >>= size
        bits -= size
        if code == clear:
            table, size, prev = table[:clear + 2], min_code + 1, None
            continue
        if code == eoi:
            raise ValueError(_LZW_ERRORS[1])
        if prev is None:
            if code >= clear:
                raise ValueError(_LZW_ERRORS[2])
            out += table[code]
            prev = table[code]
            continue
        if code < len(table):
            cur = table[code]
        elif code == len(table) and len(table) < 4096:
            cur = prev + prev[:1]
        else:
            raise ValueError(_LZW_ERRORS[2])
        out += cur
        if len(table) < 4096:
            table.append(prev + cur[:1])
            if len(table) == 1 << size and size < 12:
                size += 1
        prev = cur
    return np.frombuffer(bytes(out[:npix]), np.uint8).copy()


# --------------------------------------------------------------------------- #
# float sine
# --------------------------------------------------------------------------- #


def sinf(x: np.ndarray) -> np.ndarray:
    """sin of float32 values in float32, by the C library's sinf."""
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty_like(x)
    load().rlds_sinf(_ptr(x), x.size, _ptr(out))
    return out


def sinf_plain(x: np.ndarray) -> np.ndarray:
    """The plain version: the correctly rounded float32 sine (the C
    library's may differ from it by one unit in the last place)."""
    return np.sin(np.asarray(x, np.float32).astype(np.float64)).astype(np.float32)


# --------------------------------------------------------------------------- #
# resampling passes
# --------------------------------------------------------------------------- #


def _check_spans(starts: np.ndarray, weights: np.ndarray, in_size: int):
    starts = np.ascontiguousarray(starts, np.int32)
    weights = np.ascontiguousarray(weights, np.float32)
    if weights.ndim != 2 or weights.shape[0] != starts.shape[0]:
        raise ValueError(f"spans: starts {starts.shape}, weights {weights.shape}")
    if starts.size and (starts.min() < 0 or starts.max() >= in_size):
        raise ValueError(f"spans start outside [0, {in_size})")
    return starts, weights


def resample(img: np.ndarray, rows, cols) -> np.ndarray:
    """float32 [H, W, C] -> [out_h, out_w, C]: the vertical pass with `rows`
    = (starts [out_h], weights [out_h, span]), then the horizontal pass with
    `cols`, as TensorFlow's ScaleAndTranslate runs them."""
    img = np.ascontiguousarray(img, np.float32)
    H, W, C = img.shape
    (rs, rw), (cs, cw) = _check_spans(*rows, H), _check_spans(*cols, W)
    lib = load()
    mid = np.empty((rs.shape[0], W, C), np.float32)
    lib.rlds_resample_rows(_ptr(img), H, W * C, _ptr(rs), _ptr(rw), rw.shape[1], rs.shape[0], _ptr(mid))
    out = np.empty((rs.shape[0], cs.shape[0], C), np.float32)
    lib.rlds_resample_cols(_ptr(mid), rs.shape[0], W, C, _ptr(cs), _ptr(cw), cw.shape[1], cs.shape[0], _ptr(out))
    return out


def _pass_plain(src: np.ndarray, starts: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """One pass along axis 0 of src, tap by tap in float32 from 0."""
    n = src.shape[0]
    out = np.zeros((starts.shape[0],) + src.shape[1:], np.float32)
    taps = np.minimum(starts + weights.shape[1], n) - starts
    for j in range(weights.shape[1]):
        live = j < taps
        idx = np.where(live, starts + j, 0)
        w = np.where(live, weights[:, j], np.float32(0)).reshape((-1,) + (1,) * (src.ndim - 1))
        # a tap past an output's span adds 0 * x, which leaves the sum as it is
        out = np.where(live.reshape(w.shape), out + w * src[idx], out)
    return out


def resample_plain(img: np.ndarray, rows, cols) -> np.ndarray:
    """The plain version of `resample`, in numpy."""
    img = np.asarray(img, np.float32)
    (rs, rw), (cs, cw) = _check_spans(*rows, img.shape[0]), _check_spans(*cols, img.shape[1])
    mid = _pass_plain(img, rs, rw)
    return np.moveaxis(_pass_plain(np.moveaxis(mid, 1, 0), cs, cw), 0, 1)
