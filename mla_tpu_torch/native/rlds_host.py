"""ctypes wrapper and build at first use of the data pipeline's host loops.

`csrc/rlds_host.cpp` holds the loops that are sequential and too slow in
Python: TFRecord's masked CRC-32C, PNG un-filtering (the five filter
types; Paeth depends on the left pixel and the row above), GIF's and
TIFF's LZW, PackBits, the CCITT fax codes (Modified Huffman, T.4 1-D and
2-D, T.6; a 2-D row depends on the row above) and the two
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
            lib.rlds_tiff_lzw.argtypes, lib.rlds_tiff_lzw.restype = [p, ctypes.c_int64, p, ctypes.c_int64], i
            lib.rlds_packbits.argtypes, lib.rlds_packbits.restype = [p, ctypes.c_int64, p, ctypes.c_int64], i
            lib.rlds_ccitt.argtypes, lib.rlds_ccitt.restype = [p, ctypes.c_int64, i, i, i, p, p, p, p], i
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


# --------------------------------------------------------------------------- #
# TIFF's LZW
# --------------------------------------------------------------------------- #

_TIFF_LZW_ERRORS = {1: "the TIFF LZW data ends before the strip's last byte", 2: "a TIFF LZW code past its table"}


def tiff_lzw(data, n_out: int) -> np.ndarray:
    """One strip or tile of TIFF LZW data (compression 5) -> its first
    `n_out` bytes, uint8; corrupt or short data raises ValueError."""
    buf = np.frombuffer(bytes(data), np.uint8)
    out = np.empty(n_out, np.uint8)
    err = load().rlds_tiff_lzw(_ptr(buf) if buf.size else None, buf.size, _ptr(out), n_out)
    if err:
        raise ValueError(_TIFF_LZW_ERRORS[err])
    return out


def tiff_lzw_plain(data, n_out: int) -> np.ndarray:
    """The plain version: the code table as a list of byte strings, which
    grows one code early (libtiff's LZW)."""
    data = bytes(data)
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    bits, prev, out = 9, None, bytearray()
    acc = held = pos = 0
    while len(out) < n_out:
        while held < bits:
            if pos >= len(data):
                raise ValueError(_TIFF_LZW_ERRORS[1])
            acc = (acc << 8) | data[pos]
            pos += 1
            held += 8
        code = (acc >> (held - bits)) & ((1 << bits) - 1)
        held -= bits
        acc &= (1 << held) - 1
        if code == 256:
            table, bits, prev = table[:258], 9, None
            continue
        if code == 257:
            raise ValueError(_TIFF_LZW_ERRORS[1])
        if prev is None:
            if code > 256:
                raise ValueError(_TIFF_LZW_ERRORS[2])
            out += table[code]
            prev = table[code]
            continue
        if code > len(table) or len(table) >= 5119:
            raise ValueError(_TIFF_LZW_ERRORS[2])
        cur = table[code] if code < len(table) else prev + prev[:1]
        table.append(prev + cur[:1])
        if len(table) == (1 << bits) - 1 and bits < 12:
            bits += 1
        out += cur
        prev = cur
    return np.frombuffer(bytes(out[:n_out]), np.uint8).copy()


# --------------------------------------------------------------------------- #
# PackBits
# --------------------------------------------------------------------------- #


def packbits(data, n_out: int) -> np.ndarray:
    """PackBits data (TIFF compression 32773) -> its first `n_out` bytes;
    data that ends short raises ValueError."""
    buf = np.frombuffer(bytes(data), np.uint8)
    out = np.empty(n_out, np.uint8)
    if load().rlds_packbits(_ptr(buf) if buf.size else None, buf.size, _ptr(out), n_out):
        raise ValueError("the PackBits data ends before the strip's last byte")
    return out


def packbits_plain(data, n_out: int) -> np.ndarray:
    """The plain version, header by header."""
    data, out, pos = bytes(data), bytearray(), 0
    while pos < len(data) and len(out) < n_out:
        h = data[pos] - 256 if data[pos] > 127 else data[pos]
        pos += 1
        if h == -128:
            continue
        if h < 0:
            if pos >= len(data):
                break
            out += data[pos:pos + 1] * min(1 - h, n_out - len(out))
            pos += 1
        else:
            k = min(h + 1, n_out - len(out))
            if pos + k > len(data):
                break
            out += data[pos:pos + k]
            pos += k
    if len(out) < n_out:
        raise ValueError("the PackBits data ends before the strip's last byte")
    return np.frombuffer(bytes(out), np.uint8).copy()


# --------------------------------------------------------------------------- #
# CCITT fax codes
# --------------------------------------------------------------------------- #

# ITU T.4 tables 2 and 3: terminating codes of runs 0..63, then the makeup
# codes of 64, 128, ... 1728; the extended makeup codes 1792 ... 2560 are
# shared by both colours
_WHITE = ("00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 110101 "
          "101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
          "00000010 00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110 00010111 00101000 "
          "00101001 00101010 00101011 00101100 00101101 00000100 00000101 00001010 00001011 01010010 01010011 "
          "01010100 01010101 00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
          "00110011 00110100 "
          "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 011001100 011001101 "
          "011010010 011010011 011010100 011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
          "010011000 010011001 010011010 011000 010011011").split()
_BLACK = ("0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 00000111 "
          "000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 00000110111 00000101000 "
          "00000010111 00000011000 000011001010 000011001011 000011001100 000011001101 000001101000 000001101001 "
          "000001101010 000001101011 000011010010 000011010011 000011010100 000011010101 000011010110 "
          "000011010111 000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
          "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 000000100100 "
          "000000110111 000000111000 000000100111 000000101000 000001011000 000001011001 000000101011 "
          "000000101100 000001011010 000001100110 000001100111 "
          "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 "
          "0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 0000001110010 "
          "0000001110011 0000001110100 0000001110101 0000001110110 0000001110111 0000001010010 0000001010011 "
          "0000001010100 0000001010101 0000001011010 0000001011011 0000001100100 0000001100101").split()
_EXTENDED = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 000000010101 "
             "000000010110 000000010111 000000011100 000000011101 000000011110 000000011111").split()
_EOL = "000000000001"
# T.4 table 4: the 2-D mode codes -> 0..6 vertical offsets -3..3, 7 pass, 8 horizontal, 9 extension
_MODES = {"0000010": 0, "000010": 1, "010": 2, "1": 3, "011": 4, "000011": 5, "0000011": 6, "0001": 7, "001": 8,
          "0000001": 9, _EOL: -1}
CCITT_KINDS = {"mh": 0, "t4": 1, "t4-2d": 2, "t6": 3}
_CCITT_ERRORS = {1: "the fax data ends before the strip's last row", 2: "a bad fax code",
                 3: "fax uncompressed mode is not decoded"}


def _lookup(codes) -> np.ndarray:
    """{bit string: value} -> int32 [8192, 2]: (length, value) of the code
    each 13-bit window starts with, length 0 where none does."""
    table = np.zeros((1 << 13, 2), np.int32)
    for bits, value in codes.items():
        lo = int(bits, 2) << (13 - len(bits))
        table[lo:lo + (1 << (13 - len(bits)))] = (len(bits), value)
    return table


def _run_codes(terminating):
    runs = list(range(64)) + list(range(64, 1729, 64))
    codes = dict(zip(terminating, runs))
    codes.update(zip(_EXTENDED, range(1792, 2561, 64)))
    codes[_EOL] = -1
    return codes


CCITT_TABLES = tuple(_lookup(c) for c in (_run_codes(_WHITE), _run_codes(_BLACK), _MODES))


def _check_ccitt(kind: str, width: int, rows: int) -> None:
    if kind not in CCITT_KINDS or width <= 0 or rows < 0:
        raise ValueError(f"fax coding {kind!r} of {width} x {rows}")


def ccitt(data, kind: str, width: int, rows: int) -> np.ndarray:
    """CCITT fax data of one strip -> uint8 [rows, ceil(width / 8)] rows of
    bits, MSB first, 1 for black: kind "mh" (Modified Huffman, TIFF
    compression 2), "t4" or "t4-2d" (compression 3, T4Options bit 0 clear
    or set), "t6" (compression 4). Bad or short data raises ValueError,
    uncompressed mode NotImplementedError."""
    _check_ccitt(kind, width, rows)
    buf = np.frombuffer(bytes(data), np.uint8)
    out = np.empty((rows, (width + 7) // 8), np.uint8)
    white, black, modes = CCITT_TABLES
    err = load().rlds_ccitt(_ptr(buf) if buf.size else None, buf.size, CCITT_KINDS[kind], width, rows, _ptr(white),
                            _ptr(black), _ptr(modes), _ptr(out))
    if err == 3:
        raise NotImplementedError(_CCITT_ERRORS[3])
    if err:
        raise ValueError(_CCITT_ERRORS[err])
    return out


class _Bits:
    def __init__(self, data: bytes) -> None:
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8)).tolist() + [0] * 13
        self.n, self.pos = len(data) * 8, 0

    def code(self, table: np.ndarray) -> int:
        if self.pos >= self.n:
            raise ValueError(_CCITT_ERRORS[1])
        w = 0
        for b in self.bits[self.pos:self.pos + 13]:
            w = (w << 1) | b
        length, value = table[w]
        if length == 0:
            raise ValueError(_CCITT_ERRORS[2])
        self.pos += int(length)
        return int(value)

    def run(self, table: np.ndarray) -> int:
        total = 0
        while True:
            v = self.code(table)
            if v < 0:
                raise ValueError(_CCITT_ERRORS[2])
            total += v
            if v < 64:
                return total


def ccitt_plain(data, kind: str, width: int, rows: int) -> np.ndarray:
    """The plain version: T.4 / T.6 decoding with the changing elements of
    each row as a list."""
    _check_ccitt(kind, width, rows)
    b = _Bits(bytes(data))
    white, black, modes = CCITT_TABLES
    out = np.zeros((rows, (width + 7) // 8 * 8), np.uint8)
    ref = []
    for y in range(rows):
        two_d = kind == "t6"
        if kind in ("t4", "t4-2d"):  # the EOL, after any fill
            while True:
                if b.pos + 11 > b.n:
                    raise ValueError(_CCITT_ERRORS[1])
                if not any(b.bits[b.pos:b.pos + 11]):
                    break
                b.pos += 1
            b.pos += 11
            while True:
                if b.pos >= b.n:
                    raise ValueError(_CCITT_ERRORS[1])
                b.pos += 1
                if b.bits[b.pos - 1]:
                    break
            if kind == "t4-2d":
                if b.pos >= b.n:
                    raise ValueError(_CCITT_ERRORS[1])
                two_d = b.bits[b.pos] == 0
                b.pos += 1
        cur, a0, colour, start = [], 0, 0, True
        padded = ref + [width, width]
        while a0 < width:
            if not two_d:
                a0 += b.run(black if colour else white)
                if a0 > width:
                    raise ValueError(_CCITT_ERRORS[2])
                cur.append(a0)
                colour ^= 1
                continue
            # b1: the first change right of a0 (or at it, at the row's start) to the colour opposite a0's
            i = next(k for k, r in enumerate(padded) if k % 2 == colour and (r >= a0 if start else r > a0))
            b1, b2 = padded[i], padded[i + 1] if i + 1 < len(padded) else width
            mode = b.code(modes)
            if mode < 0:
                raise ValueError(_CCITT_ERRORS[2])
            if mode == 9:
                raise NotImplementedError(_CCITT_ERRORS[3])
            start = False
            if mode == 7:
                a0 = b2
            elif mode == 8:
                a1 = a0 + b.run(black if colour else white)
                a2 = a1 + b.run(white if colour else black)
                if a2 > width:
                    raise ValueError(_CCITT_ERRORS[2])
                cur += [a1, a2]
                a0 = a2
            else:
                a1 = b1 + mode - 3
                if a1 < a0 or a1 > width:
                    raise ValueError(_CCITT_ERRORS[2])
                cur.append(a1)
                a0 = a1
                colour ^= 1
        for k in range(0, len(cur), 2):
            out[y, cur[k]:cur[k + 1] if k + 1 < len(cur) else width] = 1
        ref = cur
        if kind == "mh":
            b.pos = (b.pos + 7) // 8 * 8
    return np.packbits(out, axis=1)
