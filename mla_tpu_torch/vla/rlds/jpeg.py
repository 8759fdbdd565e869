"""JPEG decoding and encoding without an imaging package.

The JAX package decodes JPEG in two ways, and they do not agree: the RLDS
pipeline calls TensorFlow's `tf.io.decode_image(..., channels=3)`, which
runs libjpeg-turbo's fast integer inverse DCT (JDCT_IFAST, jidctfst.c),
and the VLM stage calls Pillow's `convert("RGB")`, which runs its accurate
one (JDCT_ISLOW, jidctint.c). `decode(data, dct="ifast" | "islow")` gives
each one's pixels bit for bit: the markers are read here, the scans are
entropy-decoded (Huffman, or arithmetic by the QM-coder with the DAC
conditioning), inverse-transformed, upsampled ("fancy", the triangle filter
of jdsample.c, for h2v1, h2v2 and h1v2; each sample repeated for any other
integral ratio, as 4:1:1 or 3 x 1) and converted to RGB (jdcolor.c's
fixed-point tables) through the host helper (`native/jpeg_host.py`). Grey
is repeated into three channels. It decodes baseline, extended and
progressive frames, Huffman or arithmetic-coded, with restart intervals, 1,
3 and 4 components (CMYK, or YCCK by the Adobe transform flag, converted to
RGB as TensorFlow's jpeg_mem.cc and Pillow each convert them) at any width
and height. Lossless frames (SOF3, 8-bit), which Pillow's libjpeg-turbo 3.1
reads, decode with dct="islow": every predictor, point transforms,
restarts, interleaved or one scan a component, upsampled by repeating
samples, RGB (a JFIF or YCbCr-flagged one is refused, as libjpeg-turbo
converts no colour in lossless mode); TensorFlow's libjpeg-turbo 2.1
refuses them, so with dct="ifast" they raise ValueError. What both refuse
raises ValueError: 12-bit samples, hierarchical frames, a fractional
sampling ratio, a DNL height. A corrupt or truncated stream raises
ValueError. A cut into the
scan data is refused by TensorFlow (try_recover_truncated false) and
Pillow too. So is a stream cut only in its EOI marker: libjpeg under
TensorFlow and Pillow reads past the scan's last byte as it fills its bit
buffer and fails there too, unless that read-ahead happened to stop short
of the end (one stream of the 36 that tests/test_torch_jpeg.py cuts so),
which the port does not copy.

`encode` (and `encode_lossless` for SOF3 frames) is the fixture writer,
the counterpart of `tf.io.encode_jpeg`:
ITU T.81 Annex K's tables scaled by the IJG quality, any integral sampling,
grey, YCbCr, CMYK or YCCK, baseline or progressive (spectral selection, the
DC by successive approximation, and with arithmetic coding the first AC
band too), Huffman or arithmetic-coded (jcarith.c's coder), with or
without restart intervals. Its bytes are not TensorFlow's; TensorFlow and
Pillow decode them.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from mla_tpu_torch.native import jpeg_host
from mla_tpu_torch.vla.rlds import pillow_modes

SIGNATURE = b"\xff\xd8\xff"
ROADMAP_JPEG = "ROADMAP.md queue 1, item 2 (frame formats: JPEG variants)"
_DCT = {"ifast": jpeg_host.IFAST, "islow": jpeg_host.ISLOW}
# marker -> (progressive, arithmetic-coded)
_SOF_SUPPORTED = {0xC0: (False, False), 0xC1: (False, False), 0xC2: (True, False), 0xC9: (False, True),
                  0xCA: (True, True)}
_SOF_LOSSLESS = (0xC3, 0xCB)
_SOF_HIERARCHICAL = (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)


def _corrupt(msg: str) -> ValueError:
    return ValueError(f"corrupt JPEG data: {msg}")


def _refused(msg: str) -> ValueError:
    """What libjpeg-turbo refuses under TensorFlow and Pillow both."""
    return ValueError(f"{msg} is refused by libjpeg-turbo, as by TensorFlow's and Pillow's decoders")


def _unsupported(msg: str) -> NotImplementedError:
    return NotImplementedError(f"{msg} is not decoded ({ROADMAP_JPEG})")


@dataclass(eq=False)
class _Component:
    cid: int
    h: int
    v: int
    tq: int
    width: int = 0   # its samples across and down (the downsampled size)
    height: int = 0
    coef: Optional[np.ndarray] = None  # int16 [rows, cols, 64]
    samples: Optional[np.ndarray] = None  # a lossless frame's int32 [rows, cols], and its point transform
    pt: int = 0
    qt: Optional[np.ndarray] = None    # latched at its first scan, as libjpeg does


@dataclass
class _Frame:
    progressive: bool
    arithmetic: bool
    height: int
    width: int
    comps: List[_Component]
    hmax: int = 1
    vmax: int = 1
    mcus_x: int = 0
    mcus_y: int = 0
    scans: int = 0
    lossless: bool = False


def _u16(b: bytes, i: int) -> int:
    return (b[i] << 8) | b[i + 1]


def _frame(marker: int, body: bytes, components=(1, 3, 4)) -> _Frame:
    """A frame header; an SOF3 (lossless) frame keeps samples, not
    coefficients: its MCU is h x v samples of each component."""
    if len(body) < 6:
        raise _corrupt("a short frame header")
    precision, height, width, n = body[0], _u16(body, 1), _u16(body, 3), body[5]
    if precision != 8:
        raise _refused(f"a JPEG of {precision}-bit samples")
    if height == 0:
        raise _refused("a JPEG height given by a DNL marker")
    if width == 0 or len(body) != 6 + 3 * n:
        raise _corrupt("a bad frame header")
    if n not in components:
        raise _refused(f"a JPEG of {n} components (no colour space converts them to RGB)")
    comps = [_Component(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15, body[8 + 3 * i])
             for i in range(n)]
    if any(not (1 <= c.h <= 4 and 1 <= c.v <= 4) or c.tq > 3 for c in comps):
        raise _corrupt("bad sampling factors or quantization table")
    f = _Frame(*_SOF_SUPPORTED.get(marker, (False, False)), height, width, comps, lossless=marker == 0xC3)
    if n == 1:  # a lone component is coded alone whatever its factors say
        comps[0].h = comps[0].v = 1
    f.hmax, f.vmax = max(c.h for c in comps), max(c.v for c in comps)
    for c in comps:
        if (f.hmax % c.h, f.vmax % c.v) != (0, 0):  # jdsample.c: "Fractional sampling not implemented yet"
            raise _refused(f"JPEG sampling {[(k.h, k.v) for k in comps]} (a fractional ratio)")
    unit = 1 if f.lossless else 8
    f.mcus_x, f.mcus_y = -(-width // (unit * f.hmax)), -(-height // (unit * f.vmax))
    for c in comps:
        c.width, c.height = -(-width * c.h // f.hmax), -(-height * c.v // f.vmax)
        if f.lossless:
            c.samples = np.zeros((f.mcus_y * c.v, f.mcus_x * c.h), np.int32)
        else:
            c.coef = np.zeros((f.mcus_y * c.v, f.mcus_x * c.h, 64), np.int16)
    return f


def _quant_tables(body: bytes, qts: Dict[int, np.ndarray]) -> None:
    i = 0
    while i < len(body):
        pq, tq = body[i] >> 4, body[i] & 15
        size = 128 if pq else 64
        if tq > 3 or pq > 1 or i + 1 + size > len(body):
            raise _corrupt("a bad quantization table")
        vals = (np.frombuffer(body, ">u2", 64, i + 1) if pq else np.frombuffer(body, np.uint8, 64, i + 1))
        qt = np.zeros(64, np.uint16)
        qt[jpeg_host.NATURAL] = vals  # stored in zigzag order
        qts[tq] = qt
        i += 1 + size


def _huffman_tables(body: bytes, tables: np.ndarray, defined: set) -> None:
    i = 0
    while i < len(body):
        if i + 17 > len(body):
            raise _corrupt("a short Huffman table")
        tc, th = body[i] >> 4, body[i] & 15
        counts = body[i + 1:i + 17]
        n = sum(counts)
        if tc > 1 or th > 3 or n > 256 or i + 17 + n > len(body):
            raise _corrupt("a bad Huffman table")
        slot = 4 * tc + th
        tables[slot] = 0
        tables[slot, :16] = np.frombuffer(counts, np.uint8)
        tables[slot, 16:16 + n] = np.frombuffer(body, np.uint8, n, i + 17)
        defined.add(slot)
        i += 17 + n


def _lossless_scan(f: _Frame, comps, params, tables: np.ndarray, defined: set, restart: int, data: bytes, start: int,
                   host) -> int:
    """One SOS of a lossless frame: Ss the predictor, Al the point
    transform (jdlossls.c's checks), decoded through `host`."""
    Ss, Se, Ah, Al = params
    if not 1 <= Ss <= 7 or Se != 0 or Ah != 0 or Al >= 8:
        raise _corrupt(f"lossless scan parameters Ss {Ss}, Se {Se}, Ah {Ah}, Al {Al}")
    rows = []
    for c, td, _ in comps:
        if td > 3 or td not in defined:
            raise _corrupt("a scan's Huffman table is not defined")
        c.pt = Al
        rows.append((c.h, c.v, c.samples.shape[1], c.width, c.height, td, 0, 0))
    scan = np.array([len(comps), Ss, 0, 0, Al, restart, f.mcus_x, f.mcus_y, 8], np.int32)
    f.scans += 1
    return host.decode_scan_lossless(data, start, scan, np.array(rows, np.int32), [c.samples for c, _, _ in comps],
                                     tables)


def _conditioning(body: bytes, cond: np.ndarray) -> None:
    """A DAC segment: DC bounds L and U, AC K, by table (jdmarker.c)."""
    if len(body) % 2:
        raise _corrupt("a bad DAC segment")
    for i in range(0, len(body), 2):
        index, val = body[i], body[i + 1]
        if index >> 4 > 1 or index & 15 > 3:
            raise _corrupt(f"a bogus DAC index {index}")
        if index >> 4:
            if not 1 <= val <= 63:
                raise _corrupt(f"a bogus DAC value {val:#04x}")
            cond[8 + (index & 15)] = val
        else:
            lo, hi = val & 15, val >> 4
            if lo > hi:
                raise _corrupt(f"a bogus DAC value {val:#04x}")
            cond[index & 15], cond[4 + (index & 15)] = lo, hi


def _scan(f: _Frame, body: bytes, qts, tables: np.ndarray, defined: set, restart: int, data: bytes, start: int,
          host, cond: np.ndarray) -> int:
    """One SOS: the scan's parameters checked, its data decoded through
    `host`; returns where the marker after it starts."""
    if f is None:
        raise _corrupt("a scan before the frame header")
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
        raise _corrupt("a bad scan header")
    by_id = {c.cid: c for c in f.comps}
    comps = []
    for i in range(ns):
        c = by_id.get(body[1 + 2 * i])
        if c is None or any(c is k for k, _, _ in comps):
            raise _corrupt("a scan of an unknown or repeated component")
        comps.append((c, body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15))
    Ss, Se, Ah, Al = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15
    if f.lossless:
        return _lossless_scan(f, comps, (Ss, Se, Ah, Al), tables, defined, restart, data, start, host)
    if f.progressive:
        bad = Se > 63 or Ss > Se or Al > 13 or Ah > 13 or (Ss == 0 and Se != 0) or (Ss > 0 and ns != 1)
    else:
        bad = (Ss, Se, Ah, Al) != (0, 63, 0, 0)
    if bad:
        raise _corrupt(f"scan parameters Ss {Ss}, Se {Se}, Ah {Ah}, Al {Al}")
    rows = []
    for c, td, ta in comps:
        if c.qt is None:
            if c.tq not in qts:
                raise _corrupt(f"quantization table {c.tq} is not defined")
            c.qt = qts[c.tq]
        need = ([td] if Ss == 0 and Ah == 0 else []) + ([4 + ta] if Se > 0 else [])
        if td > 3 or ta > 3 or (not f.arithmetic and any(s not in defined for s in need)):
            raise _corrupt("a scan's Huffman table is not defined")
        if ns == 1:  # alone, a component codes only the blocks its samples cover
            bw, bh = -(-c.width // 8), -(-c.height // 8)
        else:
            bw, bh = f.mcus_x * c.h, f.mcus_y * c.v
        rows.append((c.h, c.v, c.coef.shape[1], bw, bh, td, ta, 0))
    scan = np.array([ns, Ss, Se, Ah, Al, restart, f.mcus_x, f.mcus_y, int(f.progressive)], np.int32)
    f.scans += 1
    if f.arithmetic:
        return host.decode_scan_arith(data, start, scan, np.array(rows, np.int32), [c.coef for c, _, _ in comps], cond)
    return host.decode_scan(data, start, scan, np.array(rows, np.int32), [c.coef for c, _, _ in comps], tables)


@dataclass
class _Tables:
    """What a stream's marker segments define for the scans after them: the
    quantization and Huffman tables, the arithmetic conditioning and the
    restart interval. A tables-only stream (TIFF's JPEGTables) fills one
    that the abbreviated streams of each strip or tile then read."""
    qts: Dict[int, np.ndarray]
    huffman: np.ndarray
    defined: set
    cond: np.ndarray
    restart: int = 0

    @staticmethod
    def empty() -> "_Tables":
        # 4 DC then 4 AC Huffman tables, as the DHT segments define them; the DAC defaults L 0, U 1, K 5
        return _Tables({}, np.zeros((8, 272), np.uint8), set(), np.array([0] * 4 + [1] * 4 + [5] * 4, np.int32))


def _read(data: bytes, dct: str, host, t: _Tables, components=(1, 3, 4), tables_only: bool = False):
    """The markers of one stream from SOI to EOI, its scans decoded through
    `host` into the frame -> (frame or None, JFIF seen, Adobe transform or
    None). A tables-only stream (no frame, no scan) is read with
    tables_only, as libjpeg reads one."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG image (no SOI marker)")
    n, pos = len(data), 2
    f: Optional[_Frame] = None
    jfif, adobe = False, None
    while True:
        if pos >= n:
            raise _corrupt("the data ends before the EOI marker (truncated)")
        if data[pos] != 0xFF:
            raise _corrupt(f"a byte {data[pos]:#04x} where a marker should start")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise _corrupt("the data ends before the EOI marker (truncated)")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # parameterless, skipped as libjpeg skips them
            continue
        if marker in (0x00, 0xD8):
            raise _corrupt(f"marker {marker:#04x} inside the image")
        if pos + 2 > n:
            raise _corrupt("the data ends inside a marker segment (truncated)")
        length = _u16(data, pos)
        if length < 2 or pos + length > n:
            raise _corrupt(f"marker {marker:#04x}'s segment of {length} bytes runs past the data (truncated)")
        body = data[pos + 2:pos + length]
        pos += length
        if marker in _SOF_SUPPORTED or (marker == 0xC3 and dct == "islow"):
            # Pillow's libjpeg-turbo 3 reads 8-bit lossless frames
            if f is not None:
                raise _corrupt("a second frame header")
            f = _frame(marker, body, components)
        elif marker in _SOF_LOSSLESS:  # TensorFlow's libjpeg-turbo 2.1 reads none; arithmetic-coded, neither
            raise ValueError("a lossless JPEG is refused by libjpeg-turbo under "
                             f"{'TensorFlow' if dct == 'ifast' else 'Pillow'}")
        elif marker in _SOF_HIERARCHICAL:
            raise _refused("a hierarchical JPEG")
        elif marker == 0xCC:
            _conditioning(body, t.cond)
        elif marker == 0xC4:
            _huffman_tables(body, t.huffman, t.defined)
        elif marker == 0xDB:
            _quant_tables(body, t.qts)
        elif marker == 0xDD:
            if len(body) != 2:
                raise _corrupt("a bad restart interval")
            t.restart = _u16(body, 0)
        elif marker == 0xDA:
            pos = _scan(f, body, t.qts, t.huffman, t.defined, t.restart, data, pos, host, t.cond)
        elif marker == 0xE0:
            jfif = jfif or body[:5] == b"JFIF\x00"
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
    if tables_only:
        if f is not None:
            raise _corrupt("a tables-only stream with a frame")
        return None, jfif, adobe
    if f is None or f.scans == 0:
        raise _corrupt("an image without a frame or a scan")
    return f, jfif, adobe


def decode(data, dct: str = "ifast", host=jpeg_host.NATIVE) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3]: dct "ifast" gives TensorFlow's
    decode_image pixels, "islow" Pillow's convert("RGB") pixels. `host` is
    the set of host loops (jpeg_host.NATIVE; the tests pass PLAIN)."""
    if dct not in _DCT:
        raise ValueError(f"dct {dct!r} is not one of {sorted(_DCT)}")
    f, jfif, adobe = _read(bytes(data), dct, host, _Tables.empty())
    return _pixels(f, _DCT[dct], jfif, adobe, host, dct == "ifast")


def decode_abbreviated(data, tables: Optional[bytes] = None, ycc: bool = False,
                       host=jpeg_host.NATIVE) -> np.ndarray:
    """One strip or tile of a JPEG-compressed TIFF (compression 7) ->
    uint8 [h, w, components], as libtiff has libjpeg-turbo decode it: the
    tables of `tables` (the JPEGTables tag, a tables-only stream) read
    first, then the strip's own stream, which may omit them; the accurate
    IDCT; 1 to 4 components. With `ycc` (photometric YCbCr, which Pillow
    asks libtiff to give as RGB) the components are upsampled by the
    triangle filter and converted to RGB; else they come as stored, with no
    colour conversion (libtiff's JCS_UNKNOWN)."""
    t = _Tables.empty()
    if tables:
        _read(bytes(tables), "islow", host, t, tables_only=True)
    f, _, _ = _read(bytes(data), "islow", host, t, components=(1, 2, 3, 4))
    if f.lossless:
        raise _unsupported("a lossless JPEG inside a TIFF")
    planes = [host.idct(c.coef, c.qt if c.qt is not None else np.ones(64, np.uint16), jpeg_host.ISLOW)
              for c in f.comps]
    if len(f.comps) == 1:
        return np.ascontiguousarray(planes[0][:f.height, :f.width, None])
    up = [host.upsample(p, c.width, c.height, f.hmax // c.h, f.vmax // c.v, f.width, f.height)
          for p, c in zip(planes, f.comps)]
    if ycc:
        if len(f.comps) != 3:
            raise _corrupt(f"a YCbCr strip of {len(f.comps)} components")
        return host.ycc_to_rgb(*up)
    return np.stack(up, axis=-1)


def _cmyk_to_rgb(c: np.ndarray, m: np.ndarray, y: np.ndarray, k: np.ndarray, adobe: bool, tf: bool) -> np.ndarray:
    """libjpeg's CMYK planes -> RGB as each reference converts them.
    TensorFlow (jpeg_mem.cc): with an Adobe marker the planes are inverted
    CMYK, r = k * c / 255, else r = (255 - k) * (255 - c) / 255. Pillow
    reads every CMYK JPEG as inverted ("CMYK;I") and converts it with
    cmyk2rgb (pillow_modes.cmyk)."""
    cmy = np.stack([c, m, y], axis=-1).astype(np.int32)
    kk = k.astype(np.int32)[..., None]
    if tf:
        out = kk * cmy // 255 if adobe else (255 - kk) * (255 - cmy) // 255
        return out.astype(np.uint8)
    return pillow_modes.cmyk(255 - np.concatenate([cmy, kk], axis=-1))


def _pixels(f: _Frame, method: int, jfif: bool, adobe: Optional[int], host, tf: bool) -> np.ndarray:
    if f.lossless:
        if len(f.comps) == 3 and (jfif or adobe not in (None, 0)):  # jdapimin.c: YCbCr, which no lossless
            raise ValueError("a lossless JPEG in YCbCr is refused by libjpeg-turbo (no colour conversion in "
                             "lossless mode), as by Pillow's decoder")
        if len(f.comps) == 4 and adobe not in (None, 0):  # YCCK: Pillow asks for CMYK, which is a conversion
            raise ValueError("a lossless JPEG in YCCK is refused by libjpeg-turbo (no colour conversion in "
                             "lossless mode), as by Pillow's decoder")
        planes = [((c.samples << c.pt) & 0xFF).astype(np.uint8) for c in f.comps]
    else:
        planes = [host.idct(c.coef, c.qt if c.qt is not None else np.ones(64, np.uint16), method) for c in f.comps]
    if len(f.comps) == 1:
        grey = planes[0][:f.height, :f.width]
        return np.repeat(grey[:, :, None], 3, axis=2)
    if f.lossless:  # libjpeg-turbo upsamples a lossless frame by repeating samples (no fancy filter)
        up = [np.ascontiguousarray(p[:c.height, :c.width].repeat(f.vmax // c.v, 0).repeat(f.hmax // c.h, 1)
                                   [:f.height, :f.width]) for p, c in zip(planes, f.comps)]
    else:
        up = [host.upsample(p, c.width, c.height, f.hmax // c.h, f.vmax // c.v, f.width, f.height)
              for p, c in zip(planes, f.comps)]
    if len(f.comps) == 4:
        # jdapimin.c: an Adobe transform of 0 is CMYK, any other YCCK, no Adobe marker CMYK
        if adobe is not None and adobe != 0:  # jdcolor.c ycck_cmyk_convert: 255 - (Y, Cb, Cr as RGB), K kept
            up[:3] = np.moveaxis(255 - host.ycc_to_rgb(*up[:3]), -1, 0)
        return _cmyk_to_rgb(*up, adobe is not None, tf)
    # libjpeg's guess of the colour space (jdapimin.c default_decompress_parms); a lossless frame is RGB
    ids = tuple(c.cid for c in f.comps)
    rgb = f.lossless or (not jfif and adobe == 0) or (not jfif and adobe is None and ids == (82, 71, 66))
    if rgb:
        return np.stack(up, axis=-1)
    return host.ycc_to_rgb(*up)


# --------------------------------------------------------------------------- #
# encoding: the fixture writer
# --------------------------------------------------------------------------- #

# ITU T.81 Annex K.1: the example quantization tables, zigzag order
_STD_LUMA_Q = np.array([16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40, 26, 24, 22, 22, 24, 49, 35,
                        37, 29, 40, 58, 51, 61, 60, 57, 51, 56, 55, 64, 72, 92, 78, 64, 68, 87, 69, 55, 56, 80, 109,
                        81, 87, 95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92, 101, 103, 99], np.int64)
_STD_CHROMA_Q = np.array([17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66, 99] + [99] * 49, np.int64)
# Annex K.3: the example Huffman tables (counts, values)
_STD_DC_LUMA = (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12)))
_STD_DC_CHROMA = (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12)))
_STD_AC_LUMA = (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), bytes([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
    0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA]))
_STD_AC_CHROMA = (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), bytes([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA,
    0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA]))


def _code_table(counts: bytes, values: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical codes of a Huffman table: (code, length) by symbol value."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[values[k]], len_of[values[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """The IJG quality scaling (jcparam.c) of Annex K's tables, zigzag
    order, clamped to 1..255."""
    if not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality {quality} is not in 1..100")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (_STD_LUMA_Q, _STD_CHROMA_Q))


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return m


_DCT8 = _dct_matrix()


def _blocks(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """A plane padded by its edge samples to rows x cols blocks -> float
    [rows, cols, 8, 8]."""
    h, w = plane.shape
    p = np.pad(plane, ((0, rows * 8 - h), (0, cols * 8 - w)), mode="edge")
    return p.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3).astype(np.float64)


def _quantized(blocks: np.ndarray, q_zigzag: np.ndarray) -> np.ndarray:
    """Forward DCT and quantization -> int64 [rows, cols, 64] in zigzag
    order."""
    coef = _DCT8 @ (blocks - 128.0) @ _DCT8.T
    nat = coef.reshape(blocks.shape[:2] + (64,))[..., jpeg_host.NATURAL]
    return (np.sign(nat) * np.floor(np.abs(nat) / q_zigzag + 0.5)).astype(np.int64)


def _size(v: np.ndarray) -> np.ndarray:
    """The bit length of |v| (0 for 0)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _bits_of(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """F.1.2.1's extra bits: v as s bits, negative values one below."""
    return np.where(v < 0, v + (1 << s) - 1, v) & ((1 << s) - 1)


class _Events:
    """Entropy-coder output of one interval: (sort key, value, bit count)."""

    def __init__(self) -> None:
        self.keys, self.vals, self.lens = [], [], []

    def add(self, keys, vals, lens) -> None:
        self.keys.append(np.asarray(keys, np.int64))
        self.vals.append(np.asarray(vals, np.int64))
        self.lens.append(np.asarray(lens, np.int64))

    def bytes(self) -> bytes:
        """The events in key order as bits, padded with ones to a byte, 0xFF
        bytes stuffed with 0x00."""
        if not self.keys:
            return b""
        keys, vals, lens = (np.concatenate(x) for x in (self.keys, self.vals, self.lens))
        order = np.argsort(keys, kind="stable")
        vals, lens = vals[order], lens[order]
        # each value's 32 bits, most significant first; its last `len` kept
        bits = np.unpackbits(vals.astype(">u4").view(np.uint8).reshape(-1, 4), axis=1)
        bits = bits[np.arange(32)[None, :] >= (32 - lens)[:, None]]
        pad = (-bits.size) % 8
        out = np.packbits(np.concatenate([bits, np.ones(pad, np.uint8)]))
        ff = np.nonzero(out == 0xFF)[0]
        return np.insert(out, ff + 1, 0).tobytes()


def _ac_events(ev: _Events, zz: np.ndarray, block_keys: np.ndarray, lo: int, hi: int, ac) -> None:
    """Sequential-style AC coding of zigzag positions lo..hi of each block
    (zz [n, 64]): runs, ZRLs and an EOB after the last nonzero before hi."""
    code_of, len_of = ac
    band = zz[:, lo:hi + 1]
    bi, kk = np.nonzero(band)
    if bi.size:
        vals = band[bi, kk]
        first = np.r_[True, bi[1:] != bi[:-1]]
        prev = np.where(first, -1, np.r_[-1, kk[:-1]])
        run = kk - prev - 1
        zrl, run = run // 16, run % 16
        s = _size(vals)
        sym = (run << 4) | s
        key = block_keys[bi] * 256 + 2 * (kk + lo) + 2
        ev.add(key, (code_of[sym] << s) | _bits_of(vals, s), len_of[sym] + s)
        zi = np.repeat(np.arange(bi.size), zrl)
        if zi.size:
            ev.add(key[zi] - 1, np.full(zi.size, code_of[0xF0]), np.full(zi.size, len_of[0xF0]))
    last = np.full(len(zz), -1)
    if bi.size:
        last[bi] = kk  # np.nonzero is in order: the last write is each block's last nonzero
    eob = np.nonzero(last < hi - lo)[0]
    ev.add(block_keys[eob] * 256 + 255, np.full(eob.size, code_of[0x00]), np.full(eob.size, len_of[0x00]))


def _dc_events(ev: _Events, dc: np.ndarray, comp_of: np.ndarray, block_keys: np.ndarray, dc_codes: Dict) -> None:
    """DC differences within each component of one restart interval."""
    diff, codes, lens = (np.zeros_like(dc) for _ in range(3))
    for c, (code_of, len_of) in dc_codes.items():
        m = comp_of == c
        v = dc[m]
        diff[m] = v - np.r_[0, v[:-1]]
        s = _size(diff[m])
        codes[m], lens[m] = code_of[s], len_of[s]
    s = _size(diff)
    ev.add(block_keys * 256, (codes << s) | _bits_of(diff, s), lens + s)


_SAMPLINGS = {"4:4:4": (1, 1), "4:2:0": (2, 2), "4:2:2": (2, 1), "4:4:0": (1, 2), "4:1:1": (4, 1), "3x1": (3, 1)}


def encode(img: np.ndarray, quality: int = 95, subsampling: str = "4:2:0", progressive: bool = False,
           restart_interval: int = 0, arithmetic: bool = False, colorspace: str = "ycc",
           sampling: Optional[Sequence[Tuple[int, int]]] = None, adobe: Optional[int] = None,
           conditioning: Optional[bytes] = None) -> bytes:
    """uint8 [H, W, 3] (or [H, W] grey, or [H, W, 4] CMYK) -> JPEG bytes.
    `subsampling` names the luma factors over chroma 1 x 1 (4:4:4, 4:2:0,
    4:2:2, 4:4:0, 4:1:1, 3x1); `sampling` gives each component's (h, v)
    instead. A 4-channel image is written as `colorspace` "cmyk" (the
    channels stored as given) or "ycck" (255 - C, M, Y as RGB to YCbCr, K
    kept) with an Adobe marker of transform `adobe` (0 and 2 by default; -1
    writes none). `arithmetic` codes the scans with the QM-coder (SOF9,
    SOF10) after a DAC segment of `conditioning` where given."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] not in (3, 4)) or min(img.shape[:2]) < 1:
        raise ValueError(f"encode takes uint8 [H, W, 3], [H, W, 4] or [H, W], got {img.shape}")
    if subsampling not in _SAMPLINGS:
        raise ValueError(f"subsampling {subsampling!r} is not one of {sorted(_SAMPLINGS)}")
    if not 0 <= restart_interval < 65536:
        raise ValueError(f"restart interval {restart_interval}")
    H, W = img.shape[:2]
    ql, qc = _quality_tables(quality)

    def ycc(rgb):
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
        cb = (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16
        cr = (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16
        return [y, cb, cr]

    if img.ndim == 2:
        planes, tq = [img.astype(np.int64)], [0]
    elif img.shape[2] == 3:
        planes, tq = ycc(img.astype(np.int64)), [0, 1, 1]
    else:
        px = img.astype(np.int64)
        if colorspace == "ycck":
            planes = ycc(255 - px[..., :3]) + [px[..., 3]]
        elif colorspace == "cmyk":
            planes = [px[..., i] for i in range(4)]
        else:
            raise ValueError(f"colorspace {colorspace!r} of a 4-channel image is not cmyk or ycck")
        tq = [0, 1, 1, 0]
    if sampling is not None:
        factors = [tuple(f) for f in sampling]
    else:
        factors = [_SAMPLINGS[subsampling]] + [(1, 1)] * (len(planes) - 1) if len(planes) > 1 else [(1, 1)]
    if len(factors) != len(planes):
        raise ValueError(f"{len(factors)} sampling factors for {len(planes)} components")
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    coefs = []
    for p, (h, v), t in zip(planes, factors, tq):
        sh, sv = hmax // h, vmax // v
        if (sh, sv) != (1, 1):  # means over sh x sv samples, the edges repeated
            p = np.pad(p, ((0, (-p.shape[0]) % sv), (0, (-p.shape[1]) % sh)), mode="edge")
            s = p.reshape(p.shape[0] // sv, sv, p.shape[1] // sh, sh).sum((1, 3))
            if (sh, sv) == (2, 2):  # jcsample.c's alternating bias 1, 2
                p = (s + np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)[None, :]) >> 2
            else:
                p = (s + (sh * sv) // 2) // (sh * sv)
        coefs.append(_quantized(_blocks(p, my * v, mx * h), ql if t == 0 else qc))
    tables = {"dc": [_STD_DC_LUMA, _STD_DC_CHROMA], "ac": [_STD_AC_LUMA, _STD_AC_CHROMA]}
    codes = {k: [_code_table(*t) for t in v] for k, v in tables.items()}
    ncomp = len(planes)

    out = bytearray(b"\xff\xd8")
    if ncomp == 4:
        transform = adobe if adobe is not None else (2 if colorspace == "ycck" else 0)
        if transform >= 0:
            out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform))
    else:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for i, q in enumerate((ql, qc)[: 1 if ncomp == 1 else 2]):
        out += _segment(0xDB, bytes([i]) + bytes(q.astype(np.uint8)))
    sof = struct.pack(">BHHB", 8, H, W, ncomp) + b"".join(
        bytes([i + 1, (h << 4) | v, t]) for i, ((h, v), t) in enumerate(zip(factors, tq)))
    out += _segment((0xCA if progressive else 0xC9) if arithmetic else (0xC2 if progressive else 0xC0), sof)
    if arithmetic:
        if conditioning:
            out += _segment(0xCC, conditioning)
    else:
        for cls, name in ((0, "dc"), (1, "ac")):
            for i, (counts, values) in enumerate(tables[name][: 1 if ncomp == 1 else 2]):
                out += _segment(0xC4, bytes([(cls << 4) | i]) + counts + values)
    if restart_interval:
        out += _segment(0xDD, struct.pack(">H", restart_interval))
    cond = np.array([0] * 4 + [1] * 4 + [5] * 4, np.int64)
    for i in range(0, len(conditioning or b""), 2):
        index, val = conditioning[i], conditioning[i + 1]
        if index >> 4:
            cond[8 + (index & 15)] = val
        else:
            cond[index & 15], cond[4 + (index & 15)] = val & 15, val >> 4

    comp_ids = list(range(ncomp))
    if not progressive:
        scans = [(comp_ids, 0, 63, 0, 0)]
    elif arithmetic:  # the DC and the first AC band by successive approximation, the rest by spectral selection
        scans = [(comp_ids, 0, 0, 0, 1)] + [([c], 1, 5, 0, 1) for c in comp_ids] + [
            ([c], 6, 63, 0, 0) for c in comp_ids] + [(comp_ids, 0, 0, 1, 0)] + [([c], 1, 5, 1, 0) for c in comp_ids]
    else:  # the DC by successive approximation, the AC by spectral selection
        scans = [(comp_ids, 0, 0, 0, 1)] + [([c], 1, 5, 0, 0) for c in comp_ids] + [
            ([c], 6, 63, 0, 0) for c in comp_ids] + [(comp_ids, 0, 0, 1, 0)]
    bws = [(-(-W * h // hmax) + 7) // 8 for h, _ in factors]
    bhs = [(-(-H * v // vmax) + 7) // 8 for _, v in factors]
    for comps, Ss, Se, Ah, Al in scans:
        hdr = bytes([len(comps)]) + b"".join(bytes([c + 1, (min(tq[c], 1) << 4) | min(tq[c], 1)]) for c in comps)
        out += _segment(0xDA, hdr + bytes([Ss, Se, (Ah << 4) | Al]))
        if arithmetic:
            out += _arith_scan_data(coefs, factors, comps, (mx, my), (Ss, Se, Ah, Al), restart_interval,
                                    [min(t, 1) for t in tq], bws, bhs, cond, progressive)
        else:
            out += _scan_data(coefs, factors, comps, (mx, my), (Ss, Se, Ah, Al), restart_interval, codes, tq, bws,
                              bhs)
    out += b"\xff\xd9"
    return bytes(out)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _scan_blocks(factors, comps, mcus, bws, bhs):
    """The blocks of a scan in coding order: (component, row, col) and the
    MCU each is in."""
    mx, my = mcus
    if len(comps) == 1:
        c = comps[0]
        rr, cc = np.meshgrid(np.arange(bhs[c]), np.arange(bws[c]), indexing="ij")
        comp_of = np.full(rr.size, c)
        row, col, mcu = rr.reshape(-1), cc.reshape(-1), np.arange(rr.size)
    else:
        parts = []
        for c in comps:
            h, v = factors[c]
            m_y, m_x, y, x = np.meshgrid(np.arange(my), np.arange(mx), np.arange(v), np.arange(h), indexing="ij")
            within = (comps.index(c) * 16 + y * h + x)
            parts.append((np.full(m_y.size, c), (m_y * v + y).reshape(-1), (m_x * h + x).reshape(-1),
                          (m_y * mx + m_x).reshape(-1), within.reshape(-1)))
        comp_of, row, col, mcu, within = (np.concatenate(z) for z in zip(*parts))
        order = np.lexsort((within, mcu))
        comp_of, row, col, mcu = comp_of[order], row[order], col[order], mcu[order]
    return comp_of, row, col, mcu


def _scan_data(coefs, factors, comps, mcus, params, restart: int, codes, tq, bws, bhs) -> bytes:
    """The entropy-coded data of one scan, restart markers included."""
    Ss, Se, Ah, Al = params
    comp_of, row, col, mcu = _scan_blocks(factors, comps, mcus, bws, bhs)
    zz = np.zeros((comp_of.size, 64), np.int64)
    for c in comps:
        m = comp_of == c
        zz[m] = coefs[c][row[m], col[m]]
    interval_of = mcu // restart if restart else np.zeros_like(mcu)
    out = bytearray()
    for i, start in enumerate(np.unique(interval_of)):
        sel = np.nonzero(interval_of == start)[0]
        ev = _Events()
        keys = np.arange(sel.size)
        if Ss == 0:
            if Ah == 0:
                dc_codes = {c: codes["dc"][min(tq[c], 1)] for c in comps}
                _dc_events(ev, zz[sel, 0] >> Al, comp_of[sel], keys, dc_codes)
            else:
                ev.add(keys * 256, (zz[sel, 0] >> Al) & 1, np.ones(sel.size, np.int64))
        if Se > 0:
            for c in comps:
                m = comp_of[sel] == c
                _ac_events(ev, zz[sel][m], keys[m], max(Ss, 1), Se, codes["ac"][min(tq[c], 1)])
        if i:
            out += bytes([0xFF, 0xD0 + ((i - 1) & 7)])
        out += ev.bytes()
    return bytes(out)


class _ArithEncoder:
    """The QM-coder's encoder as jcarith.c runs it (Annex D.1), with
    libjpeg's byte stacking and its flush."""

    def __init__(self) -> None:
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b: int) -> None:
        self.out.append(b)

    def _zeros(self) -> None:
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, stats: List[int], i: int, val: int) -> None:
        sv = stats[i]
        qe = int(jpeg_host.ARITAB[sv & 0x7F])
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def flush(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _arith_scan_data(coefs, factors, comps, mcus, params, restart: int, tbl, bws, bhs, cond, progressive) -> bytes:
    """The arithmetic-coded data of one scan (jcarith.c's encode_mcu and
    its progressive forms), restart markers included."""
    Ss, Se, Ah, Al = params
    comp_of, row, col, mcu = _scan_blocks(factors, comps, mcus, bws, bhs)
    out = bytearray()
    enc, dc_stats, ac_stats, last, ctx = None, {}, {}, {}, {}
    fixed = [113]

    def restart_state():
        for c in comps:
            dc_stats[tbl[c]], ac_stats[tbl[c]] = [0] * 64, [0] * 256
            last[c] = ctx[c] = 0

    def magnitude(st, i, v, k=None, t=None):
        """Figures F.8 and F.9 from bin i: v >= 1 (|value|)."""
        m, v = 0, v - 1
        if v:
            enc.encode(st, i, 1)
            m, v2 = 1, v
            if k is None:
                i = 20
                v2 >>= 1
                while v2:
                    enc.encode(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
            else:
                v2 >>= 1
                if v2:
                    enc.encode(st, i, 1)
                    m <<= 1
                    i = 189 if k <= cond[8 + t] else 217
                    v2 >>= 1
                    while v2:
                        enc.encode(st, i, 1)
                        m <<= 1
                        i += 1
                        v2 >>= 1
        enc.encode(st, i, 0)
        i += 14
        while m > 1:
            m >>= 1
            enc.encode(st, i, 1 if m & v else 0)

    def point(v):  # the point transform of an AC value: division rounding to 0
        return v >> Al if v >= 0 else -((-v) >> Al)

    def block(c, b):
        t = tbl[c]
        if not progressive or (Ss == 0 and Ah == 0):
            dcv = int(b[0]) >> Al if progressive else int(b[0])
            st, i = dc_stats[t], ctx[c]
            v = dcv - last[c]
            last[c] = dcv
            if v == 0:
                enc.encode(st, i, 0)
                ctx[c] = 0
            else:
                enc.encode(st, i, 1)
                sign = int(v < 0)
                enc.encode(st, i + 1, sign)
                v = abs(v)
                m = 1 << ((v - 1).bit_length() - 1) if v > 1 else 0  # the magnitude category's top bit
                if m < (1 << cond[t]) >> 1:
                    ctx[c] = 0
                elif m > (1 << cond[4 + t]) >> 1:
                    ctx[c] = 12 + 4 * sign
                else:
                    ctx[c] = 4 + 4 * sign
                magnitude(st, i + 2 + sign, v)
            if progressive:
                return
        elif Ss == 0:
            enc.encode(fixed, 0, (int(b[0]) >> Al) & 1)
            return
        st = ac_stats[t]
        lo, hi = (Ss, Se) if progressive else (1, 63)
        vals = [point(int(b[k])) if progressive else int(b[k]) for k in range(64)]  # b is in zigzag order
        ke = hi
        while ke >= lo and vals[ke] == 0:
            ke -= 1
        if not progressive or Ah == 0:
            k = lo
            while k <= ke:
                i = 3 * (k - 1)
                enc.encode(st, i, 0)
                while vals[k] == 0:
                    enc.encode(st, i + 1, 0)
                    i += 3
                    k += 1
                enc.encode(st, i + 1, 1)
                enc.encode(fixed, 0, int(vals[k] < 0))
                magnitude(st, i + 2, abs(vals[k]), k, t)
                k += 1
            if k <= hi:
                enc.encode(st, 3 * (k - 1), 1)
            return
        prev = []  # the previous stage's values: point-transformed by Ah
        for k in range(64):
            v = int(b[k])
            prev.append(v >> Ah if v >= 0 else -((-v) >> Ah))
        kex = ke
        while kex >= lo and prev[kex] == 0:
            kex -= 1
        k = lo
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                enc.encode(st, i, 0)
            while True:
                v = vals[k]
                if v:
                    if abs(v) >> 1:
                        enc.encode(st, i + 2, abs(v) & 1)
                    else:
                        enc.encode(st, i + 1, 1)
                        enc.encode(fixed, 0, int(v < 0))
                    break
                enc.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= hi:
            enc.encode(st, 3 * (k - 1), 1)

    interval_of = mcu // restart if restart else np.zeros_like(mcu)
    for n, start in enumerate(np.unique(interval_of)):
        enc = _ArithEncoder()
        restart_state()
        for j in np.nonzero(interval_of == start)[0]:
            c = int(comp_of[j])
            block(c, coefs[c][row[j], col[j]])
        if n:
            out += bytes([0xFF, 0xD0 + ((n - 1) & 7)])
        out += enc.flush()
    return bytes(out)


def _lossless_predict(x: np.ndarray, predictor: int, initial: int, reset_rows) -> np.ndarray:
    """The predictions of ITU T.81 H.1.2.1 for the samples x [rows, cols]
    (int64): on a reset row (the scan's first and each restart's) the
    first sample from `initial`, the rest from the left; on other rows the
    first sample from above, the rest by `predictor` (1..7)."""
    pred = np.zeros_like(x)
    for r in range(x.shape[0]):
        if r in reset_rows:
            pred[r, 0] = initial
            pred[r, 1:] = x[r, :-1]
            continue
        ra, rb, rc = x[r, :-1], x[r - 1, 1:], x[r - 1, :-1]
        pred[r, 0] = x[r - 1, 0]
        pred[r, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                       7: (ra + rb) >> 1}[predictor]
    return pred


def _pack_bits(pairs) -> bytes:
    """(value, bit count) pairs -> bytes, padded with ones, 0xFF stuffed."""
    acc, n, out = 0, 0, bytearray()
    for v, k in pairs:
        acc = (acc << k) | (v & ((1 << k) - 1))
        n += k
        while n >= 8:
            n -= 8
            b = (acc >> n) & 0xFF
            out.append(b)
            if b == 0xFF:
                out.append(0)
    if n:
        b = ((acc << (8 - n)) | ((1 << (8 - n)) - 1)) & 0xFF
        out.append(b)
        if b == 0xFF:
            out.append(0)
    return bytes(out)


def encode_lossless(img: np.ndarray, predictor: int = 1, point_transform: int = 0, restart_rows: int = 0,
                    sampling: Optional[Sequence[Tuple[int, int]]] = None, marker: str = "adobe",
                    interleaved: bool = True) -> bytes:
    """uint8 [H, W, 3] or [H, W] -> a lossless JPEG (SOF3, 8-bit, Huffman):
    the channels stored as given (no colour conversion), each downsampled
    by `sampling` (means), predicted by `predictor` after the point
    transform, with a restart every `restart_rows` MCU rows, one
    interleaved scan or a scan a component, and an Adobe (transform 0),
    JFIF or no marker. The fixture writer for the lossless decoder."""
    img = np.asarray(img, np.uint8)
    planes = [img.astype(np.int64)] if img.ndim == 2 else [img[..., i].astype(np.int64) for i in range(img.shape[2])]
    H, W = img.shape[:2]
    factors = [tuple(f) for f in sampling] if sampling else [(1, 1)] * len(planes)
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mx, my = -(-W // hmax), -(-H // vmax)  # an MCU is h x v samples of each component
    dc_codes = _code_table(*_STD_DC_LUMA)
    initial = 1 << (8 - point_transform - 1)
    out = bytearray(b"\xff\xd8")
    if marker == "adobe":
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0))
    elif marker == "jfif":
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _segment(0xC3, struct.pack(">BHHB", 8, H, W, len(planes)) + b"".join(
        bytes([i + 1, (h << 4) | v, 0]) for i, (h, v) in enumerate(factors)))
    out += _segment(0xC4, bytes([0]) + _STD_DC_LUMA[0] + _STD_DC_LUMA[1])
    samples = []
    for p, (h, v) in zip(planes, factors):
        sh, sv = hmax // h, vmax // v
        ch_, cw_ = -(-H * v // vmax), -(-W * h // hmax)
        if (sh, sv) != (1, 1):
            p = np.pad(p, ((0, (-p.shape[0]) % sv), (0, (-p.shape[1]) % sh)), mode="edge")
            p = (p.reshape(p.shape[0] // sv, sv, p.shape[1] // sh, sh).sum((1, 3)) + (sh * sv) // 2) // (sh * sv)
        p = p[:ch_, :cw_]
        if interleaved and len(planes) > 1:
            p = np.pad(p, ((0, my * v - p.shape[0]), (0, mx * h - p.shape[1])), mode="edge")
        samples.append(p >> point_transform)
    mcus_per_row = mx if interleaved and len(planes) > 1 else None
    if restart_rows:
        out += _segment(0xDD, struct.pack(">H", restart_rows * (mcus_per_row or samples[0].shape[1])))
    scans = [list(range(len(planes)))] if interleaved and len(planes) > 1 else [[c] for c in range(len(planes))]
    for comps in scans:
        out += _segment(0xDA, bytes([len(comps)]) + b"".join(bytes([c + 1, 0]) for c in comps)
                        + bytes([predictor, 0, point_transform]))
        rows_a_restart = restart_rows or 10**9
        diffs = {}
        for c in comps:
            v = factors[c][1] if len(comps) > 1 else 1
            x = samples[c]
            resets = set(range(0, x.shape[0], rows_a_restart * v))
            d = (x - _lossless_predict(x, predictor, initial, resets)) & 0xFFFF
            diffs[c] = np.where(d >= 32768, d - 65536, d)
        n_rows = my if len(comps) > 1 else samples[comps[0]].shape[0]
        for start in range(0, n_rows, rows_a_restart):
            pairs = []
            for mrow in range(start, min(start + rows_a_restart, n_rows)):
                if len(comps) > 1:
                    for mcol in range(mx):
                        for c in comps:
                            h, v = factors[c]
                            for y in range(v):
                                for x in range(h):
                                    pairs.append(diffs[c][mrow * v + y, mcol * h + x])
                else:
                    pairs.extend(diffs[comps[0]][mrow])
            vals = np.array(pairs, np.int64)
            s = _size(vals)
            bits = [(int(dc_codes[0][k]), int(dc_codes[1][k])) for k in s]
            if start:
                out += bytes([0xFF, 0xD0 + ((start // rows_a_restart - 1) & 7)])
            out += _pack_bits([p for (code, n), v, k in zip(bits, vals, s) for p in ((code, n), (int(_bits_of(v, k)), int(k)))])
    out += b"\xff\xd9"
    return bytes(out)
