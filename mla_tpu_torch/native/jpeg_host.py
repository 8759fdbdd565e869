"""ctypes wrapper of the JPEG decoder's host loops, with their plain versions.

`csrc/jpeg_host.cpp` holds the loops of `vla/rlds/jpeg.py` that are too
slow in Python: the entropy decoding of a scan (Huffman, and arithmetic
by the QM-coder of ITU T.81 Annex D; a lossless scan's differences and
their prediction undone), the two inverse DCTs, the
fancy upsampling and the YCbCr -> RGB conversion. It is built at first use
(`native/build.py`); a failed build raises. Each function has a plain
version here (Python and numpy, the same arithmetic), and `NATIVE` and
`PLAIN` bundle the two sets for `jpeg.decode`: the decoder runs NATIVE,
the tests hold PLAIN to it and both to TensorFlow's and Pillow's decodes.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from types import SimpleNamespace
from typing import List, Optional, Sequence

import numpy as np

from mla_tpu_torch.native.build import CSRC, load_library

SRC = CSRC / "jpeg_host.cpp"
IFAST, ISLOW = 0, 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The helper library, built first where it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            lib = load_library("jpeg_host")
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.jpeg_decode_scan.argtypes = [p, i64, i64, p, p, p, p, p, ctypes.c_char_p, i]
            lib.jpeg_decode_scan.restype = i
            lib.jpeg_decode_scan_arith.argtypes = [p, i64, i64, p, p, p, p, p, p, ctypes.c_char_p, i]
            lib.jpeg_decode_scan_arith.restype = i
            lib.jpeg_decode_scan_lossless.argtypes = [p, i64, i64, p, p, p, p, p, ctypes.c_char_p, i]
            lib.jpeg_decode_scan_lossless.restype = i
            lib.jpeg_idct.argtypes, lib.jpeg_idct.restype = [p, i, i, p, i, p], None
            lib.jpeg_upsample.argtypes, lib.jpeg_upsample.restype = [p, i64, i, i, i, i, p, i, i], None
            lib.jpeg_ycc_to_rgb.argtypes, lib.jpeg_ycc_to_rgb.restype = [p, p, p, i64, p], None
            _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# zigzag index -> natural index (ITU T.81 figure A.6)
NATURAL = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20,
                    13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
                    45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
# libjpeg's AAN scale factors for the fast IDCT, 14 fractional bits
AAN_SCALES = np.array([
    16384, 22725, 21407, 19266, 16384, 12873, 8867, 4520, 22725, 31521, 29692, 26722, 22725, 17855, 12299, 6270,
    21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906, 19266, 26722, 25172, 22654, 19266, 15137, 10426, 5315,
    16384, 22725, 21407, 19266, 16384, 12873, 8867, 4520, 12873, 17855, 16819, 15137, 12873, 10114, 6967, 3552,
    8867, 12299, 11585, 10426, 8867, 6967, 4799, 2446, 4520, 6270, 5906, 5315, 4520, 3552, 2446, 1247], np.int64)


# --------------------------------------------------------------------------- #
# entropy decoding of one scan
# --------------------------------------------------------------------------- #


def _check_scan(data, scan, comps, coefs, tables):
    buf = np.frombuffer(data, np.uint8)
    scan = np.ascontiguousarray(scan, np.int32)
    comps = np.ascontiguousarray(comps, np.int32)
    tables = np.ascontiguousarray(tables, np.uint8)
    if scan.shape != (9,) or comps.shape != (scan[0], 8) or tables.shape != (8, 272) or len(coefs) != scan[0]:
        raise ValueError(f"scan {scan.shape}, components {comps.shape}, tables {tables.shape}, {len(coefs)} arrays")
    for (h, v, stride, bw, bh, dc, ac, _), c in zip(comps, coefs):
        if c.dtype != np.int16 or not c.flags.c_contiguous or c.ndim != 3 or c.shape[1:] != (stride, 64):
            raise ValueError(f"coefficients {c.dtype} {c.shape}, expected int16 [rows, {stride}, 64]")
        rows = scan[7] * v if scan[0] > 1 else bh
        cols = scan[6] * h if scan[0] > 1 else bw
        if c.shape[0] < rows or stride < cols or not (0 <= dc < 4 and 0 <= ac < 4):
            raise ValueError(f"coefficients {c.shape} for {rows} x {cols} blocks, tables {dc}, {ac}")
    return buf, scan, comps, tables


def decode_scan(data, start: int, scan, comps, coefs: Sequence[np.ndarray], tables) -> int:
    """Entropy-decode the scan whose data starts at data[start] into
    `coefs` (int16 [rows, stride, 64] a component, natural order, updated
    in place). scan: [components, Ss, Se, Ah, Al, restart interval, MCUs
    across, MCUs down, progressive]; comps [n, 8]: [h, v, stride, blocks
    across and down coded alone, DC table, AC table, 0]; tables uint8 [8,
    272]: 4 DC then 4 AC tables of 16 counts and 256 values. Returns where
    the marker that ends the scan starts. A corrupt or truncated scan raises
    ValueError."""
    buf, scan, comps, tables = _check_scan(data, scan, comps, coefs, tables)
    ptrs = (ctypes.c_void_p * len(coefs))(*[_ptr(c) for c in coefs])
    end = ctypes.c_int64(0)
    err = ctypes.create_string_buffer(256)
    if load().jpeg_decode_scan(_ptr(buf), buf.size, start, _ptr(scan), _ptr(comps), ptrs, _ptr(tables),
                               ctypes.byref(end), err, len(err)):
        raise ValueError(f"corrupt JPEG data: {err.value.decode()}")
    return int(end.value)


@functools.lru_cache(maxsize=32)
def _lookup16(table: bytes) -> List[int]:
    """A Huffman table (16 counts, then values) as a 16-bit lookahead list:
    (length << 8) | value for each 16-bit window, -1 where no code starts."""
    counts = table[:16]
    look = [-1] * 65536
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if k >= 256:
                raise ValueError("corrupt JPEG data: a Huffman table whose counts overflow its code space")
            lo = code << (16 - length)
            look[lo:lo + (1 << (16 - length))] = [(length << 8) | table[16 + k]] * (1 << (16 - length))
            code += 1
            k += 1
        if code >= 1 << length:
            raise ValueError("corrupt JPEG data: a Huffman table whose counts overflow its code space")
        code <<= 1
    return look


class _PlainBits:
    """The plain version of the bit reader: an int accumulator, zero bits
    past the data, counted."""

    def __init__(self, d: bytes, pos: int) -> None:
        self.d, self.n = d, len(d)
        self.restart(pos)

    def restart(self, pos: int) -> None:
        self.pos, self.acc, self.bits, self.phantom, self.at_marker, self.marker = pos, 0, 0, 0, False, 0

    def fill(self) -> None:
        d, n = self.d, self.n
        while self.bits <= 56:
            b = 0
            if not self.at_marker:
                if self.pos >= n:
                    self.at_marker, self.marker = True, n
                elif d[self.pos] != 0xFF:
                    b = d[self.pos]
                    self.pos += 1
                else:
                    p = self.pos + 1
                    while p < n and d[p] == 0xFF:
                        p += 1
                    if p < n and d[p] == 0:
                        b, self.pos = 0xFF, p + 1
                    else:
                        self.at_marker, self.marker = True, self.pos
            if self.at_marker:
                self.phantom += 8
            self.acc = ((self.acc << 8) | b) & ((1 << 64) - 1)
            self.bits += 8

    def get(self, k: int) -> int:
        if k == 0:
            return 0
        if self.bits < k:
            self.fill()
        self.bits -= k
        return (self.acc >> self.bits) & ((1 << k) - 1)

    def decode(self, look: List[int]) -> int:
        if self.bits < 16:
            self.fill()
        v = look[(self.acc >> (self.bits - 16)) & 0xFFFF]
        if v < 0:
            return -1
        self.bits -= v >> 8
        return v & 0xFF


def _extend(v: int, s: int) -> int:
    return 0 if s == 0 else (v - (1 << s) + 1 if v < (1 << (s - 1)) else v)


def _i16(x: int) -> int:
    return ((x + 32768) & 0xFFFF) - 32768


def decode_scan_plain(data, start: int, scan, comps, coefs: Sequence[np.ndarray], tables) -> int:
    """The plain version of `decode_scan`, in Python."""
    _, scan, comps, tables = _check_scan(data, scan, comps, coefs, tables)
    ns, Ss, Se, Ah, Al, interval, mcus_x, mcus_y, progressive = (int(x) for x in scan)
    d = bytes(data)
    looks = {}
    for slot in {int(c[5]) for c in comps} | {4 + int(c[6]) for c in comps}:
        looks[slot] = _lookup16(tables[slot].tobytes())
    sc = [dict(h=int(c[0]), v=int(c[1]), bw=int(c[3]), bh=int(c[4]), dc=looks[int(c[5])], ac=looks[4 + int(c[6])],
               coef=a.reshape(-1, 64), stride=int(c[2]), pred=0) for c, a in zip(comps, coefs)]
    br = _PlainBits(d, start)
    p1, m1 = 1 << Al, -(1 << Al)
    state = {"eobrun": 0}

    def fail(msg):
        raise ValueError(f"corrupt JPEG data: {msg}")

    def block(c, b):
        ac = c["ac"]
        if not progressive:
            t = br.decode(c["dc"])
            if t < 0 or t > 15:
                fail("a bad Huffman code in a DC coefficient")
            c["pred"] += _extend(br.get(t), t)
            b[0] = _i16(c["pred"])
            k = 1
            while k < 64:
                rs = br.decode(ac)
                if rs < 0:
                    fail("a bad Huffman code in an AC coefficient")
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    if k > 63:
                        fail("an AC run past the end of its block")
                    b[NATURAL[k]] = _extend(br.get(s), s)
                elif r == 15:
                    k += 15
                else:
                    break
                k += 1
            return
        if Ss == 0:
            if not Ah:
                t = br.decode(c["dc"])
                if t < 0 or t > 15:
                    fail("a bad Huffman code in a DC coefficient")
                c["pred"] += _extend(br.get(t), t)
                b[0] = _i16(c["pred"] * p1)
            elif br.get(1):
                b[0] = int(b[0]) | p1
            return
        if not Ah:
            if state["eobrun"] > 0:
                state["eobrun"] -= 1
                return
            k = Ss
            while k <= Se:
                rs = br.decode(ac)
                if rs < 0:
                    fail("a bad Huffman code in an AC coefficient")
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    if k > Se:
                        fail("an AC run past the end of its band")
                    b[NATURAL[k]] = _i16(_extend(br.get(s), s) * p1)
                elif r == 15:
                    k += 15
                else:
                    state["eobrun"] = (1 << r) - 1 + br.get(r)
                    break
                k += 1
            return
        k = Ss
        if state["eobrun"] == 0:
            while k <= Se:
                rs = br.decode(ac)
                if rs < 0:
                    fail("a bad Huffman code in an AC refinement")
                r, s = rs >> 4, rs & 15
                if s:
                    if s != 1:
                        fail("an AC refinement of more than one bit")
                    s = p1 if br.get(1) else m1
                elif r != 15:
                    state["eobrun"] = (1 << r) + br.get(r)
                    break
                while True:
                    pos = NATURAL[k]
                    if b[pos] != 0:
                        if br.get(1) and (int(b[pos]) & p1) == 0:
                            b[pos] = int(b[pos]) + (p1 if b[pos] >= 0 else m1)
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                    if k > Se:
                        break
                if s:
                    if k > Se:
                        fail("an AC refinement past the end of its band")
                    b[NATURAL[k]] = s
                k += 1
        if state["eobrun"] > 0:
            while k <= Se:
                pos = NATURAL[k]
                if b[pos] != 0 and br.get(1) and (int(b[pos]) & p1) == 0:
                    b[pos] = int(b[pos]) + (p1 if b[pos] >= 0 else m1)
                k += 1
            state["eobrun"] -= 1

    def ends_cleanly():
        br.fill()
        return br.at_marker and br.bits - br.phantom < 8

    total = sc[0]["bw"] * sc[0]["bh"] if ns == 1 else mcus_x * mcus_y
    rst = 0
    for m in range(total):
        if interval and m and m % interval == 0:
            if not ends_cleanly():
                fail("data past the end of a restart interval")
            p = br.marker
            while p < len(d) and d[p] == 0xFF:
                p += 1
            if p >= len(d):
                fail("the data ends inside a scan (truncated)")
            if d[p] != 0xD0 + (rst & 7):
                fail("a missing or misnumbered restart marker")
            rst += 1
            br.restart(p + 1)
            for c in sc:
                c["pred"] = 0
            state["eobrun"] = 0
        if ns == 1:
            c = sc[0]
            block(c, c["coef"][(m // c["bw"]) * c["stride"] + m % c["bw"]])
        else:
            my, mx = divmod(m, mcus_x)
            for c in sc:
                for y in range(c["v"]):
                    for x in range(c["h"]):
                        block(c, c["coef"][(my * c["v"] + y) * c["stride"] + mx * c["h"] + x])
        if br.bits < br.phantom:
            fail("the data ends inside a scan (truncated)" if br.marker >= len(d)
                 else "a scan's data ends before its last block")
    if not ends_cleanly():
        fail("data past the end of a scan")
    return br.marker


# --------------------------------------------------------------------------- #
# arithmetic decoding of one scan
# --------------------------------------------------------------------------- #

# ITU T.81 table D.2 as libjpeg packs it: (Qe << 16) | (next MPS << 8) |
# (switch MPS << 7) | next LPS; entry 113 is the fixed, non-adapting one
ARITAB = np.array([
    0x5a1d0181, 0x2586020e, 0x11140310, 0x80b0412, 0x3d80514, 0x1da0617, 0xe50719, 0x6f081c, 0x36091e, 0x1a0a21,
    0xd0b23, 0x60c09, 0x30d0a, 0x10d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a,
    0xcef152b, 0x9a1162d, 0x72f172e, 0x55c1830, 0x4061931, 0x3031a33, 0x2401b34, 0x1b11c36, 0x1441d38, 0xf51e39,
    0xb71f3b, 0x8a203c, 0x68213e, 0x4e223f, 0x3b2320, 0x2c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843,
    0x261f2944, 0x1f332a45, 0x19a82b46, 0x15182c48, 0x11772d49, 0xe742e4a, 0xbfb2f4b, 0x9f8304d, 0x861314e,
    0x706324f, 0x5cd3330, 0x4de3432, 0x40f3532, 0x3633633, 0x2d43734, 0x25c3835, 0x1f83936, 0x1a43a37, 0x1603b38,
    0x1253c39, 0xf63d3a, 0xcb3e3b, 0xab3f3d, 0x8f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553,
    0x293c4654, 0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0xf6b4d4a, 0xd514e4b,
    0xbb64f4d, 0xa40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a, 0x34ee555b, 0x2eae565c, 0x299a575d,
    0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171], np.int32)


def _check_cond(cond) -> np.ndarray:
    cond = np.ascontiguousarray(cond, np.int32)
    if cond.shape != (12,):
        raise ValueError(f"conditioning {cond.shape}, expected [DC L x 4, DC U x 4, AC K x 4]")
    return cond


def decode_scan_arith(data, start: int, scan, comps, coefs: Sequence[np.ndarray], cond) -> int:
    """Entropy-decode an arithmetic-coded scan (jdarith.c), as
    decode_scan does a Huffman one; comps' table slots are the DC and AC
    conditioning tables (0..3), `cond` their DAC values [DC L of tables
    0..3, DC U of 0..3, AC K of 0..3]. Returns where the next marker
    starts; a truncated scan raises ValueError."""
    buf, scan, comps, _ = _check_scan(data, scan, comps, coefs, np.zeros((8, 272), np.uint8))
    cond = _check_cond(cond)
    ptrs = (ctypes.c_void_p * len(coefs))(*[_ptr(c) for c in coefs])
    end = ctypes.c_int64(0)
    err = ctypes.create_string_buffer(256)
    if load().jpeg_decode_scan_arith(_ptr(buf), buf.size, start, _ptr(scan), _ptr(comps), ptrs, _ptr(cond),
                                     _ptr(ARITAB), ctypes.byref(end), err, len(err)):
        raise ValueError(f"corrupt JPEG data: {err.value.decode()}")
    return int(end.value)


class _PlainArith:
    """The plain version of the QM-coder's decoder."""

    def __init__(self, d: bytes, pos: int) -> None:
        self.d, self.n = d, len(d)
        self.restart(pos)
        self.past_end = False

    def restart(self, pos: int) -> None:
        self.pos, self.c, self.a, self.ct, self.at_marker, self.marker = pos, 0, 0, -16, False, 0

    def byte(self) -> int:
        if self.at_marker:
            return 0
        d, n = self.d, self.n
        if self.pos >= n:
            self.past_end = True
            return 0
        b = d[self.pos]
        self.pos += 1
        if b != 0xFF:
            return b
        p = self.pos
        while p < n and d[p] == 0xFF:
            p += 1
        if p >= n:
            self.past_end = True
            return 0
        if d[p] == 0:
            self.pos = p + 1
            return 0xFF
        self.at_marker, self.marker = True, self.pos - 1
        return 0

    def decode(self, stats: List[int], i: int) -> int:
        while self.a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                self.c = (self.c << 8) | self.byte()
                self.ct += 8
                if self.ct < 0:
                    self.ct += 1
                    if self.ct == 0:
                        self.a = 0x8000
            self.a <<= 1
        sv = stats[i]
        qe = int(ARITAB[sv & 0x7F])
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        temp = self.a << self.ct
        if self.c >= temp:
            self.c -= temp
            if self.a < qe:
                self.a, stats[i] = qe, (sv & 0x80) ^ nm
            else:
                self.a, stats[i] = qe, (sv & 0x80) ^ nl
                sv ^= 0x80
        elif self.a < 0x8000:
            if self.a < qe:
                stats[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                stats[i] = (sv & 0x80) ^ nm
        return sv >> 7


def _next_marker(d: bytes, p: int) -> int:
    """Where the next marker starts at or after p, any other bytes skipped
    as libjpeg's marker reader skips them; -1 where the data ends first."""
    n = len(d)
    while True:
        while p < n and d[p] != 0xFF:
            p += 1
        q = p
        while q < n and d[q] == 0xFF:
            q += 1
        if q >= n:
            return -1
        if d[q] != 0:
            return p
        p = q + 1


def decode_scan_arith_plain(data, start: int, scan, comps, coefs: Sequence[np.ndarray], cond) -> int:
    """The plain version of `decode_scan_arith`, in Python."""
    _, scan, comps, _ = _check_scan(data, scan, comps, coefs, np.zeros((8, 272), np.uint8))
    cond = [int(x) for x in _check_cond(cond)]
    ns, Ss, Se, Ah, Al, interval, mcus_x, mcus_y, progressive = (int(x) for x in scan)
    d = bytes(data)
    sc = [dict(h=int(c[0]), v=int(c[1]), bw=int(c[3]), bh=int(c[4]), dc=int(c[5]), ac=int(c[6]),
               coef=a.reshape(-1, 64), stride=int(c[2]), pred=0, ctx=0) for c, a in zip(comps, coefs)]
    dc_stats = {c["dc"]: [0] * 64 for c in sc}
    ac_stats = {c["ac"]: [0] * 256 for c in sc}
    fixed = [113]
    ar = _PlainArith(d, start)
    p1, m1 = 1 << Al, -(1 << Al)

    def reset():
        for c in sc:
            if not progressive or (Ss == 0 and Ah == 0):
                dc_stats[c["dc"]][:] = [0] * 64
            if not progressive or Ss:
                ac_stats[c["ac"]][:] = [0] * 256
            c["pred"] = c["ctx"] = 0

    class Overflow(Exception):
        pass

    def dc_diff(c) -> int:
        st, i = dc_stats[c["dc"]], c["ctx"]
        if ar.decode(st, i) == 0:
            c["ctx"] = 0
            return 0
        sign = ar.decode(st, i + 1)
        i += 2 + sign
        m = ar.decode(st, i)
        if m:
            i = 20
            while ar.decode(st, i):
                m <<= 1
                if m == 0x8000:
                    raise Overflow
                i += 1
        if m < (1 << cond[c["dc"]]) >> 1:
            c["ctx"] = 0
        elif m > (1 << cond[4 + c["dc"]]) >> 1:
            c["ctx"] = 12 + sign * 4
        else:
            c["ctx"] = 4 + sign * 4
        v = m
        i += 14
        while m > 1:
            m >>= 1
            if ar.decode(st, i):
                v |= m
        return -(v + 1) if sign else v + 1

    def ac_value(tbl: int, k: int, i: int) -> int:
        st = ac_stats[tbl]
        sign = ar.decode(fixed, 0)
        i += 2
        m = ar.decode(st, i)
        if m and ar.decode(st, i):
            m <<= 1
            i = 189 if k <= cond[8 + tbl] else 217
            while ar.decode(st, i):
                m <<= 1
                if m == 0x8000:
                    raise Overflow
                i += 1
        v = m
        i += 14
        while m > 1:
            m >>= 1
            if ar.decode(st, i):
                v |= m
        return -(v + 1) if sign else v + 1

    def block(c, b):
        if not progressive or (Ss == 0 and Ah == 0):
            c["pred"] = (c["pred"] + dc_diff(c)) & 0xFFFF
            b[0] = _i16(_i16(c["pred"]) * (1 << Al)) if progressive else _i16(c["pred"])
            if progressive:
                return
        elif Ss == 0:
            if ar.decode(fixed, 0):
                b[0] = int(b[0]) | p1
            return
        st = ac_stats[c["ac"]]
        lo, hi = (Ss, Se) if progressive else (1, 63)
        if not progressive or Ah == 0:
            k = lo
            while k <= hi:
                i = 3 * (k - 1)
                if ar.decode(st, i):
                    break
                while ar.decode(st, i + 1) == 0:
                    i += 3
                    k += 1
                    if k > hi:
                        raise Overflow
                v = ac_value(c["ac"], k, i)
                b[NATURAL[k]] = _i16(v * (1 << Al)) if progressive else v
                k += 1
            return
        kex = Se
        while kex > 0 and not b[NATURAL[kex]]:
            kex -= 1
        k = Ss
        while k <= Se:
            i = 3 * (k - 1)
            if k > kex and ar.decode(st, i):
                break
            while True:
                pos = NATURAL[k]
                if b[pos]:
                    if ar.decode(st, i + 2):
                        b[pos] = int(b[pos]) + (m1 if b[pos] < 0 else p1)
                    break
                if ar.decode(st, i + 1):
                    b[pos] = m1 if ar.decode(fixed, 0) else p1
                    break
                i += 3
                k += 1
                if k > Se:
                    raise Overflow
            k += 1

    reset()
    total = sc[0]["bw"] * sc[0]["bh"] if ns == 1 else mcus_x * mcus_y
    rst, stopped = 0, False
    for m in range(total):
        if interval and m and m % interval == 0:
            p = _next_marker(d, ar.marker if ar.at_marker else ar.pos)
            if p < 0:
                raise ValueError("corrupt JPEG data: the data ends inside a scan (truncated)")
            while d[p] == 0xFF:
                p += 1
            if d[p] != 0xD0 + (rst & 7):
                raise ValueError("corrupt JPEG data: a missing or misnumbered restart marker")
            rst += 1
            ar.restart(p + 1)
            reset()
            stopped = False
        if not stopped:
            try:
                if ns == 1:
                    c = sc[0]
                    block(c, c["coef"][(m // c["bw"]) * c["stride"] + m % c["bw"]])
                else:
                    my, mx = divmod(m, mcus_x)
                    for c in sc:
                        for y in range(c["v"]):
                            for x in range(c["h"]):
                                block(c, c["coef"][(my * c["v"] + y) * c["stride"] + mx * c["h"] + x])
            except Overflow:  # libjpeg warns and decodes nothing more until the next restart
                stopped = True
        if ar.past_end:
            raise ValueError("corrupt JPEG data: the data ends inside a scan (truncated)")
    p = _next_marker(d, ar.marker if ar.at_marker else ar.pos)
    if p < 0:
        raise ValueError("corrupt JPEG data: the data ends inside a scan (truncated)")
    return p


# --------------------------------------------------------------------------- #
# lossless frames: differences and their prediction undone
# --------------------------------------------------------------------------- #


def _check_lossless(data, scan, comps, planes, tables):
    buf = np.frombuffer(data, np.uint8)
    scan = np.ascontiguousarray(scan, np.int32)
    comps = np.ascontiguousarray(comps, np.int32)
    tables = np.ascontiguousarray(tables, np.uint8)
    ns = int(scan[0]) if scan.shape == (9,) else -1
    if ns < 1 or comps.shape != (ns, 8) or tables.shape != (8, 272) or len(planes) != ns:
        raise ValueError(f"scan {scan.shape}, components {comps.shape}, tables {tables.shape}, {len(planes)} planes")
    if not (1 <= scan[1] <= 7 and 0 <= scan[4] < scan[8] <= 16):
        raise ValueError(f"predictor {scan[1]}, point transform {scan[4]}, precision {scan[8]}")
    for (h, v, stride, bw, bh, dc, _, _), pl in zip(comps, planes):
        rows = scan[7] * v if ns > 1 else bh
        cols = scan[6] * h if ns > 1 else bw
        if pl.dtype != np.int32 or not pl.flags.c_contiguous or pl.ndim != 2 or pl.shape[1] != stride:
            raise ValueError(f"plane {pl.dtype} {pl.shape}, expected int32 [rows, {stride}]")
        if pl.shape[0] < rows or stride < cols or not 0 <= dc < 4:
            raise ValueError(f"plane {pl.shape} for {rows} x {cols} samples, table {dc}")
    return buf, scan, comps, tables


def decode_scan_lossless(data, start: int, scan, comps, planes: Sequence[np.ndarray], tables) -> int:
    """Entropy-decode a lossless scan and undo its prediction into
    `planes` (int32 [rows, stride] a component, the samples before the
    point transform is undone). scan: [components, predictor, 0, 0, point
    transform, restart interval, MCUs across, MCUs down, precision]; comps
    [n, 8]: [h, v, stride, samples across and down coded alone, DC table,
    0, 0]. Returns where the next marker starts; a corrupt or truncated
    scan raises ValueError."""
    buf, scan, comps, tables = _check_lossless(data, scan, comps, planes, tables)
    ptrs = (ctypes.c_void_p * len(planes))(*[_ptr(p) for p in planes])
    end = ctypes.c_int64(0)
    err = ctypes.create_string_buffer(256)
    if load().jpeg_decode_scan_lossless(_ptr(buf), buf.size, start, _ptr(scan), _ptr(comps), ptrs, _ptr(tables),
                                        ctypes.byref(end), err, len(err)):
        raise ValueError(f"corrupt JPEG data: {err.value.decode()}")
    return int(end.value)


def decode_scan_lossless_plain(data, start: int, scan, comps, planes: Sequence[np.ndarray], tables) -> int:
    """The plain version of `decode_scan_lossless`, in Python."""
    _, scan, comps, tables = _check_lossless(data, scan, comps, planes, tables)
    ns, predictor, _, _, pt, interval, mcus_x, mcus_y, precision = (int(x) for x in scan)
    d = bytes(data)
    looks = [_lookup16(tables[int(c[5])].tobytes()) for c in comps]
    one = ns == 1
    per_row, rows = (int(comps[0][3]), int(comps[0][4])) if one else (mcus_x, mcus_y)
    if interval and interval % per_row:
        raise ValueError("corrupt JPEG data: a restart interval that is not a whole number of MCU rows")
    br = _PlainBits(d, start)

    def fail(msg):
        raise ValueError(f"corrupt JPEG data: {msg}")

    def ends_cleanly():
        br.fill()
        return br.at_marker and br.bits - br.phantom < 8

    rst = 0
    for m in range(rows * per_row):
        if interval and m and m % interval == 0:
            if not ends_cleanly():
                fail("data past the end of a restart interval")
            p = br.marker
            while p < len(d) and d[p] == 0xFF:
                p += 1
            if p >= len(d):
                fail("the data ends inside a scan (truncated)")
            if d[p] != 0xD0 + (rst & 7):
                fail("a missing or misnumbered restart marker")
            rst += 1
            br.restart(p + 1)
        my, mx = divmod(m, per_row)
        for i, c in enumerate(comps):
            h, v = (1, 1) if one else (int(c[0]), int(c[1]))
            for y in range(v):
                for x in range(h):
                    t = br.decode(looks[i])
                    if t < 0 or t > 16:
                        fail("a bad Huffman code in a sample difference")
                    planes[i][my * v + y, mx * h + x] = 32768 if t == 16 else _extend(br.get(t), t)
        if br.bits < br.phantom:
            fail("the data ends inside a scan (truncated)" if br.marker >= len(d)
                 else "a scan's data ends before its last sample")
    if not ends_cleanly():
        fail("data past the end of a scan")
    initial = 1 << (precision - pt - 1)
    reset = interval // per_row if interval else rows
    for i, c in enumerate(comps):
        v = 1 if one else int(c[1])
        width = int(c[3]) if one else mcus_x * int(c[0])
        pl = planes[i]
        for r in range(rows * v):
            row = pl[r]
            if r % (reset * v) == 0:
                ra = initial
                for x in range(width):
                    ra = (int(row[x]) + ra) & 0xFFFF
                    row[x] = ra
                continue
            up = pl[r - 1]
            rb = int(up[0])
            ra = (int(row[0]) + rb) & 0xFFFF
            row[0] = ra
            for x in range(1, width):
                rc, rb = rb, int(up[x])
                pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                        7: (ra + rb) >> 1}[predictor]
                ra = (int(row[x]) + pred) & 0xFFFF
                row[x] = ra
    return br.marker


# --------------------------------------------------------------------------- #
# inverse DCT
# --------------------------------------------------------------------------- #


def _check_idct(coef: np.ndarray, qt) -> tuple:
    coef = np.ascontiguousarray(coef, np.int16)
    qt = np.ascontiguousarray(qt, np.uint16)
    if coef.ndim != 3 or coef.shape[2] != 64 or qt.shape != (64,):
        raise ValueError(f"coefficients {coef.shape}, quantization table {qt.shape}")
    return coef, qt


def idct(coef: np.ndarray, qt, method: int) -> np.ndarray:
    """int16 [rows, cols, 64] coefficients (natural order) and a natural-order
    quantization table -> the uint8 plane [rows * 8, cols * 8]; method IFAST
    (jidctfst.c) or ISLOW (jidctint.c)."""
    coef, qt = _check_idct(coef, qt)
    rows, cols, _ = coef.shape
    out = np.empty((rows * 8, cols * 8), np.uint8)
    if coef.size:
        load().jpeg_idct(_ptr(coef), rows, cols, _ptr(qt), int(method), _ptr(out))
    return out


def _limit(x: np.ndarray) -> np.ndarray:
    """libjpeg's post-IDCT range limit: the low 10 bits as signed, + 128,
    clamped to 0..255."""
    return np.clip(((x & 1023) ^ 512) - 512 + 128, 0, 255).astype(np.uint8)


def _ifast_1d(x, mul):
    """One pass of jidctfst.c over axis -2 (the 8 samples) of int64 x."""
    t0, t1, t2, t3 = x[..., 0, :], x[..., 2, :], x[..., 4, :], x[..., 6, :]
    t10, t11, t13 = t0 + t2, t0 - t2, t1 + t3
    t12 = mul(t1 - t3, 362) - t13
    e0, e3, e1, e2 = t10 + t13, t10 - t13, t11 + t12, t11 - t12
    t4, t5, t6, t7 = x[..., 1, :], x[..., 3, :], x[..., 5, :], x[..., 7, :]
    z13, z10, z11, z12 = t6 + t5, t6 - t5, t4 + t7, t4 - t7
    o7 = z11 + z13
    o11 = mul(z11 - z13, 362)
    z5 = mul(z10 + z12, 473)
    o10 = mul(z12, 277) - z5
    o12 = mul(z10, -669) + z5
    o6 = o12 - o7
    o5 = o11 - o6
    o4 = o10 + o5
    return np.stack([e0 + o7, e1 + o6, e2 + o5, e3 - o4, e3 + o4, e2 - o5, e1 - o6, e0 - o7], axis=-2)


def _islow_1d(x):
    """One pass of jidctint.c over axis -2 (the 8 samples) of int64 x,
    before its descale."""
    z2, z3 = x[..., 2, :], x[..., 6, :]
    z1 = (z2 + z3) * 4433
    e2, e3 = z1 + z3 * -15137, z1 + z2 * 6270
    e0, e1 = (x[..., 0, :] + x[..., 4, :]) * 8192, (x[..., 0, :] - x[..., 4, :]) * 8192
    t10, t13, t11, t12 = e0 + e3, e0 - e3, e1 + e2, e1 - e2
    t0, t1, t2, t3 = x[..., 7, :], x[..., 5, :], x[..., 3, :], x[..., 1, :]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    y1, y2, y3, y4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
    o0, o1, o2, o3 = t0 * 2446 + y1 + y3, t1 * 16819 + y2 + y4, t2 * 25172 + y2 + y3, t3 * 12299 + y1 + y4
    return np.stack([t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3], axis=-2)


def idct_plain(coef: np.ndarray, qt, method: int) -> np.ndarray:
    """The plain version of `idct`, in numpy (int64, each block at once)."""
    coef, qt = _check_idct(coef, qt)
    rows, cols, _ = coef.shape
    x = coef.astype(np.int64).reshape(rows, cols, 8, 8)
    q = qt.astype(np.int64).reshape(8, 8)
    if method == IFAST:
        mult = ((q.reshape(64) * AAN_SCALES + (1 << 11)) >> 12).reshape(8, 8)

        def mul(v, c):
            return (v * c) >> 8

        ws = _ifast_1d(x * mult, mul)  # columns: axis -2 is the row index
        px = np.swapaxes(_ifast_1d(np.swapaxes(ws, -1, -2), mul), -1, -2) >> 5
    else:
        ws = (_islow_1d(x * q) + (1 << 10)) >> 11
        px = (np.swapaxes(_islow_1d(np.swapaxes(ws, -1, -2)), -1, -2) + (1 << 17)) >> 18
    return np.ascontiguousarray(_limit(px).transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8))


# --------------------------------------------------------------------------- #
# upsampling and colour conversion
# --------------------------------------------------------------------------- #


def _check_plane(plane: np.ndarray, cw: int, ch: int, hf: int, vf: int, out_w: int, out_h: int) -> np.ndarray:
    plane = np.ascontiguousarray(plane, np.uint8)
    if not (1 <= hf <= 4 and 1 <= vf <= 4):
        raise ValueError(f"upsampling by {hf} x {vf}")
    if plane.ndim != 2 or plane.shape[0] < ch or plane.shape[1] < cw or cw < 1 or ch < 1:
        raise ValueError(f"plane {plane.shape} for {cw} x {ch} samples")
    if not (0 < out_w <= cw * hf and 0 < out_h <= ch * vf):
        raise ValueError(f"an output of {out_w} x {out_h} from {cw} x {ch} by {hf} x {vf}")
    return plane


def upsample(plane: np.ndarray, cw: int, ch: int, hf: int, vf: int, out_w: int, out_h: int) -> np.ndarray:
    """A component plane whose real samples are cw x ch -> uint8 [out_h,
    out_w], upsampled by hf x vf as libjpeg-turbo's fancy upsampling does
    (the triangle filter for h2v1, h2v2 and h1v2, each sample repeated for
    any other ratio)."""
    plane = _check_plane(plane, cw, ch, hf, vf, out_w, out_h)
    out = np.empty((out_h, out_w), np.uint8)
    load().jpeg_upsample(_ptr(plane), plane.shape[1], cw, ch, hf, vf, _ptr(out), out_w, out_h)
    return out


def upsample_plain(plane: np.ndarray, cw: int, ch: int, hf: int, vf: int, out_w: int, out_h: int) -> np.ndarray:
    """The plain version of `upsample`, in numpy."""
    p = _check_plane(plane, cw, ch, hf, vf, out_w, out_h)[:ch, :cw].astype(np.int32)
    fancy_h = hf == 2 and vf <= 2 and cw > 2
    fancy_v = vf == 2 and (hf == 1 or (hf == 2 and cw > 2))
    r = np.arange(out_h)
    rows = p[np.minimum(r // vf, ch - 1)]
    if fancy_v:
        nb = p[np.clip(np.where(r % 2 == 1, r // 2 + 1, r // 2 - 1), 0, ch - 1)]
        sums = 3 * rows + nb  # the column sums of h2v2, the rows of h1v2
        if hf == 1:
            return ((sums + np.where(r % 2 == 1, 2, 1)[:, None]) >> 2).astype(np.uint8)[:, :out_w]
        left = np.concatenate([sums[:, :1], sums[:, :-1]], axis=1)
        right = np.concatenate([sums[:, 1:], sums[:, -1:]], axis=1)
        even, odd = (3 * sums + left + 8) >> 4, (3 * sums + right + 7) >> 4  # the edges: left = right = sums
        out = np.stack([even, odd], axis=-1).reshape(out_h, 2 * cw)
        return out[:, :out_w].astype(np.uint8)
    if not fancy_h:
        return rows[:, np.arange(out_w) // hf].astype(np.uint8)
    left = np.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
    right = np.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
    even, odd = (3 * rows + left + 1) >> 2, (3 * rows + right + 2) >> 2  # the edges give the sample itself
    return np.stack([even, odd], axis=-1).reshape(out_h, 2 * cw)[:, :out_w].astype(np.uint8)


def _check_ycc(y, cb, cr):
    y, cb, cr = (np.ascontiguousarray(a, np.uint8) for a in (y, cb, cr))
    if not (y.shape == cb.shape == cr.shape):
        raise ValueError(f"planes {y.shape}, {cb.shape}, {cr.shape}")
    return y, cb, cr


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Three uint8 planes [H, W] -> uint8 [H, W, 3], jdcolor.c's conversion."""
    y, cb, cr = _check_ycc(y, cb, cr)
    out = np.empty(y.shape + (3,), np.uint8)
    load().jpeg_ycc_to_rgb(_ptr(y), _ptr(cb), _ptr(cr), y.size, _ptr(out))
    return out


def ycc_to_rgb_plain(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """The plain version of `ycc_to_rgb`, in numpy."""
    y, cb, cr = (a.astype(np.int64) for a in _check_ycc(y, cb, cr))
    xb, xr = cb - 128, cr - 128
    r = y + ((91881 * xr + 32768) >> 16)
    g = y + ((-22554 * xb + 32768 - 46802 * xr) >> 16)
    b = y + ((116130 * xb + 32768) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


NATIVE = SimpleNamespace(decode_scan=decode_scan, decode_scan_arith=decode_scan_arith,
                         decode_scan_lossless=decode_scan_lossless, idct=idct, upsample=upsample, ycc_to_rgb=ycc_to_rgb)
PLAIN = SimpleNamespace(decode_scan=decode_scan_plain, decode_scan_arith=decode_scan_arith_plain,
                        decode_scan_lossless=decode_scan_lossless_plain, idct=idct_plain, upsample=upsample_plain,
                        ycc_to_rgb=ycc_to_rgb_plain)
