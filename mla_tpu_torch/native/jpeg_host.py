"""ctypes wrapper of the JPEG decoder's host loops, with their plain versions.

`csrc/jpeg_host.cpp` holds the loops of `vla/rlds/jpeg.py` that are too
slow in Python: the entropy decoding of a scan, the two inverse DCTs, the
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
    if (hf, vf) not in ((1, 1), (2, 1), (1, 2), (2, 2)):
        raise ValueError(f"upsampling by {hf} x {vf}")
    if plane.ndim != 2 or plane.shape[0] < ch or plane.shape[1] < cw or cw < 1 or ch < 1:
        raise ValueError(f"plane {plane.shape} for {cw} x {ch} samples")
    if not (0 < out_w <= cw * hf and 0 < out_h <= ch * vf):
        raise ValueError(f"an output of {out_w} x {out_h} from {cw} x {ch} by {hf} x {vf}")
    return plane


def upsample(plane: np.ndarray, cw: int, ch: int, hf: int, vf: int, out_w: int, out_h: int) -> np.ndarray:
    """A component plane whose real samples are cw x ch -> uint8 [out_h,
    out_w], upsampled by hf x vf as libjpeg-turbo's fancy upsampling does."""
    plane = _check_plane(plane, cw, ch, hf, vf, out_w, out_h)
    out = np.empty((out_h, out_w), np.uint8)
    load().jpeg_upsample(_ptr(plane), plane.shape[1], cw, ch, hf, vf, _ptr(out), out_w, out_h)
    return out


def upsample_plain(plane: np.ndarray, cw: int, ch: int, hf: int, vf: int, out_w: int, out_h: int) -> np.ndarray:
    """The plain version of `upsample`, in numpy."""
    p = _check_plane(plane, cw, ch, hf, vf, out_w, out_h)[:ch, :cw].astype(np.int32)
    fancy_h = hf == 2 and cw > 2
    fancy_v = vf == 2 and (hf == 1 or cw > 2)
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


NATIVE = SimpleNamespace(decode_scan=decode_scan, idct=idct, upsample=upsample, ycc_to_rgb=ycc_to_rgb)
PLAIN = SimpleNamespace(decode_scan=decode_scan_plain, idct=idct_plain, upsample=upsample_plain,
                        ycc_to_rgb=ycc_to_rgb_plain)
