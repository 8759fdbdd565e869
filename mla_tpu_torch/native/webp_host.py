"""The WebP decoder's loops, in C++ (`csrc/webp_host.cpp`) and in plain Python.

`vla/rlds/webp.py` reads the RIFF container; the two bitstreams are
decoded here, the way libwebp (which TensorFlow and Pillow share) decodes
them:

- VP8L, the lossless format: the LSB-first bit reader, canonical Huffman
  codes (simple and normal, code-length codes, meta codes by tile), LZ77
  copies with the 120 short plane distances, the colour cache, and the four
  inverse transforms (predictor with its 14 modes, cross colour, subtract
  green, colour indexing with pixel bundling) -> ARGB.
- VP8, the lossy format: the boolean decoder (libwebp's, bit for bit), the
  frame header (segments, filter header, partitions, quantizer indices,
  coefficient probability updates, the skip probability), intra modes (the
  16 x 16, 4 x 4 and chroma predictors with libwebp's edge samples), the
  DCT tokens, the inverse WHT and DCT, the simple and the normal loop
  filter, then libwebp's "fancy" upsampling of the chroma and its
  fixed-point YUV -> RGB.

`NATIVE` runs the C++ library (built at first use by `native/build.py`; a
failed build raises), `PLAIN` the Python versions, which the tests hold to
it and both to TensorFlow's and Pillow's pixels. A corrupt or truncated
bitstream raises ValueError. The probability and quantizer tables are
those of RFC 6386 (sections 9.6, 13.4, 13.5, 14.1 and 11.5); the plane
codes those of the WebP lossless specification (section 4.2.2).
"""

from __future__ import annotations

import ctypes
import threading
from types import SimpleNamespace
from typing import List, Optional, Tuple

import numpy as np

from mla_tpu_torch.native.build import CSRC, load_library

SRC = CSRC / "webp_host.cpp"


def _table(*rows: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex("".join(rows)), np.uint8).copy()


# RFC 6386 section 14.1: the quantizer step of each index
DC_TABLE = _table(
    "0405060708090a0a0b0c0d0e0f101111121314141515161617171819191a1b1c1d1e1f20212223242525262728292a2b2c2d2e2e2f30"
    "3132333435363738393a3b3c3d3e3f404142434445464748494a4b4c4c4d4e4f505152535455565758595b5d5f6062646566686a6c6e"
    "707274767a7c7e80828486888a8c8f9194979a9d")
# section 13.4: the probability that each coefficient probability is updated
COEFFS_UPDATE_PROBA = _table(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffffdff1fcffffffffffffff"
    "fff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefefffffffffffffffffdfffffffffffffffffffffff6feffffffffffff"
    "ffffeffdfefffffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffbfffeffffffffffffffffffffffffffffffff"
    "fffffffffdfefffffffffffffffffbfefefffffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffff"
    "fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffd9ffffffffff"
    "ffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffeefdfefeff"
    "fffffffffffffff8fefffffffffffffffff9fefffffffffffffffffffffffffffffffffffffffffffdfffffffffffffffffff7feffff"
    "fffffffffffffffffffffffffffffffffffffffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefe"
    "fffffffffffffffffdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffafffffffffffffffffffffeff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffbafbfaffffffffffffffffea"
    "fbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfefffffffffffffffffbfdfdfefeffffffffffff"
    "fffefefffffffffffffffffefefefffffffffffffffffffffffffffffffffffffffffefffffffffffffffffffefeffffffffffffffff"
    "fffefffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff8fffffffffffffffffffffafefcfeffffff"
    "fffffffff8fef9fdfffffffffffffffffdfdfffffffffffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff"
    "fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfefffffffffffffffff5fbfefffffffffffffffffdfdfeffff"
    "fffffffffffffffbfdfffffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcfffffffffffffffffff9fffeff"
    "fffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")
# section 11.5: the 4 x 4 intra mode probabilities by the modes above and left
BMODES_PROBA = _table(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150aad791850c31a3e2c4055"
    "90470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d102486b7598962656aa59448bb64829d6f204b50"
    "4266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380684f0c1bd9ff5711075744472c72330fba17"
    "2f290e6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d"
    "271c55ab3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e5f5539323033"
    "c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d1"
    "6450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd333211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb3"
    "3f3b5ab43ba65d499a282815748fd12227af2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd"
    "2803097333c01206df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a2086"
    "271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd2d25c03726467c4966012262"
    "7d622a58685575af525f543559806471652d4b4f7b2f338051ab0139110547663935293126210d7939491a0155290a438a4d6e5a2f72"
    "7315020a66ffa61706651d100a558065c41a39120a6666d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25"
    "442d8022012f0bf5ab3e1113469255373e46252b259a64a355a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f801"
    "3808118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d1"
    "2d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab120b073f90ab0404f6231b0a92aeab0c1a80"
    "be502363b4507e362d557e2f57b033291420654b808b769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc380300418")
# section 13.5: the default coefficient probabilities [4 types][8 bands][3 contexts][11]
COEFFS_PROBA0 = _table(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080bd81f2ffe3d5ffdb8080"
    "806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb80808001b9f9fff3ff808080"
    "8080b896f7ffece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff"
    "80808001ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae180"
    "808080805081d3ffc2e080808080800101ff8080808080808080f601ff8080808080808080ff80808080808080808080c623eddfc1bb"
    "a2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0"
    "bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ff"
    "e7f5ffff8080802c82c9fdcdc0ffff8080800184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9"
    "ffe8eb80808080807c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff8080802d63"
    "bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af"
    "0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff808080"
    "0118effbdadbffcd808080c933dbffc4ba8080808080452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080"
    "808d7cf8ffff8080808080800110f8ffff808080808080be24e6ffecff80808080809501ff808080808080808001e2ff808080808080"
    "8080f7c0ff8080808080808080f080ff80808080808080800186fcffff808080808080d53efaffff808080808080375dff8080808080"
    "808080808080808080808080808080808080808080808080808080808080808080808080ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4"
    "aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff79fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7"
    "f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7"
    "c2fedfffff800151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080a8aff6fc"
    "ebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caffdb8080802a50a0f0a2b9ffcd8080800101ff"
    "8080808080808080f401ff8080808080808080ee01ff8080808080808080")
# WebP lossless section 4.2.2: distance codes 1..120 as (dy << 4) | (8 - dx)
CODE_TO_PLANE = _table(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a242c58454b343c035759131d565a232d444c555b333d"
    "68026769121e666a222e545c434d656b323e78017779535d111f646c424e767a212f757b313f636d525e00747c414f1020626e30737d"
    "515f40727e616f50717f6070")
AC_TABLE = np.array([
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60,
    62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112,
    114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177,
    181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274,
    279, 284], np.int32)
ZIGZAG = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15], np.int32)
BANDS = np.array([0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0], np.int32)
CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
           (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# the 4 x 4 intra mode tree: a leaf is -mode
YMODES_INTRA4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)


# --------------------------------------------------------------------------- #
# VP8L, plain
# --------------------------------------------------------------------------- #

VP8L_SIGNATURE = 0x2F
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_ALPHABETS = (256 + 24, 256, 256, 256, 40)  # green (+ cache), red, blue, alpha, distance


def _corrupt(fmt: str, msg: str) -> ValueError:
    return ValueError(f"corrupt WebP data ({fmt}): {msg}")


class _LBits:
    """VP8L's bit reader: bits least significant first; reading past the
    data raises."""

    def __init__(self, data: bytes) -> None:
        self.v = int.from_bytes(data, "little")
        self.n = len(data) * 8
        self.pos = 0

    def read(self, k: int) -> int:
        if self.pos + k > self.n:
            raise _corrupt("VP8L", "the data ends inside the image (truncated)")
        out = (self.v >> self.pos) & ((1 << k) - 1)
        self.pos += k
        return out

    def peek(self, k: int) -> int:
        return (self.v >> self.pos) & ((1 << k) - 1)


class _Huffman:
    """A canonical code as a lookup of the next max-length bits (read least
    significant first, so each code reversed); one symbol is a code of no
    bits."""

    def __init__(self, lengths: List[int]) -> None:
        used = [(l, s) for s, l in enumerate(lengths) if l]
        if not used:
            raise _corrupt("VP8L", "a Huffman code without symbols")
        if len(used) == 1:
            self.bits, self.table = 0, [(used[0][1], 0)]
            return
        self.bits = max(l for l, _ in used)
        table: List[Optional[Tuple[int, int]]] = [None] * (1 << self.bits)
        code = 0
        for length in range(1, self.bits + 1):
            for l, sym in sorted(used):
                if l != length:
                    continue
                rev = int(format(code, f"0{length}b")[::-1], 2)
                for hi in range(1 << (self.bits - length)):
                    table[rev | (hi << length)] = (sym, length)
                code += 1
            code <<= 1
        if code != 1 << (self.bits + 1) or any(t is None for t in table):
            raise _corrupt("VP8L", "an incomplete or over-full Huffman code")
        self.table = table

    def read(self, br: _LBits) -> int:
        if not self.bits:
            return self.table[0][0]
        sym, length = self.table[br.peek(self.bits)]
        br.read(length)
        return sym


def _read_code(br: _LBits, alphabet: int) -> _Huffman:
    lengths = [0] * alphabet
    if br.read(1):  # simple: one or two symbols
        n = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        lengths[first] = 1
        if n == 2:
            second = br.read(8)
            if second >= alphabet:
                raise _corrupt("VP8L", "a simple code's symbol past its alphabet")
            lengths[second] = 1
        if first >= alphabet:
            raise _corrupt("VP8L", "a simple code's symbol past its alphabet")
        return _Huffman(lengths)
    ncl = br.read(4) + 4
    cl = [0] * 19
    for i in range(ncl):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    lc = _Huffman(cl)
    if br.read(1):
        nbits = 2 + 2 * br.read(3)
        max_symbol = 2 + br.read(nbits)
        if max_symbol > alphabet:
            raise _corrupt("VP8L", "a code-length count past the alphabet")
    else:
        max_symbol = alphabet
    sym, prev = 0, 8
    while sym < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = lc.read(br)
        if c < 16:
            lengths[sym] = c
            sym += 1
            if c:
                prev = c
            continue
        extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
        rep = br.read(extra) + offset
        if sym + rep > alphabet:
            raise _corrupt("VP8L", "a code-length run past the alphabet")
        lengths[sym:sym + rep] = [prev if c == 16 else 0] * rep
        sym += rep
    return _Huffman(lengths)


def _copy_distance(sym: int, br: _LBits) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _plane_distance(xsize: int, code: int) -> int:
    if code > 120:
        return code - 120
    d = int(CODE_TO_PLANE[code - 1])
    dist = (d >> 4) * xsize + 8 - (d & 15)
    return dist if dist >= 1 else 1


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _decode_stream(br: _LBits, xsize: int, ysize: int, level0: bool) -> List[int]:
    """One entropy-coded image of xsize x ysize ARGB words (the main image
    with level0, else a transform's or meta codes' sub-image)."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise _corrupt("VP8L", f"a colour cache of {cache_bits} bits")
    meta_bits, meta = 0, None
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        mw = _subsample(xsize, meta_bits)
        meta = [(p >> 8) & 0xFFFF for p in _decode_stream(br, mw, _subsample(ysize, meta_bits), False)]
        ngroups = max(meta) + 1
    else:
        ngroups = 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = [[_read_code(br, a + (cache_size if i == 0 else 0)) for i, a in enumerate(_ALPHABETS)]
              for _ in range(ngroups)]
    cache = [0] * cache_size
    shift = 32 - cache_bits
    out = [0] * (xsize * ysize)
    n, pos, cached = len(out), 0, 0
    mask = (1 << meta_bits) - 1 if meta is not None else -1
    group = groups[0]
    while pos < n:
        y, x = divmod(pos, xsize)
        if meta is not None and (x & mask) == 0:
            group = groups[meta[(y >> meta_bits) * _subsample(xsize, meta_bits) + (x >> meta_bits)]]
        code = group[0].read(br)
        if code < 256:
            r, b, a = group[1].read(br), group[2].read(br), group[3].read(br)
            out[pos] = (a << 24) | (r << 16) | (code << 8) | b
            pos += 1
        elif code < 256 + 24:
            length = _copy_distance(code - 256, br)
            dist = _plane_distance(xsize, _copy_distance(group[4].read(br), br))
            if dist > pos or pos + length > n:
                raise _corrupt("VP8L", "a backward reference outside the image")
            for i in range(length):
                out[pos + i] = out[pos + i - dist]
            pos += length
            if meta is not None and length:  # the group of the pixel the copy ends before
                y, x = divmod(pos, xsize)
                if pos < n:
                    group = groups[meta[(y >> meta_bits) * _subsample(xsize, meta_bits) + (x >> meta_bits)]]
        else:
            key = code - 280
            if key >= cache_size:
                raise _corrupt("VP8L", "a colour cache code past the cache")
            while cached < pos:
                v = out[cached]
                cache[((v * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = v
                cached += 1
            out[pos] = cache[key]
            pos += 1
        if cache_size:
            while cached < pos:
                v = out[cached]
                cache[((v * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = v
                cached += 1
    return out


def _avg2(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _clip255(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _channels(p: int) -> Tuple[int, int, int, int]:
    return p >> 24, (p >> 16) & 255, (p >> 8) & 255, p & 255


def _pack(c) -> int:
    return (c[0] << 24) | (c[1] << 16) | (c[2] << 8) | c[3]


def _select(t: int, l: int, tl: int) -> int:
    diff = sum(abs(lc - tlc) - abs(tc - tlc) for tc, lc, tlc in zip(_channels(t), _channels(l), _channels(tl)))
    return t if diff <= 0 else l


def _predict(mode: int, left: int, top: int, tr: int, tl: int) -> int:
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _avg2(_avg2(left, tr), top)
    if mode == 6:
        return _avg2(left, tl)
    if mode == 7:
        return _avg2(left, top)
    if mode == 8:
        return _avg2(tl, top)
    if mode == 9:
        return _avg2(top, tr)
    if mode == 10:
        return _avg2(_avg2(left, tl), _avg2(top, tr))
    if mode == 11:
        return _select(top, left, tl)
    if mode == 12:
        return _pack([_clip255(a + b - c) for a, b, c in zip(_channels(left), _channels(top), _channels(tl))])
    if mode == 13:
        avg = _avg2(left, top)
        return _pack([_clip255(a + int((a - c) / 2)) for a, c in zip(_channels(avg), _channels(tl))])
    return 0xFF000000  # 0, and the unused 14 and 15


def _add(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _delta(t: int, c: int) -> int:
    """((int8) t * (int8) c) >> 5"""
    return (((t ^ 128) - 128) * ((c ^ 128) - 128)) >> 5


def _inverse(kind: int, bits: int, sub: List[int], px: List[int], xsize: int, ysize: int) -> List[int]:
    """One inverse transform of the ARGB words `px` (xsize wide, or packed
    for colour indexing) -> the words it was made from."""
    if kind == 2:  # subtract green
        out = []
        for p in px:
            g = (p >> 8) & 255
            out.append((p & 0xFF00FF00) | ((((p >> 16) + g) & 255) << 16) | ((p + g) & 255))
        return out
    sw = _subsample(xsize, bits)
    if kind == 0:  # predictor
        out = list(px)
        for y in range(ysize):
            row = y * xsize
            for x in range(xsize):
                i = row + x
                if y == 0:
                    pred = 0xFF000000 if x == 0 else out[i - 1]
                elif x == 0:
                    pred = out[i - xsize]
                else:
                    mode = (sub[(y >> bits) * sw + (x >> bits)] >> 8) & 15
                    # the top-right of the last column is this row's first pixel, as the rows lie in memory
                    pred = _predict(mode, out[i - 1], out[i - xsize], out[i - xsize + 1], out[i - xsize - 1])
                out[i] = _add(out[i], pred)
        return out
    if kind == 1:  # cross colour
        out = []
        for i, p in enumerate(px):
            y, x = divmod(i, xsize)
            m = sub[(y >> bits) * sw + (x >> bits)]
            g2r, g2b, r2b = m & 255, (m >> 8) & 255, (m >> 16) & 255
            g = (p >> 8) & 255
            r = ((p >> 16) + _delta(g2r, g)) & 255
            b = (p + _delta(g2b, g) + _delta(r2b, r)) & 255
            out.append((p & 0xFF00FF00) | (r << 16) | b)
        return out
    # colour indexing: `sub` is the palette, `bits` the pixels a packed word holds (as a shift)
    pal = list(sub) + [0] * (256 - len(sub))
    if bits == 0:
        return [pal[(p >> 8) & 255] for p in px]
    per, width_bits = 1 << bits, 8 >> bits
    pw = _subsample(xsize, bits)
    out = []
    for y in range(ysize):
        for x in range(xsize):
            packed = (px[y * pw + (x >> bits)] >> 8) & 255
            out.append(pal[(packed >> (width_bits * (x & (per - 1)))) & ((1 << width_bits) - 1)])
    return out


def vp8l_header(data: bytes) -> Tuple[int, int, bool]:
    """(width, height, alpha hint) of a VP8L bitstream."""
    if len(data) < 5 or data[0] != VP8L_SIGNATURE:
        raise _corrupt("VP8L", "a bad signature")
    v = int.from_bytes(data[1:5], "little")
    if v >> 29:
        raise _corrupt("VP8L", f"version {v >> 29}")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, bool((v >> 28) & 1)


def vp8l_decode_plain(data) -> np.ndarray:
    """A VP8L bitstream -> its ARGB words as uint8 [H, W, 4] (A, R, G, B)."""
    data = bytes(data)
    width, height, _ = vp8l_header(data)
    br = _LBits(data)
    br.read(40)
    xsize, transforms, seen = width, [], set()
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise _corrupt("VP8L", f"transform {kind} given twice")
        seen.add(kind)
        if kind in (0, 1):
            bits = br.read(3) + 2
            sub = _decode_stream(br, _subsample(xsize, bits), _subsample(height, bits), False)
            transforms.append((kind, bits, sub, xsize))
        elif kind == 3:
            ncolours = br.read(8) + 1
            bits = 0 if ncolours > 16 else 1 if ncolours > 4 else 2 if ncolours > 2 else 3
            pal = _decode_stream(br, ncolours, 1, False)
            for i in range(1, len(pal)):
                pal[i] = _add(pal[i], pal[i - 1])
            transforms.append((kind, bits, pal, xsize))
            xsize = _subsample(xsize, bits)
        else:
            transforms.append((kind, 0, [], xsize))
    px = _decode_stream(br, xsize, height, True)
    for kind, bits, sub, w in reversed(transforms):
        px = _inverse(kind, bits, sub, px, w, height)
    argb = np.array(px, np.uint32).reshape(height, width)
    return np.stack([(argb >> s) & 255 for s in (24, 16, 8, 0)], -1).astype(np.uint8)


# --------------------------------------------------------------------------- #
# VP8, plain
# --------------------------------------------------------------------------- #

DC_PRED, TM_PRED, V_PRED, H_PRED = 0, 1, 2, 3  # the 16 x 16 and chroma modes; the 4 x 4 ones go on to HU = 9


class _BoolReader:
    """libwebp's boolean decoder: `rng` holds range - 1, `value` the bits
    loaded, `bits` the position of the window in it. Past the data it
    loads one zero byte and sets `eof`."""

    def __init__(self, data: bytes) -> None:
        self.d, self.pos = data, 0
        self.value, self.rng, self.bits, self.eof = 0, 254, -8, False

    def _load(self) -> None:
        if self.pos < len(self.d):
            self.value = (self.value << 8) | self.d[self.pos]
            self.pos += 1
            self.bits += 8
        elif not self.eof:
            self.value <<= 8
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def bit(self, prob: int) -> int:
        rng = self.rng
        if self.bits < 0:
            self._load()
        split = (rng * prob) >> 8
        if (self.value >> self.bits) > split:
            rng -= split
            self.value -= (split + 1) << self.bits
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = 7 ^ (rng.bit_length() - 1)
        self.rng = (rng << shift) - 1
        self.bits -= shift
        return bit

    def signed(self, v: int) -> int:
        if self.bits < 0:
            self._load()
        split = self.rng >> 1
        neg = (self.value >> self.bits) > split
        self.bits -= 1
        if neg:
            self.rng = (self.rng - 1) | 1
            self.value -= (split + 1) << (self.bits + 1)
            return -v
        self.rng |= 1
        return v

    def value_bits(self, n: int) -> int:
        v = 0
        while n > 0:
            n -= 1
            v |= self.bit(0x80) << n
        return v

    def signed_value(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(0x80) else v


def _clip(v: int, m: int) -> int:
    return 0 if v < 0 else m if v > m else v


class _Frame:
    """The parsed header of a key frame."""


def _vp8_header(data: bytes) -> Tuple["_Frame", _BoolReader, List[_BoolReader]]:
    if len(data) < 10:
        raise _corrupt("VP8", "a short frame header (truncated)")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    if bits & 1:
        raise _corrupt("VP8", "not a key frame")
    if ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1:
        raise _corrupt("VP8", "bad key frame parameters")
    part0 = bits >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise _corrupt("VP8", "a bad start code")
    f = _Frame()
    f.width, f.height = (data[6] | (data[7] << 8)) & 0x3FFF, (data[8] | (data[9] << 8)) & 0x3FFF
    if not f.width or not f.height:
        raise _corrupt("VP8", "a frame of no pixels")
    f.mb_w, f.mb_h = (f.width + 15) >> 4, (f.height + 15) >> 4
    rest = data[10:]
    if part0 > len(rest):
        raise _corrupt("VP8", "a bad partition length (truncated)")
    br = _BoolReader(rest[:part0])
    br.bit(0x80)  # colour space
    br.bit(0x80)  # clamping type
    f.use_segment = br.bit(0x80)
    f.update_map, f.absolute_delta = 0, 1
    f.quantizer, f.filter_strength, f.segment_probs = [0] * 4, [0] * 4, [255] * 3
    if f.use_segment:
        f.update_map = br.bit(0x80)
        if br.bit(0x80):
            f.absolute_delta = br.bit(0x80)
            f.quantizer = [br.signed_value(7) if br.bit(0x80) else 0 for _ in range(4)]
            f.filter_strength = [br.signed_value(6) if br.bit(0x80) else 0 for _ in range(4)]
        if f.update_map:
            f.segment_probs = [br.value_bits(8) if br.bit(0x80) else 255 for _ in range(3)]
    f.simple = br.bit(0x80)
    f.level = br.value_bits(6)
    f.sharpness = br.value_bits(3)
    f.ref_lf_delta, f.mode_lf_delta = [0] * 4, [0] * 4
    f.use_lf_delta = br.bit(0x80)
    if f.use_lf_delta and br.bit(0x80):
        for i in range(4):
            if br.bit(0x80):
                f.ref_lf_delta[i] = br.signed_value(6)
        for i in range(4):
            if br.bit(0x80):
                f.mode_lf_delta[i] = br.signed_value(6)
    f.filter_type = 0 if f.level == 0 else 1 if f.simple else 2
    if br.eof:
        raise _corrupt("VP8", "cannot parse the filter header")
    nparts = 1 << br.value_bits(2)
    sizes_at, start = part0, part0 + 3 * (nparts - 1)
    if start > len(rest):
        raise _corrupt("VP8", "cannot parse the partitions (truncated)")
    parts = []
    for p in range(nparts):
        if p < nparts - 1:
            size = rest[sizes_at + 3 * p] | (rest[sizes_at + 3 * p + 1] << 8) | (rest[sizes_at + 3 * p + 2] << 16)
            size = min(size, len(rest) - start)
        else:
            size = len(rest) - start
        parts.append(_BoolReader(rest[start:start + size]))
        start += size
    if not parts[-1].d:
        raise _corrupt("VP8", "the last partition is empty (truncated)")
    base_q = br.value_bits(7)
    dq = [br.signed_value(4) if br.bit(0x80) else 0 for _ in range(5)]  # y1 dc, y2 dc, y2 ac, uv dc, uv ac
    f.dqm = []
    for i in range(4):
        if f.use_segment:
            q = f.quantizer[i] + (0 if f.absolute_delta else base_q)
        elif i > 0:
            f.dqm.append(f.dqm[0])
            continue
        else:
            q = base_q
        y2_ac = max(8, (int(AC_TABLE[_clip(q + dq[2], 127)]) * 101581) >> 16)
        f.dqm.append(((int(DC_TABLE[_clip(q + dq[0], 127)]), int(AC_TABLE[_clip(q, 127)])),
                      (int(DC_TABLE[_clip(q + dq[1], 127)]) * 2, y2_ac),
                      (int(DC_TABLE[_clip(q + dq[3], 117)]), int(AC_TABLE[_clip(q + dq[4], 127)]))))
    br.bit(0x80)  # refresh the entropy probabilities: a key frame has no later frame
    upd = COEFFS_UPDATE_PROBA.reshape(4, 8, 3, 11)
    f.proba = COEFFS_PROBA0.reshape(4, 8, 3, 11).astype(np.int32)
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if br.bit(int(upd[t, b, c, p])):
                        f.proba[t, b, c, p] = br.value_bits(8)
    f.proba = f.proba.tolist()
    f.use_skip = br.bit(0x80)
    f.skip_p = br.value_bits(8) if f.use_skip else 0
    return f, br, parts


def _large_value(br: _BoolReader, p) -> int:
    if not br.bit(p[3]):
        return 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        return 7 + 2 * br.bit(165) + br.bit(145)
    bit1 = br.bit(p[8])
    cat = 2 * bit1 + br.bit(p[9 + bit1])
    v = 0
    for prob in CAT3456[cat]:
        v += v + br.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: _BoolReader, bands, ctx: int, dq, n: int, out: List[int], base: int) -> int:
    """One block's tokens from position n (GetCoeffs): dequantized into
    out[base + natural index]; returns the index after the last nonzero
    one (16 when the block runs to its end)."""
    p = bands[int(BANDS[n])][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = bands[int(BANDS[n])][0]
        nxt = bands[int(BANDS[n + 1])]
        if not br.bit(p[2]):
            v, p = 1, nxt[1]
        else:
            v, p = _large_value(br, p), nxt[2]
        out[base + int(ZIGZAG[n])] = br.signed(v) * dq[n > 0]
        n += 1
    return 16


def _intra_modes(br: _BoolReader, f, top: List[int]):
    """One macroblock row's segment, skip flag and intra modes."""
    row = []
    left = [DC_PRED] * 4
    for mbx in range(f.mb_w):
        seg = 0
        if f.update_map:
            seg = br.bit(f.segment_probs[1]) if not br.bit(f.segment_probs[0]) else br.bit(f.segment_probs[2]) + 2
        skip = br.bit(f.skip_p) if f.use_skip else 0
        t = top[4 * mbx:4 * mbx + 4]
        is4 = not br.bit(145)
        if not is4:
            ymode = (TM_PRED if br.bit(128) else H_PRED) if br.bit(156) else (V_PRED if br.bit(163) else DC_PRED)
            modes = [ymode]
            t[:] = [ymode] * 4
            left[:] = [ymode] * 4
        else:
            modes = []
            for y in range(4):
                ymode = left[y]
                for x in range(4):
                    prob = BMODES_PROBA[(t[x] * 10 + ymode) * 9:(t[x] * 10 + ymode) * 9 + 9]
                    i = YMODES_INTRA4[br.bit(int(prob[0]))]
                    while i > 0:
                        i = YMODES_INTRA4[2 * i + br.bit(int(prob[i]))]
                    ymode = -i
                    t[x] = ymode
                modes += t
                left[y] = ymode
        top[4 * mbx:4 * mbx + 4] = t
        uv = DC_PRED if not br.bit(142) else V_PRED if not br.bit(114) else TM_PRED if br.bit(183) else H_PRED
        row.append((seg, skip, is4, modes, uv))
    if br.eof:
        raise _corrupt("VP8", "the first partition ends before its last macroblock (truncated)")
    return row


def _wht(dc: List[int], out: List[int]) -> None:
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], d - tmp[4 * i + 3]
        for k, v in enumerate((a0 + a1, a3 + a2, a0 - a1, a3 - a2)):
            out[(4 * i + k) * 16] = v >> 3


def _residuals(br: _BoolReader, f, seg: int, is4: bool, nz: dict, mbx: int) -> Tuple[List[int], bool]:
    """ParseResiduals: the macroblock's 24 blocks of dequantized
    coefficients, and whether any is nonzero. `nz` holds the nonzero
    context: top flags per column, left flags of the row."""
    y1, y2, uv = f.dqm[seg]
    bands = f.proba
    out = [0] * 384
    tnz, lnz = nz["top"][mbx], nz["left"]
    any_nz = False
    if not is4:
        dc = [0] * 16
        ctx = tnz["dc"] + lnz["dc"]
        n = _coeffs(br, bands[1], ctx, y2, 0, dc, 0)
        tnz["dc"] = lnz["dc"] = int(n > 0)
        _wht(dc, out)
        first, ac = 1, bands[0]
    else:
        first, ac = 0, bands[3]
    for y in range(4):
        for x in range(4):
            ctx = lnz["y"][y] + tnz["y"][x]
            n = _coeffs(br, ac, ctx, y1, first, out, (4 * y + x) * 16)
            lnz["y"][y] = tnz["y"][x] = int(n > first)
            any_nz = any_nz or n > first or out[(4 * y + x) * 16] != 0
    for ch, key in ((16, "u"), (20, "v")):
        for y in range(2):
            for x in range(2):
                ctx = lnz[key][y] + tnz[key][x]
                n = _coeffs(br, bands[2], ctx, uv, 0, out, (ch + 2 * y + x) * 16)
                lnz[key][y] = tnz[key][x] = int(n > 0)
                any_nz = any_nz or n > 0
    return out, any_nz


def _mul1(a: int) -> int:
    return ((a * 20091) >> 16) + a


def _mul2(a: int) -> int:
    return (a * 35468) >> 16


def _idct_add(c: List[int], base: int, plane, y0: int, x0: int) -> None:
    """The inverse DCT of one 4 x 4 block added to plane[y0:y0+4, x0:x0+4]."""
    tmp = [0] * 16
    for i in range(4):
        a, b = c[base + i] + c[base + 8 + i], c[base + i] - c[base + 8 + i]
        cc = _mul2(c[base + 4 + i]) - _mul1(c[base + 12 + i])
        d = _mul1(c[base + 4 + i]) + _mul2(c[base + 12 + i])
        tmp[4 * i:4 * i + 4] = [a + d, b + cc, b - cc, a - d]
    for i in range(4):
        dc = tmp[i] + 4
        a, b = dc + tmp[8 + i], dc - tmp[8 + i]
        cc = _mul2(tmp[4 + i]) - _mul1(tmp[12 + i])
        d = _mul1(tmp[4 + i]) + _mul2(tmp[12 + i])
        row = plane[y0 + i]
        for x, v in enumerate((a + d, b + cc, b - cc, a - d)):
            row[x0 + x] = _clip(row[x0 + x] + (v >> 3), 255)


def _avg3(a: int, b: int, c: int) -> int:
    return (a + 2 * b + c + 2) >> 2


def _avg2b(a: int, b: int) -> int:
    return (a + b + 1) >> 1


def _pred4(mode: int, top: List[int], left: List[int], x_: int) -> List[List[int]]:
    """A 4 x 4 block's prediction: top = the 8 samples above (with the
    top-right), left = the 4 to the left, x_ the corner."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = x_
    if mode == DC_PRED:
        return [[(sum(top[:4]) + sum(left) + 4) >> 3] * 4 for _ in range(4)]
    if mode == TM_PRED:
        return [[_clip(t + l - X, 255) for t in top[:4]] for l in left]
    if mode == V_PRED:
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return [list(row) for _ in range(4)]
    if mode == H_PRED:
        return [[v] * 4 for v in (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L))]
    o = [[0] * 4 for _ in range(4)]

    def put(v, *xy):
        for x, y in xy:
            o[y][x] = v

    if mode == 4:  # RD
        put(_avg3(J, K, L), (0, 3))
        put(_avg3(I, J, K), (1, 3), (0, 2))
        put(_avg3(X, I, J), (2, 3), (1, 2), (0, 1))
        put(_avg3(A, X, I), (3, 3), (2, 2), (1, 1), (0, 0))
        put(_avg3(B, A, X), (3, 2), (2, 1), (1, 0))
        put(_avg3(C, B, A), (3, 1), (2, 0))
        put(_avg3(D, C, B), (3, 0))
    elif mode == 5:  # VR
        put(_avg2b(X, A), (0, 0), (1, 2))
        put(_avg2b(A, B), (1, 0), (2, 2))
        put(_avg2b(B, C), (2, 0), (3, 2))
        put(_avg2b(C, D), (3, 0))
        put(_avg3(K, J, I), (0, 3))
        put(_avg3(J, I, X), (0, 2))
        put(_avg3(I, X, A), (0, 1), (1, 3))
        put(_avg3(X, A, B), (1, 1), (2, 3))
        put(_avg3(A, B, C), (2, 1), (3, 3))
        put(_avg3(B, C, D), (3, 1))
    elif mode == 6:  # LD
        put(_avg3(A, B, C), (0, 0))
        put(_avg3(B, C, D), (1, 0), (0, 1))
        put(_avg3(C, D, E), (2, 0), (1, 1), (0, 2))
        put(_avg3(D, E, F), (3, 0), (2, 1), (1, 2), (0, 3))
        put(_avg3(E, F, G), (3, 1), (2, 2), (1, 3))
        put(_avg3(F, G, H), (3, 2), (2, 3))
        put(_avg3(G, H, H), (3, 3))
    elif mode == 7:  # VL
        put(_avg2b(A, B), (0, 0))
        put(_avg2b(B, C), (1, 0), (0, 2))
        put(_avg2b(C, D), (2, 0), (1, 2))
        put(_avg2b(D, E), (3, 0), (2, 2))
        put(_avg3(A, B, C), (0, 1))
        put(_avg3(B, C, D), (1, 1), (0, 3))
        put(_avg3(C, D, E), (2, 1), (1, 3))
        put(_avg3(D, E, F), (3, 1), (2, 3))
        put(_avg3(E, F, G), (3, 2))
        put(_avg3(F, G, H), (3, 3))
    elif mode == 8:  # HD
        put(_avg2b(I, X), (0, 0), (2, 1))
        put(_avg2b(J, I), (0, 1), (2, 2))
        put(_avg2b(K, J), (0, 2), (2, 3))
        put(_avg2b(L, K), (0, 3))
        put(_avg3(A, B, C), (3, 0))
        put(_avg3(X, A, B), (2, 0))
        put(_avg3(I, X, A), (1, 0), (3, 1))
        put(_avg3(J, I, X), (1, 1), (3, 2))
        put(_avg3(K, J, I), (1, 2), (3, 3))
        put(_avg3(L, K, J), (1, 3))
    else:  # HU
        put(_avg2b(I, J), (0, 0))
        put(_avg2b(J, K), (2, 0), (0, 1))
        put(_avg2b(K, L), (2, 1), (0, 2))
        put(_avg3(I, J, K), (1, 0))
        put(_avg3(J, K, L), (3, 0), (1, 1))
        put(_avg3(K, L, L), (3, 1), (1, 2))
        put(L, (3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
    return o


def _pred_block(mode: int, plane, y0: int, x0: int, size: int, mbx: int, mby: int) -> None:
    """The 16 x 16 or 8 x 8 prediction of a macroblock, written into the
    padded plane (row 0 and column 0 are the borders)."""
    top = plane[y0 - 1][x0:x0 + size]
    left = [plane[y0 + i][x0 - 1] for i in range(size)]
    corner = plane[y0 - 1][x0 - 1]
    shift = 4 if size == 16 else 3
    if mode == DC_PRED:
        if mbx and mby:
            v = (sum(top) + sum(left) + size) >> (shift + 1)
        elif mbx:
            v = (sum(left) + (size >> 1)) >> shift
        elif mby:
            v = (sum(top) + (size >> 1)) >> shift
        else:
            v = 0x80
        rows = [[v] * size for _ in range(size)]
    elif mode == TM_PRED:
        rows = [[_clip(t + l - corner, 255) for t in top] for l in left]
    elif mode == V_PRED:
        rows = [list(top) for _ in range(size)]
    else:
        rows = [[l] * size for l in left]
    for i in range(size):
        plane[y0 + i][x0:x0 + size] = rows[i]


def _filter_strengths(f) -> List[List[Tuple[int, int, int]]]:
    """(limit, interior limit, hev threshold) by segment and by 4 x 4
    (PrecomputeFilterStrengths); a limit of 0 is no filtering."""
    out = []
    for s in range(4):
        base = f.level
        if f.use_segment:
            base = f.filter_strength[s] + (0 if f.absolute_delta else f.level)
        row = []
        for i4 in (0, 1):
            level = base
            if f.use_lf_delta:
                level += f.ref_lf_delta[0] + (f.mode_lf_delta[0] if i4 else 0)
            level = _clip(level, 63)
            if level > 0:
                ilevel = level
                if f.sharpness > 0:
                    ilevel >>= 2 if f.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - f.sharpness)
                ilevel = max(ilevel, 1)
                row.append((2 * level + ilevel, ilevel, 2 if level >= 40 else 1 if level >= 15 else 0))
            else:
                row.append((0, 0, 0))
        out.append(row)
    return out


def _sclip1(v: int) -> int:
    return -128 if v < -128 else 127 if v > 127 else v


def _sclip2(v: int) -> int:
    return -16 if v < -16 else 15 if v > 15 else v


def _filter_line(px: List[int], pos: int, step: int, thresh2: int, ithresh: int, hev_t: int, kind: int) -> None:
    """One line across an edge at px[pos] (q0), `step` apart. kind 0:
    simple; 4: the normal filter inside a macroblock; 6: on its edge."""
    p1, p0, q0, q1 = px[pos - 2 * step], px[pos - step], px[pos], px[pos + step]
    if 4 * abs(p0 - q0) + abs(p1 - q1) > thresh2:
        return
    if kind:
        p3, p2, q2, q3 = px[pos - 4 * step], px[pos - 3 * step], px[pos + 2 * step], px[pos + 3 * step]
        if max(abs(p3 - p2), abs(p2 - p1), abs(p1 - p0), abs(q3 - q2), abs(q2 - q1), abs(q1 - q0)) > ithresh:
            return
        hev = abs(p1 - p0) > hev_t or abs(q1 - q0) > hev_t
    if not kind or hev:  # DoFilter2
        a = 3 * (q0 - p0) + _sclip1(p1 - q1)
        a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
        px[pos - step], px[pos] = _clip(p0 + a2, 255), _clip(q0 - a1, 255)
    elif kind == 4:
        a = 3 * (q0 - p0)
        a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
        a3 = (a1 + 1) >> 1
        px[pos - 2 * step], px[pos - step] = _clip(p1 + a3, 255), _clip(p0 + a2, 255)
        px[pos], px[pos + step] = _clip(q0 - a1, 255), _clip(q1 - a3, 255)
    else:
        a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        px[pos - 3 * step], px[pos - 2 * step] = _clip(p2 + a3, 255), _clip(p1 + a2, 255)
        px[pos - step], px[pos] = _clip(p0 + a1, 255), _clip(q0 - a1, 255)
        px[pos + step], px[pos + 2 * step] = _clip(q1 - a2, 255), _clip(q2 - a3, 255)


def _filter_edge(px: List[int], stride: int, start: int, along: int, across: int, size: int, thresh: int,
                 ithresh: int, hev_t: int, kind: int) -> None:
    """`size` lines, `along` apart, each across the edge at start (`across`
    between its samples), with libwebp's threshold 2 * thresh + 1."""
    for i in range(size):
        _filter_line(px, start + i * along, across, 2 * thresh + 1, ithresh, hev_t, kind)


def _loop_filter(f, planes, infos) -> None:
    """DoFilter on every macroblock in raster order; planes are flat lists
    (Y, U, V) with their strides."""
    (y, ys), (u, us), (v, vs) = planes
    for mby in range(f.mb_h):
        for mbx in range(f.mb_w):
            limit, ilevel, hev_t, inner = infos[mby][mbx]
            if limit == 0:
                continue
            y0, c0 = mby * 16 * ys + mbx * 16, mby * 8 * us + mbx * 8
            if f.filter_type == 1:
                if mbx > 0:
                    _filter_edge(y, ys, y0, ys, 1, 16, limit + 4, 0, 0, 0)
                if inner:
                    for k in (4, 8, 12):
                        _filter_edge(y, ys, y0 + k, ys, 1, 16, limit, 0, 0, 0)
                if mby > 0:
                    _filter_edge(y, ys, y0, 1, ys, 16, limit + 4, 0, 0, 0)
                if inner:
                    for k in (4, 8, 12):
                        _filter_edge(y, ys, y0 + k * ys, 1, ys, 16, limit, 0, 0, 0)
                continue
            if mbx > 0:
                _filter_edge(y, ys, y0, ys, 1, 16, limit + 4, ilevel, hev_t, 6)
                for c in (u, v):
                    _filter_edge(c, us, c0, us, 1, 8, limit + 4, ilevel, hev_t, 6)
            if inner:
                for k in (4, 8, 12):
                    _filter_edge(y, ys, y0 + k, ys, 1, 16, limit, ilevel, hev_t, 4)
                for c in (u, v):
                    _filter_edge(c, us, c0 + 4, us, 1, 8, limit, ilevel, hev_t, 4)
            if mby > 0:
                _filter_edge(y, ys, y0, 1, ys, 16, limit + 4, ilevel, hev_t, 6)
                for c in (u, v):
                    _filter_edge(c, us, c0, 1, us, 8, limit + 4, ilevel, hev_t, 6)
            if inner:
                for k in (4, 8, 12):
                    _filter_edge(y, ys, y0 + k * ys, 1, ys, 16, limit, ilevel, hev_t, 4)
                for c in (u, v):
                    _filter_edge(c, us, c0 + 4 * us, 1, us, 8, limit, ilevel, hev_t, 4)


def _upsample_pair(top_y, bot_y, top_u, top_v, cur_u, cur_v, width: int, out_top, out_bot) -> None:
    """libwebp's UpsampleRgbLinePair: two luma rows (the second may be
    None) and the chroma rows above and below them -> RGB."""
    def put(out, x, yv, uu, vv):
        out[x] = (_yuv_r(yv, vv), _yuv_g(yv, uu, vv), _yuv_b(yv, uu))

    def pair(tl, l, t, c, x):
        avg = tl + t + l + c + 8
        d12, d03 = (avg + 2 * (t + l)) >> 3, (avg + 2 * (tl + c)) >> 3
        return (d12 + tl) >> 1, (d03 + t) >> 1, (d03 + l) >> 1, (d12 + c) >> 1

    tlu, tlv, lu, lv = top_u[0], top_v[0], cur_u[0], cur_v[0]
    put(out_top, 0, top_y[0], (3 * tlu + lu + 2) >> 2, (3 * tlv + lv + 2) >> 2)
    if bot_y is not None:
        put(out_bot, 0, bot_y[0], (3 * lu + tlu + 2) >> 2, (3 * lv + tlv + 2) >> 2)
    for x in range(1, ((width - 1) >> 1) + 1):
        tu, tv, cu, cv = top_u[x], top_v[x], cur_u[x], cur_v[x]
        u0, u1, u2, u3 = pair(tlu, lu, tu, cu, x)
        v0, v1, v2, v3 = pair(tlv, lv, tv, cv, x)
        put(out_top, 2 * x - 1, top_y[2 * x - 1], u0, v0)
        put(out_top, 2 * x, top_y[2 * x], u1, v1)
        if bot_y is not None:
            put(out_bot, 2 * x - 1, bot_y[2 * x - 1], u2, v2)
            put(out_bot, 2 * x, bot_y[2 * x], u3, v3)
        tlu, tlv, lu, lv = tu, tv, cu, cv
    if not width & 1:
        put(out_top, width - 1, top_y[width - 1], (3 * tlu + lu + 2) >> 2, (3 * tlv + lv + 2) >> 2)
        if bot_y is not None:
            put(out_bot, width - 1, bot_y[width - 1], (3 * lu + tlu + 2) >> 2, (3 * lv + tlv + 2) >> 2)


def _clip8(v: int) -> int:
    return v >> 6 if (v & ~16383) == 0 else (0 if v < 0 else 255)


def _yuv_r(y: int, v: int) -> int:
    return _clip8(((y * 19077) >> 8) + ((v * 26149) >> 8) - 14234)


def _yuv_g(y: int, u: int, v: int) -> int:
    return _clip8(((y * 19077) >> 8) - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)


def _yuv_b(y: int, u: int) -> int:
    return _clip8(((y * 19077) >> 8) + ((u * 33050) >> 8) - 17685)


def fancy_rgb_plain(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Y [H, W] and chroma [(H + 1) / 2, (W + 1) / 2] -> RGB [H, W, 3], as
    libwebp's EmitFancyRGB emits the rows: the first alone, then pairs
    between chroma rows, the last alone when H is even."""
    h, w = y.shape
    Y, U, V = y.tolist(), u.tolist(), v.tolist()
    out = [[None] * w for _ in range(h)]
    _upsample_pair(Y[0], None, U[0], V[0], U[0], V[0], w, out[0], None)
    for k in range(1, (h + 1) // 2 + (0 if h & 1 else 1)):
        top, bot = 2 * k - 1, 2 * k
        if bot < h:
            _upsample_pair(Y[top], Y[bot], U[k - 1], V[k - 1], U[k], V[k], w, out[top], out[bot])
        else:
            _upsample_pair(Y[top], None, U[k - 1], V[k - 1], U[k - 1], V[k - 1], w, out[top], None)
    return np.array(out, np.uint8).reshape(h, w, 3)


def vp8_decode_plain(data) -> np.ndarray:
    """A VP8 key frame -> RGB uint8 [H, W, 3] (libwebp's decode with its
    default fancy upsampling)."""
    f, br, parts = _vp8_header(bytes(data))
    W16, H16 = f.mb_w * 16, f.mb_h * 16
    # padded planes: row 0 and column 0 are the borders (127 above, 129 to the left, the corner 127)
    Y = [[127] * (W16 + 1)] + [[129] + [0] * W16 for _ in range(H16)]
    U = [[127] * (W16 // 2 + 1)] + [[129] + [0] * (W16 // 2) for _ in range(H16 // 2)]
    V = [list(r) for r in U]
    strengths = _filter_strengths(f) if f.filter_type else None
    infos = []
    top_modes = [DC_PRED] * (4 * f.mb_w)
    nz = {"top": [{"y": [0] * 4, "u": [0] * 2, "v": [0] * 2, "dc": 0} for _ in range(f.mb_w)]}
    for mby in range(f.mb_h):
        row = _intra_modes(br, f, top_modes)
        tok = parts[mby & (len(parts) - 1)]
        nz["left"] = {"y": [0] * 4, "u": [0] * 2, "v": [0] * 2, "dc": 0}
        info_row = []
        for mbx, (seg, skip, is4, modes, uvmode) in enumerate(row):
            if not skip:
                coeffs, any_nz = _residuals(tok, f, seg, is4, nz, mbx)
            else:
                coeffs, any_nz = [0] * 384, False
                t, l = nz["top"][mbx], nz["left"]
                for key in ("y", "u", "v"):
                    t[key] = [0] * len(t[key])
                    l[key] = [0] * len(l[key])
                if not is4:
                    t["dc"] = l["dc"] = 0
            if tok.eof:
                raise _corrupt("VP8", "a token partition ends before its last macroblock (truncated)")
            if strengths is not None:
                info_row.append(strengths[seg][is4] + (is4 or any_nz,))
            y0, x0 = 1 + 16 * mby, 1 + 16 * mbx
            if is4:
                if mby == 0:
                    tr = [127] * 4
                elif mbx == f.mb_w - 1:
                    tr = [Y[y0 - 1][x0 + 15]] * 4
                else:
                    tr = Y[y0 - 1][x0 + 16:x0 + 20]
                for n in range(16):
                    by, bx = y0 + 4 * (n >> 2), x0 + 4 * (n & 3)
                    top = Y[by - 1][bx:bx + 4] + (tr if (n & 3) == 3 else Y[by - 1][bx + 4:bx + 8])
                    pred = _pred4(modes[n], top, [Y[by + i][bx - 1] for i in range(4)], Y[by - 1][bx - 1])
                    for i in range(4):
                        Y[by + i][bx:bx + 4] = pred[i]
                    _idct_add(coeffs, 16 * n, Y, by, bx)
            else:
                _pred_block(modes[0], Y, y0, x0, 16, mbx, mby)
                for n in range(16):
                    _idct_add(coeffs, 16 * n, Y, y0 + 4 * (n >> 2), x0 + 4 * (n & 3))
            c0, cx = 1 + 8 * mby, 1 + 8 * mbx
            for plane, base in ((U, 256), (V, 320)):
                _pred_block(uvmode, plane, c0, cx, 8, mbx, mby)
                for n in range(4):
                    _idct_add(coeffs, base + 16 * n, plane, c0 + 4 * (n >> 1), cx + 4 * (n & 1))
        infos.append(info_row)
    y = [v for r in Y[1:] for v in r[1:]]
    u = [v for r in U[1:] for v in r[1:]]
    v_ = [v for r in V[1:] for v in r[1:]]
    if strengths is not None:
        _loop_filter(f, ((y, W16), (u, W16 // 2), (v_, W16 // 2)), infos)
    ya = np.array(y, np.int32).reshape(H16, W16)[:f.height, :f.width]
    ch, cw = (f.height + 1) // 2, (f.width + 1) // 2
    ua = np.array(u, np.int32).reshape(H16 // 2, W16 // 2)[:ch, :cw]
    va = np.array(v_, np.int32).reshape(H16 // 2, W16 // 2)[:ch, :cw]
    return fancy_rgb_plain(ya, ua, va)


# --------------------------------------------------------------------------- #
# the C++ library
# --------------------------------------------------------------------------- #

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The helper library, built first where it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            lib = load_library("webp_host")
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.webp_vp8l_decode.argtypes = [p, i64, p, i, i, p, ctypes.c_char_p, i]
            lib.webp_vp8l_decode.restype = i
            lib.webp_vp8_decode.argtypes = [p, i64, p, p, p, p, p, p, ctypes.c_char_p, i]
            lib.webp_vp8_decode.restype = i
            _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


_AC32 = np.ascontiguousarray(AC_TABLE, np.int32)


def vp8_size(data: bytes) -> Tuple[int, int]:
    """(width, height) of a VP8 key frame."""
    if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
        raise _corrupt("VP8", "a short frame header or a bad start code")
    return (data[6] | (data[7] << 8)) & 0x3FFF, (data[8] | (data[9] << 8)) & 0x3FFF


def vp8l_decode(data) -> np.ndarray:
    """A VP8L bitstream -> its ARGB words as uint8 [H, W, 4] (A, R, G, B),
    by the C++ loop."""
    buf = np.frombuffer(bytes(data), np.uint8)
    width, height, _ = vp8l_header(buf.tobytes())
    out = np.empty((height, width, 4), np.uint8)
    err = ctypes.create_string_buffer(256)
    if load().webp_vp8l_decode(_ptr(buf), buf.size, _ptr(CODE_TO_PLANE), width, height, _ptr(out), err, len(err)):
        raise ValueError(err.value.decode())
    return out


def vp8_decode(data) -> np.ndarray:
    """A VP8 key frame -> RGB uint8 [H, W, 3], by the C++ loop."""
    buf = np.frombuffer(bytes(data), np.uint8)
    width, height = vp8_size(buf.tobytes())
    out = np.empty((max(height, 1), max(width, 1), 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    if load().webp_vp8_decode(_ptr(buf), buf.size, _ptr(DC_TABLE), _ptr(_AC32), _ptr(COEFFS_UPDATE_PROBA),
                              _ptr(COEFFS_PROBA0), _ptr(BMODES_PROBA), _ptr(out), err, len(err)):
        raise ValueError(err.value.decode())
    return out


NATIVE = SimpleNamespace(vp8l=vp8l_decode, vp8=vp8_decode)
PLAIN = SimpleNamespace(vp8l=vp8l_decode_plain, vp8=vp8_decode_plain)
