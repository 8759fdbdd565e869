"""Netpbm decoding (PBM, PGM, PPM; P1 to P6, and Pf) as Pillow's
convert("RGB") reads it.

The header's tokens are read as Pillow reads them: the magic up to the
first whitespace, then whitespace-separated numbers, each at most 10
characters, a "#" starting a comment that runs to the next CR or LF (in
the middle of a token too). The binary forms (P4, P5, P6) follow the one
whitespace byte after the last token; the plain ones (P1, P2, P3) are
tokens, with comments removed first. A maxval of 255 is read as it is, 65535
grey as 16-bit (mode "I"), any other maxval scaled to 0..255 (0..65535 for
grey over 255) by Python's round, which rounds halves to even. Pf (float,
bottom row first) is read too. Data that ends early raises ValueError;
Pillow's test-only "Py" and "P0CMYK" forms raise NotImplementedError.
"""

from __future__ import annotations

import math

import numpy as np

from mla_tpu_torch.vla.rlds import pillow_modes

ROADMAP_NETPBM = "ROADMAP.md queue 1, item 2 (frame formats: Netpbm extensions)"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB", b"Pf": "F"}
_WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"


def is_netpbm(data) -> bool:
    """Pillow's PPM signature: P and one of 0123456fy."""
    head = bytes(data[:2])
    return len(head) == 2 and head[:1] == b"P" and head[1:] in [bytes([c]) for c in b"0123456fy"]


def _corrupt(msg: str) -> ValueError:
    return ValueError(f"corrupt Netpbm data: {msg}")


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data, self.pos = data, 0

    def byte(self) -> bytes:
        b = self.data[self.pos:self.pos + 1]
        self.pos += len(b)
        return b

    def magic(self) -> bytes:
        out = b""
        for _ in range(6):
            c = self.byte()
            if not c or c in _WHITESPACE:
                break
            out += c
        return out

    def token(self) -> bytes:
        tok = b""
        while len(tok) <= 10:
            c = self.byte()
            if not c:
                break
            if c in _WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while self.byte() not in b"\r\n":  # the empty byte at the end is in every bytes object
                    pass
                continue
            tok += c
        if not tok:
            raise _corrupt("the header ends early (reached EOF while reading header)")
        if len(tok) > 10:
            raise _corrupt(f"a header token too long ({tok[:11]!r})")
        return tok


def _plain_tokens(body: bytes) -> list:
    """The plain forms' data with comments (# to the next CR or LF, which
    goes too) removed, split on whitespace."""
    while True:
        start = body.find(b"#")
        if start < 0:
            break
        ends = [e for e in (body.find(b"\n", start), body.find(b"\r", start)) if e >= 0]
        body = body[:start] + body[min(ends) + 1:] if ends else body[:start]
    return body.split()


def decode(data) -> np.ndarray:
    """Netpbm bytes -> uint8 [H, W, 3], as Pillow's convert("RGB") gives
    them."""
    data = bytes(data)
    r = _Reader(data)
    magic = r.magic()
    if magic in (b"P0CMYK", b"PyP", b"PyRGBA", b"PyCMYK"):
        raise NotImplementedError(f"the Netpbm form {magic.decode()} is not decoded ({ROADMAP_NETPBM})")
    mode = _MODES.get(magic)
    if mode is None:
        raise ValueError(f"not a Netpbm image (magic {magic!r})")
    try:
        w, h = int(r.token()), int(r.token())
    except ValueError as e:
        raise _corrupt(str(e)) from None
    if w <= 0 or h <= 0:
        raise _corrupt(f"an image of {w} x {h}")
    bands = 3 if mode == "RGB" else 1
    if mode == "F":
        scale = float(r.token())
        if scale == 0.0 or not math.isfinite(scale):
            raise _corrupt("scale must be finite and non-zero")
        need = 4 * w * h
        if r.pos + need > len(data):
            raise _corrupt("the image data ends early (image file is truncated)")
        px = np.frombuffer(data, "<f4" if scale < 0 else ">f4", w * h, r.pos).reshape(h, w)[::-1]
        return pillow_modes.to_rgb("F", px)
    maxval = 1
    if mode != "1":
        maxval = int(r.token())
        if not 0 < maxval < 65536:
            raise _corrupt("maxval must be greater than 0 and less than 65536")
        if maxval > 255 and mode == "L":
            mode = "I"
    n = w * h * bands
    out_max = 65535 if mode == "I" else 255
    if magic in (b"P1", b"P2", b"P3"):
        body = data[r.pos:]
        if magic == b"P1":  # one byte a token, whitespace optional
            toks = b"".join(_plain_tokens(body))
            if any(t not in b"01" for t in toks):
                raise _corrupt("a token other than 0 and 1")
            if len(toks) < n:
                raise _corrupt("not enough image data")
            return pillow_modes.to_rgb("1", (np.frombuffer(toks[:n], np.uint8) == ord("0")).reshape(h, w))
        vals = []
        for t in _plain_tokens(body):
            if len(t) > 10:
                raise _corrupt(f"a data token too long ({t[:11]!r})")
            v = int(t)
            if v < 0 or v > maxval:
                raise _corrupt(f"a channel value {v} outside 0..{maxval}")
            vals.append(round(v / maxval * out_max))
            if len(vals) == n:
                break
        if len(vals) < n:
            raise _corrupt("not enough image data")
        px = np.array(vals, np.int64).reshape(h, w, bands)
        return pillow_modes.to_rgb(mode, px if bands == 3 else px[..., 0])
    if magic == b"P4":
        row = (w + 7) // 8
        if r.pos + row * h > len(data):
            raise _corrupt("the image data ends early (image file is truncated)")
        bits = np.unpackbits(np.frombuffer(data, np.uint8, row * h, r.pos).reshape(h, row), axis=1)[:, :w]
        return pillow_modes.to_rgb("1", bits == 0)
    size = 1 if maxval < 256 else 2
    if r.pos + n * size > len(data):
        raise _corrupt("the image data ends early (image file is truncated)")
    v = np.frombuffer(data, np.uint8 if size == 1 else ">u2", n, r.pos).astype(np.int64)
    if maxval not in (255, 65535) or (maxval == 65535 and mode != "I"):
        # Pillow's PpmDecoder: round(value / maxval * out_max), clipped to out_max
        v = np.minimum(out_max, np.round(v / maxval * out_max)).astype(np.int64)
    px = v.reshape(h, w, bands)
    return pillow_modes.to_rgb(mode, px if bands == 3 else px[..., 0])
