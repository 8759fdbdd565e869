"""WebP decoding without an imaging package.

`decode(data, flavour)` reads the RIFF container here and decodes its
bitstream through `native/webp_host.py` (VP8L lossless, VP8 lossy; C++ by
default, the plain Python loops with host=webp_host.PLAIN), giving libwebp's
pixels, which TensorFlow and Pillow share:

- flavour "tf", as TensorFlow's decode_image(channels=3,
  expand_animations=False): a still image without alpha. An image with
  alpha (the VP8X alpha flag, an ALPH chunk or a VP8L alpha hint) has four
  channels and an animation is four-channel RGBA: TensorFlow refuses both
  at channels=3, and so does the port (ValueError).
- flavour "pillow", as Pillow's convert("RGB"): any of them; alpha is
  dropped (the RGB is libwebp's, not premultiplied), and an animation gives
  its first frame on a black canvas of the VP8X size at the frame's offset.

The ALPH chunk is parsed (its compression must be 0 or 1) and dropped. A
corrupt container, a RIFF size past the data (truncated) and a corrupt
bitstream raise ValueError.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from mla_tpu_torch.native import webp_host

FLAVOURS = ("tf", "pillow")
_ALPHA, _ANIMATION = 0x10, 0x02


def is_webp(data) -> bool:
    head = bytes(data[:12])
    return head[:4] == b"RIFF" and head[8:12] == b"WEBP"


def _corrupt(msg: str) -> ValueError:
    return ValueError(f"corrupt WebP data: {msg}")


def _chunks(data: bytes, start: int, end: int) -> List[Tuple[bytes, bytes]]:
    out, pos = [], start
    while pos + 8 <= end:
        kind, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        if pos + 8 + size > end:
            raise _corrupt(f"chunk {kind!r} runs past the data (truncated)")
        out.append((kind, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _u24(b: bytes, i: int) -> int:
    return b[i] | (b[i + 1] << 8) | (b[i + 2] << 16)


def _bitstream(chunks: List[Tuple[bytes, bytes]]) -> Tuple[bytes, bytes, bool]:
    """(kind, payload, has an ALPH chunk) of the image data among chunks."""
    alpha = False
    for kind, body in chunks:
        if kind == b"ALPH":
            if not body or (body[0] & 3) > 1:
                raise _corrupt("an ALPH chunk of an unknown compression")
            alpha = True
        elif kind in (b"VP8 ", b"VP8L"):
            return kind, body, alpha
    raise _corrupt("no VP8 or VP8L image data")


def _pixels(kind: bytes, body: bytes, host) -> np.ndarray:
    if kind == b"VP8L":
        return np.ascontiguousarray(host.vp8l(body)[..., 1:])
    return host.vp8(body)


def decode(data, flavour: str = "tf", host=webp_host.NATIVE) -> np.ndarray:
    """WebP bytes -> uint8 [H, W, 3], as `flavour`'s reference decodes them."""
    if flavour not in FLAVOURS:
        raise ValueError(f"flavour {flavour!r} is not one of {FLAVOURS}")
    data = bytes(data)
    if not is_webp(data):
        raise ValueError("not a WebP image (no RIFF/WEBP header)")
    riff = struct.unpack_from("<I", data, 4)[0]
    if riff < 12 or riff + 8 > len(data):
        raise _corrupt(f"a RIFF size of {riff} against {len(data)} bytes (truncated)")
    chunks = _chunks(data, 12, riff + 8)
    if not chunks:
        raise _corrupt("no chunk")
    first, body = chunks[0]
    if first != b"VP8X":
        kind, payload, _ = _bitstream(chunks[:1])
        if flavour == "tf" and kind == b"VP8L" and webp_host.vp8l_header(payload)[2]:
            raise ValueError("a WebP image with alpha has 4 channels: channels=3 is refused, as TensorFlow refuses it")
        return _pixels(kind, payload, host)
    if len(body) < 10:
        raise _corrupt("a short VP8X chunk")
    flags, width, height = body[0], _u24(body, 4) + 1, _u24(body, 7) + 1
    if flags & _ANIMATION:
        if flavour == "tf":
            raise ValueError("an animated WebP is 4-channel RGBA: channels=3 is refused, as TensorFlow refuses it")
        frames = [b for k, b in chunks if k == b"ANMF"]
        if not frames or len(frames[0]) < 16:
            raise _corrupt("an animation without a frame")
        fr = frames[0]
        x0, y0, fw, fh = 2 * _u24(fr, 0), 2 * _u24(fr, 3), _u24(fr, 6) + 1, _u24(fr, 9) + 1
        if x0 + fw > width or y0 + fh > height:
            raise _corrupt("a frame past the canvas")
        kind, payload, _ = _bitstream(_chunks(fr, 16, len(fr)))
        px = _pixels(kind, payload, host)
        if px.shape[:2] != (fh, fw):
            raise _corrupt(f"a frame of {px.shape[1]} x {px.shape[0]} in a {fw} x {fh} rectangle")
        canvas = np.zeros((height, width, 3), np.uint8)
        canvas[y0:y0 + fh, x0:x0 + fw] = px
        return canvas
    kind, payload, alpha = _bitstream(chunks[1:])
    if flavour == "tf" and (flags & _ALPHA or alpha):
        raise ValueError("a WebP image with alpha has 4 channels: channels=3 is refused, as TensorFlow refuses it")
    px = _pixels(kind, payload, host)
    if px.shape[:2] != (height, width):
        raise _corrupt(f"an image of {px.shape[1]} x {px.shape[0]} on a {width} x {height} canvas")
    return px
