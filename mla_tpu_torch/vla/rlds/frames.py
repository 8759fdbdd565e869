"""One entry for every image format the JAX data paths decode.

`decode(data, flavour)` names the stream's format by its first bytes and
hands it to the port's own decoder:

- flavour "tf" gives tf.io.decode_image(channels=3,
  expand_animations=False)'s pixels, the JAX RLDS path's
  (`transforms.decode_image`): PNG (`png.py`), JPEG (`jpeg.py`), GIF
  (`gif.py`), BMP (`bmp.py`) and WebP (`webp.py`), the formats TensorFlow
  sniffs. Any other stream raises ValueError, as TensorFlow refuses it.
- flavour "pillow" gives Pillow's convert("RGB") pixels, the JAX VLM
  path's (`vla/vlm_datasets._load_image`). The formats are tried in
  Pillow's order (`PIL.Image.ID` after `Image.init()`), each by Pillow's own
  test of the first bytes: those five, TIFF (`tiff.py`), Netpbm
  (`netpbm.py`), ICO (`ico.py`), QOI (`qoi.py`), PCX (`pcx.py`), SGI
  (`sgi.py`), and last TGA (`tga.py`), which has no signature and is taken
  where its header is plausible. The formats Pillow reads and the port
  does not (JPEG 2000, AVIF, DDS, PSD, EPS and the rest of Pillow's list
  in `REFUSED`) raise NotImplementedError citing ROADMAP.md item 2, as do
  the TIFF codecs not decoded (ZSTD, WebP, old-style JPEG). A stream that
  no format claims raises ValueError.

JPEG XL, which neither reads here, raises NotImplementedError citing item 2.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

from mla_tpu_torch.native import jpeg_host, rlds_host, webp_host
from mla_tpu_torch.vla.rlds import bmp, gif, ico, jpeg, netpbm, pcx, png, qoi, sgi, tga, tiff, webp

ROADMAP_FRAMES = "ROADMAP.md queue 1, item 2 (frame formats)"
FLAVOURS = ("tf", "pillow")
TF_FORMATS = ("png", "jpeg", "gif", "bmp", "webp")
_JXL = (b"\xff\x0a", b"\x00\x00\x00\x0cJXL \r\n\x87\n")


def _u32(head: bytes, big: bool = False) -> int:
    return struct.unpack(">I" if big else "<I", head[:4])[0] if len(head) >= 4 else -1


# Pillow's formats in its order of trying them, each with its test of the
# stream's first bytes (PIL's _accept functions); the loose tests that
# often fail at open (FLI, GBR, MCIDAS, WMF) are left out; of the formats
# without a test, IM is named by its header's first words and TGA by its
# header's plausibility
PILLOW_ORDER = (
    ("avif", lambda h: h[4:8] == b"ftyp" and h[8:12] in (b"avif", b"avis")),
    ("blp", lambda h: h.startswith((b"BLP1", b"BLP2"))),
    ("bmp", lambda h: h.startswith(bmp.SIGNATURE)),
    ("dib", lambda h: _u32(h) in (12, 40, 52, 56, 64, 108, 124)),
    ("bufr", lambda h: h.startswith((b"BUFR", b"ZCZC"))),
    ("cur", lambda h: h.startswith(b"\x00\x00\x02\x00") and h[4:6] != b"\x00\x00"),  # Pillow needs a cursor
    ("pcx", pcx.valid_header),
    ("dcx", lambda h: _u32(h) == 0x3ADE68B1),
    ("dds", lambda h: h.startswith(b"DDS ")),
    ("eps", lambda h: h.startswith(b"%!PS") or _u32(h) == 0xC6D3D0C5),
    ("fits", lambda h: h.startswith(b"SIMPLE")),
    ("ftex", lambda h: h.startswith(b"FTEX")),
    ("gif", lambda h: h[:6] in gif.SIGNATURES),
    ("grib", lambda h: h.startswith(b"GRIB") and len(h) >= 8 and h[7] == 1),
    ("hdf5", lambda h: h.startswith(b"\x89HDF\r\n\x1a\n")),
    ("png", lambda h: h.startswith(png.SIGNATURE)),
    ("jpeg2000", lambda h: h.startswith((b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \r\n\x87\n"))),
    ("icns", lambda h: h.startswith(b"icns")),
    ("ico", lambda h: h.startswith(ico.SIGNATURE)),
    ("im", lambda h: h.startswith(b"Image type:")),
    ("jpeg", lambda h: h.startswith(jpeg.SIGNATURE)),
    ("mpeg", lambda h: h.startswith(b"\x00\x00\x01\xb3")),
    ("tiff", lambda h: h.startswith(tiff.SIGNATURES)),
    ("msp", lambda h: h.startswith((b"DanM", b"LinS"))),
    ("pixar", lambda h: h.startswith(b"\x80\xe8\x00\x00")),
    ("netpbm", netpbm.is_netpbm),
    ("psd", lambda h: h.startswith(b"8BPS")),
    ("qoi", lambda h: h.startswith(qoi.SIGNATURE)),
    ("sgi", sgi.claims),
    ("sun", lambda h: _u32(h, big=True) == 0x59A66A95),
    ("tga", tga.claims),
    ("webp", webp.is_webp),
    ("xbm", lambda h: h.lstrip().startswith(b"#define")),
    ("xpm", lambda h: h.startswith(b"/* XPM */")),
    ("xvthumb", lambda h: h.startswith(b"P7 332")),
)
DECODED = TF_FORMATS + ("tiff", "netpbm", "tga", "ico", "qoi", "pcx", "sgi")
REFUSED = tuple(name for name, _ in PILLOW_ORDER if name not in DECODED)
# the formats whose decoders need no host loop and no flavour
_SIMPLE = {"netpbm": netpbm.decode, "tga": tga.decode, "ico": ico.decode, "qoi": qoi.decode, "pcx": pcx.decode,
           "sgi": sgi.decode}


def format_of(data) -> str:
    """The format a stream's first bytes name, in Pillow's order: one of
    DECODED or REFUSED, "jxl", or "unknown"."""
    head = bytes(data[:128])
    if head.startswith(_JXL):
        return "jxl"
    for name, claims in PILLOW_ORDER:
        if claims(head):
            return name
    return "unknown"


def decode(data, flavour: str = "tf", plain: bool = False) -> np.ndarray:
    """Encoded bytes -> uint8 [H, W, 3], as `flavour`'s reference decodes
    them; `plain` runs the plain Python versions of the host loops (the C++
    ones by default)."""
    if flavour not in FLAVOURS:
        raise ValueError(f"flavour {flavour!r} is not one of {FLAVOURS}")
    kind = format_of(data)
    if kind == "jxl":
        raise NotImplementedError(f"JPEG XL frames are not decoded ({ROADMAP_FRAMES})")
    if flavour == "tf" and kind not in TF_FORMATS:
        raise ValueError(f"an image of an unknown format (it starts {bytes(data[:8]).hex()}): TensorFlow's "
                         f"decode_image reads PNG, JPEG, GIF, BMP and WebP ({ROADMAP_FRAMES})")
    if kind == "png":
        return png.decode(data, flavour, rlds_host.png_unfilter_plain if plain else rlds_host.png_unfilter)
    if kind == "jpeg":
        return jpeg.decode(data, "ifast" if flavour == "tf" else "islow", jpeg_host.PLAIN if plain else jpeg_host.NATIVE)
    if kind == "gif":
        return gif.decode(data, flavour, rlds_host.gif_lzw_plain if plain else rlds_host.gif_lzw)
    if kind == "bmp":
        return bmp.decode(data, flavour)
    if kind == "webp":
        return webp.decode(data, flavour, webp_host.PLAIN if plain else webp_host.NATIVE)
    if kind == "tiff":
        return tiff.decode(data, plain)
    if kind in _SIMPLE:
        return _SIMPLE[kind](data)
    if kind in REFUSED:
        raise NotImplementedError(f"{kind.upper()} images, which Pillow reads, are not decoded ({ROADMAP_FRAMES})")
    raise ValueError(f"an image of an unknown format (it starts {bytes(data[:8]).hex()}): no format Pillow reads "
                     f"claims it ({ROADMAP_FRAMES})")


def digest(px: np.ndarray) -> str:
    """SHA-256 of decoded pixels with their shape: what the golden streams
    under tests/data/frames/ record."""
    px = np.ascontiguousarray(px, np.uint8)
    return hashlib.sha256(px.tobytes() + repr(px.shape).encode()).hexdigest()
