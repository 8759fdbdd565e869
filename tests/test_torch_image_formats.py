"""The image formats besides TIFF that JAX's VLM loader reads through Pillow
(mla_tpu.vla.vlm_datasets._load_image), through the port's decoders
(mla_tpu_torch/vla/rlds/{netpbm,tga,ico,qoi,pcx,sgi}.py and the
four-component lossless JPEG of jpeg.py), pixel for pixel, refused where
JAX's loader refuses: streams Pillow writes and streams built here for
the layouts it does not write, and each cut short. The formats Pillow
reads and the port does not raise NotImplementedError citing item 2;
TensorFlow's decode_image reads none of them, and neither does the port's
"tf" flavour."""

import functools
import io
import struct

import numpy as np
import pytest
from torch_frames import held_to_jax_loader, pillow_save, tf_decode

from mla_tpu_torch.native import jpeg_host
from mla_tpu_torch.vla.rlds import frames, jpeg, png

H, W = 9, 13


def _rgb(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    img = np.dstack([(xx * 19 + yy) % 256, (yy * 27) % 256, rng.integers(0, 256, (H, W))]).astype(np.uint8)
    img[2:5, 3:9] = img[2, 3]  # a flat patch: runs, repeats
    return img


def _save(mode: str, fmt: str, **kw) -> bytes:
    from PIL import Image

    img = Image.fromarray(_rgb())
    if mode == "RGBA":
        img = Image.fromarray(np.dstack([_rgb(), _rgb(1)[..., 0]]))
    elif mode == "I;16":
        img = Image.fromarray((_rgb()[..., 0].astype(np.uint16) * 257))
    elif mode == "F":
        img = Image.fromarray(_rgb()[..., 0].astype(np.float32) * 1.3 - 20)
    elif mode != "RGB":
        img = img.convert(mode)
    f = io.BytesIO()
    img.save(f, fmt, **kw)
    return f.getvalue()


def _cuts(data: bytes):
    return {f"cut {n}": data[:n] for n in (len(data) // 2, len(data) - 1, 20)}


# --------------------------------------------------------------------------- #
# Netpbm
# --------------------------------------------------------------------------- #


def _pnm(magic: str, px: np.ndarray, maxval: int, header: str = "") -> bytes:
    """P1-P6 with `header` (comments) after the magic."""
    h, w = px.shape[:2]
    head = f"{magic}\n{header}{w} {h}\n" + ("" if magic in ("P1", "P4") else f"{maxval}\n")
    if magic in ("P1", "P2", "P3"):
        body = "\n".join(" ".join(str(int(v)) for v in row.reshape(-1)) for row in px) + "\n"
        return head.encode() + body.encode()
    if magic == "P4":
        return head.encode() + np.packbits(px.astype(np.uint8), axis=1).tobytes()
    return head.encode() + px.astype(">u2" if maxval > 255 else np.uint8).tobytes()


@functools.lru_cache(maxsize=None)
def _netpbm_cases():
    rng = np.random.default_rng(5)
    cases = {f"pillow {m}": _save(m, "PPM") for m in ("RGB", "L", "1", "I;16", "F")}
    for maxval in (1, 15, 255, 256, 1000, 65535):
        for magic, ch in (("P2", 1), ("P3", 3), ("P5", 1), ("P6", 3)):
            px = rng.integers(0, maxval + 1, (H, W, ch))
            cases[f"{magic} maxval {maxval}"] = _pnm(magic, px, maxval)
    bits = rng.integers(0, 2, (H, W))
    cases["P1"] = _pnm("P1", bits, 1)
    cases["P1 packed"] = b"P1 13 9\n" + "".join(map(str, bits.reshape(-1))).encode()
    cases["P4"] = _pnm("P4", bits, 1)
    cases["comments"] = _pnm("P6", rng.integers(0, 256, (H, W, 3)), 255, "# a comment\n#another\r")
    cases["comment inside a token"] = b"P5\n1#x\n3 9\n255\n" + bytes(range(117))
    cases["comment in plain data"] = b"P2 2 2 255\n1 2#c\n3 4\n"
    cases["halves round to even"] = _pnm("P2", np.array([[0, 1, 2, 3, 4]]), 2)
    cases["value past maxval (refused)"] = _pnm("P2", np.array([[0, 9]]), 5)
    cases["maxval 0 (refused)"] = b"P5 2 2 0\n\0\0\0\0"
    cases["bad plain bit (refused)"] = b"P1 2 2\n0 1 2 0\n"
    cases["pf big-endian"] = b"Pf\n13 9\n1.0\n" + rng.uniform(-9, 300, (H, W)).astype(">f4").tobytes()
    cases["pf little-endian"] = b"Pf\n13 9\n-1.0\n" + rng.uniform(-9, 300, (H, W)).astype("<f4").tobytes()
    for name in ("P6 maxval 1000", "P3 maxval 15", "P4"):
        cases.update({f"{name} {k}": v for k, v in _cuts(cases[name]).items()})
    return cases


@pytest.mark.parametrize("case", list(_netpbm_cases()))
def test_netpbm_matches_jax(tmp_path, case):
    """P1-P6 at every kind of maxval (255 as it is, 65535 grey as 16-bit,
    any other scaled by Python's round), comments in the header and the
    data, Pf; what Pillow refuses, and each cut short."""
    held_to_jax_loader(_netpbm_cases()[case], tmp_path, "image.pnm")


# --------------------------------------------------------------------------- #
# TGA
# --------------------------------------------------------------------------- #


def _tga(itype: int, depth: int, pixels: bytes, w: int = W, h: int = H, cmap: bytes = b"", cmap_start: int = 0,
         cmap_depth: int = 0, flags: int = 0, ident: bytes = b"") -> bytes:
    n = len(cmap) // max(1, cmap_depth // 8)
    head = struct.pack("<BBBHHBHHHHBB", len(ident), 1 if cmap else 0, itype, cmap_start, n, cmap_depth, 0, 0, w, h,
                       depth, flags)
    return head + ident + cmap + pixels


def _tga_rle(px: bytes, size: int) -> bytes:
    """Runs where pixels repeat, raw packets otherwise, across rows."""
    items = [px[i:i + size] for i in range(0, len(px), size)]
    out, i = bytearray(), 0
    while i < len(items):
        j = i
        while j + 1 < len(items) and items[j + 1] == items[i] and j - i < 127:
            j += 1
        if j == i:  # a raw packet up to the next repeat
            while j + 1 < len(items) and items[j + 1] != items[j] and j - i < 127:
                j += 1
            out += bytes([j - i]) + b"".join(items[i:j + 1])
        else:
            out += bytes([0x80 | (j - i)]) + items[i]
        i = j + 1
    return bytes(out)


@functools.lru_cache(maxsize=None)
def _tga_cases():
    rng = np.random.default_rng(6)
    cases = {}
    for mode in ("RGB", "RGBA", "L", "LA", "P", "1"):
        for kw in (dict(), dict(compression="tga_rle"), dict(orientation=1)):
            cases[f"pillow {mode} {kw}"] = _save(mode, "TGA", **kw)
    v16 = rng.integers(0, 65536, H * W).astype("<u2").tobytes()
    cases["16 bits"] = _tga(2, 16, v16)
    cases["16 bits rle"] = _tga(10, 16, _tga_rle(v16, 2))
    idx = np.repeat(rng.integers(0, 40, (H, 5)), 3, axis=1)[:, :W].astype(np.uint8).tobytes()
    for cdepth in (16, 24, 32):
        cmap = rng.integers(0, 256, 30 * cdepth // 8).astype(np.uint8).tobytes()
        cases[f"colour map {cdepth}"] = _tga(1, 8, idx, cmap=cmap, cmap_start=10, cmap_depth=cdepth)
        cases[f"colour map {cdepth} rle"] = _tga(9, 8, _tga_rle(idx, 1), cmap=cmap, cmap_start=10, cmap_depth=cdepth)
    bgr = np.repeat(rng.integers(0, 256, (H, 4, 3)), 4, axis=1)[:, :W].astype(np.uint8).tobytes()
    for flags in (0x00, 0x10, 0x20, 0x30):
        cases[f"origin {flags:#x}"] = _tga(2, 24, bgr, flags=flags, ident=b"an id")
        cases[f"origin {flags:#x} rle across rows"] = _tga(10, 24, _tga_rle(bgr, 3), flags=flags)
    cases["true colour of 8 bits (refused)"] = _tga(2, 8, bytes(H * W))
    cases["colour-mapped without a map (refused)"] = _tga(1, 8, idx)
    cases["15 bits (not a TGA)"] = _tga(2, 15, v16)
    for name in ("16 bits rle", "colour map 24", "pillow RGB {}"):
        cases.update({f"{name} {k}": v for k, v in _cuts(cases[name]).items()})
    return cases


@pytest.mark.parametrize("case", list(_tga_cases()))
def test_tga_matches_jax(tmp_path, case):
    """Every mode Pillow writes, raw and run-length, both origins; 16-bit
    5-5-5 pixels and colour maps of 16 and 24 bits from a first index (of
    32, refused),
    mirrored rows, packets across rows; a TGA starting as a cursor file
    does (CUR's test of the first bytes) goes on to TGA as in Pillow."""
    held_to_jax_loader(_tga_cases()[case], tmp_path, "image.tga")


# --------------------------------------------------------------------------- #
# ICO
# --------------------------------------------------------------------------- #


def _dib(w: int, h: int, bpp: int, rows: bytes, palette: bytes = b"", mask: bytes = b"") -> bytes:
    """A DIB for an icon: the height counts the colour rows and the mask's."""
    colours = len(palette) // 4
    return struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bpp, 0, len(rows), 0, 0, colours, 0) + palette + rows + mask


def _ico(entries) -> bytes:
    """Icon entries (width, height, bpp, payload) -> an ICO file."""
    head = struct.pack("<HHH", 0, 1, len(entries))
    offset = 6 + 16 * len(entries)
    dirs, blobs = b"", b""
    for w, h, bpp, payload in entries:
        dirs += struct.pack("<BBBBHHII", w % 256, h % 256, 0, 0, 1, bpp, len(payload), offset + len(blobs))
        blobs += payload
    return head + dirs + blobs


@functools.lru_cache(maxsize=None)
def _ico_cases():
    rng = np.random.default_rng(7)
    cases = {"pillow rgb": _save("RGB", "ICO", sizes=[(8, 8), (13, 9)]),
             "pillow rgba": _save("RGBA", "ICO", sizes=[(8, 8)]), "pillow palette": _save("P", "ICO")}
    w, h = 12, 10
    mask = rng.integers(0, 256, 4 * h).astype(np.uint8).tobytes()  # rows of 32 bits
    bgra = rng.integers(0, 256, 4 * w * h).astype(np.uint8).tobytes()
    pal = rng.integers(0, 256, 16 * 4).astype(np.uint8).tobytes()
    idx4 = rng.integers(0, 256, 8 * h).astype(np.uint8).tobytes()  # 12 pixels of 4 bits: 6 bytes, padded to 8
    idx1 = rng.integers(0, 256, 4 * h).astype(np.uint8).tobytes()
    b32, b4 = _dib(w, h, 32, bgra, mask=mask), _dib(w, h, 4, idx4, pal, mask)
    b1 = _dib(w, h, 1, idx1, pal[:8], mask)
    png_small = png.encode(_rgb(2)[:6, :6])
    cases["bmp 32 bits"] = _ico([(w, h, 32, b32)])
    cases["bmp 4 bits"] = _ico([(w, h, 4, b4)])
    cases["bmp 1 bit"] = _ico([(w, h, 1, b1)])
    cases["largest of three, not first"] = _ico([(6, 6, 32, png_small), (w, h, 4, b4), (4, 4, 32, png_small)])
    cases["same size: fewest bits"] = _ico([(w, h, 32, b32), (w, h, 4, b4)])
    cases["png payload"] = _ico([(13, 9, 32, png.encode(_rgb(3)))])
    cases["mask past the end (refused)"] = _ico([(w, h, 4, b4)])[:-len(mask) // 2]
    cases["no entries (refused)"] = struct.pack("<HHH", 0, 1, 0)
    for name in ("bmp 4 bits", "png payload", "pillow rgb"):
        cases.update({f"{name} {k}": v for k, v in _cuts(cases[name]).items()})
    return cases


@pytest.mark.parametrize("case", list(_ico_cases()))
def test_ico_matches_jax(tmp_path, case):
    """The entry Pillow picks (the largest; of one size, the fewest bits a
    pixel), PNG and BMP payloads (32-bit, palette, 1-bit), the AND mask's
    refusal where the data cannot hold it, and a PNG payload cut after its
    image data, which Pillow still reads."""
    held_to_jax_loader(_ico_cases()[case], tmp_path, "image.ico")


# --------------------------------------------------------------------------- #
# QOI, PCX, SGI
# --------------------------------------------------------------------------- #


def _pcx(bits: int, planes: int, lines: bytes, w: int = W, h: int = H, stride: int = 0, version: int = 5,
         palette: bytes = bytes(48), tail: bytes = b"") -> bytes:
    stride = stride or (w * bits + 7) // 8
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1, h - 1, 72, 72) + palette + b"\0"
    head += struct.pack("<BHH", planes, stride, 1)
    return head + bytes(128 - len(head)) + lines + tail


def _pcx_rle(raw: bytes) -> bytes:
    """Each byte alone, as a one-count run where it has the top bits set."""
    return b"".join(bytes([0xC1, b]) if b >= 0xC0 else bytes([b]) for b in raw)


def _sgi(px: np.ndarray, rle: bool, size: int = 1) -> bytes:
    """[z, h, w] samples (rows bottom-up) -> an SGI file, RLE or not."""
    z, h, w = px.shape
    head = struct.pack(">HBBHHHH", 474, int(rle), size, 3 if z > 1 else 2, w, h, z) + bytes(500)
    fmt = ">u2" if size == 2 else np.uint8
    if not rle:
        return head + px.astype(fmt).tobytes()
    rows, starts, lengths = b"", [], []
    base = 512 + 8 * h * z
    for c in range(z):
        for y in range(h):
            vals = px[c, y]
            row = np.concatenate([[0x80 | len(vals[:5])], vals[:5], [len(vals) - 5], vals[5:6], [0]]) \
                if len(vals) - 5 < 128 and len(vals) > 5 and (vals[5:] == vals[5]).all() else \
                np.concatenate([[0x80 | len(vals)], vals, [0]])
            blob = row.astype(fmt).tobytes()
            starts.append(base + len(rows))
            lengths.append(len(blob))
            rows += blob
    return head + struct.pack(f">{h * z}I", *starts) + struct.pack(f">{h * z}I", *lengths) + rows


@functools.lru_cache(maxsize=None)
def _simple_cases():
    rng = np.random.default_rng(8)
    cases = {f"qoi pillow {m}": _save(m, "QOI") for m in ("RGB", "RGBA")}
    cases["qoi noise"] = pillow_save(rng.integers(0, 256, (H, W, 3), np.uint8), "QOI")
    cases["qoi an index never written"] = b"qoif" + struct.pack(">II", 2, 1) + b"\x04\x00" + bytes([0x05, 0xC0])
    for m in ("1", "L", "P", "RGB"):
        cases[f"pcx pillow {m}"] = _save(m, "PCX")
    pal = rng.integers(0, 256, 48).astype(np.uint8).tobytes()
    for planes in (2, 4):
        s = (W + 7) // 8
        lines = rng.integers(0, 256, H * planes * s).astype(np.uint8).tobytes()
        cases[f"pcx 1 bit {planes} planes"] = _pcx(1, planes, _pcx_rle(lines), palette=pal)
    grey = rng.integers(0, 256, H * W).astype(np.uint8).tobytes()
    ramp = b"\x0c" + bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
    cases["pcx grey ramp palette (grey)"] = _pcx(8, 1, _pcx_rle(grey), tail=ramp)
    cases["pcx no palette mark (grey)"] = _pcx(8, 1, _pcx_rle(grey), tail=bytes(769))
    cases["pcx padded rgb"] = _pcx(8, 3, _pcx_rle(rng.integers(0, 256, H * 3 * 14).astype(np.uint8).tobytes()),
                                   stride=14, tail=bytes(700))
    cases["pcx run past a line (refused)"] = _pcx(8, 1, bytes([0xFF, 7]) * H, tail=bytes(769))
    cases["pcx version 2 of 8 bits (refused)"] = _pcx(8, 1, _pcx_rle(grey), version=2)
    for m in ("L", "RGB", "RGBA"):
        cases[f"sgi pillow {m}"] = _save(m, "SGI")
        cases[f"sgi pillow {m} 16-bit"] = _save(m, "SGI", bpc=2)
    for z in (1, 3):
        for size in (1, 2):
            px = rng.integers(0, 256 ** size, (z, H, W))
            px[:, :, 5:] = px[:, :, 5:6]
            cases[f"sgi rle {z} channels {size * 8} bits"] = _sgi(px, True, size)
    wide = bytearray(_sgi(np.ones((1, H, 300)), True))
    wide[6:8] = struct.pack(">H", W)  # rows of 300 samples in an image of 13
    cases["sgi rle row past its width (refused)"] = bytes(wide)
    cases["sgi 2 channels (refused)"] = _sgi(np.zeros((2, H, W)), False)
    for name in ("qoi pillow RGB", "pcx pillow RGB", "sgi pillow RGB", "sgi rle 3 channels 8 bits"):
        cases.update({f"{name} {k}": v for k, v in _cuts(cases[name]).items()})
    return cases


@pytest.mark.parametrize("case", list(_simple_cases()))
def test_qoi_pcx_and_sgi_match_jax(tmp_path, case):
    """QOI's every op (Pillow's writer and noise reach them); PCX's 1-bit
    planes and header palette, the 8-bit trailing palette and its grey
    ramp, the stride rounded to even and the planes packed as Pillow's
    decoder packs them; SGI raw and RLE at 8 and 16 bits; what each
    refuses, and each cut short (a PCX shorter than 769 bytes is refused
    from a file, as JAX reads it)."""
    held_to_jax_loader(_simple_cases()[case], tmp_path, "image.bin")


# --------------------------------------------------------------------------- #
# four-component lossless JPEG
# --------------------------------------------------------------------------- #


def _lossless_cmyk_cases():
    rng = np.random.default_rng(9)
    cmyk = np.dstack([_rgb(), rng.integers(0, 256, (H, W), np.uint8)])
    cases = {}
    for kw in (dict(), dict(marker="none"), dict(predictor=4, restart_rows=2),
               dict(predictor=7, point_transform=1, interleaved=False),
               dict(sampling=[(2, 1), (1, 1), (1, 1), (2, 1)])):
        cases[" ".join(f"{k}={v}" for k, v in kw.items()) or "default"] = jpeg.encode_lossless(cmyk, **kw)
    ycck = bytearray(cases["default"])
    ycck[ycck.index(b"Adobe") + 11] = 2
    cases["adobe ycck (refused)"] = bytes(ycck)
    cases.update(_cuts(cases["default"]))
    return cases


@pytest.mark.parametrize("case", list(_lossless_cmyk_cases()))
def test_four_component_lossless_jpeg_matches_jax(tmp_path, case):
    """Pillow reads a four-component lossless JPEG as inverted CMYK (no
    Adobe transform, or transform 0) and converts it by cmyk2rgb; YCCK
    would be a colour conversion, which lossless mode refuses. Both host
    loops; TensorFlow's libjpeg-turbo refuses every lossless frame."""
    data = _lossless_cmyk_cases()[case]
    held_to_jax_loader(data, tmp_path, "image.jpg")
    try:
        want = jpeg.decode(data, "islow", jpeg_host.NATIVE)
    except ValueError:
        want = None
    if want is not None:
        assert np.array_equal(jpeg.decode(data, "islow", jpeg_host.PLAIN), want)
    with pytest.raises(ValueError):
        jpeg.decode(data, "ifast")


# --------------------------------------------------------------------------- #
# the formats the port does not decode, and TensorFlow's flavour
# --------------------------------------------------------------------------- #


def test_formats_pillow_reads_and_the_port_does_not_cite_item_2(tmp_path):
    """JPEG 2000, AVIF, DDS, IM, XBM and MSP, which Pillow reads, and PSD
    and EPS (whose pixels Pillow needs Ghostscript for) are named by
    frames.format_of and raise NotImplementedError citing item 2 in the
    VLM loader; a stream no format claims raises ValueError, as JAX's
    loader refuses it too."""
    from mla_tpu.vla import vlm_datasets as jvlm

    from mla_tpu_torch.vla import vlm_datasets as tvlm

    streams = {"jpeg2000": _save("RGB", "JPEG2000"), "avif": _save("RGB", "AVIF"), "dds": _save("RGB", "DDS"),
               "im": _save("RGB", "IM"), "xbm": _save("1", "XBM"), "msp": _save("1", "MSP"),
               "psd": b"8BPS\x00\x01" + bytes(40), "eps": _save("RGB", "EPS")}
    for name, data in streams.items():
        assert frames.format_of(data) == name
        (tmp_path / name).write_bytes(data)
        if name not in ("psd", "eps"):
            assert jvlm._load_image(tmp_path, name).shape == (H, W, 3)
        with pytest.raises(NotImplementedError, match=r"item 2"):
            tvlm._load_image(tmp_path, name)
    held_to_jax_loader(b"\x01\x02\x03\x04" + bytes(40), tmp_path, "unknown")


def test_tensorflow_reads_none_of_the_new_formats():
    """TensorFlow's decode_image sniffs PNG, JPEG, GIF, BMP and WebP only:
    it refuses a stream of each new format, and so does the port's "tf"
    flavour (the RLDS path)."""
    from torch_frames import tiff_encode

    streams = [tiff_encode(_rgb(), 2), _save("RGB", "PPM"), _save("RGB", "TGA"), _save("RGB", "ICO", sizes=[(W, H)]),
               _save("RGB", "QOI"), _save("RGB", "PCX"), _save("RGB", "SGI")]
    for data in streams:
        assert frames.format_of(data) in frames.DECODED and frames.format_of(data) not in frames.TF_FORMATS
        with pytest.raises(Exception):  # noqa: B017 - TensorFlow's InvalidArgumentError
            tf_decode(data)
        with pytest.raises(ValueError, match="unknown format"):
            frames.decode(data, "tf")
        assert frames.decode(data, "pillow").shape == (H, W, 3)
