"""Every frame format the JAX data paths decode, through the port's own
decoders (mla_tpu_torch/vla/rlds/{png,gif,bmp,webp,jpeg,frames}.py): each
variant from the C++ loops and from their plain Python versions against
TensorFlow's decode_image(channels=3, expand_animations=False) (the RLDS
path) and Pillow's convert("RGB") (the VLM path), pixel for pixel; where a
reference refuses a stream, the port refuses it too. Fixtures are written
here by Pillow, by the port's own encoders and by the libwebp Pillow
bundles (tests/torch_frames.py); the golden streams under
tests/data/frames/ are held to the digests beside them."""

import io
import json
from pathlib import Path

import numpy as np
import pytest

from torch_frames import libwebp_encode, pillow_decode, pillow_save, tf_decode  # noqa: E402

from mla_tpu_torch.native import jpeg_host, rlds_host, webp_host  # noqa: E402
from mla_tpu_torch.vla import vlm_datasets  # noqa: E402
from mla_tpu_torch.vla.rlds import bmp, frames, gif, jpeg, png, webp  # noqa: E402

FRAMES = Path(__file__).resolve().parent / "data" / "frames"
REFS = {"tf": tf_decode, "pillow": pillow_decode}


def _image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A smooth frame with a patch of noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.dstack([(xx * 3 + yy) % 256, (yy * 4) % 256, (xx * yy // 3) % 256]).astype(np.uint8)
    img[h // 4:h // 2, w // 4:w // 2] = rng.integers(0, 256, (h // 2 - h // 4, w // 2 - w // 4, 3))
    return img


def _reference(flavour: str, data: bytes):
    """The reference's pixels, or None where it refuses the stream."""
    try:
        return REFS[flavour](data)
    except Exception:  # noqa: BLE001 - TensorFlow's InvalidArgumentError, Pillow's OSError and kin
        return None


def _held(data: bytes, decoders, flavours=("tf", "pillow")) -> None:
    """Each decoder (flavour -> pixels) gives each reference's pixels, or
    raises where the reference refuses."""
    for flavour in flavours:
        want = _reference(flavour, data)
        for name, decode in decoders.items():
            if want is None:
                with pytest.raises((ValueError, NotImplementedError)):
                    decode(data, flavour)
            else:
                got = decode(data, flavour)
                assert got.dtype == np.uint8 and got.shape == want.shape, (flavour, name, got.shape, want.shape)
                assert np.array_equal(got, want), (flavour, name)


# --------------------------------------------------------------------------- #
# PNG
# --------------------------------------------------------------------------- #

PNG_DECODERS = {"native": lambda d, f: png.decode(d, f),
                "plain": lambda d, f: png.decode(d, f, rlds_host.png_unfilter_plain)}


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", [(c, d) for c, ds in png._DEPTHS.items() for d in ds])
def test_png_variants_match_both_references(ctype, depth, interlace):
    """Every colour type at every depth, plain and Adam7, with a tRNS
    chunk where one applies: 16-bit grey is where the references differ
    (TensorFlow keeps the high byte, Pillow clips)."""
    rng = np.random.default_rng(ctype * 100 + depth)
    ch = png._CHANNELS[ctype]
    px = rng.integers(0, min(1 << depth, 7) if ctype == 3 else 1 << depth, (13, 17, ch))
    palette = rng.integers(0, 256, (7, 3)) if ctype == 3 else None
    trns = bytes([10, 200]) if ctype == 3 else (np.array([px[0, 0, 0]], ">u2").tobytes() if ctype == 0 else None)
    _held(png.encode_samples(px, ctype, depth, interlace, palette, trns), PNG_DECODERS)


def test_png_sixteen_bit_grey_is_where_the_references_part():
    v = np.array([[0, 100, 255, 256, 4095, 65535]], np.uint16)[..., None]
    data = png.encode_samples(v, 0, 16)
    assert png.decode(data, "tf")[0, :, 0].tolist() == [0, 0, 0, 1, 15, 255]
    assert png.decode(data, "pillow")[0, :, 0].tolist() == [0, 100, 255, 255, 255, 255]


# --------------------------------------------------------------------------- #
# GIF
# --------------------------------------------------------------------------- #

GIF_DECODERS = {"native": lambda d, f: gif.decode(d, f),
                "plain": lambda d, f: gif.decode(d, f, rlds_host.gif_lzw_plain)}


def _gif_cases():
    rng = np.random.default_rng(3)
    tab = rng.integers(0, 256, (256, 3))
    f = rng.integers(0, 256, (37, 53)).astype(np.uint8)
    big = rng.integers(0, 4, (120, 150)).astype(np.uint8)
    return {
        "basic": gif.encode([f], tab),
        "smooth": gif.encode([np.tile(np.arange(53) // 7, (37, 1)).astype(np.uint8)], tab),
        "two-bit codes": gif.encode([big], tab[:4], min_code=2),
        "full table": gif.encode([rng.integers(0, 256, (120, 150)).astype(np.uint8)], tab),
        "interlaced": gif.encode([f], tab, interlace=True),
        "transparent": gif.encode([f], tab, transparent=5),
        "offset": gif.encode([f[:20, :30]], tab, screen=(53, 37), offsets=[(7, 9)]),
        "offset transparent": gif.encode([f[:20, :30]], tab, screen=(53, 37), offsets=[(7, 9)], transparent=5),
        "local table": gif.encode([f], None, local_tables=[tab[::-1]]),
        "local over global": gif.encode([f], tab, local_tables=[tab[::-1]]),
        "index past table": gif.encode([(f % 8 + (f == 0) * 10).astype(np.uint8)], tab[:8]),
        "animated": gif.encode([f, f[:10, :10]], tab, offsets=[(0, 0), (3, 4)]),
        "larger second frame": gif.encode([f[:10, :10], f], tab, screen=(53, 37), offsets=[(2, 3), (0, 0)]),
        "past the screen": gif.encode([f[:20, :30]], tab, screen=(30, 20), offsets=[(7, 9)]),
        "pillow": pillow_save(_image(41, 29), "GIF"),
        "pillow interlaced": pillow_save(_image(41, 29), "GIF", interlace=True, transparency=3),
    }


@pytest.mark.parametrize("case", list(_gif_cases()))
def test_gif_first_frames_match_both_references(case):
    """Offsets, tables, interlacing and transparency: TensorFlow composes
    on a black canvas of the largest frame, Pillow on the logical screen
    filled with the transparent index."""
    _held(_gif_cases()[case], GIF_DECODERS)


def test_gif_truncations_are_refused_as_both_references_refuse():
    data = _gif_cases()["basic"]
    for cut in (len(data) - 1, len(data) - 3, len(data) // 2, 30, 8):
        _held(data[:cut], GIF_DECODERS)
    assert _reference("tf", data[:-1]) is not None  # a missing trailer is read as complete


def test_gif_lzw_native_matches_plain():
    rng = np.random.default_rng(5)
    for min_code, n in ((2, 5000), (8, 40000), (3, 1)):
        idx = rng.integers(0, 1 << min_code, n).astype(np.uint8)
        stream = gif._lzw_encode(idx, min_code)
        assert np.array_equal(rlds_host.gif_lzw(stream, min_code, n), idx)
        assert np.array_equal(rlds_host.gif_lzw_plain(stream, min_code, n), idx)
    for lzw in (rlds_host.gif_lzw, rlds_host.gif_lzw_plain):
        with pytest.raises(ValueError, match="ends before"):
            lzw(stream[:-3], 3, 10)
        with pytest.raises(ValueError, match="past its table"):
            lzw(bytes([0xFF, 0xFF]), 2, 10)


# --------------------------------------------------------------------------- #
# BMP
# --------------------------------------------------------------------------- #

BMP_DECODERS = {"native": lambda d, f: bmp.decode(d, f)}


def _rows(a: np.ndarray, bpp: int, top: bool = False) -> bytes:
    a = np.asarray(a)
    h = a.shape[0]
    if bpp <= 8:
        r = np.packbits(((a[..., None] >> np.arange(bpp - 1, -1, -1)) & 1).reshape(h, -1).astype(np.uint8), axis=1)
    elif bpp == 16:
        r = a.astype("<u2").view(np.uint8).reshape(h, -1)
    else:
        r = a.reshape(h, -1).astype(np.uint8)
    r = np.pad(r, ((0, 0), (0, (-r.shape[1]) % 4)))
    return (r if top else r[::-1]).tobytes()


def _rle8(idx: np.ndarray) -> bytes:
    out = bytearray()
    for r in idx[::-1]:
        x = 0
        while x < len(r):
            n = 1
            while x + n < len(r) and r[x + n] == r[x] and n < 255:
                n += 1
            if n >= 3:
                out += bytes([n, r[x]])
                x += n
            elif len(r) - x >= 3:
                k = min(len(r) - x, 255)
                out += bytes([0, k]) + bytes(r[x:x + k].astype(np.uint8)) + (b"\0" if k % 2 else b"")
                x += k
            else:
                out += b"".join(bytes([1, v]) for v in r[x:])
                x = len(r)
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _rle4(idx: np.ndarray) -> bytes:
    out = bytearray()
    for r in idx[::-1]:
        x = 0
        while x < len(r):
            k = min(len(r) - x, 6)
            if x % 12 == 0 and k >= 3:
                v = r[x:x + k]
                b = bytes([(v[i] << 4) | (v[i + 1] if i + 1 < k else 0) for i in range(0, k, 2)])
                out += bytes([0, k]) + b + (b"\0" if len(b) % 2 else b"")
            else:
                out += bytes([k, (r[x] << 4) | (r[x + 1] if x + 1 < len(r) else 0)])
            x += k
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _pillow_palette_bmp(img: np.ndarray) -> bytes:
    from PIL import Image

    f = io.BytesIO()
    Image.fromarray(img).convert("P").save(f, "BMP")
    return f.getvalue()


def _bmp_cases():
    rng = np.random.default_rng(7)
    img = _image(13, 17)
    H, W = 13, 17
    pal = rng.integers(0, 256, (16, 3))
    v16 = rng.integers(0, 65536, (H, W))
    p4 = rng.integers(0, 256, (H, W, 4))
    runs = np.repeat(rng.integers(0, 16, (H, W // 3 + 1)), 3, axis=1)[:, :W]
    runs[2:5, 4:9] = rng.integers(0, 16, (3, 5))
    cases = {
        "pillow rgb": pillow_save(img, "BMP"),
        "pillow rgba": pillow_save(np.dstack([img, img[..., 0]]), "BMP", mode="RGBA"),
        "pillow grey": pillow_save(img[..., 0], "BMP"),
        "pillow palette (tf reads grey)": _pillow_palette_bmp(img),
        "24 top-down": bmp.encode(_rows(img[..., ::-1], 24, True), W, H, 24, top_down=True),
        "32 top-down": bmp.encode(_rows(p4, 32, True), W, H, 32, top_down=True),
        "24 v5 header": bmp.encode(_rows(img[..., ::-1], 24), W, H, 24, header_size=124),
        "16 5-5-5": bmp.encode(_rows(v16, 16), W, H, 16),
        "16 5-6-5 fields": bmp.encode(_rows(v16, 16), W, H, 16, compression=3, masks=(0xF800, 0x7E0, 0x1F)),
        "16 unknown fields": bmp.encode(_rows(v16, 16), W, H, 16, compression=3, masks=(0xF00, 0xF0, 0xF)),
        "rle8": bmp.encode(_rle8(runs), W, H, 8, pal, compression=1),
        "rle8 delta": bmp.encode(b"\0\2\3\2" + _rle8(runs), W, H, 8, pal, compression=1),
        "rle8 early end": bmp.encode(_rle8(runs)[:20] + b"\0\0\0\1", W, H, 8, pal, compression=1),
        "rle4": bmp.encode(_rle4(runs), W, H, 4, pal, compression=2),
    }
    for bpp in (1, 2, 4, 8):
        idx = rng.integers(0, min(16, 1 << bpp), (H, W))
        cases[f"palette {bpp}"] = bmp.encode(_rows(idx, bpp), W, H, bpp, pal[:1 << bpp] if bpp < 8 else pal)
        cases[f"palette {bpp} top-down"] = bmp.encode(_rows(idx, bpp, True), W, H, bpp, pal[:min(16, 1 << bpp)],
                                                      top_down=True)
        cases[f"palette {bpp} core header"] = bmp.encode(_rows(idx, bpp), W, H, bpp, pal[:min(16, 1 << bpp)],
                                                         header_size=12)
    for masks in [(0xFF0000, 0xFF00, 0xFF), (0xFF000000, 0xFF0000, 0xFF00), (0xFF, 0xFF00, 0xFF0000),
                  (0xFF00, 0xFF0000, 0xFF000000)]:
        cases[f"32 fields {masks}"] = bmp.encode(_rows(p4, 32), W, H, 32, compression=3, masks=masks)
    for masks in [(0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                  (0xFF000000, 0xFF0000, 0xFF00, 0xFF), (0, 0, 0, 0), (0xFF000000, 0xFF0000, 0xFF00, 0)]:
        cases[f"32 fields {masks} v4"] = bmp.encode(_rows(p4, 32), W, H, 32, compression=3, masks=masks,
                                                    header_size=108)
    good = cases["pillow rgb"]
    cases.update({"cut 1": good[:-1], "cut 40": good[:40], "cut 20": good[:20], "an extra byte": good + b"\0"})
    return cases


@pytest.mark.parametrize("case", list(_bmp_cases()))
def test_bmp_layouts_match_both_references(case):
    """TensorFlow's decode_bmp (8 bits as grey, 24, 32; the size exact) and
    Pillow's wider reader (palettes, bit fields, RLE)."""
    _held(_bmp_cases()[case], BMP_DECODERS)


# --------------------------------------------------------------------------- #
# WebP
# --------------------------------------------------------------------------- #

WEBP_DECODERS = {"native": lambda d, f: webp.decode(d, f, webp_host.NATIVE),
                 "plain": lambda d, f: webp.decode(d, f, webp_host.PLAIN)}
WEBP_LOSSY = {
    "simple filter": dict(filter_type=0), "simple filter sharp": dict(filter_type=0, filter_sharpness=5),
    "normal filter sharpest": dict(filter_type=1, filter_sharpness=7),
    "strongest filter": dict(filter_type=1, filter_strength=100, filter_sharpness=3),
    "four partitions": dict(partitions=2), "eight partitions one segment": dict(partitions=3, segments=1),
    "no filter": dict(filter_strength=0), "four segments": dict(sns_strength=0, segments=4),
    "fastest": dict(method=0),
}


@pytest.mark.parametrize("quality", [8, 60, 97])
@pytest.mark.parametrize("settings", list(WEBP_LOSSY))
def test_webp_lossy_matches_both_references(settings, quality):
    """VP8: both loop filters and the sharpness, token partitions,
    segments, every quality range; libwebp's fancy upsampling and YUV ->
    RGB."""
    _held(libwebp_encode(_image(45, 70), quality, **WEBP_LOSSY[settings]), WEBP_DECODERS)


def _webp_cases():
    from PIL import Image

    img = _image(45, 70)
    rng = np.random.default_rng(9)
    rgba = np.dstack([img, rng.integers(0, 256, img.shape[:2], np.uint8)])
    few = (rng.integers(0, 3, (23, 31, 1)).repeat(3, 2) * 80).astype(np.uint8)
    cases = {f"lossless m{m}": pillow_save(img, "WEBP", lossless=True, method=m) for m in (0, 4, 6)}
    cases["lossless palette"] = pillow_save(few, "WEBP", lossless=True)
    cases["lossless 16 colours"] = pillow_save((rng.integers(0, 16, (23, 31, 1)) * [[[13, 7, 3]]]).astype(np.uint8),
                                               "WEBP", lossless=True)
    cases["lossless noise"] = pillow_save(rng.integers(0, 256, (23, 31, 3), np.uint8), "WEBP", lossless=True)
    cases["pillow lossy"] = pillow_save(img, "WEBP", quality=70)
    cases["lossy alpha (tf refuses)"] = pillow_save(rgba, "WEBP", mode="RGBA", quality=70)
    cases["lossless alpha (tf refuses)"] = pillow_save(rgba, "WEBP", mode="RGBA", lossless=True, exact=True)
    for kw in (dict(lossless=True), dict(quality=70)):
        f = io.BytesIO()
        Image.fromarray(img).save(f, "WEBP", save_all=True, append_images=[Image.fromarray(img[::-1].copy())], **kw)
        cases[f"animation {sorted(kw)[0]} (tf refuses)"] = f.getvalue()
    for name in ("pillow lossy", "lossless m4"):
        data = cases[name]
        for cut in (len(data) - 1, len(data) // 2, 30, 12):
            cases[f"{name} cut {cut}"] = data[:cut]
    return cases


@pytest.mark.parametrize("case", list(_webp_cases()))
def test_webp_containers_match_both_references(case):
    """VP8L with its transforms, the VP8X container, ALPH, animations'
    first frames; TensorFlow refuses alpha and animations at channels=3."""
    _held(_webp_cases()[case], WEBP_DECODERS)


def test_webp_native_matches_plain_on_a_larger_frame():
    img = _image(150, 190, seed=4)
    for data in (libwebp_encode(img, 50, filter_type=0), libwebp_encode(img, 80, partitions=1),
                 pillow_save(img, "WEBP", lossless=True)):
        assert np.array_equal(webp.decode(data, "tf", webp_host.NATIVE), webp.decode(data, "tf", webp_host.PLAIN))


# --------------------------------------------------------------------------- #
# JPEG: arithmetic coding, samplings, CMYK and YCCK, refusals
# --------------------------------------------------------------------------- #

JPEG_DECODERS = {"native": lambda d, f: jpeg.decode(d, "ifast" if f == "tf" else "islow", jpeg_host.NATIVE),
                 "plain": lambda d, f: jpeg.decode(d, "ifast" if f == "tf" else "islow", jpeg_host.PLAIN)}


def _patched_sof(data: bytes, offset: int, value: int) -> bytes:
    b = bytearray(data)
    i = b.index(b"\xff\xc0")
    b[i + offset] = value
    return bytes(b)


def _jpeg_cases():
    from PIL import Image

    img = _image(37, 53)
    cmyk = np.dstack([img, np.random.default_rng(11).integers(0, 256, img.shape[:2], np.uint8)])
    cases = {f"sampling {s}": jpeg.encode(img, 90, s) for s in ("4:1:1", "3x1", "4:4:0", "4:2:2")}
    cases["sampling h1v2 chroma over h2v2"] = jpeg.encode(img, 90, sampling=[(1, 1), (1, 2), (2, 2)])
    cases["sampling 4 x 2"] = jpeg.encode(img, 90, sampling=[(4, 2), (1, 1), (1, 1)])
    cases["sampling 1 x 4"] = jpeg.encode(img, 90, sampling=[(1, 4), (1, 1), (1, 1)])
    for prog in (False, True):
        for ri in (0, 3):
            cases[f"arithmetic progressive={prog} restart={ri}"] = jpeg.encode(img, 85, progressive=prog,
                                                                             restart_interval=ri, arithmetic=True)
    cases["arithmetic grey"] = jpeg.encode(img[..., 0], 85, arithmetic=True)
    cases["arithmetic conditioning"] = jpeg.encode(img, 60, arithmetic=True,
                                                   conditioning=bytes([0x00, 0x21, 0x10, 0x02, 0x01, 0x10, 0x11, 40]))
    cases["arithmetic progressive conditioning"] = jpeg.encode(img, 60, progressive=True, arithmetic=True,
                                                               conditioning=bytes([0x00, 0x32, 0x10, 0x09]))
    cases["cmyk adobe"] = jpeg.encode(cmyk, 90, colorspace="cmyk")
    cases["cmyk without adobe"] = jpeg.encode(cmyk, 90, colorspace="cmyk", adobe=-1)
    cases["ycck"] = jpeg.encode(cmyk, 90, colorspace="ycck")
    cases["ycck 4:2:0"] = jpeg.encode(cmyk, 90, colorspace="ycck", sampling=[(2, 2), (1, 1), (1, 1), (2, 2)])
    cases["ycck arithmetic"] = jpeg.encode(cmyk, 90, colorspace="ycck", arithmetic=True)
    cases["pillow cmyk"] = pillow_save(np.asarray(Image.fromarray(img).convert("CMYK")), "JPEG", mode="CMYK",
                                       quality=90)
    arith = cases["arithmetic progressive=False restart=0"]
    cases.update({f"arithmetic cut {c}": arith[:c] for c in (len(arith) - 1, len(arith) - 2, len(arith) // 2)})
    for kw in (dict(), dict(predictor=4, restart_rows=2), dict(predictor=7, point_transform=2),
               dict(predictor=6, interleaved=False, restart_rows=3), dict(predictor=5, sampling=[(2, 2), (1, 1), (1, 1)]),
               dict(sampling=[(2, 1), (1, 1), (1, 1)], interleaved=False), dict(marker="none"),
               dict(marker="jfif")):
        name = " ".join(f"{k}={v}" for k, v in kw.items()) or "default"
        cases[f"lossless {name} (tf refuses)"] = jpeg.encode_lossless(img, **kw)
    cases["lossless grey (tf refuses)"] = jpeg.encode_lossless(img[..., 0], predictor=3, restart_rows=4)
    base = jpeg.encode(img, 85)
    cases["12-bit (refused)"] = _patched_sof(base, 4, 12)
    cases["lossless (refused)"] = _patched_sof(base, 1, 0xC3)
    cases["hierarchical (refused)"] = _patched_sof(base, 1, 0xC5)
    cases["fractional sampling (refused)"] = _patched_sof(jpeg.encode(img, 90, "3x1"), 14, 0x21)
    return cases


@pytest.mark.parametrize("case", list(_jpeg_cases()))
def test_jpeg_variants_match_both_references(case):
    """Arithmetic-coded sequential and progressive frames (the port's own
    encoder writes them), 4:1:1, 3 x 1 and other integral samplings, CMYK
    and YCCK with and without the Adobe marker; lossless frames, which
    Pillow reads (every predictor, restarts, point transforms, samplings
    repeated, one scan a component; a JFIF one, YCbCr, refused) and
    TensorFlow refuses; 12-bit, hierarchical and fractional streams refused
    as both refuse them."""
    _held(_jpeg_cases()[case], JPEG_DECODERS)


# --------------------------------------------------------------------------- #
# the two entries, and the golden streams
# --------------------------------------------------------------------------- #


def test_decode_image_and_the_vlm_loader_read_every_format(tmp_path):
    """transforms.decode_image (TensorFlow's pixels) and the VLM loader
    (Pillow's) dispatch on the signature; JPEG XL and unknown streams
    raise citing item 2 (a JPEG 2000 stream, which Pillow reads, in the VLM
    path)."""
    from mla_tpu_torch.vla.rlds import transforms

    img = _image(21, 34)
    streams = {"png": png.encode(img), "jpeg": jpeg.encode(img), "gif": pillow_save(img, "GIF"),
               "bmp": pillow_save(img, "BMP"), "webp": pillow_save(img, "WEBP", quality=80),
               "webp-lossless": pillow_save(img, "WEBP", lossless=True)}
    for name, data in streams.items():
        assert frames.format_of(data) == name.split("-")[0]
        assert np.array_equal(transforms.decode_image(data), tf_decode(data)), name
        (tmp_path / name).write_bytes(data)
        assert np.array_equal(vlm_datasets._load_image(tmp_path, name), pillow_decode(data)), name
    with pytest.raises(NotImplementedError, match=r"JPEG XL.*item 2"):
        transforms.decode_image(b"\x00\x00\x00\x0cJXL \r\n\x87\n" + bytes(20))
    with pytest.raises(ValueError, match=r"unknown format.*item 2"):
        frames.decode(b"\x00" * 16, "pillow")
    (tmp_path / "t.jp2").write_bytes(pillow_save(img, "JPEG2000"))
    with pytest.raises(NotImplementedError, match=r"item 2"):
        vlm_datasets._load_image(tmp_path, "t.jp2")


def test_golden_streams_hold_their_digests():
    """tests/data/frames/: each stream's recorded TensorFlow and Pillow
    digests are the references' on this box and the port's, from the C++
    loops and (but for the larger timing frames) the plain ones; the whole
    set stays under 200 KB."""
    index = json.loads((FRAMES / "digests.json").read_text())
    total = 0
    for name, want in index.items():
        data = (FRAMES / name).read_bytes()
        total += len(data)
        for flavour in ("tf", "pillow"):
            loops = (False,) if want.get("timing") else (False, True)
            if want[flavour] is None:  # the reference refuses it
                assert _reference(flavour, data) is None, (name, flavour)
                for plain in loops:
                    with pytest.raises((ValueError, NotImplementedError)):
                        frames.decode(data, flavour, plain=plain)
                continue
            assert frames.digest(REFS[flavour](data)) == want[flavour], (name, flavour)
            for plain in loops:
                assert frames.digest(frames.decode(data, flavour, plain=plain)) == want[flavour], (name, flavour)
    assert len(index) >= 8 and total < 200_000
