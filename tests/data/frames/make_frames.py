"""Writes the golden frame streams of this directory and digests.json.

    python tests/data/frames/make_frames.py

Each stream is a small frame of one format and variant the port decodes
(vla/rlds/frames.py); the ones after WebP are formats only Pillow reads,
the VLM path's (TIFF by libtiff's LZW, Group 4 and JPEG, Netpbm, TGA,
ICO, QOI, PCX, SGI, four-component lossless JPEG). digests.json records, per stream, the SHA-256 of
TensorFlow's decode_image(channels=3, expand_animations=False) pixels
("tf") and of Pillow's convert("RGB") pixels ("pillow"), each with its
shape (frames.digest), or null where that reference refuses the stream;
"timing" marks the larger frames that chip_smoke.py times, which the
tests decode through the C++ loops only.
It needs TensorFlow and Pillow, so it runs on a development machine;
chip_smoke.py's oxe phase and tests/test_torch_frame_formats.py read what
it writes.
"""

import io
import json
import re
import struct
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from torch_frames import libwebp_encode, pillow_decode, pillow_save, tf_decode  # noqa: E402

from mla_tpu_torch.vla.rlds import bmp, frames, gif, jpeg, png  # noqa: E402


def image(h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.dstack([(xx * 3 + yy) % 256, (yy * 4) % 256, (xx * yy // 3) % 256]).astype(np.uint8)
    img[h // 4:h // 2, w // 4:w // 2] = rng.integers(0, 256, (h // 2 - h // 4, w // 2 - w // 4, 3))
    return img


def camera(h: int, w: int, noise: float = 2.0) -> np.ndarray:
    """A smooth synthetic scene: gradients, a few discs, mild noise."""
    rng = np.random.default_rng(h * w)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.dstack([120 + 80 * np.sin(3 * xx + 1), 100 + 90 * yy, 140 - 60 * np.cos(4 * xx * yy)])
    for cy, cx, r, col in ((0.3, 0.3, 0.12, (200, 40, 40)), (0.6, 0.7, 0.2, (30, 160, 60))):
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = col
    return np.clip(img + rng.normal(0, noise, img.shape), 0, 255).astype(np.uint8)


def streams():
    rng = np.random.default_rng(17)
    img = image(48, 64)
    cmyk = np.dstack([img, rng.integers(0, 256, img.shape[:2], np.uint8)])
    tab = rng.integers(0, 256, (256, 3))
    idx = rng.integers(0, 256, (40, 56)).astype(np.uint8)
    rows = img[:, :, ::-1].reshape(48, -1)  # BGR, top row first (64 pixels fill whole 4-byte words)
    return {
        "png16_adam7.png": png.encode_samples(rng.integers(0, 65536, (48, 64, 3)), 2, 16, interlace=True),
        "png_grey16.png": png.encode_samples(rng.integers(0, 1024, (48, 64, 1)), 0, 16),
        "png_palette2.png": png.encode_samples(rng.integers(0, 4, (48, 64, 1)), 3, 2,
                                               palette=rng.integers(0, 256, (4, 3))),
        "gif_offset_transparent.gif": gif.encode([idx[:30, :40]], tab, screen=(56, 40), offsets=[(9, 5)],
                                                 transparent=7),
        "gif_interlaced.gif": pillow_save(img, "GIF", interlace=True),
        "bmp_top_down.bmp": bmp.encode(rows.tobytes(), 64, 48, 24, top_down=True),
        "bmp_palette4.bmp": bmp.encode(np.packbits(((rng.integers(0, 16, (48, 64))[..., None] >> np.arange(3, -1, -1))
                                                    & 1).reshape(48, -1).astype(np.uint8), axis=1).tobytes(),
                                       64, 48, 4, rng.integers(0, 256, (16, 3))),
        "webp_simple_filter.webp": libwebp_encode(img, 60, filter_type=0),
        "webp_partitions.webp": libwebp_encode(img, 80, partitions=2, filter_sharpness=3),
        "webp_lossless.webp": pillow_save(img, "WEBP", lossless=True),
        "webp_alpha.webp": pillow_save(cmyk, "WEBP", mode="RGBA", quality=70),
        "jpeg_arith_progressive.jpg": jpeg.encode(img, 85, progressive=True, arithmetic=True, restart_interval=2),
        "jpeg_411.jpg": jpeg.encode(img, 90, "4:1:1"),
        "jpeg_ycck.jpg": jpeg.encode(cmyk, 90, colorspace="ycck"),
        "jpeg_lossless.jpg": jpeg.encode_lossless(img, predictor=5, restart_rows=2, sampling=[(2, 1), (1, 1), (1, 1)]),
        # the WebP frames chip_smoke.py times (the port writes no WebP); smooth, as camera frames are
        "webp_lossy_256x256.webp": libwebp_encode(camera(256, 256), 80),
        "webp_lossy_640x480.webp": libwebp_encode(camera(480, 640), 80),
        "webp_lossless_256x256.webp": pillow_save(camera(256, 256, 0), "WEBP", lossless=True),
        "webp_lossless_640x480.webp": pillow_save(camera(480, 640, 0), "WEBP", lossless=True),
        **pillow_only_streams(),
    }


def document(h: int, w: int) -> np.ndarray:
    """A page of text-like lines: glyphs of 7 x 5 from a small font of
    random shapes, black on white (bool, True white), as a fax or a
    document scan holds."""
    rng = np.random.default_rng(h + w)
    font = rng.random((30, 7, 5)) > 0.55
    page = np.ones((h, w), bool)
    for y in range(12, h - 12, 12):
        x = 10
        while x < w - 16:
            if rng.random() < 0.18:  # a space
                x += 5
                continue
            page[y:y + 7, x:x + 5] = ~font[rng.integers(0, 30)]
            x += 6
    return page


def tiff(img: np.ndarray, compression, mode=None, **tags) -> bytes:
    """A TIFF by Pillow (libtiff for every compression), with `tags` by number
    (t317=2: Predictor 2)."""
    from PIL import Image, TiffImagePlugin

    im = Image.fromarray(img) if mode is None else Image.fromarray(img).convert(mode)
    ifd = TiffImagePlugin.ImageFileDirectory_v2()
    for k, v in tags.items():
        ifd[int(k[1:])] = v
    f = io.BytesIO()
    im.save(f, "TIFF", compression=compression, tiffinfo=ifd)
    return f.getvalue()


def pillow_only_streams():
    """The formats only Pillow reads, each small, and the TIFF frames that
    chip_smoke.py times: LZW and Deflate, both with Predictor 2, at 256 x
    256, Group 4 and JPEG (YCbCr) at 640 x 480, the largest that fit the
    set's cap."""
    rng = np.random.default_rng(23)
    img, small = image(48, 64, 1), image(24, 32, 2)
    cmyk = np.dstack([small, rng.integers(0, 256, small.shape[:2], np.uint8)])
    grey = rng.integers(0, 1001, (24, 32))
    ico_px = np.dstack([small, rng.integers(0, 256, small.shape[:2], np.uint8)])[::-1, :, [2, 1, 0, 3]]
    mask = rng.integers(0, 256, (24, 4), np.uint8)
    dib = struct.pack("<IiiHHIIiiII", 40, 32, 48, 1, 32, 0, 0, 0, 0, 0, 0) + ico_px.tobytes() + mask.tobytes()
    ico = struct.pack("<HHHBBBBHHII", 0, 1, 1, 32, 24, 0, 0, 1, 32, len(dib), 22) + dib
    return {
        "tiff_lzw.tif": tiff(small, "tiff_lzw"),
        "tiff_g4.tif": tiff(document(48, 64), "group4"),
        "tiff_jpeg.tif": tiff(img, "jpeg", "YCbCr"),
        "netpbm_p5_maxval1000.pgm": b"P5\n# a comment\n32 24\n1000\n" + grey.astype(">u2").tobytes(),
        "tga_rle.tga": pillow_save(small, "TGA", compression="tga_rle"),
        "ico_bmp32.ico": ico,
        "qoi.qoi": pillow_save(small, "QOI"),
        "pcx.pcx": pillow_save(small, "PCX"),
        "sgi16.sgi": pillow_save(small, "SGI", bpc=2),
        "jpeg_lossless_cmyk.jpg": jpeg.encode_lossless(cmyk, predictor=6, restart_rows=3),
        "tiff_lzw_pred_256x256.tif": tiff(camera(256, 256, 0), "tiff_lzw", t317=2),
        "tiff_deflate_pred_256x256.tif": tiff(camera(256, 256, 0), "tiff_deflate", t317=2),
        "tiff_g4_640x480.tif": tiff(document(480, 640), "group4"),
        "tiff_jpeg_640x480.tif": tiff(camera(480, 640, 0), "jpeg", "YCbCr"),
    }


def main() -> None:
    index = {}
    for name, data in streams().items():
        (HERE / name).write_bytes(data)
        entry = {}
        for flavour, ref in (("tf", tf_decode), ("pillow", pillow_decode)):
            try:
                entry[flavour] = frames.digest(ref(data))
            except Exception:  # noqa: BLE001 - the reference refuses the stream
                entry[flavour] = None
        if re.search(r"_\d+x\d+\.", name):  # a timing frame, too large for the plain loops' tests
            entry["timing"] = True
        index[name] = entry
    (HERE / "digests.json").write_text(json.dumps(index, indent=1) + "\n")
    print(f"{len(index)} streams, {sum(len(d) for d in streams().values())} bytes")


if __name__ == "__main__":
    main()
