"""TIFF through the port's VLM loader (mla_tpu_torch/vla/rlds/tiff.py and
the host loops of native/rlds_host.py), against JAX's loader
(mla_tpu.vla.vlm_datasets._load_image, Pillow's convert("RGB")): every mode
Pillow writes under every compression it writes, the layouts Pillow does
not write (tiles, planar 2, Predictor 3, big-endian, associated alpha,
FillOrder 2, BigTIFF; tests/torch_frames.tiff_encode writes them), fax
streams of every coding, multi-page files and the Orientation tag, each
from the C++ loops and the plain ones; truncated streams and the codecs
the port does not decode are refused, as JAX's loader refuses or reads
them (TensorFlow's refusal of the new formats is checked in
test_torch_image_formats.py). Images are small, so that the whole file
runs in seconds."""

import functools
import io
import struct

import numpy as np
import pytest
from torch_frames import held_to_jax_loader, packbits_encode, tiff_encode, tiff_lzw_encode

from mla_tpu_torch.native import rlds_host
from mla_tpu_torch.vla.rlds import tiff

H, W = 11, 21


def _pillow_image(mode: str):
    from PIL import Image

    rng = np.random.default_rng(len(mode))
    yy, xx = np.mgrid[:H, :W]
    rgb = np.dstack([(xx * 12 + yy) % 256, (yy * 23) % 256, rng.integers(0, 256, (H, W))]).astype(np.uint8)
    if mode == "I;16":
        return Image.fromarray(rng.integers(0, 700, (H, W)).astype(np.uint16))
    if mode == "I":
        return Image.fromarray(rng.integers(-20, 400, (H, W)).astype(np.int32))
    if mode == "F":
        return Image.fromarray(rng.uniform(-5, 300, (H, W)).astype(np.float32))
    if mode == "RGBA":
        return Image.fromarray(np.dstack([rgb, rng.integers(0, 256, (H, W), np.uint8)]))
    return Image.fromarray(rgb).convert(mode)


def _pillow_tiff(mode: str, compression, **tags) -> bytes:
    from PIL import TiffImagePlugin

    ifd = TiffImagePlugin.ImageFileDirectory_v2()
    for k, v in tags.items():
        ifd[int(k[1:])] = v
    f = io.BytesIO()
    _pillow_image(mode).save(f, "TIFF", compression=compression, tiffinfo=ifd)
    return f.getvalue()


_BYTE_CODECS = [None, "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate", "packbits", "lzma"]
_PILLOW_CASES = [(m, c) for m in ("1", "L", "P", "RGB", "RGBA", "CMYK", "I;16", "I", "F", "LA", "YCbCr", "PA")
                 for c in _BYTE_CODECS]
_PILLOW_CASES += [(m, "jpeg") for m in ("L", "RGB", "RGBA", "CMYK", "LA", "YCbCr")]
_PILLOW_CASES += [("1", c) for c in ("tiff_ccitt", "group3", "group4")]


@pytest.mark.parametrize("mode,compression", _PILLOW_CASES, ids=[f"{m}-{c}" for m, c in _PILLOW_CASES])
def test_pillow_written_tiffs_match_jax(tmp_path, mode, compression):
    """Each mode Pillow writes under each compression it writes, as one
    strip and (but for YCbCr, whose blocks must not split) as strips of a
    few rows; Predictor 2 where libtiff takes it (8 bits and more, the byte
    codecs). I;16 clips at 255, I clips, F truncates toward zero, alpha is
    dropped, CMYK goes through Pillow's cmyk2rgb; YCbCr that is not JPEG
    goes through libtiff's RGBA interface (its default 2 x 2 blocks),
    JPEG YCbCr through libjpeg's fancy upsampling and the accurate IDCT."""
    held_to_jax_loader(_pillow_tiff(mode, compression), tmp_path, "one.tif")
    if mode != "YCbCr":
        held_to_jax_loader(_pillow_tiff(mode, compression, t278=8 if compression == "jpeg" else 4), tmp_path,
                           "strips.tif")
    if compression in ("tiff_lzw", "tiff_deflate", "lzma") and mode not in ("1", "P", "PA", "YCbCr"):
        held_to_jax_loader(_pillow_tiff(mode, compression, t317=2), tmp_path, "predicted.tif")


@functools.lru_cache(maxsize=None)
def _layout_cases():
    rng = np.random.default_rng(3)
    rgb, rgba = rng.integers(0, 256, (H, W, 3)), rng.integers(0, 256, (H, W, 4))
    grey16 = rng.integers(0, 65536, (H, W, 1))
    floats = rng.uniform(-20, 300, (H, W, 1)).astype(np.float32)
    cases = {}
    for order in ("II", "MM"):
        for comp in (1, 5, 8, 32773):
            for name, layout in (("tiles", dict(tile=(16, 16))), ("planar", dict(planar=2)),
                                 ("tiled planar", dict(tile=(16, 16), planar=2))):
                cases[f"{order} {comp} {name} rgb"] = tiff_encode(rgb, 2, order=order, compression=comp, **layout)
                cases[f"{order} {comp} {name} rgba associated"] = tiff_encode(rgba, 2, order=order,
                                                                              compression=comp, extra=[1], **layout)
            cases[f"{order} {comp} rgb16 associated"] = tiff_encode(rng.integers(0, 65536, (H, W, 4)), 2, 16,
                                                                    order=order, compression=comp, extra=[1])
            cases[f"{order} {comp} grey16"] = tiff_encode(grey16, 1, 16, order=order, compression=comp)
            cases[f"{order} {comp} int16"] = tiff_encode(rng.integers(-300, 300, (H, W, 1)), 1, 16, order=order,
                                                         compression=comp, sample_format=2)
            cases[f"{order} {comp} int32"] = tiff_encode(rng.integers(-300, 300, (H, W, 1)), 1, 32, order=order,
                                                         compression=comp, sample_format=2)
            cases[f"{order} {comp} float"] = tiff_encode(floats, 1, 32, order=order, compression=comp,
                                                         sample_format=3)
            cases[f"{order} {comp} cmyk16"] = tiff_encode(rng.integers(0, 65536, (H, W, 4)), 5, 16, order=order,
                                                          compression=comp)
        for comp in (5, 8, 34925):
            cases[f"{order} {comp} float predictor 3"] = tiff_encode(floats, 1, 32, order=order, compression=comp,
                                                                     predictor=3, sample_format=3)
            cases[f"{order} {comp} rgb16 predictor 2"] = tiff_encode(rng.integers(0, 65536, (H, W, 3)), 2, 16,
                                                                     order=order, compression=comp, predictor=2,
                                                                     tile=(16, 16))
            cases[f"{order} {comp} int32 predictor 2"] = tiff_encode(rng.integers(-9, 9, (H, W, 1)), 1, 32,
                                                                     order=order, compression=comp, predictor=2,
                                                                     sample_format=2)
    for comp in (1, 5, 32773):
        for bits, photometric in ((1, 0), (1, 1), (2, 1), (4, 0), (8, 0), (8, 2)):
            px = rng.integers(0, 1 << bits, (H, W, 3 if photometric == 2 else 1))
            cases[f"{comp} fill order 2 bits {bits} photometric {photometric}"] = tiff_encode(
                px, photometric, bits, compression=comp, fill_order=2)
        cases[f"{comp} palette 4"] = tiff_encode(rng.integers(0, 16, (H, W, 1)), 3, 4, compression=comp,
                                                 colormap=rng.integers(0, 65536, (16, 3)), tile=(16, 16))
        cases[f"{comp} rgbx tiled planar"] = tiff_encode(rgba, 2, compression=comp, extra=[0], tile=(16, 16),
                                                         planar=2)
        cases[f"{comp} rgbx planar strips"] = tiff_encode(rgba, 2, compression=comp, extra=[0], planar=2)
    ycc = rng.integers(0, 256, (H, W, 3))
    for sub in ((1, 1), (2, 1), (2, 2)):
        bw, bh = -(-W // sub[0]), -(-H // sub[1])
        blocks = rng.integers(0, 256, (bh * bw * (sub[0] * sub[1] + 2),)).astype(np.uint8)
        cases[f"ycbcr {sub}"] = tiff_encode(blocks.reshape(1, -1, 1), 6, 8, compression=5, tags={
            256: (4, [W]), 257: (4, [H]), 278: (4, [H]), 277: (3, [3]), 258: (3, [8, 8, 8]), 530: (3, list(sub)),
            532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])})
    cases["ycbcr raw (read as RGBX)"] = tiff_encode(np.concatenate([ycc, ycc[:, :, :1]], -1).reshape(H, -1, 3), 6,
                                                    tags={256: (4, [W])})
    cases["sample format 1 1 1"] = tiff_encode(rgb, 2, tags={339: (3, [1, 1, 1])})
    cases["sample format 2 2 2 (refused)"] = tiff_encode(rgb, 2, tags={339: (3, [2, 2, 2])})
    cases["extra samples 3 (refused)"] = tiff_encode(rgba, 2, extra=[3])
    cases["predictor 2 with 4 bits (refused)"] = tiff_encode(rng.integers(0, 16, (H, W, 1)), 1, 4, compression=5,
                                                            tags={317: (3, [2])})
    cases["predictor 5 (refused)"] = tiff_encode(rgb, 2, compression=5, tags={317: (3, [5])})
    return cases


@pytest.mark.parametrize("case", list(_layout_cases()))
def test_tiff_layouts_pillow_does_not_write_match_jax(tmp_path, case):
    """Tiles (edge tiles padded), planar 2 (libtiff's reader interleaves
    the planes, Pillow's own uncompressed reader takes each plane as a band
    of one letter of the raw layout), big-endian files (libtiff gives
    little-endian samples, which Pillow reads in the file's order for
    signed 16-bit, 32-bit and float samples: byte-swapped), Predictor 2 and
    3 (the float's byte planes), associated alpha (un-premultiplied),
    FillOrder 2, 2- and 4-bit samples, subsampled YCbCr with reference
    black and white, and what Pillow refuses."""
    held_to_jax_loader(_layout_cases()[case], tmp_path, "layout.tif")


@functools.lru_cache(maxsize=None)
def _other_cases():
    from PIL import Image, TiffImagePlugin

    img = _pillow_image("RGB")
    cases = {}
    f = io.BytesIO()
    img.save(f, "TIFF", big_tiff=True)
    cases["bigtiff"] = f.getvalue()
    f = io.BytesIO()
    img.save(f, "TIFF", compression="tiff_lzw", save_all=True, append_images=[img.transpose(0), img.convert("L")])
    cases["multi-page (page 0)"] = f.getvalue()
    bits = _pillow_image("1")
    for t4 in (1, 5, 4):
        ifd = TiffImagePlugin.ImageFileDirectory_v2()
        ifd[292] = t4
        f = io.BytesIO()
        bits.save(f, "TIFF", compression="group3", tiffinfo=ifd)
        cases[f"g3 t4options {t4}"] = f.getvalue()
    rng = np.random.default_rng(8)
    wide = Image.fromarray(np.repeat(rng.random((6, 40)) > 0.8, 80, axis=1))  # runs past the makeup codes' 2560
    for comp in ("tiff_ccitt", "group3", "group4"):
        f = io.BytesIO()
        wide.save(f, "TIFF", compression=comp)
        cases[f"{comp} long runs"] = f.getvalue()
    for o in range(1, 9):
        for comp in (None, "tiff_lzw"):
            cases[f"orientation {o} {comp}"] = _pillow_tiff("RGB", comp, t274=o)
        cases[f"orientation {o} ycbcr"] = _pillow_tiff("YCbCr", "tiff_lzw", t274=o)
    return cases


@pytest.mark.parametrize("case", list(_other_cases()))
def test_tiff_pages_fax_codings_and_orientation_match_jax(tmp_path, case):
    """BigTIFF, the first page of a multi-page file, T.4 2-D with and
    without fill bits, fax runs longer than the makeup codes, and every
    Orientation, which Pillow applies after loading a TIFF."""
    held_to_jax_loader(_other_cases()[case], tmp_path, "other.tif")


@pytest.mark.parametrize("name", ["RGB-tiff_lzw", "1-group4", "RGB-jpeg", "L-tiff_deflate", "CMYK-packbits",
                                  "I;16-None"])
def test_tiff_truncations_are_refused_as_jax_refuses(tmp_path, name):
    mode, comp = name.split("-")
    data = _pillow_tiff(mode, None if comp == "None" else comp)
    for cut in (len(data) // 2, len(data) - 1, 12, 6):
        held_to_jax_loader(data[:cut], tmp_path, "cut.tif")


def _patched_compression(data: bytes, value: int) -> bytes:
    """A little-endian TIFF with its Compression tag set to `value`."""
    at = struct.unpack_from("<I", data, 4)[0]
    b = bytearray(data)
    for i in range(struct.unpack_from("<H", data, at)[0]):
        entry = at + 2 + 12 * i
        if struct.unpack_from("<H", data, entry)[0] == 259:
            struct.pack_into("<H", b, entry + 8, value)
    return bytes(b)


def test_codecs_not_decoded_cite_item_2(tmp_path):
    """ZSTD (Pillow writes it; Python 3.12 has no zstd), and WebP, old-style
    JPEG and ThunderScan by their Compression tag raise NotImplementedError
    citing item 2; a compression Pillow does not know raises ValueError, as
    JAX's loader refuses it."""
    zstd = _pillow_tiff("RGB", "zstd")
    for data in (zstd, _patched_compression(zstd, 50001), _patched_compression(zstd, 6),
                 _patched_compression(zstd, 32809)):
        with pytest.raises(NotImplementedError, match=r"item 2"):
            tiff.decode(data)
    unknown = _patched_compression(zstd, 12345)
    with pytest.raises(ValueError, match="compression 12345"):
        tiff.decode(unknown)
    held_to_jax_loader(unknown, tmp_path, "unknown.tif")


def test_lzw_and_packbits_native_match_plain_and_refuse_bad_data():
    """The table's resets and the early code-width change over a long
    stream, every PackBits header kind; data cut short and a code past the
    table raise in both loops."""
    rng = np.random.default_rng(11)
    for raw in (rng.integers(0, 256, 30000, np.uint8).tobytes(), bytes(20000),
                np.repeat(rng.integers(0, 4, 3000), 7).astype(np.uint8).tobytes()):
        for encode, loops in ((tiff_lzw_encode, (rlds_host.tiff_lzw, rlds_host.tiff_lzw_plain)),
                              (packbits_encode, (rlds_host.packbits, rlds_host.packbits_plain))):
            blob = encode(raw)
            for loop in loops:
                assert loop(blob, len(raw)).tobytes() == raw
                with pytest.raises(ValueError, match="ends before"):
                    loop(blob[:len(blob) // 2], len(raw))
    for loop in (rlds_host.tiff_lzw, rlds_host.tiff_lzw_plain):
        with pytest.raises(ValueError, match="past its table"):
            loop(bytes([0x80, 0x7F, 0xFF]), 10)  # clear, then a code far past the table
    assert rlds_host.packbits(bytes([0x80, 0xFE, 7]), 3).tolist() == [7, 7, 7]  # a no-op header, then a run


def test_fax_native_matches_plain_on_random_rows():
    """Modified Huffman, T.4 1-D and 2-D, T.6 from libtiff (through Pillow)
    on noise, whose runs reach most terminating and makeup codes."""
    from PIL import Image, TiffImagePlugin

    rng = np.random.default_rng(12)
    img = Image.fromarray(rng.random((24, 300)) > rng.random((24, 1)))
    for comp, t4, kind in (("tiff_ccitt", 0, "mh"), ("group3", 0, "t4"), ("group3", 1, "t4-2d"),
                           ("group4", 0, "t6")):
        ifd = TiffImagePlugin.ImageFileDirectory_v2()
        if t4:
            ifd[292] = t4
        f = io.BytesIO()
        img.save(f, "TIFF", compression=comp, tiffinfo=ifd)
        t = Image.open(io.BytesIO(f.getvalue()))
        (off,), (cnt,) = t.tag_v2[273], t.tag_v2[279]
        blob = f.getvalue()[off:off + cnt]
        got = rlds_host.ccitt(blob, kind, 300, 24)
        assert np.array_equal(got, rlds_host.ccitt_plain(blob, kind, 300, 24))
        ones = np.unpackbits(got, axis=1)[:, :300] == 1  # the decoder's black runs; BlackIsZero shows them white
        assert np.array_equal(ones if t.tag_v2.get(262, 0) == 1 else ~ones, np.asarray(t))
        for loop in (rlds_host.ccitt, rlds_host.ccitt_plain):
            with pytest.raises(ValueError):
                loop(blob[:cnt // 3], kind, 300, 24)
