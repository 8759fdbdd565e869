"""Shared fixtures of the frame-format tests (tests/test_torch_frame_formats.py
and tests/data/frames/make_frames.py): the two references the port's
decoders are held to, TensorFlow's decode_image(channels=3,
expand_animations=False) and Pillow's convert("RGB"), and a writer of lossy
WebP with the encoder settings Pillow does not expose (the simple loop
filter, sharpness, token partitions, segments), through the libwebp that
Pillow bundles."""

import ctypes
import glob
import io
import os

import numpy as np

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")


def tf_decode(data: bytes) -> np.ndarray:
    import tensorflow as tf

    return tf.io.decode_image(data, channels=3, expand_animations=False, dtype=tf.uint8).numpy()


def pillow_decode(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def pillow_save(img: np.ndarray, fmt: str, mode=None, **kw) -> bytes:
    from PIL import Image

    im = Image.fromarray(img) if mode is None else Image.fromarray(img, mode)
    f = io.BytesIO()
    im.save(f, fmt, **kw)
    return f.getvalue()


class _Config(ctypes.Structure):
    _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR") else ctypes.c_int) for n in (
        "lossless", "quality", "method", "image_hint", "target_size", "target_PSNR", "segments", "sns_strength",
        "filter_strength", "filter_sharpness", "filter_type", "autofilter", "alpha_compression", "alpha_filtering",
        "alpha_quality", "pass_", "show_compressed", "preprocessing", "partitions", "partition_limit",
        "emulate_jpeg_size", "thread_level", "low_memory", "near_lossless", "exact", "use_delta_palette",
        "use_sharp_yuv", "qmin", "qmax")]


class _Picture(ctypes.Structure):
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int), ("width", ctypes.c_int),
                ("height", ctypes.c_int), ("y", ctypes.c_void_p), ("u", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int), ("a", ctypes.c_void_p),
                ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2), ("argb", ctypes.c_void_p),
                ("argb_stride", ctypes.c_int), ("pad2", ctypes.c_uint32 * 3), ("writer", ctypes.c_void_p),
                ("custom_ptr", ctypes.c_void_p), ("extra_info_type", ctypes.c_int), ("extra_info", ctypes.c_void_p),
                ("stats", ctypes.c_void_p), ("error_code", ctypes.c_int), ("progress_hook", ctypes.c_void_p),
                ("user_data", ctypes.c_void_p), ("pad3", ctypes.c_uint32 * 3), ("pad4", ctypes.c_void_p),
                ("pad5", ctypes.c_void_p), ("pad6", ctypes.c_uint32 * 8), ("memory_", ctypes.c_void_p),
                ("memory_argb_", ctypes.c_void_p), ("pad7", ctypes.c_void_p * 2)]


class _Writer(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                ("pad", ctypes.c_uint32)]


def _libwebp():
    import PIL

    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
    for dep in glob.glob(os.path.join(libs, "libsharpyuv-*.so*")):  # libwebp's own dependency
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libwebp-*.so*"))[0])
    p = ctypes.c_void_p
    lib.WebPConfigInitInternal.argtypes = [p, ctypes.c_int, ctypes.c_float, ctypes.c_int]
    lib.WebPPictureInitInternal.argtypes = [p, ctypes.c_int]
    lib.WebPPictureImportRGB.argtypes = [p, p, ctypes.c_int]
    for name in ("WebPValidateConfig", "WebPPictureFree", "WebPMemoryWriterInit", "WebPMemoryWriterClear"):
        getattr(lib, name).argtypes = [p]
    lib.WebPEncode.argtypes = [p, p]
    return lib


def libwebp_encode(img: np.ndarray, quality: float = 75, **settings) -> bytes:
    """uint8 [H, W, 3] -> a lossy WebP (RIFF + VP8) by libwebp's advanced
    API, with WebPConfig fields `settings` (filter_type 0 = simple,
    filter_sharpness, filter_strength, partitions, segments, ...)."""
    lib = _libwebp()
    cfg, pic, wr = _Config(), _Picture(), _Writer()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, quality, 0x020F):
        raise RuntimeError("WebPConfigInit failed")
    for k, v in settings.items():
        setattr(cfg, k, v)
    if not lib.WebPValidateConfig(ctypes.byref(cfg)):
        raise ValueError(f"libwebp refuses {settings}")
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), 0x020F):
        raise RuntimeError("WebPPictureInit failed")
    img = np.ascontiguousarray(img, np.uint8)
    pic.width, pic.height = img.shape[1], img.shape[0]
    lib.WebPMemoryWriterInit(ctypes.byref(wr))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    pic.custom_ptr = ctypes.addressof(wr)
    try:
        if not lib.WebPPictureImportRGB(ctypes.byref(pic), img.ctypes.data, img.shape[1] * 3):
            raise RuntimeError("WebPPictureImportRGB failed")
        if not lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode failed: {pic.error_code}")
        return ctypes.string_at(wr.mem, wr.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(wr))


# --------------------------------------------------------------------------- #
# a TIFF writer for the layouts Pillow does not write
# --------------------------------------------------------------------------- #

_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def tiff_lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (compression 5): a clear code first and whenever the table
    fills, codes MSB first, one bit wider whenever the next free entry
    reaches a power of two (the decoder, one entry behind, widens one code
    early), the end code last."""
    codes, table, nxt, bits, cur = [(256, 9)], {}, 258, 9, None
    for b in data:
        if cur is None:
            cur = b
            continue
        key = (cur, b)
        if key in table:
            cur = table[key]
            continue
        codes.append((cur, bits))
        table[key] = nxt
        nxt += 1
        if nxt == 1 << bits and bits < 12:
            bits += 1
        if nxt == 4094:
            codes.append((256, bits))
            table, nxt, bits = {}, 258, 9
        cur = b
    if cur is not None:
        codes.append((cur, bits))
    codes.append((257, bits))
    acc = n = 0
    out = bytearray()
    for code, k in codes:
        acc = (acc << k) | code
        n += k
        while n >= 8:
            n -= 8
            out.append((acc >> n) & 0xFF)
    if n:
        out.append((acc << (8 - n)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < len(data) and j - i < 128 and not (j + 1 < len(data) and data[j + 1] == data[j]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _tiff_rows(px: np.ndarray, bits: int, end: str, fmt: int) -> np.ndarray:
    """Samples [h, w, spp] -> byte rows [h, row bytes] in the file's order."""
    h, w, spp = px.shape
    if bits < 8:
        v = px.reshape(h, w * spp).astype(np.uint8)
        b = (v[..., None] >> np.arange(bits - 1, -1, -1, dtype=np.uint8)) & 1
        return np.packbits(b.reshape(h, -1), axis=1)
    kind = {1: "u", 2: "i", 3: "f"}[fmt]
    return px.astype(f"{end}{kind}{bits // 8}").reshape(h, -1).view(np.uint8)


def _tiff_predicted(px: np.ndarray, predictor: int, bits: int, end: str, fmt: int) -> np.ndarray:
    """The rows of px [h, w, spp] after the forward predictor."""
    h, w, spp = px.shape
    if predictor == 2:
        dt = np.dtype(f"u{bits // 8}")
        v = px.astype(f"{'i' if fmt == 2 else 'u'}{bits // 8}").view(dt)
        d = v.copy()
        d[:, 1:] = v[:, 1:] - v[:, :-1]
        return _tiff_rows(d, bits, end, 1)
    nb = bits // 8
    be = px.astype(f">f{nb}").reshape(h, -1).view(np.uint8).reshape(h, w * spp, nb)
    planes = np.ascontiguousarray(be.transpose(0, 2, 1)).reshape(h, -1)
    d = planes.copy()
    d[:, spp:] = planes[:, spp:] - planes[:, :-spp]
    return d


def tiff_encode(px: np.ndarray, photometric: int, bits: int = 8, *, order: str = "II", compression: int = 1,
                rows_per_strip: int = 0, tile=None, planar: int = 1, predictor: int = 1, fill_order: int = 1,
                sample_format: int = 1, extra=None, colormap=None, tags=None) -> bytes:
    """Samples px [H, W, spp] (uint, int or float) -> a one-page TIFF of
    `order` ("II" or "MM") with `compression` 1, 5 (LZW), 8 (Deflate),
    32773 (PackBits) or 34925 (LZMA); strips of `rows_per_strip` rows (0:
    one strip) or tiles `tile` = (width, length); planar 1 or 2; Predictor
    `predictor`; FillOrder `fill_order` (the stored bits reversed);
    ExtraSamples `extra`, a ColorMap and any more `tags` ({tag: (type,
    values)})."""
    import lzma
    import struct
    import zlib

    px = np.asarray(px)
    if px.ndim == 2:
        px = px[..., None]
    H, W, spp = px.shape
    end = "<" if order == "II" else ">"
    pw, ph = tile if tile else (W, rows_per_strip or H)
    pieces = []
    planes = [px[..., i:i + 1] for i in range(spp)] if planar == 2 else [px]
    for plane in planes:
        for y in range(0, H, ph):
            for x in range(0, W, pw):
                part = plane[y:y + ph, x:x + pw]
                if tile:  # a tile is whole: the edge ones padded
                    part = np.pad(part, ((0, ph - part.shape[0]), (0, pw - part.shape[1]), (0, 0)))
                rows = (_tiff_predicted(part, predictor, bits, end, sample_format) if predictor != 1
                        else _tiff_rows(part, bits, end, sample_format))
                raw = rows.tobytes()
                blob = {1: lambda b: b, 5: tiff_lzw_encode, 8: zlib.compress, 32773: packbits_encode,
                        34925: lzma.compress}[compression](raw)
                if fill_order == 2:
                    blob = _REVERSED[np.frombuffer(blob, np.uint8)].tobytes()
                pieces.append(blob)
    entries = {256: (4, [W]), 257: (4, [H]), 258: (3, [bits] * spp), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if sample_format != 1:
        entries[339] = (3, [sample_format] * spp)
    if extra:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, list(np.asarray(colormap, np.int64).T.reshape(-1)))
    entries.update(tags or {})
    data = bytearray(b"II*\x00" if order == "II" else b"MM\x00*") + bytes(4)
    offsets = []
    for blob in pieces:
        offsets.append(len(data))
        data += blob + bytes(len(blob) & 1)
    counts = [len(b) for b in pieces]
    if tile:
        entries.update({322: (3, [pw]), 323: (3, [ph]), 324: (4, offsets), 325: (4, counts)})
    else:
        entries.update({273: (4, offsets), 278: (4, [ph]), 279: (4, counts)})
    fmt = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 7: "B", 11: "f", 12: "d"}
    ifd_at = len(data)
    ext = bytearray()
    ifd = struct.pack(end + "H", len(entries))
    ext_at = ifd_at + 2 + 12 * len(entries) + 4
    for tag in sorted(entries):
        typ, vals = entries[tag]
        vals = list(vals)
        body = struct.pack(end + fmt[typ] * len(vals), *vals)
        count = len(vals) // 2 if typ == 5 else len(vals)
        if len(body) <= 4:
            ifd += struct.pack(end + "HHI", tag, typ, count) + body + bytes(4 - len(body))
        else:
            ifd += struct.pack(end + "HHII", tag, typ, count, ext_at + len(ext))
            ext += body + bytes(len(body) & 1)
    data += ifd + bytes(4) + ext
    struct.pack_into(end + "I", data, 4, ifd_at)
    return bytes(data)


# --------------------------------------------------------------------------- #
# the VLM loader's reference
# --------------------------------------------------------------------------- #


def held_to_jax_loader(data: bytes, directory, name: str = "image") -> None:
    """The port's VLM loader (vla/vlm_datasets._load_image, the C++ loops)
    and frames.decode's plain loops give the pixels of JAX's loader
    (mla_tpu.vla.vlm_datasets._load_image: Pillow's convert("RGB") of the
    file), and Pillow's of the same bytes in memory where those agree (for a
    PCX shorter than 769 bytes they do not: a file cannot seek back past its
    start, a buffer can); where JAX's loader refuses the stream, both
    raise. TensorFlow's flavour refuses every format TensorFlow does not
    sniff."""
    import pytest
    from mla_tpu.vla import vlm_datasets as jvlm

    from mla_tpu_torch.vla import vlm_datasets as tvlm
    from mla_tpu_torch.vla.rlds import frames

    path = os.path.join(str(directory), name)
    with open(path, "wb") as f:
        f.write(data)
    try:
        want = jvlm._load_image(directory, name)
    except Exception:  # noqa: BLE001 - Pillow's OSError, SyntaxError, ValueError and kin
        want = None
    try:
        in_memory = pillow_decode(data)
    except Exception:  # noqa: BLE001
        in_memory = None
    if want is None:
        with pytest.raises((ValueError, NotImplementedError)):
            tvlm._load_image(directory, name)
        with pytest.raises((ValueError, NotImplementedError)):
            frames.decode(data, "pillow", plain=True)
    else:
        for got in (tvlm._load_image(directory, name), frames.decode(data, "pillow", plain=True)):
            assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
            assert np.array_equal(got, want)
        assert in_memory is None or np.array_equal(in_memory, want)
    if frames.format_of(data) not in frames.TF_FORMATS:
        with pytest.raises((ValueError, NotImplementedError)):
            frames.decode(data, "tf")
