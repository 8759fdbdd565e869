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
