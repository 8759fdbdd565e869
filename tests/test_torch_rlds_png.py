"""The port's PNG decoder and encoder against TensorFlow's
tf.io.decode_image(channels=3) and tf.io.encode_png (libpng)."""

import struct
import zlib

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from mla_tpu_torch.vla.rlds import png  # noqa: E402


def tf_decode(data: bytes) -> np.ndarray:
    return tf.io.decode_image(data, channels=3, expand_animations=False).numpy()


def _smooth(rng, h, w, c):
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([(xx * 7 + yy * 3 + 40 * k) % 256 for k in range(c)], -1)
    return np.clip(base + rng.integers(-6, 7, (h, w, c)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["grey", "grey-alpha", "rgb", "rgba"])
def test_decode_matches_tensorflow(channels):
    """8-bit PNGs encoded by TensorFlow, smooth content and noise: the port
    decodes what libpng does with channels=3 (grey repeated, alpha
    dropped)."""
    rng = np.random.default_rng(channels)
    for h, w in ((1, 1), (17, 23), (48, 64)):
        img = _smooth(rng, h, w, channels) if h > 1 else rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
        data = tf.io.encode_png(img).numpy()
        got = png.decode(data)
        np.testing.assert_array_equal(got, tf_decode(data))
        assert got.shape == (h, w, 3) and got.dtype == np.uint8


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _raw_png(ihdr, rows: bytes, plte: bytes = b"") -> bytes:
    body = png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", *ihdr))
    if plte:
        body += _chunk(b"PLTE", plte)
    return body + _chunk(b"IDAT", zlib.compress(rows)) + _chunk(b"IEND", b"")


def test_palette_matches_tensorflow():
    """An 8-bit palette image: the palette expanded, as libpng does."""
    rng = np.random.default_rng(5)
    palette = rng.integers(0, 256, (40, 3), dtype=np.uint8)
    idx = rng.integers(0, 40, (11, 13), dtype=np.uint8)
    rows = np.concatenate([np.zeros((11, 1), np.uint8), idx], axis=1).tobytes()
    data = _raw_png((13, 11, 8, 3, 0, 0, 0), rows, palette.tobytes())
    np.testing.assert_array_equal(png.decode(data), tf_decode(data))
    np.testing.assert_array_equal(png.decode(data), palette[idx])


@pytest.mark.parametrize("filter_type", [None, 0, 1, 2, 3, 4], ids=["heuristic", "none", "sub", "up", "average",
                                                                  "paeth"])
def test_encoded_filters_round_trip(filter_type):
    """The port's encoder with each filter type forced (and its per-row
    choice): TensorFlow and the port decode the written pixels exactly."""
    img = _smooth(np.random.default_rng(7), 31, 29, 3)
    data = png.encode(img, filter_type)
    np.testing.assert_array_equal(tf_decode(data), img)
    np.testing.assert_array_equal(png.decode(data), img)
    if filter_type is not None:
        raw = zlib.decompress(data[8 + 25 + 8:-12 - 4])
        assert set(np.frombuffer(raw, np.uint8).reshape(31, -1)[:, 0]) == {filter_type}


def test_sixteen_bit_and_interlaced_raise():
    """16-bit and interlaced PNGs are refused with the ROADMAP.md item;
    a broken chunk CRC raises."""
    data16 = tf.io.encode_png(np.full((4, 5, 3), 300, np.uint16)).numpy()
    with pytest.raises(NotImplementedError, match="16-bit.*ROADMAP.md queue 1, item 2"):
        png.decode(data16)
    rows = np.zeros((4, 1 + 5 * 3), np.uint8).tobytes()
    with pytest.raises(NotImplementedError, match="interlaced.*ROADMAP.md queue 1, item 2"):
        png.decode(_raw_png((5, 4, 8, 2, 0, 0, 1), rows))
    good = png.encode(np.zeros((4, 5, 3), np.uint8))
    bad = bytearray(good)
    bad[-20] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(bad))
