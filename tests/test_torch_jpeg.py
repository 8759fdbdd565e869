"""The port's JPEG decoder (mla_tpu_torch/vla/rlds/jpeg.py and its host loops,
native/jpeg_host.py) against the two decoders of the JAX package:
tf.io.decode_image (the RLDS pipeline, libjpeg-turbo's fast integer IDCT)
with dct="ifast", and Pillow's convert("RGB") (the VLM stage, the accurate
integer IDCT) with dct="islow". Both the C++ loops (NATIVE) and their plain
versions (PLAIN) are held to each reference bit for bit: the tolerance is
zero everywhere in this file.

Streams come from TensorFlow's encode_jpeg (qualities 10..100, 4:2:0 and
4:4:4, baseline and progressive, optimize_size), Pillow (4:2:2,
progressive, grey), OpenCV (restart intervals, 4:4:0) and the port's own
encoder, at sizes from 1 x 1 to 480 x 640. The refusals (arithmetic
coding, 12-bit samples, CMYK, 4:1:1, truncated streams) raise, and the
golden digests of chip_smoke.py are recomputed here."""

import hashlib
import io
import sys
from pathlib import Path

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from mla_tpu_torch.native import jpeg_host  # noqa: E402
from mla_tpu_torch.vla.rlds import jpeg  # noqa: E402
from mla_tpu_torch.vla.rlds import transforms as tT  # noqa: E402

ROADMAP = r"ROADMAP\.md queue 1, item 2"
SIZES = ((1, 1), (7, 9), (97, 131), (256, 320), (480, 640))


def frame(h, w, seed=0, noise=6.0):
    """A gradient with noise: every block has AC energy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    base = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1), (xx * 3 + yy * 2) % 256], -1)
    return np.clip(base + rng.normal(0, noise, (h, w, 3)), 0, 255).astype(np.uint8)


def tf_decode(data):
    return tf.io.decode_image(data, channels=3, expand_animations=False).numpy()


def pil_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def pil_encode(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def cv2_encode(img, *params):
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]), list(params))
    assert ok
    return enc.tobytes()


def _streams():
    """(id, factory) for every stream the parity tests decode."""
    out = []
    for q in (10, 50, 75, 95, 100):
        for sub in ("420", "444"):
            for prog in (False, True):
                out.append((f"tf-q{q}-{sub}-{'prog' if prog else 'base'}",
                            lambda q=q, sub=sub, prog=prog: tf.io.encode_jpeg(
                                frame(97, 131, q), quality=q, chroma_downsampling=sub == "420",
                                progressive=prog).numpy()))
    for h, w in SIZES:
        s = f"{h}x{w}"
        out += [
            (f"tf-{s}", lambda h=h, w=w: tf.io.encode_jpeg(frame(h, w, 1), quality=95).numpy()),
            (f"tf-{s}-prog-optimized", lambda h=h, w=w: tf.io.encode_jpeg(
                frame(h, w, 2), quality=90, progressive=True, optimize_size=True).numpy()),
            (f"pil-{s}-422", lambda h=h, w=w: pil_encode(frame(h, w, 3), quality=90, subsampling=1)),
            (f"pil-{s}-prog", lambda h=h, w=w: pil_encode(frame(h, w, 4), quality=85, progressive=True)),
            (f"pil-{s}-grey", lambda h=h, w=w: pil_encode(frame(h, w, 5)[..., 1], quality=85)),
            (f"cv2-{s}-rst", lambda h=h, w=w: cv2_encode(frame(h, w, 6), cv2.IMWRITE_JPEG_QUALITY, 90,
                                                         cv2.IMWRITE_JPEG_RST_INTERVAL, 3)),
            (f"cv2-{s}-440", lambda h=h, w=w: cv2_encode(frame(h, w, 7), cv2.IMWRITE_JPEG_QUALITY, 90,
                                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)),
        ]
    out.append(("tf-noise-q100-444", lambda: tf.io.encode_jpeg(
        np.random.default_rng(8).integers(0, 256, (64, 64, 3), dtype=np.uint8), quality=100,
        chroma_downsampling=False).numpy()))
    return out


STREAMS = _streams()


@pytest.fixture(scope="module")
def streams():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = dict(STREAMS)[name]()
        return cache[name]

    return get


@pytest.mark.parametrize("name", [n for n, _ in STREAMS])
def test_decode_matches_tensorflow_and_pillow(streams, name):
    """ifast == tf.io.decode_image, islow == Pillow's convert("RGB"), each
    through the C++ loops and through their plain versions, exactly."""
    data = streams(name)
    for dct, want in (("ifast", tf_decode(data)), ("islow", pil_decode(data))):
        for host in (jpeg_host.NATIVE, jpeg_host.PLAIN):
            got = jpeg.decode(data, dct, host)
            assert got.dtype == np.uint8 and got.shape == want.shape, (dct, got.shape, want.shape)
            assert np.array_equal(got, want), (dct, host is jpeg_host.PLAIN, int((got != want).sum()))


def test_the_two_references_part():
    """Why two IDCTs: TensorFlow's and Pillow's pixels differ on a q95
    stream, and TensorFlow's are its INTEGER_FAST decode."""
    data = tf.io.encode_jpeg(frame(96, 128), quality=95).numpy()
    t, p = tf_decode(data), pil_decode(data)
    assert (t != p).mean() > 0.1
    assert np.array_equal(t, tf.io.decode_jpeg(data, channels=3, dct_method="INTEGER_FAST").numpy())
    assert np.array_equal(p, tf.io.decode_jpeg(data, channels=3, dct_method="INTEGER_ACCURATE").numpy())


@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4"])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("size", [(1, 1), (7, 9), (97, 131), (256, 320)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_port_encoder_streams_decode_alike(size, sub, progressive, restart):
    """The fixture writer's streams: TensorFlow and Pillow decode them, and
    the port's decode equals each (C++ and plain)."""
    data = jpeg.encode(frame(*size, seed=9), 95, sub, progressive, restart)
    for dct, want in (("ifast", tf_decode(data)), ("islow", pil_decode(data))):
        assert want.shape == (*size, 3)
        for host in (jpeg_host.NATIVE, jpeg_host.PLAIN):
            assert np.array_equal(jpeg.decode(data, dct, host), want), (dct, host is jpeg_host.PLAIN)


@pytest.mark.parametrize("quality", [1, 10, 50, 100])
def test_port_encoder_quality_and_grey(quality):
    img = frame(33, 47, seed=quality)
    for data in (jpeg.encode(img, quality), jpeg.encode(img[..., 0], quality)):
        assert np.array_equal(jpeg.decode(data, "ifast"), tf_decode(data))
        assert np.array_equal(jpeg.decode(data, "islow"), pil_decode(data))


def test_encoder_uses_the_standard_tables():
    """Annex K's Huffman tables, as Pillow writes them without optimizing,
    and the IJG quality scaling of its quantization tables."""
    pil = pil_encode(frame(16, 16), quality=80, subsampling=2)
    ours = jpeg.encode(frame(16, 16), 80)

    def tables(data, marker):
        """{table id byte: body} of every table in the `marker` segments."""
        out, pos = {}, 2
        while data[pos + 1] != 0xDA:
            n = (data[pos + 2] << 8) | data[pos + 3]
            body, i = data[pos + 4:pos + 2 + n], 0
            while data[pos + 1] == marker and i < len(body):
                size = 64 if marker == 0xDB else 16 + sum(body[i + 1:i + 17])
                out[body[i]] = body[i + 1:i + 1 + size]
                i += 1 + size
            pos += 2 + n
        return out

    for marker in (0xC4, 0xDB):
        assert tables(ours, marker) == tables(pil, marker) and len(tables(ours, marker)) in (2, 4)


def test_digests_of_chip_smoke_are_tensorflows_and_pillows():
    """chip_smoke.py's golden SHA-256 digests: the streams the port's encoder
    writes, and TensorFlow's and Pillow's decodes of them."""
    streams = chip_smoke.jpeg_golden_streams()
    assert set(streams) == set(chip_smoke.JPEG_DIGESTS)
    for name, data in streams.items():
        want = chip_smoke.JPEG_DIGESTS[name]
        got = {"stream": hashlib.sha256(data).hexdigest(),
               "ifast": hashlib.sha256(np.ascontiguousarray(tf_decode(data)).tobytes()).hexdigest(),
               "islow": hashlib.sha256(np.ascontiguousarray(pil_decode(data)).tobytes()).hexdigest()}
        assert got == want, name


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """data with byte `offset` of the first `marker` segment's body set."""
    pos = 2
    while data[pos + 1] != marker:
        pos += 2 + ((data[pos + 2] << 8) | data[pos + 3])
    b = bytearray(data)
    b[pos + 4 + offset] = value
    return bytes(b)


def _sof_marker(data: bytes, marker: int) -> bytes:
    pos = 2
    while data[pos + 1] not in (0xC0, 0xC1, 0xC2):
        pos += 2 + ((data[pos + 2] << 8) | data[pos + 3])
    b = bytearray(data)
    b[pos + 1] = marker
    return bytes(b)


@pytest.mark.parametrize("what,make", [
    ("arithmetic", lambda d: jpeg.encode(frame(16, 16), 90, arithmetic=True)),
    ("progressive arithmetic", lambda d: jpeg.encode(frame(16, 16), 90, progressive=True, arithmetic=True)),
    ("lossless", lambda d: _sof_marker(d, 0xC3)),
    ("12-bit", lambda d: _patched(d, 0xC0, 0, 12)),
    ("cmyk", lambda d: _cmyk()),
    ("4:1:1", lambda d: cv2_encode(frame(16, 32), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)),
])
def test_unsupported_streams_raise_citing_the_roadmap(what, make):
    """(The name is the test's from before the port decoded these.) Each
    variant decodes to TensorFlow's pixels where TensorFlow decodes it
    (arithmetic coding, CMYK, 4:1:1), and raises ValueError where it
    refuses it (lossless, 12-bit), with both sets of host loops; the
    patched lossless stream, whose scan is not a lossless one, raises with
    Pillow's flavour too, as Pillow refuses it."""
    data = make(tf.io.encode_jpeg(frame(16, 16), quality=90).numpy())
    try:
        want = tf_decode(data)
    except tf.errors.InvalidArgumentError:
        want = None
    for host in (jpeg_host.NATIVE, jpeg_host.PLAIN):
        if want is None:
            with pytest.raises(ValueError, match="refused by libjpeg-turbo"):
                jpeg.decode(data, "ifast", host)
        else:
            assert np.array_equal(jpeg.decode(data, "ifast", host), want), what
    if what == "lossless":
        with pytest.raises(OSError):
            pil_decode(data)
        with pytest.raises(ValueError, match="lossless scan parameters"):
            jpeg.decode(data, "islow")


def _cmyk() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(frame(16, 16)).convert("CMYK").save(buf, "JPEG", quality=90)
    return buf.getvalue()


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("cut", [3, 5, 100, -1])
def test_truncated_streams_raise_as_tensorflow_and_pillow_refuse(progressive, cut):
    """A cut into the scan data: TensorFlow (try_recover_truncated false)
    and Pillow refuse it, and so does the port; nothing is padded."""
    data = tf.io.encode_jpeg(frame(96, 128), quality=95, progressive=progressive).numpy()
    short = data[:len(data) // 2] if cut == -1 else data[:-cut]
    with pytest.raises(tf.errors.InvalidArgumentError):
        tf_decode(short)
    with pytest.raises(OSError):
        pil_decode(short)
    for host in (jpeg_host.NATIVE, jpeg_host.PLAIN):
        with pytest.raises(ValueError, match="corrupt JPEG data"):
            jpeg.decode(short, "ifast", host)


def _refused(decode, data) -> bool:
    try:
        decode(data)
    except (tf.errors.InvalidArgumentError, OSError):
        return True
    return False


@pytest.mark.parametrize("cut", [1, 2])
def test_a_stream_without_its_eoi_raises(cut):
    """A stream whose scan data is whole but whose EOI marker is cut (by
    one byte, the 0xD9, or by both): the port refuses it, as TensorFlow's
    decode_image and Pillow refuse it. Their libjpeg reads past the scan's
    last byte as it fills its bit buffer, and TensorFlow's memory source
    (try_recover_truncated false) and Pillow's both fail at the end of the
    data; only where that read-ahead happened to stop short of the end do
    they decode such a stream. Of the 36 streams here (baseline and
    progressive, six sizes, quality 50/75/95) that is one, baseline 96 x 128
    at quality 95, which TensorFlow decodes cut by one byte and Pillow cut
    by one or two: the port refuses that one too."""
    decoded_by = {"tensorflow": set(), "pillow": set()}
    for progressive in (False, True):
        for h, w in [(96, 128), (7, 9), (97, 131), (64, 64), (256, 320), (33, 50)]:
            for q in (50, 75, 95):
                data = tf.io.encode_jpeg(frame(h, w), quality=q, progressive=progressive).numpy()
                assert data[-2:] == b"\xff\xd9"
                short = data[:-cut]
                for name, ref in (("tensorflow", tf_decode), ("pillow", pil_decode)):
                    if not _refused(ref, short):
                        decoded_by[name].add((progressive, h, w, q))
                for host in (jpeg_host.NATIVE, jpeg_host.PLAIN):
                    with pytest.raises(ValueError, match="before the EOI marker"):
                        jpeg.decode(short, "ifast", host)
    lucky = {(False, 96, 128, 95)}
    assert decoded_by == {"tensorflow": lucky if cut == 1 else set(), "pillow": lucky}


def test_not_a_jpeg_raises():
    with pytest.raises(ValueError, match="no SOI"):
        jpeg.decode(b"\x89PNG\r\n\x1a\n" + bytes(30))
    with pytest.raises(ValueError, match="dct"):
        jpeg.decode(jpeg.encode(frame(8, 8)), "float")


def test_decode_image_dispatches_on_the_signature():
    """transforms.decode_image decodes as tf.io.decode_image does: PNG,
    JPEG with the fast IDCT, and since GIF, BMP and WebP (a corrupt GIF
    raises as a GIF); an unknown format raises."""
    from mla_tpu_torch.vla.rlds import png

    img = frame(24, 40)
    data = jpeg.encode(img, 90)
    assert np.array_equal(tT.decode_image(data), tf_decode(data))
    assert np.array_equal(tT.decode_image(png.encode(img)), img)
    with pytest.raises(ValueError, match="corrupt GIF data"):
        tT.decode_image(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="unknown format"):
        tT.decode_image(b"\x00" * 20)


# --------------------------------------------------------------------------- #
# each host loop against its plain version, on random inputs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("method", [jpeg_host.IFAST, jpeg_host.ISLOW])
@pytest.mark.parametrize("scale", [8, 300, 2047])
def test_idct_matches_its_plain_version(method, scale):
    """Random coefficients (a quarter of the blocks DC only) and tables,
    large enough to reach the range limit's wrap: equal bytes."""
    rng = np.random.default_rng(scale + method)
    coef = rng.integers(-scale, scale + 1, (5, 7, 64)).astype(np.int16)
    coef[::2, ::2, 1:] = 0
    qt = rng.integers(1, 256 if scale < 2047 else 4, 64).astype(np.uint16)
    assert np.array_equal(jpeg_host.idct(coef, qt, method), jpeg_host.idct_plain(coef, qt, method))


@pytest.mark.parametrize("hf,vf", [(1, 1), (2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("cw,ch", [(1, 1), (2, 3), (3, 2), (17, 9)])
def test_upsample_matches_its_plain_version(hf, vf, cw, ch):
    rng = np.random.default_rng(cw * 10 + ch)
    plane = rng.integers(0, 256, (ch + 5, cw + 3)).astype(np.uint8)
    for out_w, out_h in ((cw * hf, ch * vf), (max(cw * hf - 1, 1), max(ch * vf - 1, 1))):
        assert np.array_equal(jpeg_host.upsample(plane, cw, ch, hf, vf, out_w, out_h),
                              jpeg_host.upsample_plain(plane, cw, ch, hf, vf, out_w, out_h))


def test_ycc_to_rgb_matches_its_plain_version():
    y, cb, cr = np.meshgrid(np.arange(0, 256, 5), np.arange(256), np.arange(0, 256, 3), indexing="ij")
    y, cb, cr = (a.astype(np.uint8).reshape(-1, 52) for a in (y, cb, cr))
    assert np.array_equal(jpeg_host.ycc_to_rgb(y, cb, cr), jpeg_host.ycc_to_rgb_plain(y, cb, cr))


def test_host_loops_check_their_arguments():
    with pytest.raises(ValueError):
        jpeg_host.idct(np.zeros((2, 2, 63), np.int16), np.ones(64, np.uint16), 0)
    with pytest.raises(ValueError):
        jpeg_host.upsample(np.zeros((4, 4), np.uint8), 4, 4, 5, 1, 20, 4)  # no sampling factor is above 4
    with pytest.raises(ValueError):
        jpeg_host.ycc_to_rgb(np.zeros((2, 2), np.uint8), np.zeros((2, 3), np.uint8), np.zeros((2, 2), np.uint8))
