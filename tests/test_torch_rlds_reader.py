"""The port's TFDS-layout reader and writer, TFRecord framing and
tf.train.Example codec, and the host helper, against the JAX package's
reader (TensorFlow's tf.data and protobuf) on fixtures written into
tmp_path by each package's writer."""

import json
import struct

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from mla_tpu.vla.rlds import tfds_compat as jtfds  # noqa: E402
from mla_tpu_torch.native import rlds_host  # noqa: E402
from mla_tpu_torch.vla.rlds import tfds_compat as ttfds  # noqa: E402
from mla_tpu_torch.vla.rlds import transforms as tT  # noqa: E402
from test_tfds_builder import write_franka_fixture, write_rlbench_fixture  # noqa: E402


def assert_tree_equal(a, b, path=""):
    """Leaf by leaf: same keys, shapes, dtypes and values (bytes equal)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b) if isinstance(b, dict) else b)
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
        return
    x, y = np.asarray(a), np.asarray(b)
    assert x.shape == y.shape and x.dtype == y.dtype, (path, x.shape, y.shape, x.dtype, y.dtype)
    assert (x == y).all(), path


def jax_episodes(builder, split="train", shuffle_files=False):
    """JAX's reader's episodes with the nested step dataset batched to
    [T, ...] numpy arrays, as make_dataset_from_rlds flattens them."""
    out = []
    for ep in builder.as_dataset(split=split, shuffle_files=shuffle_files):
        steps = ep["steps"].batch(10**9).get_single_element()
        e = {"steps": tf.nest.map_structure(lambda t: t.numpy(), steps)}
        if "episode_metadata" in ep:
            e["episode_metadata"] = tf.nest.map_structure(lambda t: t.numpy(), ep["episode_metadata"])
        out.append(e)
    return out


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_written")
    write_rlbench_fixture(d, num_shards=2)
    write_franka_fixture(d)
    return d


@pytest.mark.parametrize("name", ["rlbench", "franka"])
def test_reader_matches_jax(jax_written, name):
    """On a directory JAX's writer wrote (rlbench in 2 shards), the port's
    reader yields JAX's episodes leaf by leaf, bytes equal, and the same
    builder info."""
    jb, tb = jtfds.builder(name, jax_written), ttfds.builder(name, jax_written)
    assert str(tb.info) == str(jb.info)
    assert {k: vars(v) for k, v in tb.info.splits.items()} == {k: vars(v) for k, v in jb.info.splits.items()}
    want, got = jax_episodes(jb), list(tb.as_dataset(split="train"))
    assert len(got) == len(want) > 0
    for a, b in zip(want, got):
        assert_tree_equal(a, b)
    for split in ("train[:95%]", "train[95%:]", "all"):
        assert len(list(tb.as_dataset(split=split))) == len(jax_episodes(jb, split))


@pytest.mark.parametrize("num_shards", [1, 2])
def test_jax_reads_port_written(tmp_path, num_shards):
    """JAX's reader reads the port's writer's directory: the written
    episodes, equal to what the port's reader gives; the two writers'
    layout files are the same."""
    eps = write_franka_fixture(tmp_path / "ref")
    ttfds.write_rlds_dataset(tmp_path / "port", "franka", eps, num_shards=num_shards)
    jtfds.write_rlds_dataset(tmp_path / "jax", "franka", eps, num_shards=num_shards)
    for f in ("features.json", "dataset_info.json"):
        assert (tmp_path / "port/franka/1.0.0" / f).read_text() == (tmp_path / "jax/franka/1.0.0" / f).read_text()
    want = jax_episodes(jtfds.builder("franka", tmp_path / "port"))
    got = list(ttfds.builder("franka", tmp_path / "port").as_dataset())
    assert len(want) == len(got) == len(eps)
    for w, g, e in zip(want, got, eps):
        assert_tree_equal(w, g)
        for k in ("image_third", "image_wrist"):
            assert list(g["steps"]["observation"][k]) == list(e["steps"]["observation"][k])


def _first_actions(builder, split, shuffle):
    return [tuple(np.round(ep["steps"]["action"][0], 5)) for ep in builder.as_dataset(split=split,
                                                                                     shuffle_files=shuffle)]


def test_percent_splits_partition_and_shuffle_files(tmp_path):
    """train[:95%] and train[95%:] partition the episodes with and without
    file shuffling (bounds bind on the canonical order); shuffle_files
    reorders between calls and never changes the set."""
    write_rlbench_fixture(tmp_path, n_episodes=12, lens=(4, 5, 6), num_shards=6)
    b = ttfds.builder("rlbench", tmp_path)
    everything = _first_actions(b, "train", False)
    for shuffle in (False, True):
        train, val = _first_actions(b, "train[:95%]", shuffle), _first_actions(b, "train[95%:]", shuffle)
        assert len(train) == 11 and len(val) == 1
        assert set(train) | set(val) == set(everything) and not set(train) & set(val)
    draws = [tuple(_first_actions(b, "train", True)) for _ in range(6)]
    assert all(set(d) == set(everything) for d in draws)
    assert len(set(draws)) > 1, "file shuffling is a no-op"  # 720 orders: 6 equal draws is ~1e-17
    with pytest.raises(ValueError):
        b.as_dataset(split="test")


def test_stream_level_fallback(tmp_path):
    """Without usable shard lengths both readers carve percent splits from
    the stream of the sorted files."""
    write_rlbench_fixture(tmp_path, n_episodes=6, lens=(4, 5, 6), num_shards=3)
    info = tmp_path / "rlbench/1.0.0/dataset_info.json"
    raw = json.loads(info.read_text())
    raw["splits"][0]["shardLengths"] = ["6"]
    info.write_text(json.dumps(raw))
    jb, tb = jtfds.builder("rlbench", tmp_path), ttfds.builder("rlbench", tmp_path)
    for split in ("train", "train[:50%]", "train[50%:]"):
        want, got = jax_episodes(jb, split), list(tb.as_dataset(split=split))
        assert len(want) == len(got) == {"train": 6}.get(split, 3)
        for a, b in zip(want, got):
            assert_tree_equal(a, b)


def test_missing_dataset_and_tfds_built_directory(tmp_path):
    with pytest.raises(FileNotFoundError):
        ttfds.builder("nope", tmp_path)
    d = tmp_path / "tfds_built" / "1.0.0"
    d.mkdir(parents=True)
    (d / "dataset_info.json").write_text(json.dumps({"name": "tfds_built", "splits": []}))
    (d / "features.json").write_text(json.dumps({"pythonClassName": "tensorflow_datasets.core.features."
                                                 "features_dict.FeaturesDict", "featuresDict": {}}))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 2"):
        ttfds.builder("tfds_built", tmp_path)


@pytest.mark.parametrize("where", ["data", "length"])
def test_corrupted_byte_is_refused_by_both(tmp_path, where):
    """One flipped byte in a record (in its data, or in its length) is
    refused by TensorFlow's reader and by the port's CRC check."""
    write_rlbench_fixture(tmp_path, n_episodes=2, num_shards=1)
    shard = next((tmp_path / "rlbench/1.0.0").glob("rlbench-train.tfrecord-*"))
    raw = bytearray(shard.read_bytes())
    raw[1000 if where == "data" else 2] ^= 0x10
    shard.write_bytes(bytes(raw))
    with pytest.raises(tf.errors.DataLossError):
        jax_episodes(jtfds.builder("rlbench", tmp_path))
    with pytest.raises(ttfds.DataLossError, match="corrupted record"):
        list(ttfds.builder("rlbench", tmp_path).as_dataset())


def test_example_codec_against_protobuf():
    """The port's tf.train.Example encoder against TensorFlow's protobuf
    parser, and its decoder on TensorFlow's encoding, packed and unpacked,
    with negative int64 values (10-byte varints) and empty lists."""
    ints = np.array([0, 1, -1, 127, 128, -(2**63), 2**63 - 1, 300, -300], np.int64)
    floats = np.array([0.0, -1.5, 3.25e-8, np.inf], np.float32)
    feats = {"i": ints, "f": floats, "s": np.array([b"", b"ab\x00c", "text"], object),
             "empty_f": np.zeros(0, np.float32), "empty_i": np.zeros(0, np.int64)}
    ex = tf.train.Example.FromString(ttfds.encode_example(feats)).features.feature
    assert list(ex["i"].int64_list.value) == ints.tolist()
    assert np.array_equal(np.array(ex["f"].float_list.value, np.float32), floats)
    assert list(ex["s"].bytes_list.value) == [b"", b"ab\x00c", b"text"]
    assert len(ex["empty_f"].float_list.value) == len(ex["empty_i"].int64_list.value) == 0

    ref = tf.train.Example(features=tf.train.Features(feature={
        "i": tf.train.Feature(int64_list=tf.train.Int64List(value=ints.tolist())),
        "f": tf.train.Feature(float_list=tf.train.FloatList(value=floats.tolist())),
        "s": tf.train.Feature(bytes_list=tf.train.BytesList(value=[b"x", b""])),
    })).SerializeToString()
    got = ttfds.decode_example(ref)
    assert got["i"][0] == 3 and got["i"][1].tolist() == ints.tolist()
    assert got["f"][0] == 2 and np.array_equal(got["f"][1], floats)
    assert got["s"] == (1, [b"x", b""])

    # unpacked repeated values (wire types 0 and 5), which proto readers accept
    int_list = b"".join(ttfds._varint(1 << 3 | 0) + ttfds._varint(int(v)) for v in ints)
    float_list = b"".join(ttfds._varint(1 << 3 | 5) + struct.pack("<f", v) for v in floats)
    entries = b"".join(ttfds._len_field(1, ttfds._len_field(1, k) + ttfds._len_field(2, ttfds._len_field(n, body)))
                       for k, n, body in ((b"i", 3, int_list), (b"f", 2, float_list)))
    unpacked = ttfds._len_field(1, entries)
    parsed = tf.io.parse_single_example(unpacked, {"i": tf.io.VarLenFeature(tf.int64),
                                                   "f": tf.io.VarLenFeature(tf.float32)})
    got = ttfds.decode_example(unpacked)
    assert got["i"][1].tolist() == tf.sparse.to_dense(parsed["i"]).numpy().tolist() == ints.tolist()
    assert np.array_equal(got["f"][1], tf.sparse.to_dense(parsed["f"]).numpy())


# --------------------------------------------------------------------------- #
# the host helper against its plain versions (g++ is here)
# --------------------------------------------------------------------------- #


def test_helper_crc_matches_plain_and_tensorflow():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 9, 63, 64, 65, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert rlds_host.masked_crc32c(data) == rlds_host.masked_crc32c_plain(data)
    # the published CRC-32C check value of "123456789", then TFRecord's mask
    c = 0xE3069283
    assert rlds_host.masked_crc32c_plain(b"123456789") == (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_helper_unfilter_matches_plain(bpp):
    """Every filter type, in random order, at each pixel width."""
    rng = np.random.default_rng(bpp)
    h, w = 9, 7
    rows = rng.integers(0, 256, (h, w * bpp + 1), dtype=np.uint8)
    rows[:, 0] = rng.permutation(np.arange(h) % 5)
    raw = rows.tobytes()
    np.testing.assert_array_equal(rlds_host.png_unfilter(raw, h, w * bpp, bpp),
                                  rlds_host.png_unfilter_plain(raw, h, w * bpp, bpp))
    bad = bytearray(raw)
    bad[0] = 5
    with pytest.raises(ValueError, match="unknown filter type 5"):
        rlds_host.png_unfilter(bytes(bad), h, w * bpp, bpp)


@pytest.mark.parametrize("shape,out", [((13, 17, 3), (29, 8)), ((5, 40, 1), (40, 5)), ((24, 24, 3), (24, 24))])
def test_helper_resample_matches_plain(shape, out):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    rows, cols = tT.lanczos3_spans(shape[0], out[0]), tT.lanczos3_spans(shape[1], out[1])
    np.testing.assert_array_equal(rlds_host.resample(img, rows, cols), rlds_host.resample_plain(img, rows, cols))


def test_helper_sinf_within_an_ulp_of_plain():
    x = np.linspace(-10, 10, 20001, dtype=np.float32)
    got, want = rlds_host.sinf(x), rlds_host.sinf_plain(x)
    assert np.all(np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64)) <= 1)
