"""The port's RLDS pipeline against the JAX package's (tf.data) on fixtures
JAX's writer puts in tmp_path: the frame resize, the trajectories and
statistics of make_dataset_from_rlds and apply_trajectory_transforms, the
frames of make_interleaved_dataset across its .repeat(), RLDSBatchTransform
and the collator, and the trainer on a data root (its run dir served).

Images may differ by one step of uint8 on at most 1e-3 of their pixels
(TensorFlow's Lanczos weights through another route); everything else is
held exactly, the normalized actions and proprio bit for bit."""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from mla_tpu.training import checkpointing as jckpt  # noqa: E402
from mla_tpu.vla import datasets as jdata  # noqa: E402
from mla_tpu.vla.action_tokenizer import ActionTokenizer as JActionTokenizer  # noqa: E402
from mla_tpu.vla.rlds import dataset as jds  # noqa: E402
from mla_tpu.vla.rlds import transforms as jT  # noqa: E402
from mla_tpu.vla.tokenizer import SimpleTokenizer as JTokenizer  # noqa: E402
from mla_tpu_torch.vla import datasets as tdata  # noqa: E402
from mla_tpu_torch.vla.action_tokenizer import ActionTokenizer as TActionTokenizer  # noqa: E402
from mla_tpu_torch.vla.rlds import dataset as tds  # noqa: E402
from mla_tpu_torch.vla.rlds import stream  # noqa: E402
from mla_tpu_torch.vla.rlds import transforms as tT  # noqa: E402
from mla_tpu_torch.vla.tokenizer import SimpleTokenizer as TTokenizer  # noqa: E402
from test_tfds_builder import write_franka_fixture, write_rlbench_fixture  # noqa: E402
from test_torch_rlds_reader import assert_tree_equal  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
IMAGE_SIZE = 168  # mla-tiny's vision image_size
MIX_KW = {"rlbench": dict(load_pointcloud=True, load_tactile=False),
          "franka": dict(load_pointcloud=True, load_tactile=True)}
PROPRIO_DIM = 7  # the MLA suites' proprio, as wide as the model's: nothing to fit


def assert_images_close(want, got):
    """uint8 images: |difference| <= 1 on at most 1e-3 of the pixels."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype == np.uint8
    d = np.abs(want.astype(np.int64) - got.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def split_images(frame):
    """(frame without its decoded image_* leaves, {key: image})."""
    obs = dict(frame["observation"])
    images = {k: obs.pop(k) for k in list(obs) if k.startswith("image_")}
    return {**frame, "observation": obs}, images


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """rlbench and franka in one shard each (frame order is then the file
    order on both sides)."""
    d = tmp_path_factory.mktemp("rlds")
    write_rlbench_fixture(d, num_shards=1)
    write_franka_fixture(d)
    return d


# --------------------------------------------------------------------------- #
# the frame resize
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shape", [(24, 24), (256, 256), (480, 640), (672, 672)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_and_resize_matches_jax(shape):
    """PNG -> Lanczos-3 -> round/clip/uint8 at 672, against JAX's
    tf.image.resize; 672 -> 672 gives the written pixels."""
    h, w = shape
    rng = np.random.default_rng(h + w)
    yy, xx = np.mgrid[:h, :w]
    img = np.clip(np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 127 / (h + w)], -1)
                  + rng.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)
    data = tf.io.encode_png(img).numpy()
    got = tT.decode_and_resize_image(data, 672)
    assert_images_close(jT.decode_and_resize_image(tf.constant(data), 672).numpy(), got)
    if shape == (672, 672):
        np.testing.assert_array_equal(got, img)


def test_empty_string_gives_zeros():
    np.testing.assert_array_equal(tT.decode_and_resize_image(b"", (12, 20)), np.zeros((12, 20, 3), np.uint8))
    np.testing.assert_array_equal(jT.decode_and_resize_image(tf.constant(b""), (12, 20)).numpy(),
                                  np.zeros((12, 20, 3), np.uint8))


# --------------------------------------------------------------------------- #
# trajectories and statistics
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["rlbench", "franka"])
def test_trajectories_and_statistics_match_jax(data_root, tmp_path, name):
    """make_dataset_from_rlds: the statistics dict (num_transitions and
    num_trajectories included) and every standardized, normalized
    trajectory exactly; then apply_trajectory_transforms' pad masks and
    chunks exactly."""
    kw = dict(train=True, shuffle=False, **MIX_KW[name])
    jdset, jstats = jds.make_dataset_from_rlds(name, str(data_root), stats_cache_dir=str(tmp_path / "j"), **kw)
    tdset, tstats = tds.make_dataset_from_rlds(name, str(data_root), stats_cache_dir=str(tmp_path / "t"), **kw)
    assert_tree_equal(jstats, tstats)
    assert tstats["num_transitions"] == jstats["num_transitions"] > 0
    want, got = list(jdset.as_numpy_iterator()), list(tdset)
    assert len(want) == len(got) == jstats["num_trajectories"]
    for a, b in zip(want, got):
        assert_tree_equal(a, b)
    want = list(jds.apply_trajectory_transforms(jdset, dataset_statistics=jstats).as_numpy_iterator())
    got = list(tds.apply_trajectory_transforms(tdset, dataset_statistics=tstats))
    for a, b in zip(want, got):
        assert_tree_equal(a, b)
    # the statistics came from the port's own cache the second time
    assert list((tmp_path / "t").iterdir())
    _, again = tds.make_dataset_from_rlds(name, str(data_root), stats_cache_dir=str(tmp_path / "t"), **kw)
    assert_tree_equal(tstats, again)


# --------------------------------------------------------------------------- #
# frames and batches
# --------------------------------------------------------------------------- #


def _frames(data_root, tmp_path, name):
    """The first 2 x len(dataset) frames of both pipelines (across the
    .repeat()), shuffle buffer 1, the pool on."""
    kw = dict(shuffle_buffer_size=1, image_size=IMAGE_SIZE, **MIX_KW[name])
    jd, jlen, jstats = jds.make_interleaved_dataset(name, str(data_root), stats_cache_dir=str(tmp_path / "j"), **kw)
    td, tlen, tstats = tds.make_interleaved_dataset(name, str(data_root), stats_cache_dir=str(tmp_path / "t"),
                                                    proprio_dim=PROPRIO_DIM, **kw)
    assert tlen == jlen
    assert_tree_equal(jstats, tstats)
    return list(jd.take(2 * jlen).as_numpy_iterator()), list(td.take(2 * tlen)), jlen


@pytest.fixture(scope="module")
def frames(data_root, tmp_path_factory):
    return {name: _frames(data_root, tmp_path_factory.mktemp(f"frames_{name}"), name) for name in MIX_KW}


@pytest.mark.parametrize("name", ["rlbench", "franka"])
def test_frames_match_jax(frames, name):
    want, got, n = frames[name]
    assert len(want) == len(got) == 2 * n
    for a, b in zip(want, got):
        (a, ia), (b, ib) = split_images(a), split_images(b)
        assert sorted(ia) == sorted(ib) and len(ia) >= 2
        for k in ia:
            assert ib[k].shape == (1, IMAGE_SIZE, IMAGE_SIZE, 3)
            assert_images_close(ia[k], ib[k])
        assert_tree_equal(a, b)


@pytest.mark.parametrize("tokens", [False, True], ids=["diffusion-only", "action-tokens"])
@pytest.mark.parametrize("name", ["rlbench", "franka"])
def test_batches_match_jax(frames, name, tokens):
    """RLDSBatchTransform and the collator on the same frames (the port's
    own frames through the port's transform): CLIP images within one uint8
    step of their channel's scale on at most 1e-3 of the elements; ids,
    labels, masks, splice_idx, actions, proprio, point clouds and tactile
    exactly."""
    want_frames, got_frames, _ = frames[name]
    jtok, ttok = JTokenizer(), TTokenizer()
    kw = dict(image_size=IMAGE_SIZE, use_pointcloud=True, use_tactile=MIX_KW[name]["load_tactile"], num_points=64)
    jtf = jdata.RLDSBatchTransform(JActionTokenizer(jtok, vocab_size=32000) if tokens else None, jtok, **kw)
    ttf = tdata.RLDSBatchTransform(TActionTokenizer(ttok, vocab_size=32000) if tokens else None, ttok, **kw)
    jcol, tcol = jdata.PaddedCollatorForActionPrediction(), tdata.PaddedCollatorForActionPrediction()
    for lo in range(0, len(want_frames), 4):
        want = jcol([jtf(f) for f in want_frames[lo:lo + 4]])
        got = tcol([ttf(f) for f in got_frames[lo:lo + 4]])
        for key in ("images", "next_images"):
            w_imgs, g_imgs = (want[key], got.pop(key)) if key == "images" else ({key: want[key]}, {key: got.pop(key)})
            for k, w in w_imgs.items():
                g = g_imgs[k]
                assert g.shape == w.shape and g.dtype == w.dtype == np.float32
                tol = (1 / (255 * tdata.CLIP_STD) + 1e-6).reshape(1, 3, 1, 1)
                d = np.abs(g[:, :3] - w[:, :3])
                assert (d > tol).sum() == 0 and (d > 1e-6).mean() <= 1e-3
                np.testing.assert_array_equal(g[:, 3:], w[:, 3:])
            want.pop(key)
        assert_tree_equal(want, got)
        if tokens:
            assert (got["labels"] != -100).sum(1).tolist() == [8] * len(got["labels"])


def test_shuffle_buffer_permutes(data_root, tmp_path):
    """The port's frame buffer draws from its own seeded generator: over the
    validation frames (one buffer, cached), each seed gives a permutation of
    the unshuffled frames, the same one again for the same seed, and
    another for another seed."""
    def key(f):
        return int(f["observation"]["timestep"][0]), tuple(np.round(f["action"][0], 4))

    def shuffled(seed):
        ds, _, _ = tds.make_interleaved_dataset("rlbench", str(data_root), train=False, shuffle_buffer_size=30,
                                                image_size=8, seed=seed, stats_cache_dir=str(tmp_path),
                                                proprio_dim=PROPRIO_DIM)
        return [key(f) for f in ds]

    trajs, stats = tds.make_dataset_from_rlds("rlbench", str(data_root), train=False, stats_cache_dir=str(tmp_path))
    base = [key(f) for f in tds.flatten_to_frames(tds.apply_trajectory_transforms(trajs, train=False,
                                                                                    dataset_statistics=stats))]
    a, b, c = shuffled(0), shuffled(0), shuffled(1)
    assert len(base) == 8 and sorted(a) == sorted(c) == sorted(base)
    assert a == b and a != c and a != base


def test_pool_preserves_order_under_contention():
    """The order-preserving pool with more threads than cores and a short
    switch interval: results in input order, each input once."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        rng = np.random.default_rng(0)
        delays = rng.uniform(0, 2e-3, 400)
        seen, lock = [], threading.Lock()

        def work(i):
            time.sleep(delays[i])
            with lock:
                seen.append(i)
            return i * i

        ds = stream.Dataset(lambda: iter(range(400))).map(work, num_parallel_calls=4 * (os.cpu_count() or 1))
        ds = ds.map(lambda x: x + 1, num_parallel_calls=stream.AUTOTUNE)  # fused into the same pool
        assert isinstance(ds, stream.ParallelMap)
        assert list(ds) == [i * i + 1 for i in range(400)]
        assert sorted(seen) == list(range(400))
        assert list(ds.take(5)) == [1, 2, 5, 10, 17]  # stopping early shuts the pool down
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("what,call", [
    ("augment", lambda d: tds.make_interleaved_dataset("rlbench", d, augment=True, proprio_dim=PROPRIO_DIM)),
    ("augment-kwargs", lambda d: tds.make_interleaved_dataset("rlbench", d, image_augment_kwargs={},
                                                              proprio_dim=PROPRIO_DIM)),
    ("goal-relabel", lambda d: tds.apply_trajectory_transforms(stream.Dataset(lambda: iter([])),
                                                               goal_relabeling_strategy="uniform")),
    ("task-augment", lambda d: tds.apply_trajectory_transforms(stream.Dataset(lambda: iter([])),
                                                               task_augment_strategy="delete_task_conditioning")),
    ("subsample", lambda d: tds.apply_trajectory_transforms(stream.Dataset(lambda: iter([])), subsample_length=4)),
])
def test_not_ported_raises(data_root, what, call):
    """The train-time transforms are ported now: each option builds its
    stream instead of raising (tests/test_torch_rlds_augment.py holds them
    to JAX's)."""
    out = call(str(data_root))
    ds = out[0] if isinstance(out, tuple) else out
    assert isinstance(ds, stream.Dataset)


@pytest.fixture(scope="module")
def data_root_run(tmp_path_factory):
    """python -m mla_tpu_torch.train --device cpu --data_root_dir <fixture>:
    one step on real frames and a checkpoint. -> the temporary dir (the
    fixture under data/, the run under runs/ondisk)."""
    tmp = tmp_path_factory.mktemp("data_root_run")
    write_rlbench_fixture(tmp / "data")
    cmd = [sys.executable, "-m", "mla_tpu_torch.train", "--device", "cpu", "--vla.type", "mla-tiny-debug",
           "--data_root_dir", str(tmp / "data"), "--data_mix", "rlbench", "--shuffle_buffer_size", "16",
           "--max_steps", "1", "--save_interval", "1", "--run_root_dir", str(tmp / "runs"), "--run_id", "ondisk"]
    env = {**os.environ, "HOME": str(tmp / "home")}  # the statistics cache goes under HOME
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return tmp


def _as_lists(tree):
    """A statistics tree with its numpy arrays and scalars as lists and
    numbers (the reference's run-dir format)."""
    if isinstance(tree, dict):
        return {k: _as_lists(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_lists(v) for v in tree]
    return tree.tolist() if isinstance(tree, (np.ndarray, np.generic)) else tree


def test_trainer_on_a_data_root(data_root_run):
    """The trainer's run dir on a data root: a step-1 checkpoint, the
    statistics cache, and a dataset_statistics.json that holds, exactly, the
    statistics JAX's pipeline computes for the same root, as lists (JAX's
    own run metadata writes the arrays as their numpy strings, which no
    loader reads back; the port writes numbers)."""
    run = data_root_run / "runs" / "ondisk"
    assert list((run / "checkpoints").glob("step-000001-*/state.pt"))
    assert list((data_root_run / "home/.cache/mla_tpu_torch").glob("dataset_statistics_*.json"))
    _, _, jstats = jds.make_interleaved_dataset("rlbench", str(data_root_run / "data"), shuffle_buffer_size=16,
                                                stats_cache_dir=str(data_root_run / "jcache"))
    written = json.loads((run / "dataset_statistics.json").read_text())
    assert written == json.loads(json.dumps(_as_lists(jstats)))
    assert isinstance(written["rlbench"]["action"]["q01"], list)


def test_data_root_run_dir_serves(data_root_run):
    """load_vla of a run dir trained on a data root: its q01/q99 are
    numbers, so a served chunk unnormalizes to finite actions inside the
    statistics' bounds."""
    from mla_tpu_torch.models.load import load_vla

    pol = load_vla(data_root_run / "runs" / "ondisk", device="cpu")
    stats = pol.norm_stats["rlbench"]["action"]
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (3, IMAGE_SIZE, IMAGE_SIZE), np.uint8)
    pc = rng.normal(size=(64, 3)).astype(np.float32)
    out = pol.predict_action_diff(img, pc, "", input_ids=np.array([[1, 5, 6, 29871]], np.int32), unnorm_key="rlbench",
                                  sampler="dpm")
    assert out.shape == (16, 7) and np.isfinite(out).all()
    lo, hi = np.asarray(stats["q01"]), np.asarray(stats["q99"])
    assert ((out[:, :6] >= lo[:6] - 1e-6) & (out[:, :6] <= hi[:6] + 1e-6)).all()


@pytest.mark.parametrize("kind", ["bounds_q99", "bounds", "normal"])
def test_normalization_types_match_jax(kind):
    """normalize_action_and_proprio bit for bit against TensorFlow's float32
    arithmetic, for each normalization type, with a mask and a constant
    dimension (min == max) that comes out zero."""
    rng = np.random.default_rng(3)
    act, prop = rng.normal(size=(9, 7)).astype(np.float32), rng.normal(size=(9, 7)).astype(np.float32)
    act[:, 2] = prop[:, 4] = 0.25
    stats = {k: tT.compute_dataset_statistics(np.concatenate([act, act * 1.5]), prop)[k] for k in ("action", "proprio")}
    stats["action"]["mask"] = [True] * 6 + [False]
    ttraj = tT.normalize_action_and_proprio({"action": act.copy(), "observation": {"proprio": prop.copy()}}, stats,
                                            tT.NormalizationType(kind))
    jtraj = jT.normalize_action_and_proprio({"action": tf.constant(act), "observation": {"proprio": tf.constant(prop)}},
                                            stats, jT.NormalizationType(kind))
    for got, want in ((ttraj["action"], jtraj["action"]), (ttraj["observation"]["proprio"],
                                                           jtraj["observation"]["proprio"])):
        want = want.numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_tree_utilities_and_weights_match_jax():
    """tree_merge, to_padding, compute_sample_weights and allocate_threads
    give JAX's results."""
    a, b = {"x": 1, "d": {"p": 1, "q": 2}}, {"d": {"q": 3, "r": 4}, "y": 5}
    assert tT.tree_merge(a, b) == jT.tree_merge(a, b)
    strings = np.asarray([b"a", b"", b"bc"], object)
    np.testing.assert_array_equal(tT.to_padding(strings), jT.to_padding(tf.constant(strings)).numpy())
    nums = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(tT.to_padding(nums), jT.to_padding(tf.constant(nums)).numpy())
    for raw, sizes, balance in (([1.0, 0.5, 2.0], [100, 40, 7], True), ([1.0, 1.0], [30, 12], False),
                                ([0.3, 0.2], [5, 9], True)):
        tw, tn = tds.compute_sample_weights(raw, sizes, balance)
        jw, jn = jds.compute_sample_weights(raw, sizes, balance)
        np.testing.assert_array_equal(tw, jw)
        assert tn == jn
        for n in (None, 3, 8, 17):
            np.testing.assert_array_equal(tT.allocate_threads(n, tw), jT.allocate_threads(n, jw))


def test_dataset_classes_match_jax(data_root, tmp_path, monkeypatch):
    """RLDSDataset (the frame stream, buffer 1) and EpisodicRLDSDataset (the
    validation split's whole trajectories, images decoded) against the JAX
    package's classes."""
    monkeypatch.setenv("HOME", str(tmp_path))  # both statistics caches under tmp_path
    kw = dict(train=True, shuffle_buffer_size=1, load_pointcloud=True, image_size=32)
    jset = jds.RLDSDataset(str(data_root), "rlbench", **kw)
    tset = tds.RLDSDataset(str(data_root), "rlbench", proprio_dim=PROPRIO_DIM, **kw)
    assert len(tset) == len(jset) == 30
    assert_tree_equal(jset.dataset_statistics, tset.dataset_statistics)
    jit, tit = iter(jset), iter(tset)
    for _ in range(12):
        (a, ia), (b, ib) = split_images(next(jit)), split_images(next(tit))
        for k in ia:
            assert_images_close(ia[k], ib[k])
        assert_tree_equal(a, b)
    kw = dict(train=False, load_pointcloud=True, image_size=32)
    jep = list(jds.EpisodicRLDSDataset(str(data_root), "rlbench", **kw))
    tep = list(tds.EpisodicRLDSDataset(str(data_root), "rlbench", **kw))
    assert len(jep) == len(tep) == 1
    (a, ia), (b, ib) = split_images(jep[0]), split_images(tep[0])
    assert ib["image_primary"].shape == (len(b["action"]), 1, 32, 32, 3)
    for k in ia:
        assert_images_close(ia[k], ib[k])
    assert_tree_equal(a, b)
