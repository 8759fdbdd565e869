"""The port's interleaved Open-X mixture against the JAX package's pipeline,
on a `bridge_rt_1` data root of JPEG frames (bridge_orig and
fractal20220817_data in their raw schemas, chip_smoke.oxe_fixture: the
port's encoder and writer).

JAX cannot run this mixture: tf.data refuses to interleave its two
datasets, whose frames hold different camera views (TypeError), and with
explicit views its kwargs factory's 7-long proprio masks meet the
datasets' 8-float proprio (ValueError); its model embeds a proprio as wide
as the actions (7). The first two are pinned here as JAX's faults; the
port keeps the factory's refusal, and its mixture, fitted to the model
(`fit_mixture`), loads the views every dataset has and gives a dataset
whose proprio is not the model's width a zero proprio of that width, and
says so once per dataset (ROADMAP.md section 3). Everything the port computes is held against what
JAX computes for each dataset alone: the statistics, weights and effective
length exactly, each dataset's frames in its own order exactly but the
resized images, which may differ by one step of uint8 on at most 1e-3 of
their pixels (TensorFlow's Lanczos weights through another route, as in
test_torch_rlds_pipeline.py). The shares of the interleave lie within 4
binomial standard deviations of the weights."""

import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from mla_tpu.conf.models import get_model_config as jget_model_config  # noqa: E402
from mla_tpu.vla import datasets as jdata  # noqa: E402
from mla_tpu.vla.rlds import dataset as jds  # noqa: E402
from mla_tpu.vla.tokenizer import SimpleTokenizer as JTokenizer  # noqa: E402
from mla_tpu_torch.vla import datasets as tdata  # noqa: E402
from mla_tpu_torch.vla.rlds import dataset as tds  # noqa: E402
from mla_tpu_torch.vla.rlds import jpeg  # noqa: E402
from mla_tpu_torch.vla.rlds.oxe import transforms as tox  # noqa: E402
from mla_tpu_torch.vla.rlds.stream import Dataset  # noqa: E402
from mla_tpu_torch.vla.tokenizer import SimpleTokenizer as TTokenizer  # noqa: E402
from test_tfds_builder import write_franka_fixture  # noqa: E402
from test_torch_rlds_pipeline import assert_images_close, split_images, _as_lists  # noqa: E402
from test_torch_rlds_reader import assert_tree_equal  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
NAMES = ("bridge_orig", "fractal20220817_data")
EPISODES, STEPS = 3, 8
IMAGE_SIZE = 64


@pytest.fixture(scope="module")
def oxe_root(tmp_path_factory):
    """bridge_rt_1's two datasets, one shard each (frame order is then the
    file order on both sides), and a franka dataset for explicit views."""
    d = tmp_path_factory.mktemp("oxe")
    written = chip_smoke.oxe_fixture(d, EPISODES, STEPS, 1, 21)
    write_franka_fixture(d)
    return d, written


def _port(root, mix="bridge_rt_1", tmp=None, **kw):
    """The port's mixture, by default fitted to the OXE datasets' own
    8-float proprio (nothing zeroed), as JAX's frames carry it."""
    kw.setdefault("shuffle_buffer_size", 1)
    kw.setdefault("load_pointcloud", False)
    kw.setdefault("proprio_dim", 8)
    return tds.make_interleaved_dataset(mix, str(root), image_size=IMAGE_SIZE, stats_cache_dir=str(tmp / "t"), **kw)


def _jax(root, mix, tmp, **kw):
    kw.setdefault("shuffle_buffer_size", 1)
    kw.setdefault("load_pointcloud", False)
    return jds.make_interleaved_dataset(mix, str(root), image_size=IMAGE_SIZE, stats_cache_dir=str(tmp / "j"), **kw)


# --------------------------------------------------------------------------- #
# what JAX does on this mixture
# --------------------------------------------------------------------------- #


def test_jax_cannot_interleave_bridge_rt_1(oxe_root, tmp_path):
    """JAX's default views: bridge's frames hold image_primary and
    image_secondary, fractal's image_primary alone, and tf.data refuses."""
    with pytest.raises(TypeError, match="compatible element specs"):
        _jax(oxe_root[0], "bridge_rt_1", tmp_path)


def test_explicit_views_refuse_oxe_proprio_in_both(oxe_root, tmp_path):
    """The kwargs factory's EEF masks are 7 long; bridge's and fractal's
    proprio 8 floats. JAX refuses as it builds the graph, the port as its
    first trajectory is normalized."""
    with pytest.raises(ValueError, match="Dimensions must be equal"):
        _jax(oxe_root[0], "bridge_rt_1", tmp_path, load_camera_views=("primary",))
    ds, _, _ = _port(oxe_root[0], tmp=tmp_path, load_camera_views=("primary",))
    with pytest.raises(ValueError, match="broadcast"):
        next(iter(ds))


def test_jax_model_embeds_a_proprio_as_wide_as_the_actions(oxe_root, tmp_path):
    """JAX's frames of bridge_orig carry an 8-float proprio; its mla-tiny
    embeds action_dim = 7. The port's mixture fitted to the model's width
    gives every frame of both datasets a float32 zero proprio of 7 floats
    and leaves every other key as the unfitted mixture has it; the batch
    transform passes that proprio on as JAX's passes a 7-float one."""
    jd, _, _ = _jax(oxe_root[0], "bridge_orig", tmp_path)
    frame = next(jd.as_numpy_iterator())
    assert frame["observation"]["proprio"].shape == (1, 8)
    assert jget_model_config("mla-tiny").action_dim == 7
    fitted = list(_port(oxe_root[0], tmp=tmp_path, proprio_dim=7)[0].take(40))
    unfitted = list(_port(oxe_root[0], tmp=tmp_path)[0].take(40))
    assert {bytes(f["dataset_name"]).decode() for f in fitted} == set(NAMES)
    kw = dict(action_tokenizer=None, image_size=IMAGE_SIZE)
    frame7 = {**frame, "observation": {**frame["observation"], "proprio": np.zeros((1, 7), np.float32)}}
    want = jdata.RLDSBatchTransform(base_tokenizer=JTokenizer(), **kw)(frame7)["proprio"]
    assert np.array_equal(tdata.RLDSBatchTransform(base_tokenizer=TTokenizer(), **kw)(fitted[0])["proprio"], want)
    for a, b in zip(fitted, unfitted):
        a, b = dict(a), dict(b)
        a["observation"], b["observation"] = dict(a["observation"]), dict(b["observation"])
        got = a["observation"].pop("proprio")
        assert got.dtype == np.float32 and np.array_equal(got, np.zeros((1, 7), np.float32))
        assert b["observation"].pop("proprio").shape == (1, 8)
        assert_tree_equal(b, a)


# --------------------------------------------------------------------------- #
# the port's mixture against each dataset under JAX
# --------------------------------------------------------------------------- #


def _recomputed_sizes(written):
    """num_transitions from the written episodes: bridge drops its first
    step and relabels away its last, fractal keeps every step."""
    return {"bridge_orig": EPISODES * (STEPS - 2), "fractal20220817_data": EPISODES * STEPS}


def test_statistics_weights_and_length_match_jax(oxe_root, tmp_path):
    root, written = oxe_root
    _, n, stats = _port(root, tmp=tmp_path)
    sizes = []
    for name in NAMES:
        _, jstats = jds.make_dataset_from_rlds(name, str(root), load_pointcloud=False,
                                               stats_cache_dir=str(tmp_path / "j"))
        assert_tree_equal(jstats, stats[name])
        assert stats[name]["num_transitions"] == _recomputed_sizes(written)[name]
        assert stats[name]["num_trajectories"] == EPISODES
        sizes.append(jstats["num_transitions"])
    jw, jn = jds.compute_sample_weights([1.0, 1.0], sizes, True)
    tw, tn = tds.compute_sample_weights([1.0, 1.0], sizes, True)
    assert np.array_equal(jw, tw) and n == tn == jn


def _by_dataset(frames):
    out = {}
    for f in frames:
        out.setdefault(bytes(f["dataset_name"]).decode(), []).append(f)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_each_datasets_frames_match_jax(oxe_root, tmp_path, name):
    """The mixture's frames of one dataset, in their order (shuffle buffer
    1, across the .repeat()), against JAX's frames of that dataset alone:
    every key the mixture keeps, images within the stated bound and
    everything else exactly. The mixture keeps the views both datasets
    have: bridge's image_secondary goes."""
    root, _ = oxe_root
    ds, _, _ = _port(root, tmp=tmp_path)
    got = _by_dataset(ds.take(160))[name]
    jd, _, _ = _jax(root, name, tmp_path)
    it = jd.as_numpy_iterator()
    want = [next(it) for _ in range(len(got))]
    assert len(got) > 2 * EPISODES * (STEPS - 2) // 2
    for a, b in zip(got, want):
        a_rest, a_img = split_images(a)
        b_rest, b_img = split_images(b)
        dropped = {"image_secondary"} if name == "bridge_orig" else set()
        assert set(a_img) == set(b_img) - dropped == {"image_primary"}
        for k in a_img:
            assert_images_close(b_img[k], a_img[k])
        b_rest["observation"]["pad_mask_dict"] = {k: v for k, v in b_rest["observation"]["pad_mask_dict"].items()
                                                  if k not in dropped}
        assert_tree_equal(b_rest, a_rest)


def test_frames_at_their_own_size_are_the_decoded_pixels(oxe_root, tmp_path):
    """bridge's 256 x 256 frames through the mixture at image_size 256 (the
    resize an identity): TensorFlow's decode_image of the written JPEG."""
    root, written = oxe_root
    ds = tds.make_interleaved_dataset("bridge_rt_1", str(root), shuffle_buffer_size=1, load_pointcloud=False,
                                      image_size=256, stats_cache_dir=str(tmp_path / "t"), proprio_dim=7)[0]
    frames = _by_dataset(ds.take(40))["bridge_orig"]
    raw = written["bridge_orig"][0]["steps"]["observation"]["image_0"]
    for t, f in enumerate(frames[:STEPS - 2]):  # step t of the standardized episode is raw step t + 1
        want = tf.io.decode_image(raw[t + 1], channels=3, expand_animations=False).numpy()
        assert np.array_equal(f["observation"]["image_primary"][0], want)


def test_mixture_shares_lie_within_the_binomial_bound(oxe_root, tmp_path):
    """2000 frames of the training stream: each dataset's count within 4
    binomial standard deviations of its balanced weight."""
    root, _ = oxe_root
    ds, _, stats = tds.make_interleaved_dataset("bridge_rt_1", str(root), shuffle_buffer_size=64,
                                                load_pointcloud=False, image_size=16,
                                                stats_cache_dir=str(tmp_path / "t"), proprio_dim=7)
    n = 2000
    names = [bytes(f["dataset_name"]).decode() for f in ds.take(n)]
    w, _ = tds.compute_sample_weights([1.0, 1.0], [stats[k]["num_transitions"] for k in NAMES], True)
    for name, p in zip(NAMES, w):
        k = names.count(name)
        assert abs(k - n * p) <= 4 * np.sqrt(n * p * (1 - p)), (name, k, n * p)


@pytest.mark.parametrize("views", [("primary",), ("primary", "wrist")], ids=lambda v: "+".join(v))
def test_explicit_camera_views_match_jax(oxe_root, tmp_path, views):
    """load_camera_views through the kwargs factory on franka (a 7-float
    proprio): its masks, the requested views (wrist padded), frames against
    JAX's."""
    root, _ = oxe_root
    kw = dict(load_pointcloud=True, load_tactile=True, load_camera_views=views)
    ds, n, stats = _port(root, "franka", tmp_path, proprio_dim=7, **kw)
    jd, jn, jstats = _jax(root, "franka", tmp_path, **kw)
    assert n == jn
    assert_tree_equal(jstats, stats)
    it = jd.as_numpy_iterator()
    for a in ds.take(10):
        b = next(it)
        a_rest, a_img = split_images(a)
        b_rest, b_img = split_images(b)
        assert set(a_img) == set(b_img) == {f"image_{v}" for v in views}
        for k in a_img:
            assert_images_close(b_img[k], a_img[k])
        assert_tree_equal(b_rest, a_rest)


def test_frame_filter_drops_droids_zero_actions():
    zero = np.concatenate([np.tile(np.float32(2) * (0 - tox._DROID_Q01) / (tox._DROID_Q99 - tox._DROID_Q01
                                                                         + np.float32(1e-8)) - 1, (4, 1)),
                           np.zeros((4, 1), np.float32)], axis=1).astype(np.float32)
    frames = [{"action": zero}, {"action": zero + 1}, {"action": zero}]
    kept = list(tds.apply_per_dataset_frame_transforms(Dataset(lambda: iter(frames)),
                                                       chunk_filter_fn=tox.droid_zero_action_filter))
    assert len(kept) == 1 and kept[0] is frames[1]


# --------------------------------------------------------------------------- #
# the weighted interleave
# --------------------------------------------------------------------------- #


def test_tf_default_keeps_sampling_past_an_empty_input():
    sig = inspect.signature(tf.data.Dataset.sample_from_datasets)
    assert sig.parameters["stop_on_empty_dataset"].default is False


def test_sample_from_datasets_drops_an_exhausted_input():
    a, b = Dataset(lambda: iter(range(100))), Dataset(lambda: iter(range(1000, 1010)))
    out = list(Dataset.sample_from_datasets([a, b], [0.5, 0.5], seed=3))
    assert sorted(out) == list(range(100)) + list(range(1000, 1010))
    assert [x for x in out if x < 1000] == list(range(100))  # each input keeps its order
    assert out == list(Dataset.sample_from_datasets([a, b], [0.5, 0.5], seed=3))
    assert out != list(Dataset.sample_from_datasets([a, b], [0.5, 0.5], seed=4))


@pytest.mark.parametrize("weights", [[0.2, 0.8], [0.7, 0.1, 0.2], [3.0, 3.0, 3.0]])
def test_sample_from_datasets_shares(weights):
    k = len(weights)
    streams = [Dataset(lambda i=i: iter(lambda: i, None)) for i in range(k)]
    n = 20000
    picks = np.array(list(Dataset.sample_from_datasets(streams, weights, seed=0).take(n)))
    p = np.asarray(weights) / np.sum(weights)
    for i in range(k):
        assert abs((picks == i).sum() - n * p[i]) <= 4 * np.sqrt(n * p[i] * (1 - p[i]))


@pytest.mark.parametrize("weights", [[1.0], [-1.0, 2.0], [0.0, 0.0]])
def test_sample_from_datasets_checks_its_weights(weights):
    with pytest.raises(ValueError):
        Dataset.sample_from_datasets([Dataset(lambda: iter([]))] * 2, weights)


# --------------------------------------------------------------------------- #
# the trainer on the mixture
# --------------------------------------------------------------------------- #


def test_trainer_takes_a_step_on_bridge_rt_1(oxe_root, tmp_path):
    """python -m mla_tpu_torch.train --device cpu --data_mix bridge_rt_1
    --use_pointcloud false --use_contrastive false: one step on mla-tiny and
    a checkpoint; the run dir's statistics equal JAX's of each dataset."""
    root, _ = oxe_root
    cmd = [sys.executable, "-m", "mla_tpu_torch.train", "--device", "cpu", "--vla.type", "mla-tiny-debug",
           "--data_root_dir", str(root), "--data_mix", "bridge_rt_1", "--use_pointcloud", "false",
           "--use_contrastive", "false", "--shuffle_buffer_size", "16", "--max_steps", "1", "--save_interval", "1",
           "--run_root_dir", str(tmp_path / "runs"), "--run_id", "oxe"]
    env = {**os.environ, "HOME": str(tmp_path / "home")}
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    run = tmp_path / "runs" / "oxe"
    assert list((run / "checkpoints").glob("step-000001-*/state.pt"))
    log = proc.stdout + proc.stderr
    # what the mixture drops, once per dataset
    assert log.count("its frames carry a zero proprio") == 2
    assert log.count("drops camera views") == 1 and "`bridge_orig` drops camera views ['secondary']" in log
    written = json.loads((run / "dataset_statistics.json").read_text())
    assert sorted(written) == sorted(NAMES)
    for name in NAMES:
        _, jstats = jds.make_dataset_from_rlds(name, str(root), load_pointcloud=False,
                                               stats_cache_dir=str(tmp_path / "j"))
        assert written[name] == json.loads(json.dumps(_as_lists(jstats)))


def test_the_fixture_frames_are_jpeg(oxe_root):
    written = oxe_root[1]
    for name, cam in (("bridge_orig", "image_0"), ("bridge_orig", "image_1"), ("fractal20220817_data", "image")):
        data = written[name][0]["steps"]["observation"][cam][0]
        assert data.startswith(jpeg.SIGNATURE)
        assert jpeg.decode(data).shape == (*chip_smoke.OXE_SIZES[name], 3)
