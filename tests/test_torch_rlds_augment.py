"""The RLDS train-time transforms of the port (vla/rlds/transforms.py)
against the JAX package's TensorFlow ops.

  * The Philox-4x32-10 draw equals tf.random.stateless_uniform exactly.
  * crop_and_resize, AdjustContrastv2, AdjustSaturation and AdjustHue
    equal TensorFlow's float kernels exactly, and augment_image equals
    mla_tpu.vla.rlds.transforms.augment_image pixel for pixel (the bound
    is 0: every op is replayed in TensorFlow's float32 order) for the
    default kwargs and for each op alone, on several seeds, uint8 and
    float, at 256 and 672 pixels.
  * goal_relabel_uniform, delete_task_conditioning and subsample keep
    their rules with the port's draws, and equal JAX's when the same draw
    is injected into both (TensorFlow's stateful RNG patched to return it).
  * The pipeline applies them in JAX's order on the rlbench fixture, with
    JAX's seed rules for the frame stage.
"""

import numpy as np
import pytest
import tensorflow as tf

from mla_tpu.vla.rlds import transforms as jT
from mla_tpu.vla.rlds.dataset import DEFAULT_IMAGE_AUGMENT_KWARGS as JAX_DEFAULTS
from mla_tpu_torch.vla.rlds import dataset as tds
from mla_tpu_torch.vla.rlds import transforms as tT

SEEDS = [[1, 2], [77, -5], [2**31 - 2, 123456]]
OPS = {
    "crop": {"random_resized_crop": {"scale": [0.7, 0.95], "ratio": [0.8, 1.25]},
             "augment_order": ["random_resized_crop"]},
    "brightness": {"random_brightness": [0.2], "augment_order": ["random_brightness"]},
    "contrast": {"random_contrast": [0.8, 1.2], "augment_order": ["random_contrast"]},
    "saturation": {"random_saturation": [0.8, 1.2], "augment_order": ["random_saturation"]},
    "hue": {"random_hue": [0.05], "augment_order": ["random_hue"]},
    "flip": {"random_flip": True, "augment_order": ["random_flip"]},
    "default": JAX_DEFAULTS,
}


def _image(size, dtype, seed=0):
    rng = np.random.default_rng(seed + size)
    yy, xx = np.mgrid[:size, :size]
    img = np.clip(np.stack([xx * 255 / size, yy * 255 / size, (xx + yy) * 127 / size], -1)
                  + rng.integers(-40, 41, (size, size, 3)), 0, 255).astype(np.uint8)
    img[: size // 8, : size // 8] = 128  # gray: hue and saturation of a zero range
    return img if dtype == "uint8" else img.astype(np.float32) / np.float32(255)


# --------------------------------------------------------------------------- #
# the draw
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", SEEDS + [[0, 0], [-1, -1]], ids=str)
@pytest.mark.parametrize("shape,lo,hi", [([], 0.0, 1.0), ([7], -0.2, 0.2), ([1001], 0.8, 1.2)], ids=["scalar", "7", "1001"])
def test_philox_draw_equals_tensorflow(seed, shape, lo, hi):
    want = tf.random.stateless_uniform(shape, tf.constant(seed, tf.int32), lo, hi).numpy()
    got = tT.stateless_uniform(shape, seed, lo, hi)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_philox_bits_against_the_reference_vector():
    """Philox-4x32-10 of counter 0 under key 0 (Random123's known answer)."""
    assert tT._philox([0, 0, 0, 0], [0, 0]) == (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)


# --------------------------------------------------------------------------- #
# the ops
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shape", [(67, 45), (256, 256), (1, 9)], ids=str)
def test_color_ops_equal_tensorflow_kernels(shape):
    img = np.random.default_rng(sum(shape)).random(shape + (3,), dtype=np.float32)
    img[0, 0] = 0.5
    for f in (0.8, 1.13):
        np.testing.assert_array_equal(tT.adjust_contrast(img, f), tf.image.adjust_contrast(img, f).numpy())
        np.testing.assert_array_equal(tT.adjust_saturation(img, f), tf.image.adjust_saturation(img, f).numpy())
    for d in (-0.05, 0.031, 0.5):
        np.testing.assert_array_equal(tT.adjust_hue(img, d), tf.image.adjust_hue(img, d).numpy())


@pytest.mark.parametrize("box", [[0.05, 0.03, 0.95, 0.97], [0.0123, 0.0456, 0.9123, 0.9456], [-0.1, 0.2, 1.1, 0.9]],
                         ids=["inside", "odd", "outside"])
def test_crop_and_resize_equals_tensorflow(box):
    img = np.random.default_rng(1).random((40, 30, 3), dtype=np.float32) * 255
    for size in ((40, 30), (17, 50)):
        want = tf.image.crop_and_resize(img[None], [box], [0], size).numpy()[0]
        np.testing.assert_array_equal(tT.crop_and_resize(img, np.asarray(box, np.float32), size), want)


@pytest.mark.parametrize("size", [256, 672])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("op", list(OPS))
def test_augment_image_equals_jax(op, dtype, size):
    img = _image(size, dtype)
    for seed in SEEDS:
        want = jT.augment_image(tf.constant(img), tf.constant(seed, tf.int32), **OPS[op]).numpy()
        got = tT.augment_image(img, seed, **OPS[op])
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{op} seed {seed}")


def test_augment_image_moves_the_pixels():
    img = _image(256, "uint8")
    a, b = tT.augment_image(img, [1, 2], **JAX_DEFAULTS), tT.augment_image(img, [1, 3], **JAX_DEFAULTS)
    assert not np.array_equal(a, img) and not np.array_equal(a, b)
    np.testing.assert_array_equal(a, tT.augment_image(img, [1, 2], **JAX_DEFAULTS))


# --------------------------------------------------------------------------- #
# the trajectory transforms
# --------------------------------------------------------------------------- #


def _traj(T=9, seed=0):
    rng = np.random.default_rng(seed)
    instr = np.array([b"pick the cube"] * T, object)
    instr[T // 2] = b""  # a frame without an instruction keeps its goal image
    traj = {
        "observation": {"image_primary": np.array([bytes([65 + i]) * 5 for i in range(T)], object),
                        "proprio": rng.normal(size=(T, 7)).astype(np.float32)},
        "task": {"language_instruction": instr, "timestep": np.arange(T, dtype=np.int32)},
        "action": rng.normal(size=(T, 7)).astype(np.float32),
        "dataset_name": np.array([b"rlbench"] * T, object),
    }
    return tT.add_pad_mask_dict(traj)


def _tf_traj(traj):
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        x = np.asarray(x)
        return tf.constant(x.astype(bytes) if x.dtype == object else x)
    return conv(traj)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    a = np.asarray(tree.numpy() if hasattr(tree, "numpy") else tree)
    return a.astype(object) if a.dtype.kind == "S" else a


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def test_goal_relabel_rule_and_jax(monkeypatch):
    T = 9
    for s in range(20):
        out = tT.goal_relabel_uniform(_traj(T), np.random.default_rng(s))
        goal = np.array([x[0] - 65 for x in out["task"]["image_primary"]])
        t = np.arange(T)
        assert np.all((goal > t) | (t == T - 1)) and np.all(goal < T), goal
        np.testing.assert_array_equal(out["task"]["proprio"], out["observation"]["proprio"][goal])
    u = np.random.default_rng(5).random(T, dtype=np.float32)
    monkeypatch.setattr(tf.random, "uniform", lambda shape, *a, **k: tf.constant(u))
    want = _np(jT.goal_relabel_uniform(_tf_traj(_traj(T))))
    low = np.arange(1, T + 1, dtype=np.float32)
    got = tT.goal_relabel_uniform(_traj(T), goal_idxs=(u * (np.float32(T) - low) + low).astype(np.int32))
    _assert_tree_equal(got, want)


def test_delete_task_conditioning_rule_and_jax(monkeypatch):
    T = 9
    for s in range(20):
        traj = tT.goal_relabel_uniform(_traj(T), np.random.default_rng(s))
        out = tT.delete_task_conditioning(traj, 0.5, np.random.default_rng(s + 100))
        task = out["task"]
        has_img = np.array([len(x) > 0 for x in task["image_primary"]])
        has_lang = np.array([len(x) > 0 for x in task["language_instruction"]])
        assert np.all(has_img != has_lang), (has_img, has_lang)  # exactly one of the two on every frame
        assert has_img[T // 2]  # no instruction: the goal image stays
        np.testing.assert_array_equal(task["pad_mask_dict"]["image_primary"], has_img)
        np.testing.assert_array_equal(task["timestep"][~has_img], T - 1)
    u = np.random.default_rng(7).random(T, dtype=np.float32)
    monkeypatch.setattr(tf.random, "uniform", lambda shape, *a, **k: tf.constant(u))
    base = tT.goal_relabel_uniform(_traj(T), goal_idxs=np.minimum(np.arange(T) + 1, T - 1))
    want = _np(jT.delete_task_conditioning(_tf_traj(base), keep_image_prob=0.4))
    got = tT.delete_task_conditioning(tT.goal_relabel_uniform(_traj(T), goal_idxs=np.minimum(np.arange(T) + 1, T - 1)),
                                      0.4, keep_images=u < 0.4)
    _assert_tree_equal(got, want)


def test_subsample_rule_and_jax(monkeypatch):
    T = 9
    for s in range(20):
        out = tT.subsample(_traj(T), 4, np.random.default_rng(s))
        idx = np.array([x[0] - 65 for x in out["observation"]["image_primary"]])
        assert len(idx) == 4 and np.all(np.diff(idx) > 0) and idx.max() < T
        np.testing.assert_array_equal(out["action"], _traj(T)["action"][idx])
    assert len(tT.subsample(_traj(3), 4, np.random.default_rng(0))["action"]) == 3
    perm = np.random.default_rng(3).permutation(T).astype(np.int32)
    monkeypatch.setattr(tf.random, "shuffle", lambda x, *a, **k: tf.constant(perm))
    want = _np(jT.subsample(_tf_traj(_traj(T)), 4))
    got = tT.subsample(_traj(T), 4, indices=np.sort(perm[:4]))
    _assert_tree_equal(got, want)


# --------------------------------------------------------------------------- #
# the pipeline
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    from test_tfds_builder import write_rlbench_fixture

    d = tmp_path_factory.mktemp("rlds_aug")
    write_rlbench_fixture(d, num_shards=1)
    return d


def _frames(root, n=6, **kw):
    ds, _, _ = tds.make_interleaved_dataset("rlbench", str(root), shuffle_buffer_size=4, image_size=64,
                                            proprio_dim=7, stats_cache_dir=str(root / "stats"), seed=3, **kw)
    it = iter(ds)
    return [next(it) for _ in range(n)]


def test_pipeline_augments_on_the_fixture(data_root):
    """augment=True moves the pixels of every frame and nothing else; the
    same seed gives the same stream; image_augment_kwargs as one dict with
    augment_order."""
    plain, aug = _frames(data_root), _frames(data_root, augment=True)
    for a, b in zip(plain, aug):
        pa, pb = a["observation"]["image_primary"], b["observation"]["image_primary"]
        assert pa.shape == pb.shape and pb.dtype == np.uint8
        assert not np.array_equal(pa, pb)
        np.testing.assert_array_equal(a["action"], b["action"])
    again = _frames(data_root, augment=True)
    for a, b in zip(aug, again):
        np.testing.assert_array_equal(a["observation"]["image_primary"], b["observation"]["image_primary"])
    flip = _frames(data_root, n=2, image_augment_kwargs=OPS["flip"])
    assert flip[0]["observation"]["image_primary"].shape == plain[0]["observation"]["image_primary"].shape


def test_frame_stage_seed_rules():
    """One seed per frame, seed + i for the i-th key of the sorted dict,
    padding frames zeroed, only frames (at most one leading dim)."""
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    enc = [tf.io.encode_png(im).numpy() for im in imgs]
    d = {"image_a": np.array(enc, object), "depth": np.zeros(2), "image_b": np.array(enc[:1] * 2, object),
         "pad_mask_dict": {"image_a": np.array([True, False]), "image_b": np.array([True, True])}}
    kw = OPS["brightness"]
    seed = np.array([11, 22], np.int32)
    out = tds._transform_image_dict(dict(d), lambda k: (16, 16), lambda k: kw, seed)
    keys = sorted(d)
    dec = [tT.decode_and_resize_image(e, (16, 16)) for e in enc]
    np.testing.assert_array_equal(out["image_a"][0], tT.augment_image(dec[0], seed + keys.index("image_a"), **kw))
    np.testing.assert_array_equal(out["image_a"][1], 0)
    np.testing.assert_array_equal(out["image_b"][1], tT.augment_image(dec[0], seed + keys.index("image_b"), **kw))


def test_trajectory_options_run_in_the_pipeline(data_root):
    ds, stats = tds.make_dataset_from_rlds("rlbench", str(data_root), train=True, shuffle=False,
                                           stats_cache_dir=str(data_root / "stats"))
    out = list(tds.apply_trajectory_transforms(
        ds, goal_relabeling_strategy="uniform", task_augment_strategy="delete_task_conditioning",
        task_augment_kwargs={"keep_image_prob": 0.5}, subsample_length=5, dataset_statistics=stats, seed=1))
    assert out and all(len(t["action"]) <= 5 for t in out)
    assert all("image_front_image" in t["task"] or any(k.startswith("image_") for k in t["task"]) for t in out)
    with pytest.raises(KeyError):
        tds.apply_trajectory_transforms(ds, goal_relabeling_strategy="nearest")


def test_refusal_messages_name_their_items():
    """What still raises in the data path cites item 2: JPEG XL frames,
    unknown formats, the JPEG variants and image formats that Pillow reads
    and the port does not (frames.py, tiff.py's codecs, netpbm.py's
    test-only forms), directories written by tensorflow_datasets; training
    over tensor parallelism no longer raises (test_torch_tp_train.py; what
    tp still refuses cites item 16). Every PNG now decodes (no PNG refusal
    is left), a GIF frame decodes where it used to be refused, and the VLM
    loader passes on frames.py's refusal (its own constant is gone)."""
    from mla_tpu_torch.vla import vlm_datasets
    from mla_tpu_torch.vla.rlds import frames, gif, jpeg, netpbm, png, tfds_compat, tiff

    assert not hasattr(png, "ROADMAP_PNG")
    assert jpeg.ROADMAP_JPEG == "ROADMAP.md queue 1, item 2 (frame formats: JPEG variants)"
    assert tfds_compat.ROADMAP_TFDS == ("ROADMAP.md queue 1, item 2 (frame formats: directories written by "
                                        "tensorflow_datasets)")
    assert not hasattr(vlm_datasets, "ROADMAP_IMAGES")
    assert frames.ROADMAP_FRAMES == "ROADMAP.md queue 1, item 2 (frame formats)"
    assert tiff.ROADMAP_TIFF == "ROADMAP.md queue 1, item 2 (frame formats: TIFF codecs)"
    assert netpbm.ROADMAP_NETPBM == "ROADMAP.md queue 1, item 2 (frame formats: Netpbm extensions)"
    assert not hasattr(tds, "ROADMAP_DATA")
    with pytest.raises(NotImplementedError, match=r"JPEG XL.*item 2 \(frame formats\)"):
        tT.decode_image(b"\xff\x0a" + bytes(20))
    with pytest.raises(ValueError, match=r"unknown format.*item 2 \(frame formats\)"):
        tT.decode_image(b"II*\x00" + bytes(20))
    idx = np.arange(12, dtype=np.uint8).reshape(3, 4)
    table = np.arange(48, dtype=np.uint8).reshape(16, 3) * 5
    assert np.array_equal(tT.decode_image(gif.encode([idx], table)), table[idx])


def test_no_jax_check_covers_the_parallel_modules():
    import test_torch_no_jax as nj

    names = {p.relative_to(nj.ROOT).as_posix() for p in nj.FILES}
    assert {"mla_tpu_torch/parallel/mesh.py", "mla_tpu_torch/parallel/sharding.py",
            "mla_tpu_torch/parallel/collectives.py", "mla_tpu_torch/parallel/__init__.py"} <= names
