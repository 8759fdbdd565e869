"""The port's Open-X-Embodiment standardization transforms, frame filters and
kwargs factory (mla_tpu_torch/vla/rlds/oxe/) against the JAX package's.

Every name of JAX's OXE_STANDARDIZATION_TRANSFORMS runs JAX's transform
(TensorFlow graph ops, eagerly) and the port's (numpy) on the same seeded
raw trajectory in that dataset's schema. The outputs hold the same keys,
shapes and dtypes, and equal values exactly, except where a transform
calls a transcendental. There TensorFlow runs Eigen's float32 polynomials
(atan to 2 units in the last place, ulp, by Eigen's own account; its asin
measures up to 3.5 here) and the port the correctly rounded value (within
0.5 ulp): quat_to_euler's angles are held within 4 ulp of their own value,
and the DROID rotation matrices, whose entries cancel, within 4 ulp of 1
(their scale), 2^-21 absolute. The gripper conventions are held exactly,
the factory's kwargs equal JAX's for every named mixture and view set,
callables compared by name."""

import zlib

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from mla_tpu.vla.rlds import transforms as jT  # noqa: E402
from mla_tpu.vla.rlds.oxe import materialize as jmat  # noqa: E402
from mla_tpu.vla.rlds.oxe import mixtures as jmix  # noqa: E402
from mla_tpu.vla.rlds.oxe import transforms as jox  # noqa: E402
from mla_tpu_torch.vla.rlds import transforms as tT  # noqa: E402
from mla_tpu_torch.vla.rlds.oxe import configs as tcfg  # noqa: E402
from mla_tpu_torch.vla.rlds.oxe import materialize as tmat  # noqa: E402
from mla_tpu_torch.vla.rlds.oxe import mixtures as tmix  # noqa: E402
from mla_tpu_torch.vla.rlds.oxe import transforms as tox  # noqa: E402

T_LEN = 9
ULP = 4  # float32 units in the last place, for the transcendental outputs (see above)
# (transform, output path) whose values pass through a transcendental
TRANSCENDENTAL = {
    "furniture_bench_transform": {("action",)},
    "iamlab_pick_insert_transform": {("action",)},
    "cmu_playing_with_food_transform": {("action",)},
}


# --------------------------------------------------------------------------- #
# seeded raw trajectories, one schema a transform
# --------------------------------------------------------------------------- #


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _raw(fn_name: str, name: str) -> dict:
    """A raw trajectory in the schema `fn_name` reads (the dataset `name`'s)."""
    rng = _rng(name)

    def f(*shape):
        return rng.normal(size=(T_LEN, *shape)).astype(np.float32)

    def img():
        out = np.empty(T_LEN, object)
        out[:] = [bytes(rng.integers(0, 256, 12, dtype=np.uint8)) for _ in range(T_LEN)]
        return out

    def lang(text=b"wipe the table"):
        out = np.empty(T_LEN, object)
        out[:] = [text] * T_LEN
        return out

    def grip01():
        return rng.choice(np.float32([0.0, 0.02, 0.5, 0.97, 1.0]), T_LEN)

    def griprel(shape=(T_LEN, 1)):
        return rng.choice(np.float32([-1.0, 0.0, 0.0, 1.0, 0.05]), T_LEN).reshape(shape)

    def quat_action(grip_last=True):
        q = rng.normal(size=(T_LEN, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        return np.concatenate([f(3), q.astype(np.float32), grip01()[:, None]], axis=1)

    def dict_action(grip_shape=(T_LEN, 1)):
        return {"world_vector": f(3), "rotation_delta": f(3),
                "gripper_closedness_action": griprel(grip_shape)}

    flat7 = np.concatenate([f(6), grip01()[:, None]], axis=1)
    obs_nli = {"image": img(), "natural_language_instruction": lang()}
    schemas = {
        "bridge_oxe_transform": lambda: {
            "observation": {"image": img(), "image_1": img(), "state": f(7), "natural_language_instruction": lang()},
            "action": {"world_vector": f(3), "rotation_delta": f(3),
                       "open_gripper": rng.integers(0, 2, T_LEN).astype(bool)},
            "traj_metadata": {"episode_id": np.arange(T_LEN, dtype=np.int64)}},
        "bridge_orig_transform": lambda: {
            "observation": {"image_0": img(), "image_1": img(), "state": f(7)},
            "action": np.concatenate([np.zeros((1, 7), np.float32), flat7[1:]]), "language_instruction": lang()},
        "tdroid_transform": lambda: {
            "observation": {"static_image": img(), "cartesian_position": f(6), "gripper_position": f(1)},
            "action": flat7, "language_instruction": lang()},
        "ppgm_transform": lambda: {
            "observation": {"image": img(), "cartesian_position": f(6), "gripper_position": f(1)},
            "action": flat7, "language_instruction": lang()},
        "rt1_transform": lambda: {
            "observation": {**obs_nli, "base_pose_tool_reached": f(7), "gripper_closed": f(1)},
            "action": dict_action()},
        "kuka_transform": lambda: {
            "observation": {**obs_nli, "clip_function_input/base_pose_tool_reached": _zipped(f(7)),
                            "gripper_closed": _zipped(f(1))},
            "action": dict_action()},
        "taco_play_transform": lambda: {
            "observation": {"rgb_static": img(), "robot_obs": f(15), "natural_language_instruction": lang()},
            "action": {"rel_actions_world": np.concatenate([f(6), griprel()], axis=1)}},
        "jaco_play_transform": lambda: {
            "observation": {**obs_nli, "end_effector_cartesian_pos": f(7)}, "action": dict_action()},
        "berkeley_cable_routing_transform": lambda: {
            "observation": {**obs_nli, "robot_state": f(7)},
            "action": {"world_vector": f(3), "rotation_delta": f(3)}},
        "roboturk_transform": lambda: {
            "observation": {"front_rgb": img(), "natural_language_instruction": lang()},
            "action": {**dict_action(), "gripper_closedness_action": f(1) * 2}},
        "nyu_door_opening_transform": lambda: {"observation": obs_nli, "action": dict_action()},
        "viola_transform": lambda: {
            "observation": {"agentview_rgb": img(), "joint_states": f(7), "gripper_states": f(1),
                            "natural_language_instruction": lang()},
            "action": {**dict_action((T_LEN,)), "gripper_closedness_action": f() * 2}},
        "berkeley_autolab_ur5_transform": lambda: {
            "observation": {**obs_nli, "robot_state": f(15), "image_with_depth": f(4, 4, 1)},
            "action": dict_action((T_LEN,))},
        "toto_transform": lambda: {
            "observation": {**obs_nli, "state": f(7)},
            "action": {"world_vector": f(3), "rotation_delta": f(3),
                       "open_gripper": rng.integers(0, 2, T_LEN).astype(bool)}},
        "language_table_transform": lambda: {
            "observation": {"rgb": img(), "instruction": _codepoints(rng), "effector_translation": f(2)},
            "action": f(2)},
        "pusht_transform": lambda: {"observation": obs_nli, "action": dict_action((T_LEN,))},
        "stanford_kuka_multimodal_transform": lambda: {
            "observation": {"image": img(), "depth_image": f(4, 4, 1), "ee_position": f(3)},
            "action": f(7), "language_instruction": lang()},
        "iamlab_pick_insert_transform": lambda: {
            "observation": {"image": img(), "state": f(10)}, "action": quat_action(),
            "language_instruction": lang()},
        "furniture_bench_transform": lambda: {
            "observation": {"image": img(), "state": f(35)}, "action": quat_action(),
            "language_instruction": lang()},
        "cmu_playing_with_food_transform": lambda: {
            "observation": {"image": img(), "state": f(8)}, "action": quat_action(),
            "language_instruction": lang()},
        "nyu_franka_play_transform": lambda: {
            "observation": {"image": img(), "depth": rng.integers(0, 999, (T_LEN, 4, 4, 1)).astype(np.int32),
                            "depth_additional_view": rng.integers(0, 999, (T_LEN, 4, 4, 1)).astype(np.int32),
                            "state": f(13)},
            "action": np.concatenate([f(13), grip01()[:, None] * 1.4 - 0.2, f(1)], axis=1),
            "language_instruction": lang()},
        "bc_z_transform": lambda: {
            "observation": {**obs_nli, "present/xyz": f(3)},
            "action": {"future/xyz_residual": f(30), "future/axis_angle_residual": f(30),
                       "future/target_close": rng.integers(0, 2, (T_LEN, 10)).astype(np.int64)}},
        "asu_table_top_transform": lambda: {
            "observation": {"image": img(), "state": f(7)}, "ground_truth_states": {"EE": f(6)},
            "action": f(7), "language_instruction": lang()},
        "droid_baseact_transform": lambda: _droid(f, img, lang),
        "droid_finetuning_transform": lambda: _droid(f, img, lang),
        "fmb_transform": lambda: {
            "observation": {"image_side_1": img(), "eef_pose": f(6), "state_gripper_pose": f()},
            "action": flat7, "language_instruction": lang()},
        "rh20t_transform": lambda: {
            "observation": {"image_front": img(), "tcp_base": f(7), "gripper_width": f()},
            "action": {"tcp_base": f(6), "gripper": rng.integers(0, 2, T_LEN).astype(np.int64)},
            "language_instruction": lang()},
        "gnm_transform": lambda: {
            "observation": {"image": img(), "position": f(2), "yaw": f(1), "state": f(5)},
            "action": f(2), "language_instruction": lang()},
        "berkeley_fanuc_transform": lambda: {
            "observation": {"image": img(), "state": f(7)}, "action": f(6), "language_instruction": lang()},
        "uiuc_d3field_transform": lambda: {
            "observation": {"image_1": img()}, "action": f(3), "language_instruction": lang()},
        "stanford_mask_vit_transform": lambda: {
            "observation": {"image": img(), "end_effector_pose": f(5)}, "action": f(5),
            "language_instruction": lang()},
        "robo_net_transform": lambda: {
            "observation": {"image": img(), "state": f(5)}, "action": f(5), "language_instruction": lang()},
        "rlbench_transform": lambda: {
            "observation": {"front_image": img(), "point_cloud": f(16, 3), "proprio": f(7)},
            "action": f(7), "language_instruction": lang()},
        "metaworld_transform": lambda: {
            "observation": {"image_third": img(), "point_cloud": f(16, 3), "proprio": f(4)},
            "action": f(4), "language_instruction": lang()},
        "franka_transform": lambda: {
            "observation": {"image_third": img(), "image_wrist": img(), "point_cloud": f(16, 3), "proprio": f(7),
                            "tactile_right": f(6), "tactile_left": f(6), "gripper_xyz": f(3)},
            "action": f(7), "language_instruction": lang()},
        "agilex_transform": lambda: {
            "observation": {"image_head": img(), "image_right": img(), "image_left": img(), "proprio": f(14)},
            "action": f(14), "language_instruction": lang()},
        "rtx_dataset_transform": lambda: {
            "observation": {"image": img(), "proprio": f(7)}, "action": f(7), "language_instruction": lang()},
    }
    # the rest read a flat action and a packed state
    generic = lambda: {  # noqa: E731
        "observation": {"image": img(), "wrist_image": img(), "state": f(24)},
        "action": np.concatenate([f(6), grip01()[:, None] * 1.4 - 0.2, f(8)], axis=1),
        "language_instruction": lang()}
    return schemas.get(fn_name, generic)()


def _zipped(x):
    out = np.empty(len(x), object)
    out[:] = [zlib.compress(row.tobytes()) for row in x]
    return out


def _codepoints(rng):
    codes = np.zeros((T_LEN, 32), np.int32)
    for i in range(T_LEN):
        text = "push the red block" if i % 2 else "slide the blue moon ☾ left"
        codes[i, :len(text)] = [ord(c) for c in text]
    return codes


def _droid(f, img, lang):
    return {"observation": {"exterior_image_1_left": img(), "exterior_image_2_left": img(),
                            "wrist_image_left": img(), "cartesian_position": f(6), "gripper_position": f(1)},
            "action_dict": {"cartesian_velocity": f(6), "gripper_position": f(1)},
            "action": f(7), "language_instruction": lang()}


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def _to_tf(tree):
    if isinstance(tree, dict):
        return {k: _to_tf(v) for k, v in tree.items()}
    return tf.convert_to_tensor(tree)


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return tree.numpy() if hasattr(tree, "numpy") else np.asarray(tree)


def _ulps(a, b):
    """|a - b| in float32 units in the last place of b."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    spacing = np.spacing(np.maximum(np.abs(b), np.finfo(np.float32).tiny))
    return np.abs(a.astype(np.float64) - b.astype(np.float64)) / spacing


def assert_trees_match(got, want, close=frozenset(), path=()):
    """Same keys, shapes and dtypes; values equal, within ULP where the
    path is in `close`."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_trees_match(got[k], want[k], close, path + (k,))
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    if want.dtype.kind in "OSU":
        assert got.dtype == object, (path, got.dtype)
        assert [bytes(x) for x in got.reshape(-1)] == [bytes(x) for x in want.reshape(-1)], path
        return
    assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
    if path in close:
        assert _ulps(got, want).max(initial=0) <= ULP, (path, _ulps(got, want).max())
    else:
        assert np.array_equal(got, want), (path, got, want)


# --------------------------------------------------------------------------- #
# the registry
# --------------------------------------------------------------------------- #


def test_registry_names_match_jax():
    assert list(tox.OXE_STANDARDIZATION_TRANSFORMS) == list(jox.OXE_STANDARDIZATION_TRANSFORMS)
    assert set(tox.FRAME_FILTERS) == set(jox.FRAME_FILTERS)
    for name, fn in jox.OXE_STANDARDIZATION_TRANSFORMS.items():
        assert tox.OXE_STANDARDIZATION_TRANSFORMS[name].__name__ == fn.__name__, name


def test_unknown_name_is_the_identity():
    assert tox.get_standardization_transform("no_such_dataset") is tox.identity_transform
    assert jox.get_standardization_transform("no_such_dataset").__name__ == "identity_transform"
    for name in jox.OXE_STANDARDIZATION_TRANSFORMS:
        assert tox.get_standardization_transform(name) is tox.OXE_STANDARDIZATION_TRANSFORMS[name]


@pytest.mark.parametrize("name", list(jox.OXE_STANDARDIZATION_TRANSFORMS))
def test_transform_matches_jax(name):
    fn_name = jox.OXE_STANDARDIZATION_TRANSFORMS[name].__name__
    raw = _raw(fn_name, name)
    want = _to_np(jox.OXE_STANDARDIZATION_TRANSFORMS[name](_to_tf(_copy(raw))))
    given = _copy(raw)
    got = tox.OXE_STANDARDIZATION_TRANSFORMS[name](given)
    close = TRANSCENDENTAL.get(fn_name, frozenset())
    if fn_name == "droid_baseact_transform":  # each side swaps the exterior cameras at random
        obs = want["observation"]
        swapped = {**want, "observation": {**obs, "exterior_image_1_left": obs["exterior_image_2_left"],
                                           "exterior_image_2_left": obs["exterior_image_1_left"]}}
        first = [bytes(x) for x in got["observation"]["exterior_image_1_left"]]
        want = want if first == [bytes(x) for x in obs["exterior_image_1_left"]] else swapped
    assert_trees_match(got, want, close)
    # no array the transform was given is written into
    for key, val in raw["observation"].items():
        if isinstance(val, np.ndarray) and val.dtype != object:
            assert np.array_equal(_copy(raw)["observation"][key], val)


def test_droid_swaps_both_ways():
    raw = _raw("droid_baseact_transform", "droid")
    firsts = {bytes(tox.droid_baseact_transform(_copy(raw))["observation"]["exterior_image_1_left"][0])
              for _ in range(40)}
    assert firsts == {bytes(raw["observation"]["exterior_image_1_left"][0]),
                      bytes(raw["observation"]["exterior_image_2_left"][0])}


# --------------------------------------------------------------------------- #
# frame filters and helpers
# --------------------------------------------------------------------------- #


def _droid_zero(chunk=16):
    q01, q99 = tox._DROID_Q01, tox._DROID_Q99
    zero = np.float32(2) * (np.float32(0) - q01) / (q99 - q01 + np.float32(1e-8)) - np.float32(1)
    return np.concatenate([np.tile(zero, (chunk, 1)), np.full((chunk, 1), 0.5, np.float32)], axis=1)


@pytest.mark.parametrize("case", ["zero", "zero+1e-6", "zero+1e-4", "one-step-moves", "random"])
def test_frame_filters_match_jax(case):
    rng = np.random.default_rng(3)
    act = _droid_zero()
    if case == "zero+1e-6":
        act = act + np.float32(1e-6)
    elif case == "zero+1e-4":
        act = act + np.float32(1e-4)
    elif case == "one-step-moves":
        act[5, 2] += np.float32(0.3)
    elif case == "random":
        act = rng.normal(size=act.shape).astype(np.float32)
    for name, fn in jox.FRAME_FILTERS.items():
        want = bool(fn({"action": tf.constant(act)}))
        assert tox.FRAME_FILTERS[name]({"action": act}) is want, (name, case)


@pytest.mark.parametrize("seq", [
    [1.0, 0.97, 0.5, 0.03, 0.0, 0.0], [0.5, 0.5, 0.5], [0.2, 1.0, 0.3, 0.04], [0.0], [0.96, 0.5], [0.05, 0.95, 0.951],
])
def test_binarize_matches_jax(seq):
    a = np.asarray(seq, np.float32)
    want = jT.binarize_gripper_actions(tf.constant(a)).numpy()
    got = tT.binarize_gripper_actions(a)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("seq", [
    [0, 1, 0, -1, 0, 1], [0, 0, 0], [0, 0, -1], [1], [0.05, -0.2, 0.15, 0.0], [-1, -1, 0],
])
def test_rel2abs_matches_jax(seq):
    a = np.asarray(seq, np.float32)
    want = jT.rel2abs_gripper_actions(tf.constant(a)).numpy()
    got = tT.rel2abs_gripper_actions(a)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


def test_invert_matches_jax():
    a = np.float32([0, 0.25, 1, 1.5, -0.5])
    assert np.array_equal(tT.invert_gripper_actions(a), jT.invert_gripper_actions(tf.constant(a)).numpy())


def test_quat_to_euler_within_ulps_of_jax():
    rng = np.random.default_rng(11)
    q = rng.normal(size=(512, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q = np.concatenate([q, [[0, 0.7071068, 0, 0.7071068], [0, 0, 0, 1], [1, 0, 0, 0]]]).astype(np.float32)
    want = jox.quat_to_euler(tf.constant(q)).numpy()
    got = tox.quat_to_euler(q)
    assert got.dtype == np.float32 and _ulps(got, want).max() <= ULP


def test_droid_rotations_within_ulps_of_jax():
    rng = np.random.default_rng(12)
    e = rng.uniform(-3, 3, (256, 3)).astype(np.float32)
    got, want = tox._euler_to_rmat(e), jox._euler_to_rmat(tf.constant(e)).numpy()
    assert got.dtype == np.float32 and np.abs(got - want).max() <= ULP * 2.0 ** -23
    vel, pose = rng.normal(size=(64, 6)), rng.normal(size=(64, 6))
    # in float64, where the products' order leaves no visible trace
    want = jox.velocity_act_to_wrist_frame(tf.constant(vel), tf.constant(pose)).numpy()
    np.testing.assert_allclose(tox.velocity_act_to_wrist_frame(vel, pose), want, rtol=0, atol=1e-12)


# --------------------------------------------------------------------------- #
# the kwargs factory
# --------------------------------------------------------------------------- #


def _comparable(kwargs):
    out = {}
    for k, v in kwargs.items():
        if callable(v):
            out[k] = ("callable", v.__name__)
        elif isinstance(v, dict):
            out[k] = _comparable(v)
        elif hasattr(v, "value"):  # an enum
            out[k] = ("enum", v.value)
        else:
            out[k] = v
    return out


VIEWS = [("primary",), ("primary", "wrist"), ("primary", "secondary", "wrist")]


@pytest.mark.parametrize("views", VIEWS, ids=lambda v: "+".join(v))
@pytest.mark.parametrize("mix", sorted(jmix.OXE_NAMED_MIXTURES))
def test_mixture_kwargs_and_weights_match_jax(mix, views):
    kw = dict(load_camera_views=views, load_pointcloud=False, load_tactile=False,
              action_proprio_normalization_type=jT.NormalizationType.BOUNDS_Q99)
    jk, jw = jmat.get_oxe_dataset_kwargs_and_weights("/data", jmix.OXE_NAMED_MIXTURES[mix], **kw)
    kw["action_proprio_normalization_type"] = tT.NormalizationType.BOUNDS_Q99
    tk, tw = tmat.get_oxe_dataset_kwargs_and_weights("/data", tmix.OXE_NAMED_MIXTURES[mix], **kw)
    assert tw == jw
    assert [_comparable(k) for k in tk] == [_comparable(k) for k in jk]


@pytest.mark.parametrize("views", VIEWS, ids=lambda v: "+".join(v))
def test_dataset_kwargs_match_jax_for_every_config(views):
    """make_oxe_dataset_kwargs for every configured dataset: equal kwargs,
    or the same refusal (ValueError)."""
    for name in tcfg.OXE_DATASET_CONFIGS:
        try:
            want = _comparable(jmat.make_oxe_dataset_kwargs(name, "/data", views, load_depth=True))
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split(";")[0]):
                tmat.make_oxe_dataset_kwargs(name, "/data", views, load_depth=True)
            continue
        assert _comparable(tmat.make_oxe_dataset_kwargs(name, "/data", views, load_depth=True)) == want, name


def test_factory_resolves_frame_filters_and_dedups():
    kw = tmat.make_oxe_dataset_kwargs("droid", "/data")
    assert kw["dataset_frame_transform_kwargs"]["chunk_filter_fn"] is tox.droid_zero_action_filter
    spec = [("bridge_orig", 1.0), ("fractal20220817_data", 0.5), ("bridge_orig", 3.0)]
    tk, tw = tmat.get_oxe_dataset_kwargs_and_weights("/data", spec)
    assert [k["name"] for k in tk] == ["bridge_orig", "fractal20220817_data"] and tw == [1.0, 0.5]
