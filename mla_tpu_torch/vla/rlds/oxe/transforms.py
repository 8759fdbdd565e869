"""Per-dataset Open-X-Embodiment standardization transforms, in numpy.

The port's copy of mla_tpu/vla/rlds/oxe/transforms.py, entry for entry.
Each function takes one raw trajectory as the builder yields it (a dict of
numpy arrays, time leading: dict actions, zlib-compressed proprio, code
point instructions) and returns it standardized: `action` a flat [T, 7]
(or 8 for joint-space robots) laid out translation | rotation | gripper,
the gripper absolute (0 closed, 1 open); the proprio keys that configs.py's
`state_obs_keys` name synthesized from the raw state; `language_instruction`
lifted out of the observation where the builder stores it there. The MLA
suites (rlbench, metaworld, franka, franka_dual, agilex, rtx_dataset) add
next-frame copies of their camera, point-cloud and tactile keys.

The JAX transforms are TensorFlow graph ops on float32 tensors; these are
the same operations in numpy, in the same order and the same dtypes, so
slices, concatenations, clips and the gripper conventions give the same
values bit for bit. A transcendental (quat_to_euler's atan2 and asin, the
DROID rotations' sin and cos) is evaluated in float64 and rounded, where
TensorFlow runs Eigen's float32 polynomials: the two may part by a few
units in the last place. Each transform rebinds the entries it changes and
writes into no array it was given.

One draw cannot follow TensorFlow's: DROID's random exterior-camera swap
draws from numpy's generator (unseeded, as TensorFlow's draw is).
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict

import numpy as np

from mla_tpu_torch.vla.rlds.transforms import (
    binarize_gripper_actions,
    invert_gripper_actions,
    rel2abs_gripper_actions,
    tree_map,
)

# --------------------------------------------------------------------------- #
# shared building blocks
# --------------------------------------------------------------------------- #


def _cat(*parts) -> np.ndarray:
    return np.concatenate([np.asarray(p) for p in parts], axis=-1)


def _zeros(x, n: int) -> np.ndarray:
    """n zero columns with x's leading dim and dtype (fewer where x has
    fewer, as a slice gives)."""
    return np.zeros_like(np.asarray(x)[:, :n])


def _lift_language(traj: Dict, key: str = "natural_language_instruction") -> Dict:
    traj["language_instruction"] = traj["observation"][key]
    return traj


def _exact(fn, *args) -> np.ndarray:
    """fn of float32 arguments, evaluated in float64 and rounded back: the
    correctly rounded value (numpy's float32 versions, like TensorFlow's
    own polynomials, are not)."""
    dtype = np.result_type(*args)
    return fn(*(np.asarray(a, np.float64) for a in args)).astype(dtype)


def quat_to_euler(q: np.ndarray) -> np.ndarray:
    """Quaternion (x, y, z, w) -> roll, pitch, yaw of R = Rz(y) Ry(p) Rx(r),
    pitch's sine clamped to [-1, 1]; the arithmetic in q's dtype."""
    q = np.asarray(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = _exact(np.arctan2, 2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = _exact(np.arcsin, np.clip(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = _exact(np.arctan2, 2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return np.stack([roll, pitch, yaw], axis=-1)


def _unzip_floats(blobs, width: int) -> np.ndarray:
    """zlib-compressed float32 bytes, one string a step -> [T, width]."""
    raw = [np.frombuffer(zlib.decompress(bytes(b)), np.float32) for b in np.asarray(blobs, object).reshape(-1)]
    return np.stack(raw).reshape(-1, width)


def _drop_first_step(traj: Dict, nested_action: bool) -> Dict:
    """Remove timestep 0 everywhere but traj_metadata (Bridge V2's first
    action is all zero); `nested_action` slices inside the action dict."""
    out = {}
    for key, val in traj.items():
        if key == "traj_metadata":
            out[key] = val
        elif key == "observation" or (key == "action" and nested_action):
            out[key] = {k: v[1:] for k, v in val.items()}
        else:
            out[key] = val[1:]
    return out


def _eef_gripper_from_state(traj: Dict, src: str = "state", eef_key: str = "eef_state", eef_dims=slice(None, 6),
                            grip_dims=slice(-1, None)) -> Dict:
    """`eef_state` / `gripper_state` views of a packed state."""
    state = traj["observation"][src]
    traj["observation"][eef_key] = state[:, eef_dims]
    traj["observation"]["gripper_state"] = state[:, grip_dims]
    return traj


def _next_frame_keys(traj: Dict, keys) -> Dict:
    """Append next-timestep copies of `keys` (the last frame repeats)."""
    obs = traj["observation"]
    for k in keys:
        v = np.asarray(obs[k])
        obs[f"next_{k}"] = np.concatenate([v[1:], v[-1:]], axis=0)
    return traj


# --------------------------------------------------------------------------- #
# Bridge V2
# --------------------------------------------------------------------------- #


def relabel_bridge_actions(traj: Dict) -> Dict:
    """Translation and rotation actions become the reached state's deltas,
    and the last (actionless) step goes, from every leaf."""
    reached = traj["observation"]["state"]
    deltas = reached[1:, :6] - reached[:-1, :6]
    grip = traj["action"][:-1, -1:]
    out = tree_map(lambda x: x[:-1], traj)
    out["action"] = np.concatenate([deltas, grip], axis=1)
    return out


def bridge_oxe_transform(traj: Dict) -> Dict:
    traj = _drop_first_step(traj, nested_action=True)
    act = traj["action"]
    traj["action"] = _cat(act["world_vector"], act["rotation_delta"],
                          np.asarray(act["open_gripper"])[:, None].astype(np.float32))
    traj = _lift_language(traj)
    traj = relabel_bridge_actions(traj)
    return _eef_gripper_from_state(traj, eef_key="EEF_state")


def bridge_orig_transform(traj: Dict) -> Dict:
    traj = _drop_first_step(traj, nested_action=False)
    act = traj["action"]
    traj["action"] = _cat(act[:, :6], binarize_gripper_actions(act[:, -1])[:, None])
    traj = relabel_bridge_actions(traj)
    return _eef_gripper_from_state(traj, eef_key="EEF_state")


def ppgm_transform(traj: Dict) -> Dict:
    act = traj["action"]
    traj["action"] = _cat(act[:, :6], binarize_gripper_actions(act[:, -1])[:, None])
    traj["observation"]["EEF_state"] = traj["observation"]["cartesian_position"][:, :6]
    traj["observation"]["gripper_state"] = traj["observation"]["gripper_position"][:, -1:]
    return traj


# --------------------------------------------------------------------------- #
# Google robots
# --------------------------------------------------------------------------- #


def rt1_transform(traj: Dict) -> Dict:
    act = traj["action"]
    grip = rel2abs_gripper_actions(act["gripper_closedness_action"][:, 0])
    traj["action"] = _cat(act["world_vector"], act["rotation_delta"], grip[:, None])
    return _lift_language(traj)


def kuka_transform(traj: Dict) -> Dict:
    act = traj["action"]
    grip = rel2abs_gripper_actions(act["gripper_closedness_action"][:, 0])
    traj["action"] = _cat(act["world_vector"], act["rotation_delta"], grip[:, None])
    obs = traj["observation"]
    obs["clip_function_input/base_pose_tool_reached"] = _unzip_floats(
        obs["clip_function_input/base_pose_tool_reached"], 7)
    obs["gripper_closed"] = _unzip_floats(obs["gripper_closed"], 1)
    return _lift_language(traj)


# --------------------------------------------------------------------------- #
# moderate-scale labs
# --------------------------------------------------------------------------- #


def taco_play_transform(traj: Dict) -> Dict:
    obs = traj["observation"]
    obs["state_eef"] = obs["robot_obs"][:, :6]
    obs["state_gripper"] = obs["robot_obs"][:, 7:8]
    act = traj["action"]["rel_actions_world"]
    traj["action"] = _cat(act[:, :6], np.clip(act[:, -1:], 0, 1))
    return _lift_language(traj)


def jaco_play_transform(traj: Dict) -> Dict:
    obs = traj["observation"]
    obs["state_eef"] = obs["end_effector_cartesian_pos"][:, :6]
    obs["state_gripper"] = obs["end_effector_cartesian_pos"][:, -1:]
    act = traj["action"]
    grip = rel2abs_gripper_actions(act["gripper_closedness_action"][:, 0])
    wv = act["world_vector"]
    traj["action"] = _cat(wv, np.zeros_like(wv), grip[:, None])
    return _lift_language(traj)


def berkeley_cable_routing_transform(traj: Dict) -> Dict:
    act = traj["action"]
    traj["action"] = _cat(act["world_vector"], act["rotation_delta"], _zeros(act["world_vector"], 1))
    return _lift_language(traj)


def roboturk_transform(traj: Dict) -> Dict:
    act = traj["action"]
    grip = invert_gripper_actions(np.clip(act["gripper_closedness_action"], 0, 1))
    traj["action"] = _cat(act["world_vector"], act["rotation_delta"], grip)
    return _lift_language(traj)


def nyu_door_opening_transform(traj: Dict) -> Dict:
    act = traj["action"]
    grip = rel2abs_gripper_actions(act["gripper_closedness_action"][:, 0])
    traj["action"] = _cat(act["world_vector"], act["rotation_delta"], grip[:, None])
    return _lift_language(traj)


def viola_transform(traj: Dict) -> Dict:
    act = traj["action"]
    grip = invert_gripper_actions(np.clip(act["gripper_closedness_action"][:, None], 0, 1))
    traj["action"] = _cat(act["world_vector"], act["rotation_delta"], grip)
    return _lift_language(traj)


def berkeley_autolab_ur5_transform(traj: Dict) -> Dict:
    obs = traj["observation"]
    obs["state"] = obs["robot_state"][:, 6:14]
    obs["depth"] = obs.pop("image_with_depth")
    act = traj["action"]
    grip = rel2abs_gripper_actions(act["gripper_closedness_action"])
    traj["action"] = _cat(act["world_vector"], act["rotation_delta"], grip[:, None])
    return _lift_language(traj)


def toto_transform(traj: Dict) -> Dict:
    act = traj["action"]
    traj["action"] = _cat(act["world_vector"], act["rotation_delta"],
                          np.asarray(act["open_gripper"])[:, None].astype(np.float32))
    return _lift_language(traj)


def language_table_transform(traj: Dict) -> Dict:
    """A 2-DoF pusher: translation padded to 7-DoF, the gripper held open;
    the code-point instruction up to its first NUL, as UTF-8."""
    act = traj["action"]
    traj["action"] = _cat(act, np.zeros_like(act), np.zeros_like(act), np.ones_like(act[:, :1]))
    codes = np.asarray(traj["observation"]["instruction"])
    text = np.empty(len(codes), object)
    text[:] = ["".join(map(chr, row)).encode("utf-8").split(b"\x00")[0] for row in codes.tolist()]
    traj["language_instruction"] = text
    return traj


def pusht_transform(traj: Dict) -> Dict:
    act = traj["action"]
    traj["action"] = _cat(act["world_vector"], act["rotation_delta"], act["gripper_closedness_action"][:, None])
    return _lift_language(traj)


def stanford_kuka_multimodal_transform(traj: Dict) -> Dict:
    traj["observation"]["depth_image"] = traj["observation"]["depth_image"][..., 0]
    act = traj["action"]
    traj["action"] = _cat(act[:, :3], _zeros(act, 3), act[:, -1:])
    return traj


def nyu_rot_transform(traj: Dict) -> Dict:
    traj = _eef_gripper_from_state(traj)
    traj["action"] = traj["action"][..., :7]
    return traj


def stanford_hydra_transform(traj: Dict) -> Dict:
    act = traj["action"]
    traj["action"] = _cat(act[:, :6], invert_gripper_actions(act[:, -1:]))
    state = traj["observation"]["state"]
    traj["observation"]["eef_state"] = _cat(state[:, :3], state[:, 7:10])
    traj["observation"]["gripper_state"] = state[:, -3:-2]
    return traj


def _clip_invert_gripper(traj: Dict) -> Dict:
    """act[:, :6] | invert(clip(act[:, -1:], 0, 1)): the austin, mutex and
    furniture gripper convention."""
    act = traj["action"]
    traj["action"] = _cat(act[:, :6], invert_gripper_actions(np.clip(act[:, -1:], 0, 1)))
    return traj


def austin_buds_transform(traj: Dict) -> Dict:
    traj = _clip_invert_gripper(traj)
    traj["observation"]["state"] = traj["observation"]["state"][:, :8]
    return traj


def nyu_franka_play_transform(traj: Dict) -> Dict:
    obs = traj["observation"]
    obs["depth"] = np.asarray(obs["depth"][..., 0]).astype(np.float32)
    obs["depth_additional_view"] = np.asarray(obs["depth_additional_view"][..., 0]).astype(np.float32)
    obs["eef_state"] = obs["state"][:, -6:]
    act = traj["action"]
    traj["action"] = _cat(act[:, -8:-2], np.clip(act[:, -2:-1], 0, 1))
    return traj


def maniskill_transform(traj: Dict) -> Dict:
    traj["observation"]["gripper_state"] = traj["observation"]["state"][..., 7:8]
    return traj


def furniture_bench_transform(traj: Dict) -> Dict:
    state = traj["observation"]["state"]
    traj["observation"]["state"] = _cat(state[:, :7], state[:, -1:])
    act = traj["action"]
    traj["action"] = _cat(act[:, :3], quat_to_euler(act[:, 3:7]),
                          invert_gripper_actions(np.clip(act[:, -1:], 0, 1)))
    return traj


def cmu_franka_exploration_transform(traj: Dict) -> Dict:
    traj["action"] = traj["action"][..., :-1]
    return traj


def ucsd_kitchen_transform(traj: Dict) -> Dict:
    traj["observation"]["joint_state"] = traj["observation"]["state"][:, :7]
    traj["action"] = traj["action"][..., :-1]
    return traj


def ucsd_pick_place_transform(traj: Dict) -> Dict:
    traj = _eef_gripper_from_state(traj)
    act = traj["action"]
    traj["action"] = _cat(act[:, :3], _zeros(act, 3), act[:, -1:])
    return traj


def bc_z_transform(traj: Dict) -> Dict:
    """Actions from the future-residual dict."""
    act = traj["action"]
    traj["action"] = _cat(
        act["future/xyz_residual"][:, :3],
        act["future/axis_angle_residual"][:, :3],
        invert_gripper_actions(np.asarray(act["future/target_close"][:, :1]).astype(np.float32)),
    )
    return _lift_language(traj)


def tokyo_pr2_transform(traj: Dict) -> Dict:
    traj = _eef_gripper_from_state(traj)
    traj["action"] = traj["action"][..., :-1]
    return traj


def utokyo_xarm_pick_place_transform(traj: Dict) -> Dict:
    return traj


def utokyo_xarm_bimanual_transform(traj: Dict) -> Dict:
    traj["action"] = traj["action"][..., -7:]
    return traj


def robo_net_transform(traj: Dict) -> Dict:
    state = traj["observation"]["state"]
    traj["observation"]["eef_state"] = _cat(state[:, :4], _zeros(state, 2))
    traj["observation"]["gripper_state"] = state[:, -1:]
    act = traj["action"]
    traj["action"] = _cat(act[:, :4], _zeros(act, 2), act[:, -1:])
    return traj


def identity_transform(traj: Dict) -> Dict:
    return traj


def kaist_nonprehensile_transform(traj: Dict) -> Dict:
    traj["observation"]["state"] = traj["observation"]["state"][:, -7:]
    act = traj["action"]
    traj["action"] = _cat(act[:, :6], _zeros(act, 1))
    return traj


def stanford_mask_vit_transform(traj: Dict) -> Dict:
    pose = traj["observation"]["end_effector_pose"]
    traj["observation"]["eef_state"] = _cat(pose[:, :4], _zeros(pose, 2))
    traj["observation"]["gripper_state"] = pose[:, -1:]
    act = traj["action"]
    traj["action"] = _cat(act[:, :4], _zeros(act, 2), act[:, -1:])
    return traj


def tokyo_lsmo_transform(traj: Dict) -> Dict:
    return _eef_gripper_from_state(traj)


def dlr_sara_grid_clamp_transform(traj: Dict) -> Dict:
    traj["observation"]["state"] = traj["observation"]["state"][:, :6]
    return traj


def dlr_edan_transform(traj: Dict) -> Dict:
    act = traj["action"]
    traj["action"] = _cat(act[:, :6], invert_gripper_actions(act[:, -1:]))
    return traj


def asu_table_top_transform(traj: Dict) -> Dict:
    traj["observation"]["eef_state"] = traj["ground_truth_states"]["EE"]
    traj["observation"]["gripper_state"] = traj["observation"]["state"][:, -1:]
    return traj


def robocook_transform(traj: Dict) -> Dict:
    return _eef_gripper_from_state(traj)


def imperial_wristcam_transform(traj: Dict) -> Dict:
    traj["action"] = traj["action"][..., :-1]
    return traj


def iamlab_pick_insert_transform(traj: Dict) -> Dict:
    obs = traj["observation"]
    obs["joint_state"] = obs["state"][:, :7]
    obs["gripper_state"] = obs["state"][:, 7:8]
    act = traj["action"]
    traj["action"] = _cat(act[:, :3], quat_to_euler(act[:, 3:7]), act[:, 7:8])
    return traj


def uiuc_d3field_transform(traj: Dict) -> Dict:
    act = traj["action"]
    traj["action"] = _cat(act, np.zeros_like(act), _zeros(act, 1))
    return traj


def utaustin_mutex_transform(traj: Dict) -> Dict:
    traj["observation"]["state"] = traj["observation"]["state"][:, :8]
    return _clip_invert_gripper(traj)


def berkeley_fanuc_transform(traj: Dict) -> Dict:
    """No stored gripper action: the inverted gripper state stands for it."""
    obs = traj["observation"]
    obs["joint_state"] = obs["state"][:, :6]
    obs["gripper_state"] = obs["state"][:, 6:7]
    traj["action"] = _cat(traj["action"], invert_gripper_actions(obs["gripper_state"]))
    return traj


def cmu_playing_with_food_transform(traj: Dict) -> Dict:
    act = traj["action"]
    traj["action"] = _cat(act[:, :3], quat_to_euler(act[:, 3:7]), act[:, -1:])
    return traj


def playfusion_transform(traj: Dict) -> Dict:
    act = traj["action"]
    traj["action"] = _cat(act[:, :3], act[:, -4:])
    return traj


def cmu_stretch_transform(traj: Dict) -> Dict:
    state = traj["observation"]["state"]
    traj["observation"]["eef_state"] = _cat(state[:, :3], _zeros(state, 3))
    traj["observation"]["gripper_state"] = state[:, -1:]
    traj["action"] = traj["action"][..., :-1]
    return traj


def gnm_transform(traj: Dict) -> Dict:
    obs = traj["observation"]
    obs["state"] = _cat(obs["position"], _zeros(obs["state"], 3), obs["yaw"])
    act = traj["action"]
    traj["action"] = _cat(act, np.zeros_like(act), np.zeros_like(act), _zeros(act, 1))
    return traj


# --------------------------------------------------------------------------- #
# DROID
# --------------------------------------------------------------------------- #


def _euler_to_rmat(e: np.ndarray) -> np.ndarray:
    """R = Rz(yaw) Ry(pitch) Rx(roll), the inverse of quat_to_euler's map."""
    e = np.asarray(e)
    r, p, y = e[..., 0], e[..., 1], e[..., 2]
    cr, sr, cp, sp, cy, sy = (_exact(f, a) for a in (r, p, y) for f in (np.cos, np.sin))
    row0 = np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1)
    row1 = np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1)
    row2 = np.stack([-sp, cp * sr, cp * cr], axis=-1)
    return np.stack([row0, row1, row2], axis=-2)


def _rmat_to_rot6d(mat: np.ndarray) -> np.ndarray:
    """The first two rows, flattened."""
    return np.concatenate([mat[..., 0, :], mat[..., 1, :]], axis=-1)


def velocity_act_to_wrist_frame(velocity: np.ndarray, wrist_pose: np.ndarray) -> np.ndarray:
    """A base-frame 6-DoF velocity rotated into the wrist frame, its
    rotation as R6."""
    R = _euler_to_rmat(np.asarray(wrist_pose)[:, 3:6])
    R_inv = np.swapaxes(R, -1, -2)
    vel_t = np.einsum("bij,bj->bi", R_inv, np.asarray(velocity)[:, :3])
    dR = R_inv @ (_euler_to_rmat(np.asarray(velocity)[:, 3:6]) @ R)
    return np.concatenate([vel_t, _rmat_to_rot6d(dR)], axis=-1)


def _droid_action_and_proprio(traj: Dict) -> Dict:
    vel = traj["action_dict"]["cartesian_velocity"]
    traj["action"] = _cat(vel[:, :3], vel[:, 3:6], 1 - traj["action_dict"]["gripper_position"])
    traj["observation"]["proprio"] = _cat(traj["observation"]["cartesian_position"],
                                          traj["observation"]["gripper_position"])
    return traj


def droid_baseact_transform(traj: Dict) -> Dict:
    """Base-frame DROID actions, the two exterior cameras swapped at random
    (numpy's unseeded draw; TensorFlow's is unseeded too)."""
    traj = _droid_action_and_proprio(traj)
    obs = traj["observation"]
    if not np.random.default_rng().uniform() > 0.5:
        obs["exterior_image_1_left"], obs["exterior_image_2_left"] = (obs["exterior_image_2_left"],
                                                                      obs["exterior_image_1_left"])
    return traj


def droid_finetuning_transform(traj: Dict) -> Dict:
    """Base-frame DROID actions, the camera fixed (droid_wipe)."""
    return _droid_action_and_proprio(traj)


_DROID_Q01 = np.array([-0.7776297926902771, -0.5803514122962952, -0.5795090794563293, -0.6464047729969025,
                       -0.7041108310222626, -0.8895104378461838], np.float32)
_DROID_Q99 = np.array([0.7597932070493698, 0.5726242214441299, 0.7351000607013702, 0.6705610305070877,
                       0.6464948207139969, 0.8897542208433151], np.float32)


def droid_zero_action_filter(frame: Dict) -> bool:
    """False for a frame whose (normalized) 6-DoF actions all equal the
    normalized zero action within 1e-5, in float32."""
    act = np.asarray(frame["action"])[:, :6]
    norm_zero = np.float32(2) * (np.zeros_like(act) - _DROID_Q01) / (_DROID_Q99 - _DROID_Q01 + np.float32(1e-8)) \
        - np.float32(1)
    return bool(np.any(np.abs(act - norm_zero) > np.float32(1e-5)))


def roboset_transform(traj: Dict) -> Dict:
    traj["observation"]["proprio"] = traj["observation"]["state"]
    act = traj["action"]
    grip = invert_gripper_actions(np.clip(act[:, -1:], 0, 1))
    traj["action"] = _cat(act[:, :7], grip)
    return traj


def fmb_transform(traj: Dict) -> Dict:
    obs = traj["observation"]
    obs["proprio"] = _cat(obs["eef_pose"], np.asarray(obs["state_gripper_pose"])[..., None])
    return traj


def dobbe_transform(traj: Dict) -> Dict:
    traj["observation"]["proprio"] = traj["observation"]["state"]
    return traj


def rh20t_transform(traj: Dict) -> Dict:
    act = traj["action"]
    traj["action"] = _cat(act["tcp_base"], np.asarray(act["gripper"])[:, None].astype(np.float32))
    obs = traj["observation"]
    obs["proprio"] = _cat(obs["tcp_base"], np.asarray(obs["gripper_width"])[..., None])
    return traj


def tdroid_transform(traj: Dict) -> Dict:
    act = traj["action"]
    traj["action"] = _cat(act[:, :6], binarize_gripper_actions(act[:, -1])[:, None])
    traj["observation"]["EEF_state"] = traj["observation"]["cartesian_position"][:, :6]
    traj["observation"]["gripper_state"] = traj["observation"]["gripper_position"][:, -1:]
    return traj


# --------------------------------------------------------------------------- #
# MLA suites: next-frame copies
# --------------------------------------------------------------------------- #


def rlbench_transform(traj: Dict) -> Dict:
    return _next_frame_keys(traj, ["front_image", "point_cloud"])


def metaworld_transform(traj: Dict) -> Dict:
    return _next_frame_keys(traj, ["image_third", "point_cloud"])


def franka_transform(traj: Dict) -> Dict:
    return _next_frame_keys(traj, ["image_third", "point_cloud", "tactile_right", "tactile_left"])


def agilex_transform(traj: Dict) -> Dict:
    return _next_frame_keys(traj, ["image_head", "image_right", "image_left"])


def rtx_dataset_transform(traj: Dict) -> Dict:
    return _next_frame_keys(traj, ["image"])


# --------------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------------- #

OXE_STANDARDIZATION_TRANSFORMS: Dict[str, Callable] = {
    "bridge_oxe": bridge_oxe_transform,
    "bridge_orig": bridge_orig_transform,
    "bridge_dataset": bridge_orig_transform,
    "ppgm": ppgm_transform,
    "ppgm_static": ppgm_transform,
    "ppgm_wrist": ppgm_transform,
    "fractal20220817_data": rt1_transform,
    "kuka": kuka_transform,
    "taco_play": taco_play_transform,
    "jaco_play": jaco_play_transform,
    "berkeley_cable_routing": berkeley_cable_routing_transform,
    "roboturk": roboturk_transform,
    "nyu_door_opening_surprising_effectiveness": nyu_door_opening_transform,
    "viola": viola_transform,
    "berkeley_autolab_ur5": berkeley_autolab_ur5_transform,
    "toto": toto_transform,
    "language_table": language_table_transform,
    "columbia_cairlab_pusht_real": pusht_transform,
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds": stanford_kuka_multimodal_transform,
    "nyu_rot_dataset_converted_externally_to_rlds": nyu_rot_transform,
    "stanford_hydra_dataset_converted_externally_to_rlds": stanford_hydra_transform,
    "austin_buds_dataset_converted_externally_to_rlds": austin_buds_transform,
    "nyu_franka_play_dataset_converted_externally_to_rlds": nyu_franka_play_transform,
    "maniskill_dataset_converted_externally_to_rlds": maniskill_transform,
    "furniture_bench_dataset_converted_externally_to_rlds": furniture_bench_transform,
    "cmu_franka_exploration_dataset_converted_externally_to_rlds": cmu_franka_exploration_transform,
    "ucsd_kitchen_dataset_converted_externally_to_rlds": ucsd_kitchen_transform,
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds": ucsd_pick_place_transform,
    "austin_sailor_dataset_converted_externally_to_rlds": _clip_invert_gripper,
    "austin_sirius_dataset_converted_externally_to_rlds": _clip_invert_gripper,
    "bc_z": bc_z_transform,
    "utokyo_pr2_opening_fridge_converted_externally_to_rlds": tokyo_pr2_transform,
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds": tokyo_pr2_transform,
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds": utokyo_xarm_pick_place_transform,
    "utokyo_xarm_bimanual_converted_externally_to_rlds": utokyo_xarm_bimanual_transform,
    "robo_net": robo_net_transform,
    "berkeley_mvp_converted_externally_to_rlds": identity_transform,
    "berkeley_rpt_converted_externally_to_rlds": identity_transform,
    "kaist_nonprehensile_converted_externally_to_rlds": kaist_nonprehensile_transform,
    "stanford_mask_vit_converted_externally_to_rlds": stanford_mask_vit_transform,
    "tokyo_u_lsmo_converted_externally_to_rlds": tokyo_lsmo_transform,
    "dlr_sara_pour_converted_externally_to_rlds": identity_transform,
    "dlr_sara_grid_clamp_converted_externally_to_rlds": dlr_sara_grid_clamp_transform,
    "dlr_edan_shared_control_converted_externally_to_rlds": dlr_edan_transform,
    "asu_table_top_converted_externally_to_rlds": asu_table_top_transform,
    "stanford_robocook_converted_externally_to_rlds": robocook_transform,
    "imperialcollege_sawyer_wrist_cam": imperial_wristcam_transform,
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds": iamlab_pick_insert_transform,
    "uiuc_d3field": uiuc_d3field_transform,
    "utaustin_mutex": utaustin_mutex_transform,
    "berkeley_fanuc_manipulation": berkeley_fanuc_transform,
    "cmu_playing_with_food": cmu_playing_with_food_transform,
    "cmu_play_fusion": playfusion_transform,
    "cmu_stretch": cmu_stretch_transform,
    "berkeley_gnm_recon": gnm_transform,
    "berkeley_gnm_cory_hall": gnm_transform,
    "berkeley_gnm_sac_son": gnm_transform,
    "droid": droid_baseact_transform,
    "fmb_dataset": fmb_transform,
    "dobbe": dobbe_transform,
    "roboset": roboset_transform,
    "rh20t": rh20t_transform,
    "tdroid_carrot_in_bowl": tdroid_transform,
    "tdroid_pour_corn_in_pot": tdroid_transform,
    "tdroid_flip_pot_upright": tdroid_transform,
    "tdroid_move_object_onto_plate": tdroid_transform,
    "tdroid_knock_object_over": tdroid_transform,
    "tdroid_cover_object_with_towel": tdroid_transform,
    "droid_wipe": droid_finetuning_transform,
    "custom_finetuning": identity_transform,
    "rlbench": rlbench_transform,
    "metaworld": metaworld_transform,
    "franka": franka_transform,
    "franka_dual": franka_transform,
    "agilex": agilex_transform,
    "rtx_dataset": rtx_dataset_transform,
}

# frame-level filters that configs' aux_kwargs name (by string, so the
# config table stays plain data)
FRAME_FILTERS: Dict[str, Callable] = {
    "droid_zero_action_filter": droid_zero_action_filter,
}


def get_standardization_transform(name: str) -> Callable:
    """The dataset's transform; the identity for a name the registry does
    not know."""
    return OXE_STANDARDIZATION_TRANSFORMS.get(name, identity_transform)
