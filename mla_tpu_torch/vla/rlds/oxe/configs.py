"""Per-dataset Open-X-Embodiment configuration matrix.

The port's copy of mla_tpu/vla/rlds/oxe/configs.py, entry for entry (plain
data). Each entry records which builder keys hold the camera views
(`image_obs_keys`, None marking a padded or absent view), the depth views,
the 1-dimensional proprio keys concatenated into `observation["proprio"]`
(`state_obs_keys`, None inserting one zero column), and the state and action
encoding tags. `agilex` has an entry built from its transform's keys.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Any, Dict, List, Optional


class StateEncoding(IntEnum):
    """Proprio layouts (reference configs.py:33-43)."""

    NONE = -1
    POS_EULER = 1       # xyz(3) + rpy(3) + pad(1) + gripper(1)
    POS_QUAT = 2        # xyz(3) + quat(4) + gripper(1)
    JOINT = 3           # joints(7) + gripper(1)
    JOINT_BIMANUAL = 4
    EEF_BIMANUAL = 5
    STATE_METAWORLD = 6


class ActionEncoding(IntEnum):
    """Action layouts (reference configs.py:46-55)."""

    EEF_POS = 1         # dxyz(3) + drpy(3) + gripper(1)
    JOINT_POS = 2
    JOINT_POS_BIMANUAL = 3
    EEF_R6 = 4
    EEF_BIMANUAL = 5
    ACTION_METAWORLD = 6


def _d(
    primary: Optional[str],
    state: List[Optional[str]],
    *,
    secondary: Optional[str] = None,
    wrist: Optional[str] = None,
    depth_primary: Optional[str] = None,
    depth_secondary: Optional[str] = None,
    depth_wrist: Optional[str] = None,
    senc: StateEncoding = StateEncoding.POS_EULER,
    aenc: ActionEncoding = ActionEncoding.EEF_POS,
    extra_images: Optional[Dict[str, str]] = None,
    aux: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    imgs: Dict[str, Optional[str]] = {"primary": primary, "secondary": secondary, "wrist": wrist}
    if extra_images:
        imgs.update(extra_images)
    cfg: Dict[str, Any] = {
        "image_obs_keys": imgs,
        "depth_obs_keys": {"primary": depth_primary, "secondary": depth_secondary, "wrist": depth_wrist},
        "state_obs_keys": list(state),
        "state_encoding": senc,
        "action_encoding": aenc,
    }
    if aux:
        cfg["aux_kwargs"] = aux
    return cfg


_NO_STATE: List[Optional[str]] = [None] * 8
_PQ = StateEncoding.POS_QUAT
_J = StateEncoding.JOINT
_NONE = StateEncoding.NONE

OXE_DATASET_CONFIGS: Dict[str, Dict[str, Any]] = {
    # --- MLA suites (configs.py:60-100) ---
    "rlbench": _d("front_image", ["proprio"], senc=_PQ,
                  extra_images={"next_primary": "next_front_image"}),
    "metaworld": _d("image_third", ["proprio"], senc=StateEncoding.STATE_METAWORLD,
                    aenc=ActionEncoding.ACTION_METAWORLD,
                    extra_images={"next_primary": "next_image_third"}),
    "franka": _d("image_third", ["proprio"], senc=_PQ,
                 extra_images={"next_primary": "next_image_third", "wrist_right": "image_wrist"}),
    "franka_dual": _d("image_third", ["proprio"], senc=StateEncoding.EEF_BIMANUAL,
                      aenc=ActionEncoding.EEF_BIMANUAL,
                      extra_images={"next_primary": "next_image_third",
                                    "wrist_right": "image_wrist_right",
                                    "wrist_left": "image_wrist_left"}),
    # reference omission fixed: keys from agilex_transform_next
    "agilex": _d("image_head", ["proprio"], senc=StateEncoding.JOINT_BIMANUAL,
                 aenc=ActionEncoding.JOINT_POS_BIMANUAL,
                 extra_images={"next_primary": "next_image_head",
                               "wrist_right": "image_right", "wrist_left": "image_left"}),
    "rtx_dataset": _d("image", ["proprio"], senc=_PQ,
                      extra_images={"next_primary": "next_image"}),
    # --- Google robots ---
    "fractal20220817_data": _d("image", ["base_pose_tool_reached", "gripper_closed"], senc=_PQ),
    "kuka": _d("image", ["clip_function_input/base_pose_tool_reached", "gripper_closed"], senc=_PQ),
    # --- Bridge V2 variants ---
    "bridge_oxe": _d("image", ["EEF_state", None, "gripper_state"], secondary="image_1"),
    "bridge_orig": _d("image_0", ["EEF_state", None, "gripper_state"], secondary="image_1"),
    "bridge_dataset": _d("image_0", ["EEF_state", None, "gripper_state"], secondary="image_1"),
    # --- moderate-scale labs ---
    "taco_play": _d("rgb_static", ["state_eef", None, "state_gripper"], wrist="rgb_gripper",
                    depth_primary="depth_static", depth_wrist="depth_gripper"),
    "jaco_play": _d("image", ["state_eef", None, "state_gripper"], wrist="image_wrist"),
    "berkeley_cable_routing": _d("image", ["robot_state", None], secondary="top_image",
                                 wrist="wrist45_image", senc=_J),
    "roboturk": _d("front_rgb", _NO_STATE, senc=_NONE),
    "nyu_door_opening_surprising_effectiveness": _d(None, _NO_STATE, wrist="image", senc=_NONE),
    "viola": _d("agentview_rgb", ["joint_states", "gripper_states"], wrist="eye_in_hand_rgb", senc=_J),
    "berkeley_autolab_ur5": _d("image", ["state"], wrist="hand_image",
                               depth_primary="depth", senc=_PQ),
    "toto": _d("image", ["state", None], senc=_J),
    "language_table": _d("rgb", ["effector_translation", None, None, None, None, None, None]),
    "columbia_cairlab_pusht_real": _d("image", ["robot_state", None, None, None, None, None, None],
                                      wrist="wrist_image"),
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds": _d(
        "image", ["ee_position", "ee_orientation", None], depth_primary="depth_image", senc=_PQ),
    "nyu_rot_dataset_converted_externally_to_rlds": _d("image", ["eef_state", None, "gripper_state"]),
    "stanford_hydra_dataset_converted_externally_to_rlds": _d(
        "image", ["eef_state", None, "gripper_state"], wrist="wrist_image"),
    "austin_buds_dataset_converted_externally_to_rlds": _d("image", ["state"], wrist="wrist_image", senc=_J),
    "nyu_franka_play_dataset_converted_externally_to_rlds": _d(
        "image", ["eef_state", None, None], secondary="image_additional_view",
        depth_primary="depth", depth_secondary="depth_additional_view"),
    "maniskill_dataset_converted_externally_to_rlds": _d(
        "image", ["tcp_pose", "gripper_state"], wrist="wrist_image",
        depth_primary="depth", depth_wrist="wrist_depth", senc=_PQ),
    "furniture_bench_dataset_converted_externally_to_rlds": _d(
        "image", ["state"], wrist="wrist_image", senc=_PQ),
    "cmu_franka_exploration_dataset_converted_externally_to_rlds": _d(
        "highres_image", _NO_STATE, senc=_NONE),
    "ucsd_kitchen_dataset_converted_externally_to_rlds": _d("image", ["joint_state", None], senc=_J),
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds": _d(
        "image", ["eef_state", None, "gripper_state"]),
    "austin_sailor_dataset_converted_externally_to_rlds": _d(
        "image", ["state"], wrist="wrist_image", senc=_PQ),
    "austin_sirius_dataset_converted_externally_to_rlds": _d(
        "image", ["state"], wrist="wrist_image", senc=_PQ),
    "bc_z": _d("image", ["present/xyz", "present/axis_angle", None, "present/sensed_close"]),
    "utokyo_pr2_opening_fridge_converted_externally_to_rlds": _d(
        "image", ["eef_state", None, "gripper_state"]),
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds": _d(
        "image", ["eef_state", None, "gripper_state"]),
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds": _d(
        "image", ["end_effector_pose", None, None], secondary="image2", wrist="hand_image"),
    "utokyo_xarm_bimanual_converted_externally_to_rlds": _d("image", ["pose_r", None, None]),
    "robo_net": _d("image", ["eef_state", None, "gripper_state"], secondary="image1"),
    "berkeley_mvp_converted_externally_to_rlds": _d(
        None, ["pose", "gripper"], wrist="hand_image", senc=_PQ, aenc=ActionEncoding.JOINT_POS),
    "berkeley_rpt_converted_externally_to_rlds": _d(
        None, ["joint_pos", "gripper"], wrist="hand_image", senc=_J, aenc=ActionEncoding.JOINT_POS),
    "kaist_nonprehensile_converted_externally_to_rlds": _d("image", ["state", None], senc=_PQ),
    "stanford_mask_vit_converted_externally_to_rlds": _d("image", ["eef_state", None, "gripper_state"]),
    "tokyo_u_lsmo_converted_externally_to_rlds": _d("image", ["eef_state", None, "gripper_state"]),
    "dlr_sara_pour_converted_externally_to_rlds": _d("image", ["state", None, None]),
    "dlr_sara_grid_clamp_converted_externally_to_rlds": _d("image", ["state", None, None]),
    "dlr_edan_shared_control_converted_externally_to_rlds": _d("image", ["state", None]),
    "asu_table_top_converted_externally_to_rlds": _d("image", ["eef_state", None, "gripper_state"]),
    "stanford_robocook_converted_externally_to_rlds": _d(
        "image_1", ["eef_state", None, "gripper_state"], secondary="image_2",
        depth_primary="depth_1", depth_secondary="depth_2"),
    "imperialcollege_sawyer_wrist_cam": _d(
        "image", [None, None, None, None, None, None, None, "state"], wrist="wrist_image", senc=_NONE),
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds": _d(
        "image", ["joint_state", "gripper_state"], wrist="wrist_image", senc=_J),
    "uiuc_d3field": _d("image_1", _NO_STATE, secondary="image_2",
                       depth_primary="depth_1", depth_secondary="depth_2", senc=_NONE),
    "utaustin_mutex": _d("image", ["state"], wrist="wrist_image", senc=_J),
    "berkeley_fanuc_manipulation": _d(
        "image", ["joint_state", None, "gripper_state"], wrist="wrist_image", senc=_J),
    "cmu_playing_with_food": _d("image", ["state", None, None], wrist="finger_vision_1"),
    "cmu_play_fusion": _d("image", ["state"], senc=_J),
    "cmu_stretch": _d("image", ["eef_state", None, "gripper_state"]),
    "berkeley_gnm_recon": _d(None, ["state", None, None], wrist="image"),
    "berkeley_gnm_cory_hall": _d(None, ["state", None, None], wrist="image"),
    "berkeley_gnm_sac_son": _d(None, ["state", None, None], wrist="image"),
    # --- DROID family ---
    "droid": _d("exterior_image_1_left", ["proprio"], secondary="exterior_image_2_left",
                wrist="wrist_image_left", senc=_PQ,
                aux={"dataset_frame_transform_kwargs": {"chunk_filter_fn": "droid_zero_action_filter"}}),
    "fmb_dataset": _d("image_side_1", ["proprio"], secondary="image_side_2", wrist="image_wrist_1",
                      depth_primary="image_side_1_depth", depth_secondary="image_side_2_depth",
                      depth_wrist="image_wrist_1_depth"),
    "dobbe": _d("wrist_image", ["proprio"]),
    "roboset": _d("image_left", ["proprio"], secondary="image_right", wrist="image_wrist",
                  senc=_J, aenc=ActionEncoding.JOINT_POS),
    "rh20t": _d("image_front", ["proprio"], secondary="image_side_right", wrist="image_wrist"),
    # --- T-DROID ---
    "tdroid_carrot_in_bowl": _d("static_image", ["EEF_state", None, "gripper_state"],
                                depth_primary="static_depth_image"),
    "tdroid_pour_corn_in_pot": _d("static_image", ["EEF_state", None, "gripper_state"],
                                  depth_primary="static_depth_image"),
    "tdroid_flip_pot_upright": _d("static_image", ["EEF_state", None, "gripper_state"],
                                  depth_primary="static_depth_image"),
    "tdroid_move_object_onto_plate": _d("static_image", ["EEF_state", None, "gripper_state"],
                                        depth_primary="static_depth_image"),
    "tdroid_knock_object_over": _d("static_image", ["EEF_state", None, "gripper_state"],
                                   depth_primary="static_depth_image"),
    "tdroid_cover_object_with_towel": _d("static_image", ["EEF_state", None, "gripper_state"],
                                         depth_primary="static_depth_image"),
    # --- DROID finetuning ---
    "droid_wipe": _d("exterior_image_2_left", ["proprio"], wrist="wrist_image_left"),
    # --- custom ---
    "custom_finetuning": _d("image", ["base_pose_tool_reached", "gripper_closed"],
                            depth_primary="depth", senc=_PQ),
}

# MLA passthrough keys: point cloud / tactile observations are not part of
# the reference's per-dataset configs — its make_dataset_from_rlds hardcodes
# them when load_pointcloud/load_tactile are set (reference dataset.py:179-189).
POINTCLOUD_KEYS = ("point_cloud", "next_point_cloud")
TACTILE_KEYS = ("gripper_xyz", "tactile_right", "tactile_left",
                "next_tactile_right", "next_tactile_left")
