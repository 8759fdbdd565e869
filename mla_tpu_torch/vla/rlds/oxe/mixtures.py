"""Named Open-X-Embodiment dataset mixtures (sampling weights).

The port's copy of mla_tpu/vla/rlds/oxe/mixtures.py, name for name and
weight for weight (plain data), including the duplicate entries of
`rtx_franka`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# RT-X base mixture weights (reference mixtures.py:38-53), shared verbatim by
# the `rtx` and `rtx_franka` mixtures.
_RTX_BASE: List[Tuple[str, float]] = [
    ("fractal20220817_data", 0.54087122203),
    ("kuka", 0.8341046294),
    ("bridge_orig", 1.0),
    ("taco_play", 2.0),
    ("jaco_play", 2.0),
    ("berkeley_cable_routing", 3.0),
    ("roboturk", 1.0),
    ("viola", 2.0),
    ("berkeley_autolab_ur5", 1.0),
    ("toto", 1.0),
]

# Franka-focused additions stacked on top of the RT-X base (mixtures.py:55-90).
_RTX_FRANKA_EXTRA: List[Tuple[str, float]] = [
    ("taco_play", 1.0),
    ("berkeley_cable_routing", 1.0),
    ("viola", 1.0),
    ("toto", 1.0),
    ("stanford_hydra_dataset_converted_externally_to_rlds", 1.0),
    ("austin_buds_dataset_converted_externally_to_rlds", 3.0),
    ("nyu_franka_play_dataset_converted_externally_to_rlds", 3.0),
    ("maniskill_dataset_converted_externally_to_rlds", 0.1),
    ("furniture_bench_dataset_converted_externally_to_rlds", 0.1),
    ("cmu_franka_exploration_dataset_converted_externally_to_rlds", 5.0),
    ("austin_sailor_dataset_converted_externally_to_rlds", 1.0),
    ("austin_sirius_dataset_converted_externally_to_rlds", 1.0),
    ("berkeley_rpt_converted_externally_to_rlds", 1.0),
    ("kaist_nonprehensile_converted_externally_to_rlds", 3.0),
    ("stanford_robocook_converted_externally_to_rlds", 1.0),
    ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
    ("utaustin_mutex", 1.0),
    ("cmu_play_fusion", 1.0),
]

# The Open-X "magic soup" (mixtures.py:92-118). Note the weights differ from
# the RT-X base for jaco/cable/roboturk/ur5.
_MAGIC_SOUP: List[Tuple[str, float]] = [
    ("fractal20220817_data", 0.54087122203),
    ("kuka", 0.8341046294),
    ("bridge_orig", 1.0),
    ("taco_play", 2.0),
    ("jaco_play", 1.0),
    ("berkeley_cable_routing", 1.0),
    ("roboturk", 2.0),
    ("viola", 2.0),
    ("berkeley_autolab_ur5", 2.0),
    ("toto", 1.0),
    ("language_table", 0.1),
    ("stanford_hydra_dataset_converted_externally_to_rlds", 2.0),
    ("austin_buds_dataset_converted_externally_to_rlds", 1.0),
    ("nyu_franka_play_dataset_converted_externally_to_rlds", 3.0),
    ("furniture_bench_dataset_converted_externally_to_rlds", 0.1),
    ("ucsd_kitchen_dataset_converted_externally_to_rlds", 2.0),
    ("austin_sailor_dataset_converted_externally_to_rlds", 1.0),
    ("austin_sirius_dataset_converted_externally_to_rlds", 1.0),
    ("dlr_edan_shared_control_converted_externally_to_rlds", 1.0),
    ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
    ("utaustin_mutex", 1.0),
    ("berkeley_fanuc_manipulation", 2.0),
    ("cmu_stretch", 1.0),
]

# Datasets added in MagicSoup++ (mixtures.py:143-147).
_SOUP_PLUS_NEW: List[Tuple[str, float]] = [
    ("bc_z", 0.2),
    ("fmb_dataset", 1.0),
    ("dobbe", 0.2),
]


def _single(name: str) -> List[Tuple[str, float]]:
    return [(name, 1.0)]


OXE_NAMED_MIXTURES: Dict[str, List[Tuple[str, float]]] = {
    # MLA's own suites (mixtures.py:12-29)
    "rlbench": _single("rlbench"),
    "metaworld": _single("metaworld"),
    "franka": _single("franka"),
    "franka_dual": _single("franka_dual"),
    "agilex": _single("agilex"),
    "rtx_dataset": _single("rtx_dataset"),
    # Bridge++ (mixtures.py:32-36)
    "bridge_rt_1": [("bridge_orig", 1.0), ("fractal20220817_data", 1.0)],
    # RT-X (mixtures.py:38-90)
    "rtx": list(_RTX_BASE),
    "rtx_franka": _RTX_BASE + _RTX_FRANKA_EXTRA,
    # Open-X Magic Soup family (mixtures.py:92-182)
    "oxe_magic_soup": list(_MAGIC_SOUP),
    "oxe_magic_soup_plus": _MAGIC_SOUP + _SOUP_PLUS_NEW + [("droid", 0.06)],
    # ++minus: fractal back at weight 1.0, language_table dropped, no droid
    "oxe_magic_soup_plus_minus": (
        [("fractal20220817_data", 1.0)]
        + [(n, w) for n, w in _MAGIC_SOUP[1:] if n != "language_table"]
        + _SOUP_PLUS_NEW
    ),
    # T-DROID (mixtures.py:185-203)
    "tdroid_carrot_in_bowl": _single("tdroid_carrot_in_bowl"),
    "tdroid_pour_corn_in_pot": _single("tdroid_pour_corn_in_pot"),
    "tdroid_flip_pot_upright": _single("tdroid_flip_pot_upright"),
    "tdroid_move_object_onto_plate": _single("tdroid_move_object_onto_plate"),
    "tdroid_knock_object_over": _single("tdroid_knock_object_over"),
    "tdroid_cover_object_with_towel": _single("tdroid_cover_object_with_towel"),
    # DROID finetuning (mixtures.py:205-208)
    "droid_wipe": _single("droid_wipe"),
    # Custom finetuning (mixtures.py:210-213)
    "custom_finetuning": _single("custom_finetuning"),
}
