"""The kwargs factory: the OXE config matrix -> `make_dataset_from_rlds`
kwargs.

The port's copy of mla_tpu/vla/rlds/oxe/materialize.py. It applies the EEF
action contract (every dimension normalized but the absolute gripper),
keeps the requested camera views, attaches the standardization transform
and resolves the frame filters that a config names. A mixture drops a
repeated dataset (the first weight wins) and skips, with a warning, one
whose encoding the factory does not take.

The JAX package's documented deviation is kept: a requested view that a
dataset lacks is dropped with a warning, and only a dataset with none of
the requested views is refused.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Sequence, Tuple

from mla_tpu_torch.utils.overwatch import initialize_overwatch
from mla_tpu_torch.vla.rlds.oxe.configs import OXE_DATASET_CONFIGS, ActionEncoding
from mla_tpu_torch.vla.rlds.oxe.transforms import FRAME_FILTERS, OXE_STANDARDIZATION_TRANSFORMS
from mla_tpu_torch.vla.rlds.transforms import NormalizationType

overwatch = initialize_overwatch(__name__)

# the action and proprio masks of each encoding: EEF-style actions are
# relative but for the gripper, which is absolute and left unnormalized
_ENCODING_MASKS: Dict[ActionEncoding, Dict[str, List[bool]]] = {
    ActionEncoding.EEF_POS: {
        "absolute_action_mask": [False] * 6 + [True],
        "absolute_proprio_mask": [False] * 6 + [True],
        "action_normalization_mask": [True] * 6 + [False],
        "proprio_normalization_mask": [True] * 6 + [False],
    },
    ActionEncoding.EEF_R6: {
        "absolute_action_mask": [False] * 9 + [True],
        "absolute_proprio_mask": [False] * 9 + [True],
        "action_normalization_mask": [True] * 9 + [False],
        "proprio_normalization_mask": [True] * 9 + [False],
    },
    ActionEncoding.EEF_BIMANUAL: {
        "absolute_action_mask": ([False] * 6 + [True]) * 2,
        "absolute_proprio_mask": ([False] * 6 + [True]) * 2,
        "action_normalization_mask": ([True] * 6 + [False]) * 2,
        "proprio_normalization_mask": ([True] * 6 + [False]) * 2,
    },
    ActionEncoding.ACTION_METAWORLD: {
        "absolute_action_mask": [False] * 3 + [True],
        "absolute_proprio_mask": [False] * 4,
        "action_normalization_mask": [True] * 3 + [False],
        "proprio_normalization_mask": [True] * 4,
    },
}


def make_oxe_dataset_kwargs(
    dataset_name: str,
    data_root_dir,
    load_camera_views: Sequence[str] = ("primary",),
    load_depth: bool = False,
    load_proprio: bool = True,
    load_language: bool = True,
    load_pointcloud: bool = False,
    load_tactile: bool = False,
    action_proprio_normalization_type: NormalizationType = NormalizationType.NORMAL,
) -> Dict[str, Any]:
    """`make_dataset_from_rlds` kwargs for one OXE dataset."""
    cfg = deepcopy(OXE_DATASET_CONFIGS[dataset_name])
    if cfg["action_encoding"] not in _ENCODING_MASKS:
        raise ValueError(f"Cannot load `{dataset_name}`; only EEF-style actions are supported!")
    kwargs: Dict[str, Any] = dict(_ENCODING_MASKS[cfg["action_encoding"]])
    kwargs["action_proprio_normalization_type"] = action_proprio_normalization_type

    available = set(cfg["image_obs_keys"])
    if missing := (set(load_camera_views) - available):
        overwatch.warning(f"`{dataset_name}` lacks camera views {sorted(missing)}; loading the rest")
    views = [v for v in load_camera_views if v in available]
    if not views:
        raise ValueError(f"Cannot load `{dataset_name}`; none of the requested camera views exist")
    kwargs["image_obs_keys"] = {k: cfg["image_obs_keys"][k] for k in views}
    if load_depth:
        kwargs["depth_obs_keys"] = {k: v for k, v in cfg["depth_obs_keys"].items() if k in views}
    if load_proprio:
        kwargs["state_obs_keys"] = cfg["state_obs_keys"]
    if load_language:
        kwargs["language_key"] = "language_instruction"
    kwargs["load_pointcloud"] = load_pointcloud
    kwargs["load_tactile"] = load_tactile
    kwargs["standardize_fn"] = OXE_STANDARDIZATION_TRANSFORMS[dataset_name]

    for aux_key, aux_val in cfg.get("aux_kwargs", {}).items():
        if aux_key == "dataset_frame_transform_kwargs":
            aux_val = {k: (FRAME_FILTERS[v] if isinstance(v, str) else v) for k, v in aux_val.items()}
        kwargs[aux_key] = aux_val

    return {"name": dataset_name, "data_dir": str(data_root_dir), **kwargs}


def get_oxe_dataset_kwargs_and_weights(
    data_root_dir,
    mixture_spec: List[Tuple[str, float]],
    load_camera_views: Sequence[str] = ("primary",),
    load_depth: bool = False,
    load_proprio: bool = True,
    load_language: bool = True,
    load_pointcloud: bool = False,
    load_tactile: bool = False,
    action_proprio_normalization_type: NormalizationType = NormalizationType.NORMAL,
) -> Tuple[List[Dict[str, Any]], List[float]]:
    """A (name, weight) mixture -> per-dataset kwargs and weights, a repeat
    dropped (the first weight wins) and a dataset the factory refuses
    skipped with a warning."""
    seen, spec = set(), []
    for name, weight in mixture_spec:
        if name in seen:
            overwatch.warning(f"Skipping duplicate dataset `{(name, weight)}`")
            continue
        seen.add(name)
        spec.append((name, weight))

    per_dataset_kwargs, weights = [], []
    for name, weight in spec:
        try:
            per_dataset_kwargs.append(make_oxe_dataset_kwargs(
                name, data_root_dir, load_camera_views, load_depth, load_proprio, load_language, load_pointcloud,
                load_tactile, action_proprio_normalization_type))
            weights.append(weight)
        except ValueError as e:
            overwatch.warning(f"Skipping `{name}`: {e}")
    return per_dataset_kwargs, weights
