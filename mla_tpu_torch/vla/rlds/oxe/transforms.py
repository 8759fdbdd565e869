"""Per-dataset standardization transforms, in numpy: the MLA suites.

The port's copy of the MLA-suite part of mla_tpu/vla/rlds/oxe/transforms.py.
Each transform takes one raw trajectory (a dict of numpy arrays, time
leading) and returns it standardized. The MLA suites (rlbench, metaworld,
franka, franka_dual, agilex, rtx_dataset) add next-frame copies of their
camera, point-cloud and tactile keys, the last frame repeating itself; the
datasets the JAX package maps to its identity transform keep it. The other
Open-X-Embodiment transforms are not ported: asking for one raises.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from mla_tpu_torch.vla.rlds.oxe.configs import OXE_DATASET_CONFIGS

ROADMAP_OXE = "ROADMAP.md queue 1, item 2 (the next data slice: the Open-X-Embodiment transforms)"


def identity_transform(traj: Dict) -> Dict:
    return traj


def _next_frame_keys(traj: Dict, keys) -> Dict:
    """Append next-timestep copies of `keys` (the last frame repeats)."""
    obs = traj["observation"]
    for k in keys:
        v = np.asarray(obs[k])
        obs[f"next_{k}"] = np.concatenate([v[1:], v[-1:]], axis=0)
    return traj


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


OXE_STANDARDIZATION_TRANSFORMS: Dict[str, Callable] = {
    "berkeley_mvp_converted_externally_to_rlds": identity_transform,
    "berkeley_rpt_converted_externally_to_rlds": identity_transform,
    "dlr_sara_pour_converted_externally_to_rlds": identity_transform,
    "custom_finetuning": identity_transform,
    "rlbench": rlbench_transform,
    "metaworld": metaworld_transform,
    "franka": franka_transform,
    "franka_dual": franka_transform,
    "agilex": agilex_transform,
    "rtx_dataset": rtx_dataset_transform,
}

# the JAX package's other transforms: every configured dataset, and ppgm
NOT_PORTED = (set(OXE_DATASET_CONFIGS) | {"ppgm", "ppgm_static", "ppgm_wrist"}) - set(OXE_STANDARDIZATION_TRANSFORMS)


def get_standardization_transform(name: str) -> Callable:
    """The dataset's transform; the identity for a name the registry does not
    know, as in JAX."""
    if name in NOT_PORTED:
        raise NotImplementedError(f"the standardization transform of `{name}` is not ported ({ROADMAP_OXE})")
    return OXE_STANDARDIZATION_TRANSFORMS.get(name, identity_transform)
