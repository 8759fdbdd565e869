"""Trajectory and frame transforms, in numpy.

The port's copy of mla_tpu/vla/rlds/transforms.py, which builds TensorFlow
graph ops. A trajectory is a nested dict of numpy arrays with time leading;
strings are object arrays of bytes.

  * normalize_action_and_proprio, to_padding, tree_merge, add_pad_mask_dict,
    chunk_act_obs: TensorFlow meets a float64 numpy operand (the q01/q99
    bounds, high - low + 1e-8, chunk_act_obs's normalized zero action) by
    converting it to float32 first; so does this copy, and the normalized
    actions and proprio come out bit for bit as JAX's pipeline gives them.
  * decode_and_resize_image: PNG decode (png.py), then TensorFlow's
    tf.image.resize(method="lanczos3") with antialias off, which is
    ScaleAndTranslate: each axis a float32 sum over at most 7 taps of the
    Lanczos-3 kernel (weights normalized to sum 1), the vertical pass first,
    in TensorFlow's tap order, through the host helper; then round half to
    even, clip to 0..255 and cast to uint8. An empty string gives zeros.
  * compute_dataset_statistics, cached_dataset_statistics,
    get_dataset_statistics (full pass, a JSON cache keyed by a hash of the
    builder info, split, state keys and transform source), allocate_threads.
"""

from __future__ import annotations

import functools
import hashlib
import json
from enum import Enum
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from mla_tpu_torch.native import rlds_host
from mla_tpu_torch.vla.rlds import png


class NormalizationType(str, Enum):
    NORMAL = "normal"
    BOUNDS = "bounds"
    BOUNDS_Q99 = "bounds_q99"


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


# --------------------------------------------------------------------------- #
# normalization
# --------------------------------------------------------------------------- #


def normalize_action_and_proprio(traj: Dict, metadata: Dict, normalization_type: NormalizationType) -> Dict:
    """Normalize traj['action'] and traj['observation']['proprio'] in place."""

    def norm(x, stats):
        ref = stats["q01"] if "q01" in stats else stats["mean"]
        mask = np.asarray(stats.get("mask", np.ones_like(np.asarray(ref), bool)), bool)
        if normalization_type == NormalizationType.NORMAL:
            return np.where(mask, (x - _f32(stats["mean"])) / _f32(np.asarray(stats["std"]) + 1e-8), x)
        low = np.asarray(stats["min"] if normalization_type == NormalizationType.BOUNDS else stats["q01"])
        high = np.asarray(stats["max"] if normalization_type == NormalizationType.BOUNDS else stats["q99"])
        scaled = np.float32(2) * (x - _f32(low)) / _f32(high - low + 1e-8) - np.float32(1)
        y = np.where(mask, np.clip(scaled, np.float32(-1), np.float32(1)), x)
        zeros_mask = (np.asarray(stats["min"]) == np.asarray(stats["max"]) if "min" in stats
                      else np.zeros_like(low, bool))
        return np.where(zeros_mask, np.zeros_like(y), y)

    traj["action"] = norm(traj["action"], {k: np.asarray(v) for k, v in metadata["action"].items()})
    if "proprio" in traj.get("observation", {}):
        traj["observation"]["proprio"] = norm(
            traj["observation"]["proprio"], {k: np.asarray(v) for k, v in metadata["proprio"].items()})
    return traj


# --------------------------------------------------------------------------- #
# padding / tree utilities
# --------------------------------------------------------------------------- #


def _is_string(a) -> bool:
    return np.asarray(a).dtype.kind in ("O", "S", "U")


def to_padding(a: np.ndarray) -> np.ndarray:
    """The padding value of an array: zeros for numbers, b"" for strings."""
    if _is_string(a):
        out = np.empty(np.shape(a), object)
        out[...] = b""
        return out
    return np.zeros_like(a)


def tree_merge(*trees: Dict) -> Dict:
    """Right-biased nested-dict merge."""
    merged: Dict = {}
    for tree in trees:
        for k, v in tree.items():
            merged[k] = tree_merge(merged.get(k, {}), v) if isinstance(v, dict) else v
    return merged


def add_pad_mask_dict(traj: Dict) -> Dict:
    """Mark padded (empty-string) observation and task entries."""
    traj_len = len(traj["action"])
    for group in ("observation", "task"):
        masks = {}
        for key, val in traj[group].items():
            if _is_string(val):
                masks[key] = np.array([len(s) != 0 for s in np.asarray(val).reshape(-1)], bool).reshape(
                    np.shape(val))
            else:
                masks[key] = np.ones([traj_len], bool)
        traj[group]["pad_mask_dict"] = masks
    return traj


# --------------------------------------------------------------------------- #
# trajectory chunking
# --------------------------------------------------------------------------- #


def chunk_act_obs(traj: Dict, window_size: int, future_action_window_size: int = 0,
                  dataset_statistics: Optional[Dict] = None) -> Dict:
    """Window the observations and chunk the actions (future steps), with
    edge padding and the normalized zero action past the goal and before the
    start."""
    traj_len = len(traj["action"])
    steps = np.arange(traj_len, dtype=np.int32)[:, None]
    chunk_indices = np.arange(-window_size + 1, 1, dtype=np.int32)[None, :] + steps
    action_chunk_indices = np.arange(-window_size + 1, 1 + future_action_window_size, dtype=np.int32)[None, :] + steps
    floored_chunk_indices = np.maximum(chunk_indices, 0)
    task = traj.get("task", {})
    goal_timestep = (np.asarray(task["timestep"]) if "timestep" in task
                     else np.full([traj_len], traj_len - 1, np.int32))
    floored_action_chunk_indices = np.minimum(np.maximum(action_chunk_indices, 0), goal_timestep[:, None])

    traj["observation"] = tree_map(lambda x: np.asarray(x)[floored_chunk_indices], traj["observation"])
    traj["action"] = np.asarray(traj["action"])[floored_action_chunk_indices]
    traj["observation"]["pad_mask"] = chunk_indices >= 0

    if dataset_statistics is not None:
        action_dim = traj["action"].shape[-1]
        absolute_action_mask = traj.get("absolute_action_mask", np.zeros([traj_len, action_dim], bool))
        low = np.asarray(dataset_statistics["action"]["q01"])
        high = np.asarray(dataset_statistics["action"]["q99"])
        # computed in float64 by numpy, then cast to the actions' float32
        norm_zero = 2 * (0 - low) / (high - low + 1e-8) - 1
        expanded = np.broadcast_to(norm_zero, traj["action"].shape).astype(traj["action"].dtype)
        neutral_actions = np.where(np.asarray(absolute_action_mask)[:, None, :], traj["action"], expanded)
        past_goal = action_chunk_indices > goal_timestep[:, None]
        traj["action"] = np.where(past_goal[:, :, None], neutral_actions, traj["action"])
        before_start = action_chunk_indices < 0
        traj["action"] = np.where(before_start[:, :, None], neutral_actions, traj["action"])
    return traj


# --------------------------------------------------------------------------- #
# frame transforms: decode and TensorFlow's Lanczos-3 resize
# --------------------------------------------------------------------------- #

_KPI = np.float32(3.14159265359)
_RADIUS = np.float32(3.0)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    """TensorFlow's LanczosKernelFunc(3) in float32, term for term: radius *
    sin(pi x) * sin(pi x / radius) / (pi pi x x), 1 within 1e-3 of 0, 0 past
    the radius, with the C library's float sine as TensorFlow's."""
    x = np.abs(x.astype(np.float32))
    s1, s2 = rlds_host.sinf(_KPI * x), rlds_host.sinf(_KPI * x / _RADIUS)
    with np.errstate(divide="ignore", invalid="ignore"):
        val = _RADIUS * s1 * s2 / (_KPI * _KPI * x * x)
    return np.where(x > _RADIUS, np.float32(0), np.where(x.astype(np.float64) <= 1e-3, np.float32(1), val))


@functools.lru_cache(maxsize=64)
def lanczos3_spans(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """TensorFlow's ComputeSpans for Lanczos-3, scale out/in, no translation,
    no antialiasing: (first input index [out], weights [out, span]), each
    output's weights normalized by their float32 sum in tap order, zero
    past its span and all zero where the sample falls outside the input."""
    scale = np.float32(out_size) / np.float32(in_size)
    inv_scale = np.float32(1.0 / float(scale))
    inv_translate = -inv_scale * np.float32(0)
    span = min(2 * int(np.ceil(_RADIUS)) + 1, in_size)
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale + inv_translate
    inside = (sample >= 0) & (sample <= np.float32(in_size))
    lo = np.ceil(sample - _RADIUS - np.float32(0.5)).astype(np.int64)
    hi = np.floor(sample + _RADIUS - np.float32(0.5)).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 1)
    hi = np.clip(hi, 0, in_size - 1) + 1
    starts = np.where(inside, lo, 0).astype(np.int32)
    weights = np.zeros((out_size, span), np.float32)
    total = np.zeros(out_size, np.float32)
    for j in range(span):
        live = inside & (lo + j < hi)
        pos = ((lo + j).astype(np.float32) + np.float32(0.5)) - sample
        w = np.where(live, _lanczos3(pos), np.float32(0))
        weights[:, j] = w
        total = np.where(live, total + w, total)
    keep = np.abs(total) >= np.float32(1000) * np.finfo(np.float32).tiny
    inv_total = np.where(keep, np.float32(1) / np.where(keep, total, np.float32(1)), np.float32(0))
    weights = np.where(keep[:, None], weights * inv_total[:, None], np.float32(0))
    starts.flags.writeable = weights.flags.writeable = False  # cached: shared by every caller
    return starts, weights


def resize_lanczos3(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 or float [H, W, C] -> float32 [size[0], size[1], C], as
    tf.image.resize(tf.cast(image, tf.float32), size, method="lanczos3")."""
    img = np.asarray(image, np.float32)
    return rlds_host.resample(img, lanczos3_spans(img.shape[0], size[0]), lanczos3_spans(img.shape[1], size[1]))


def decode_and_resize_image(image, size=672) -> np.ndarray:
    """Encoded bytes (or a uint8 [H, W, 3] array) -> uint8 [h, w, 3]; an
    empty string, a padded view, decodes to zeros."""
    if isinstance(size, int):
        size = (size, size)
    if isinstance(image, (bytes, bytearray, memoryview)):
        if len(image) == 0:
            return np.zeros((*size, 3), np.uint8)
        image = png.decode(image)
    out = resize_lanczos3(image, size)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------- #
# dataset statistics
# --------------------------------------------------------------------------- #


def compute_dataset_statistics(actions: np.ndarray, proprios: np.ndarray,
                               num_trajectories: Optional[int] = None) -> Dict:
    """q01/q99/mean/std/min/max over concatenated transitions."""

    def stats(x):
        return {
            "mean": x.mean(0).tolist(),
            "std": x.std(0).tolist(),
            "max": x.max(0).tolist(),
            "min": x.min(0).tolist(),
            "q01": np.quantile(x, 0.01, axis=0).tolist(),
            "q99": np.quantile(x, 0.99, axis=0).tolist(),
        }

    out = {
        "action": stats(np.asarray(actions, np.float64)),
        "proprio": stats(np.asarray(proprios, np.float64)),
        "num_transitions": int(len(actions)),
    }
    if num_trajectories is not None:
        out["num_trajectories"] = int(num_trajectories)
    return out


def cached_dataset_statistics(cache_dir, hash_dependencies: Sequence[str], compute_fn) -> Dict:
    """A JSON cache keyed by a sha256 over the dependency strings."""
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha256("".join(hash_dependencies).encode("utf-8")).hexdigest()[:32]
    path = cache_dir / f"dataset_statistics_{h}.json"
    if path.exists():
        return json.loads(path.read_text())
    stats = compute_fn()
    path.write_text(json.dumps(stats))
    return stats


def get_dataset_statistics(ds, cache_dir, hash_dependencies: Sequence[str],
                           sample_trajectories: Optional[int] = None) -> Dict:
    """Statistics of a standardized trajectory stream, one full pass (or the
    first `sample_trajectories`, which joins the cache key), hash-cached."""

    def compute():
        source = ds.take(sample_trajectories) if sample_trajectories else ds
        acts, props, n_traj = [], [], 0
        for traj in source:
            act = np.asarray(traj["action"])
            acts.append(act.reshape(-1, act.shape[-1]))
            prop = traj["observation"]["proprio"] if "proprio" in traj["observation"] else np.zeros_like(acts[-1])
            props.append(np.asarray(prop).reshape(-1, np.asarray(prop).shape[-1]))
            n_traj += 1
        return compute_dataset_statistics(np.concatenate(acts), np.concatenate(props), num_trajectories=n_traj)

    deps = list(hash_dependencies) + ([f"sample={sample_trajectories}"] if sample_trajectories else [])
    return cached_dataset_statistics(cache_dir, deps, compute)


def allocate_threads(n: Optional[int], weights: np.ndarray) -> np.ndarray:
    """Distribute `n` threads across datasets in proportion to their
    weights, at least 1 each; None gives AUTOTUNE (-1) to each."""
    if n is None:
        return np.array([-1] * len(weights))
    if len(weights) > n:
        raise ValueError("Not enough threads to give each dataset at least one.")
    weights = np.asarray(weights, np.float64) / np.sum(weights)
    alloc = np.zeros(len(weights), dtype=np.int64)
    while True:
        # datasets whose proportional share would round to zero get exactly 1
        mask = (weights * n < 1) & (weights > 0)
        if not mask.any():
            break
        n -= int(mask.sum())
        alloc += mask.astype(np.int64)
        weights[mask] = 0
        weights = weights / weights.sum()
    fractional, integral = np.modf(weights * n)
    alloc += integral.astype(np.int64)
    n -= int(integral.sum())
    for i in np.argsort(fractional)[::-1][:n]:
        alloc[i] += 1
    return alloc
