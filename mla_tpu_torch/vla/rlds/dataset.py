"""The RLDS pipeline: trajectories off disk to an interleaved, shuffled
stream of decoded frames.

The port's copy of mla_tpu/vla/rlds/dataset.py, on `stream.Dataset` in
place of tf.data, with the same stages in the same order:

  * make_dataset_from_rlds: the builder (tfds_compat), each episode
    restructured into {observation, task, action, dataset_name} by its
    standardization transform, camera views and proprio keys from the OXE
    config, point-cloud and tactile passthrough, full-pass hash-cached
    statistics over split "all", BOUNDS_Q99 normalization.
  * apply_trajectory_transforms: the unlabelled filter, max_action and
    max_proprio, pad masks, window and future-action chunking.
  * flatten_to_frames, apply_per_dataset_frame_transforms,
    apply_frame_transforms (decode and resize every image_* key).
  * make_interleaved_dataset: statistics, `.repeat()` for training, the
    trajectory transforms, frames, the frame shuffle buffer (placed before
    decoding, so it holds frames with their images still encoded), then the
    frame transforms in an order-preserving pool of threads that also
    prefetches.
  * RLDSDataset and EpisodicRLDSDataset.

The port runs in one process, so there is no host sharding: the JAX
package's per-host shard of the episodes is the whole split here. Not
ported yet (each raises NotImplementedError naming its ROADMAP.md item): a
mixture of more than one dataset, explicit camera views, image
augmentation, goal relabelling, task augmentation and subsampling.
"""

from __future__ import annotations

import inspect
from functools import partial
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mla_tpu_torch.utils.overwatch import initialize_overwatch
from mla_tpu_torch.vla.rlds import tfds_compat
from mla_tpu_torch.vla.rlds import transforms as T
from mla_tpu_torch.vla.rlds.oxe.configs import OXE_DATASET_CONFIGS, POINTCLOUD_KEYS, TACTILE_KEYS
from mla_tpu_torch.vla.rlds.oxe.mixtures import OXE_NAMED_MIXTURES
from mla_tpu_torch.vla.rlds.oxe.transforms import get_standardization_transform
from mla_tpu_torch.vla.rlds.stream import AUTOTUNE, Dataset

overwatch = initialize_overwatch(__name__)

_DEFAULT_STATS_CACHE = "~/.cache/mla_tpu_torch"
ROADMAP_DATA = "ROADMAP.md queue 1, item 2 (the next data slice)"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({ROADMAP_DATA})")


def _strings(value: bytes, n: int) -> np.ndarray:
    out = np.empty(n, object)
    out[:] = [value] * n
    return out


def make_restructure_fn(
    name: str,
    standardize_fn: Callable[[Dict], Dict],
    image_obs_keys: Dict[str, Optional[str]],
    depth_obs_keys: Dict[str, Optional[str]],
    state_obs_keys: Sequence[Optional[str]],
    language_key: Optional[str],
    load_pointcloud: bool,
    load_tactile: bool,
    absolute_action_mask: Optional[Sequence[bool]] = None,
    absolute_proprio_mask: Optional[Sequence[bool]] = None,
) -> Callable[[Dict], Dict]:
    """The raw-trajectory -> standardized-schema map."""

    def restructure(traj: Dict) -> Dict:
        traj = standardize_fn(dict(traj))
        for required in ("observation", "action"):
            if required not in traj:
                raise ValueError(f"standardize_fn for `{name}` must produce `{required}`")

        traj_len = len(traj["action"])
        old_obs = traj["observation"]
        obs: Dict[str, Any] = {}
        for new, old in image_obs_keys.items():
            obs[f"image_{new}"] = _strings(b"", traj_len) if old is None else old_obs[old]
        for new, old in depth_obs_keys.items():
            obs[f"depth_{new}"] = _strings(b"", traj_len) if old is None else old_obs[old]

        # proprio: a standardized `proprio` key wins; else state_obs_keys
        # concatenated (None -> one zero column)
        if "proprio" in old_obs:
            obs["proprio"] = np.asarray(old_obs["proprio"]).astype(np.float32)
        elif any(k is not None for k in state_obs_keys):
            obs["proprio"] = np.concatenate(
                [np.zeros((traj_len, 1), np.float32) if key is None else np.asarray(old_obs[key]).astype(np.float32)
                 for key in state_obs_keys], axis=1)
        elif state_obs_keys:
            obs["proprio"] = np.zeros((traj_len, len(state_obs_keys)), np.float32)
        else:
            obs["proprio"] = np.zeros([traj_len, np.shape(traj["action"])[-1]], np.float32)
        obs["timestep"] = np.arange(traj_len, dtype=np.int32)

        if load_pointcloud:
            for key in POINTCLOUD_KEYS:
                obs[key] = np.asarray(old_obs[key]).astype(np.float32)
        if load_tactile:
            for key in TACTILE_KEYS:
                obs[key] = np.asarray(old_obs[key]).astype(np.float32)

        task: Dict[str, Any] = {}
        if language_key is not None:
            task["language_instruction"] = traj[language_key] if language_key in traj else old_obs[language_key]

        out = {
            "observation": obs,
            "task": task,
            "action": np.asarray(traj["action"]).astype(np.float32),
            "dataset_name": _strings(name.encode(), traj_len),
        }
        if absolute_action_mask is not None:
            out["absolute_action_mask"] = np.tile(np.asarray(absolute_action_mask, bool)[None], [traj_len, 1])
        if absolute_proprio_mask is not None:
            out["absolute_proprio_mask"] = np.tile(np.asarray(absolute_proprio_mask, bool)[None], [traj_len, 1])
        return out

    return restructure


def make_dataset_from_rlds(
    name: str,
    data_dir: str,
    *,
    train: bool = True,
    standardize_fn: Optional[Callable[[Dict], Dict]] = None,
    shuffle: bool = True,
    image_obs_keys: Optional[Dict[str, Optional[str]]] = None,
    depth_obs_keys: Optional[Dict[str, Optional[str]]] = None,
    state_obs_keys: Optional[Sequence[Optional[str]]] = None,
    language_key: Optional[str] = "language_instruction",
    action_proprio_normalization_type: T.NormalizationType = T.NormalizationType.BOUNDS_Q99,
    dataset_statistics: Optional[Dict] = None,
    absolute_action_mask: Optional[Sequence[bool]] = None,
    absolute_proprio_mask: Optional[Sequence[bool]] = None,
    action_normalization_mask: Optional[Sequence[bool]] = None,
    proprio_normalization_mask: Optional[Sequence[bool]] = None,
    load_pointcloud: bool = True,
    load_tactile: bool = False,
    load_all_data_for_training: bool = True,
    num_parallel_calls: Optional[int] = None,
    stats_cache_dir: str = _DEFAULT_STATS_CACHE,
    stats_sample_trajectories: Optional[int] = None,
) -> Tuple[Dataset, Dict]:
    """One standardized, normalized trajectory stream and its statistics.
    The key maps default to the dataset's OXE config entry; episodes are
    parsed, restructured and normalized in one pool of threads."""
    cfg = OXE_DATASET_CONFIGS.get(name, {})
    if standardize_fn is None:
        standardize_fn = get_standardization_transform(name)
    if image_obs_keys is None:
        # padded (None) views are dropped, so the frame schema stays tight
        image_obs_keys = {k: v for k, v in cfg.get("image_obs_keys", {}).items() if v is not None}
    if depth_obs_keys is None:
        depth_obs_keys = {}
    if state_obs_keys is None:
        state_obs_keys = cfg.get("state_obs_keys", [])
    n_calls = AUTOTUNE if num_parallel_calls in (None, -1) else num_parallel_calls

    restructure = make_restructure_fn(
        name, standardize_fn, image_obs_keys, depth_obs_keys, state_obs_keys, language_key, load_pointcloud,
        load_tactile, absolute_action_mask, absolute_proprio_mask,
    )
    builder = tfds_compat.builder(name, data_dir)

    def episodes_to_trajs(ds: Dataset) -> Dataset:
        return ds.map(lambda episode: restructure(dict(episode["steps"])), num_parallel_calls=n_calls)

    if dataset_statistics is None:
        # one full pass over every split, hash-cached on the builder info,
        # the split, the state keys and the transform's source
        stats_split = "all"
        stats_ds = episodes_to_trajs(builder.as_dataset(split=stats_split, shuffle_files=False))
        dataset_statistics = T.get_dataset_statistics(
            stats_ds,
            cache_dir=Path(stats_cache_dir).expanduser(),
            hash_dependencies=(
                str(builder.info),
                stats_split,
                str(list(state_obs_keys)),
                inspect.getsource(standardize_fn) if standardize_fn is not None else "",
            ),
            sample_trajectories=stats_sample_trajectories,
        )
    dataset_statistics = {
        k: ({kk: np.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict) else v)
        for k, v in dataset_statistics.items()
    }
    if action_normalization_mask is not None:
        dataset_statistics["action"]["mask"] = np.asarray(action_normalization_mask)
    if proprio_normalization_mask is not None:
        dataset_statistics["proprio"]["mask"] = np.asarray(proprio_normalization_mask)

    if "val" not in builder.info.splits:
        split = "train[:95%]" if train else "train[95%:]"
    else:
        split = "train" if train else "val"
    if load_all_data_for_training and train:
        split = "train"

    ds = episodes_to_trajs(builder.as_dataset(split=split, shuffle_files=shuffle and train))
    ds = ds.map(
        partial(T.normalize_action_and_proprio, metadata=dataset_statistics,
                normalization_type=action_proprio_normalization_type),
        num_parallel_calls=n_calls,
    )
    return ds, dataset_statistics


def apply_trajectory_transforms(
    ds: Dataset,
    *,
    train: bool = True,
    window_size: int = 1,
    future_action_window_size: int = 15,
    skip_unlabeled: bool = True,
    max_action: Optional[float] = None,
    max_proprio: Optional[float] = None,
    goal_relabeling_strategy: Optional[str] = None,
    task_augment_strategy: Optional[str] = None,
    task_augment_kwargs: Optional[Dict] = None,
    subsample_length: Optional[int] = None,
    dataset_statistics: Optional[Dict] = None,
    num_parallel_calls: Optional[int] = None,
) -> Dataset:
    """Trajectory-level filters, pad masks and chunking."""
    if goal_relabeling_strategy is not None:
        raise _not_ported(f"goal relabelling ({goal_relabeling_strategy!r})")
    if train and task_augment_strategy is not None:
        raise _not_ported(f"task augmentation ({task_augment_strategy!r}, {task_augment_kwargs})")
    if train and subsample_length is not None:
        raise _not_ported(f"trajectory subsampling (subsample_length={subsample_length})")
    n_calls = AUTOTUNE if num_parallel_calls in (None, -1) else num_parallel_calls

    if skip_unlabeled:
        ds = ds.filter(lambda traj: bool(np.any(np.asarray(traj["task"]["language_instruction"]) != b"")))
    if max_action is not None:
        ds = ds.filter(lambda traj: bool(np.all(np.abs(traj["action"]) <= max_action)))
    if max_proprio is not None:
        ds = ds.filter(lambda traj: bool(np.all(np.abs(traj["observation"]["proprio"]) <= max_proprio)))

    def transform(traj):
        traj = T.add_pad_mask_dict(traj)
        return T.chunk_act_obs(traj, window_size, future_action_window_size, dataset_statistics)

    return ds.map(transform, num_parallel_calls=n_calls)


def flatten_to_frames(ds: Dataset) -> Dataset:
    """Each trajectory's steps, one frame at a time, in order."""

    def frames(traj):
        n = len(traj["action"])
        return (T.tree_map(lambda x: x[i], traj) for i in range(n))

    return ds.flat_map(frames)


def apply_per_dataset_frame_transforms(ds: Dataset, chunk_filter_fn: Optional[Callable] = None) -> Dataset:
    """Per-dataset frame-level hooks (a frame filter)."""
    if chunk_filter_fn is not None:
        ds = ds.filter(chunk_filter_fn)
    return ds


def _transform_image_dict(d: Dict, size_for: Callable[[str], Tuple[int, int]]) -> Dict:
    """Decode and resize every image_* entry of one dict, whatever its
    leading dims ([window], [T, window] or none)."""
    for k in sorted(d):
        if not k.startswith("image_"):
            continue
        size = size_for(k[len("image_"):])
        raw = np.asarray(d[k]) if not isinstance(d[k], bytes) else d[k]
        if isinstance(raw, bytes) or raw.dtype == object:
            flat = [raw] if isinstance(raw, bytes) else list(raw.reshape(-1))
            lead = () if isinstance(raw, bytes) else raw.shape
        else:  # decoded uint8 images keep their [H, W, C] tail
            lead = raw.shape[:-3]
            flat = list(raw.reshape((-1,) + raw.shape[-3:]))
        imgs = [T.decode_and_resize_image(im, size) for im in flat]
        d[k] = np.stack(imgs).reshape(tuple(lead) + (size[0], size[1], 3)) if imgs else np.zeros(
            tuple(lead) + (size[0], size[1], 3), np.uint8)
    return d


def apply_frame_transforms(
    ds: Dataset,
    *,
    image_size: int = 672,
    resize_size: Optional[Dict[str, Tuple[int, int]]] = None,
    train: bool = True,
    augment: bool = False,
    image_augment_kwargs: Optional[Dict] = None,
    num_parallel_calls: Optional[int] = AUTOTUNE,
) -> Dataset:
    """Frame-level decode and resize of the observation's and the task's
    image_* keys; `resize_size` maps key suffixes to (h, w), others get
    `image_size` square."""
    if augment or image_augment_kwargs is not None:
        raise _not_ported("image augmentation")
    del train

    def size_for(key: str) -> Tuple[int, int]:
        if resize_size and key in resize_size:
            return tuple(resize_size[key])
        return (image_size, image_size)

    def fn(frame):
        frame = dict(frame)
        frame["observation"] = _transform_image_dict(dict(frame["observation"]), size_for)
        if isinstance(frame.get("task"), dict):
            frame["task"] = _transform_image_dict(dict(frame["task"]), size_for)
        return frame

    return ds.map(fn, num_parallel_calls=num_parallel_calls)


def _dataset_kwargs_for_mix(
    data_mix: str,
    data_dir: str,
    *,
    load_camera_views: Optional[Sequence[str]],
    load_pointcloud: bool,
    load_tactile: bool,
) -> Tuple[List[Dict], List[float]]:
    """Per-dataset kwargs and raw weights of the mix (each view its dataset
    has; a repeated dataset keeps its first weight)."""
    if load_camera_views is not None:
        raise _not_ported(f"loading the camera views {list(load_camera_views)} through the OXE kwargs factory")
    mixture = OXE_NAMED_MIXTURES.get(data_mix, [(data_mix, 1.0)])
    per_dataset_kwargs, weights, seen = [], [], set()
    for ds_name, w in mixture:
        if ds_name in seen:
            overwatch.warning(f"Skipping duplicate dataset `{(ds_name, w)}`")
            continue
        seen.add(ds_name)
        per_dataset_kwargs.append({"name": ds_name, "data_dir": data_dir, "load_pointcloud": load_pointcloud,
                                   "load_tactile": load_tactile})
        weights.append(w)
    return per_dataset_kwargs, weights


def compute_sample_weights(raw_weights: Sequence[float], sizes: Sequence[int], balance: bool
                           ) -> Tuple[np.ndarray, int]:
    """Normalized sampling weights and the effective dataset length: with
    `balance`, raw weights times each dataset's transition count; the length
    is the expected number of samples until every primary dataset (raw
    weight 1.0) completes one epoch."""
    weights = np.asarray(raw_weights, np.float64)
    primary = np.nonzero(weights == 1.0)[0]
    if balance:
        weights = weights * np.asarray(sizes, np.float64)
    weights = weights / weights.sum()
    if primary.size == 0:
        primary = np.arange(len(weights))
    dataset_len = int((np.asarray(sizes, np.float64) / weights)[primary].max())
    return weights, dataset_len


def make_interleaved_dataset(
    data_mix: str,
    data_dir: str,
    *,
    train: bool = True,
    shuffle_buffer_size: int = 10_000,
    window_size: int = 1,
    future_action_window_size: int = 15,
    load_camera_views: Optional[Sequence[str]] = None,
    load_pointcloud: bool = True,
    load_tactile: bool = False,
    image_size: int = 672,
    resize_size: Optional[Dict[str, Tuple[int, int]]] = None,
    augment: bool = False,
    image_augment_kwargs: Optional[Dict] = None,
    balance_weights: bool = True,
    goal_relabeling_strategy: Optional[str] = None,
    task_augment_strategy: Optional[str] = None,
    task_augment_kwargs: Optional[Dict] = None,
    subsample_length: Optional[int] = None,
    max_action: Optional[float] = None,
    max_proprio: Optional[float] = None,
    traj_transform_threads: Optional[int] = None,
    stats_sample_trajectories: Optional[int] = None,
    stats_cache_dir: str = _DEFAULT_STATS_CACHE,
    seed: int = 0,
) -> Tuple[Dataset, int, Dict]:
    """The mixture's frame stream: (dataset, effective length, per-dataset
    statistics). With `balance_weights` each raw weight is multiplied by the
    dataset's transition count. One dataset a mixture in this port."""
    if augment or image_augment_kwargs is not None:
        raise _not_ported("image augmentation")
    per_dataset_kwargs, raw_weights = _dataset_kwargs_for_mix(
        data_mix, data_dir, load_camera_views=load_camera_views, load_pointcloud=load_pointcloud,
        load_tactile=load_tactile)
    if not per_dataset_kwargs:
        raise ValueError(f"Mixture `{data_mix}` resolved to zero loadable datasets")
    if len(per_dataset_kwargs) > 1:
        raise _not_ported(f"interleaving the {len(per_dataset_kwargs)} datasets of mixture `{data_mix}`")

    # pass 1: statistics (cached), and the sizes for the weights
    all_stats: Dict[str, Dict] = {}
    sizes = []
    for kwargs in per_dataset_kwargs:
        _, stats = make_dataset_from_rlds(**kwargs, train=train, stats_sample_trajectories=stats_sample_trajectories,
                                          stats_cache_dir=stats_cache_dir)
        all_stats[kwargs["name"]] = stats
        sizes.append(int(stats["num_transitions"]))
    weights, dataset_len = compute_sample_weights(raw_weights, sizes, balance_weights)
    threads_per = T.allocate_threads(traj_transform_threads, np.array(weights))

    (kwargs,), (n_threads,) = per_dataset_kwargs, threads_per
    ds, stats = make_dataset_from_rlds(**kwargs, train=train, dataset_statistics=all_stats[kwargs["name"]],
                                       num_parallel_calls=int(n_threads))
    ds = apply_trajectory_transforms(
        ds.repeat() if train else ds, train=train, window_size=window_size,
        future_action_window_size=future_action_window_size, goal_relabeling_strategy=goal_relabeling_strategy,
        task_augment_strategy=task_augment_strategy, task_augment_kwargs=task_augment_kwargs,
        subsample_length=subsample_length, max_action=max_action, max_proprio=max_proprio,
        dataset_statistics=stats, num_parallel_calls=int(n_threads),
    )
    ds = apply_per_dataset_frame_transforms(flatten_to_frames(ds))
    if not train:
        # one buffer of validation data, fixed and cached
        ds = ds.take(shuffle_buffer_size).cache()
    ds = ds.shuffle(shuffle_buffer_size, seed=seed)
    ds = apply_frame_transforms(ds, image_size=image_size, resize_size=resize_size, train=train)
    return ds, dataset_len, all_stats


class RLDSDataset:
    """Iterable frame stream over the interleaved pipeline."""

    def __init__(self, data_root_dir: str, data_mix: str, *, train: bool = True, shuffle_buffer_size: int = 10_000,
                 future_action_window_size: int = 15, load_pointcloud: bool = True, load_tactile: bool = False,
                 image_size: int = 672, augment: bool = False, seed: int = 0, balance_weights: bool = True,
                 load_camera_views: Optional[Sequence[str]] = None) -> None:
        self.dataset, self.dataset_length, self.dataset_statistics = make_interleaved_dataset(
            data_mix, data_root_dir, train=train, shuffle_buffer_size=shuffle_buffer_size,
            future_action_window_size=future_action_window_size, load_pointcloud=load_pointcloud,
            load_tactile=load_tactile, image_size=image_size, augment=augment, seed=seed,
            balance_weights=balance_weights, load_camera_views=load_camera_views,
        )

    def __iter__(self):
        return iter(self.dataset)

    def __len__(self) -> int:
        return self.dataset_length


class EpisodicRLDSDataset:
    """Whole trajectories (chunked, normalized, images decoded) instead of a
    frame stream, for replay."""

    def __init__(self, data_root_dir: str, dataset_name: str, *, train: bool = False,
                 future_action_window_size: int = 15, load_pointcloud: bool = True, load_tactile: bool = False,
                 image_size: int = 672) -> None:
        ds, stats = make_dataset_from_rlds(dataset_name, data_root_dir, train=train, load_pointcloud=load_pointcloud,
                                           load_tactile=load_tactile)
        ds = apply_trajectory_transforms(ds, future_action_window_size=future_action_window_size,
                                         dataset_statistics=stats, train=train)
        self.dataset = apply_frame_transforms(ds, image_size=image_size, train=train)
        self.dataset_statistics = stats

    def __iter__(self):
        return iter(self.dataset)
