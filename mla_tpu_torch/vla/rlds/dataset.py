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
    max_proprio, pad masks, goal relabelling, task augmentation (training),
    window and future-action chunking, subsampling (training); the draws of
    trajectory n from numpy's generator of (seed, n).
  * flatten_to_frames, apply_per_dataset_frame_transforms,
    apply_frame_transforms (decode and resize every image_* key, then, in
    training, augment_image with one seed per frame: seed + i for the i-th
    key in sorted order, the padding frames zeroed).
  * make_interleaved_dataset: each dataset of the mixture (its kwargs from
    the views it has, or from the OXE kwargs factory, oxe/materialize.py,
    where `load_camera_views` is given) with its statistics, fitted to
    the mixture's common views and the model's proprio width
    (`fit_mixture`, where JAX refuses), `.repeat()` for training, the
    trajectory transforms, frames and its frame filter;
    the datasets interleaved by their size-balanced weights
    (`Dataset.sample_from_datasets`); the frame shuffle buffer (placed
    before decoding, so it holds frames with their images still encoded),
    then the frame transforms in an order-preserving pool of threads that
    also prefetches.
  * RLDSDataset and EpisodicRLDSDataset.

Over several processes (torchrun) each data rank reads its own shard of
every dataset's episodes: every data-world-th episode from its data rank,
cut from the canonical file order with no per-rank file shuffle, as JAX's
ds.shard(process_count, process_index) does; a mixture is sharded per
dataset. The data rank and world (`data_shard`) are the trainer's mesh's:
the ranks of a tp group share one and read the same frames; by default
the process index and count. The trajectory draws cannot be TensorFlow's
(its stateful RNG replays nowhere else); the frame augmentation's are
(stateless Philox), given the frame's seed. Each data rank draws both
from its own seed (draw_seed), as JAX's processes draw independently.
"""

from __future__ import annotations

import inspect
from functools import partial
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mla_tpu_torch.utils.overwatch import initialize_overwatch, process_count, process_index
from mla_tpu_torch.vla.rlds import tfds_compat
from mla_tpu_torch.vla.rlds import transforms as T
from mla_tpu_torch.vla.rlds.oxe.configs import OXE_DATASET_CONFIGS, POINTCLOUD_KEYS, TACTILE_KEYS
from mla_tpu_torch.vla.rlds.oxe.materialize import get_oxe_dataset_kwargs_and_weights
from mla_tpu_torch.vla.rlds.oxe.mixtures import OXE_NAMED_MIXTURES
from mla_tpu_torch.vla.rlds.oxe.transforms import get_standardization_transform
from mla_tpu_torch.vla.rlds.stream import AUTOTUNE, Dataset

overwatch = initialize_overwatch(__name__)

_DEFAULT_STATS_CACHE = "~/.cache/mla_tpu_torch"

# the default train-time augmentation set (JAX dataset.py:332-345)
DEFAULT_IMAGE_AUGMENT_KWARGS: Dict[str, Any] = {
    "random_resized_crop": {"scale": [0.9, 0.9], "ratio": [1.0, 1.0]},
    "random_brightness": [0.2],
    "random_contrast": [0.8, 1.2],
    "random_saturation": [0.8, 1.2],
    "random_hue": [0.05],
    "augment_order": ["random_resized_crop", "random_brightness", "random_contrast", "random_saturation",
                      "random_hue"],
}


def _data_shard(data_shard: Optional[Tuple[int, int]]) -> Tuple[int, int]:
    """(data rank, data world): the given pair, or this process's index and
    the process count."""
    return tuple(data_shard) if data_shard is not None else (process_index(), process_count())


def draw_seed(seed: int, data_rank: Optional[int] = None) -> int:
    """The seed of this rank's train-time draws (the trajectory transforms'
    and the frames' augmentation seeds): seed + 1_000_003 * data rank, the
    fold of utils.set_global_seed. The data ranks then draw independently,
    as JAX's processes do from TensorFlow's unseeded RNG (the ranks of a
    tp group alike), and a run on one process draws from `seed` itself.
    The shuffle and the mixture's sampling keep `seed` on every rank, as
    JAX's do. `data_rank` defaults to the process index."""
    return seed + 1_000_003 * (process_index() if data_rank is None else data_rank)


def _enumerated(ds: Dataset) -> Dataset:
    """(index, element) pairs, the index counting over repeats too."""
    return Dataset(lambda: enumerate(iter(ds)))


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
    data_shard: Optional[Tuple[int, int]] = None,
) -> Tuple[Dataset, Dict]:
    """One standardized, normalized trajectory stream and its statistics.
    The key maps default to the dataset's OXE config entry; episodes are
    parsed, restructured and normalized in one pool of threads. Over
    several data ranks (`data_shard`: data rank, data world; by default
    the process index and count), this rank's shard of the episodes
    (statistics over all of them)."""
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

    index, num_shards = _data_shard(data_shard)
    # shards are cut from the canonical file order: a per-rank file shuffle
    # would make shard(P, i) take every P-th episode of P different orders
    ds = builder.as_dataset(split=split, shuffle_files=shuffle and train and num_shards == 1)
    if num_shards > 1:
        ds = ds.shard(num_shards, index)
    ds = episodes_to_trajs(ds)
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
    seed: int = 0,
    data_rank: Optional[int] = None,
) -> Dataset:
    """Trajectory-level filters, pad masks, goal relabelling, task
    augmentation (training), chunking and subsampling (training), in JAX's
    order; trajectory n draws from numpy's generator of (draw_seed(seed,
    data_rank), n)."""
    if goal_relabeling_strategy not in (None, "uniform"):
        raise KeyError(goal_relabeling_strategy)
    if train and task_augment_strategy not in (None, "delete_task_conditioning"):
        raise KeyError(task_augment_strategy)
    n_calls = AUTOTUNE if num_parallel_calls in (None, -1) else num_parallel_calls
    seed = draw_seed(seed, data_rank)

    if skip_unlabeled:
        ds = ds.filter(lambda traj: bool(np.any(np.asarray(traj["task"]["language_instruction"]) != b"")))
    if max_action is not None:
        ds = ds.filter(lambda traj: bool(np.all(np.abs(traj["action"]) <= max_action)))
    if max_proprio is not None:
        ds = ds.filter(lambda traj: bool(np.all(np.abs(traj["observation"]["proprio"]) <= max_proprio)))

    def transform(item):
        n, traj = item
        rng = np.random.default_rng([seed, n])
        traj = T.add_pad_mask_dict(traj)
        if goal_relabeling_strategy is not None:
            traj = T.goal_relabel_uniform(traj, rng)
        if train and task_augment_strategy is not None:
            traj = T.delete_task_conditioning(traj, rng=rng, **(task_augment_kwargs or {}))
        traj = T.chunk_act_obs(traj, window_size, future_action_window_size, dataset_statistics)
        if train and subsample_length is not None:
            traj = T.subsample(traj, subsample_length, rng)
        return traj

    return _enumerated(ds).map(transform, num_parallel_calls=n_calls)


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


def _transform_image_dict(d: Dict, size_for: Callable[[str], Tuple[int, int]],
                          augment_for: Callable[[str], Optional[Dict]] = lambda key: None,
                          seed: Optional[np.ndarray] = None) -> Dict:
    """Decode and resize every image_* entry of one dict, whatever its
    leading dims ([window], [T, window] or none); then augment (where
    augment_for gives kwargs, and only frames: at most one leading dim) the
    i-th key of the sorted dict with seed + i, padding frames zeroed."""
    pad_masks = d.get("pad_mask_dict", {})
    for i, k in enumerate(sorted(d)):
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
        kw = augment_for(k[len("image_"):]) if len(lead) <= 1 else None
        if kw:
            s = np.asarray(seed, np.int32) + np.int32(i)
            if not lead:
                d[k] = T.augment_image(d[k], s, **kw)
            else:
                d[k] = np.stack([T.augment_image(im, s, **kw) for im in d[k]])
                if k in pad_masks:
                    d[k] = d[k] * np.asarray(pad_masks[k]).astype(d[k].dtype).reshape(-1, 1, 1, 1)
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
    seed: int = 0,
    data_rank: Optional[int] = None,
) -> Dataset:
    """Frame-level decode and resize of the observation's and the task's
    image_* keys; `resize_size` maps key suffixes to (h, w), others get
    `image_size` square. In training with `augment` (the default kwargs,
    DEFAULT_IMAGE_AUGMENT_KWARGS) or `image_augment_kwargs` (one dict with
    `augment_order`, or one per key suffix), each frame's images are
    augmented with one seed, two int32 in [0, 2**31 - 1) drawn for frame n
    from numpy's generator of (draw_seed(seed, data_rank), n) (JAX draws
    them from TensorFlow's stateful RNG)."""
    aug = image_augment_kwargs if image_augment_kwargs is not None else (
        DEFAULT_IMAGE_AUGMENT_KWARGS if augment else None)
    seed = draw_seed(seed, data_rank)

    def size_for(key: str) -> Tuple[int, int]:
        if resize_size and key in resize_size:
            return tuple(resize_size[key])
        return (image_size, image_size)

    def augment_for(key: str) -> Optional[Dict]:
        if aug is None or not train:
            return None
        return aug if "augment_order" in aug else aug.get(key)

    def fn(item):
        n, frame = item
        frame = dict(frame)
        frame_seed = np.random.default_rng([seed, n]).integers(0, 2**31 - 1, 2, dtype=np.int32) if aug else None
        frame["observation"] = _transform_image_dict(dict(frame["observation"]), size_for, augment_for, frame_seed)
        if isinstance(frame.get("task"), dict):
            frame["task"] = _transform_image_dict(dict(frame["task"]), size_for, augment_for, frame_seed)
        return frame

    return _enumerated(ds).map(fn, num_parallel_calls=num_parallel_calls)


def _dataset_kwargs_for_mix(
    data_mix: str,
    data_dir: str,
    *,
    load_camera_views: Optional[Sequence[str]],
    load_pointcloud: bool,
    load_tactile: bool,
) -> Tuple[List[Tuple[Dict, Dict]], List[float]]:
    """Per dataset of the mix, its `make_dataset_from_rlds` kwargs and its
    frame-transform kwargs, and the raw weights (a repeated dataset keeps
    its first weight). With `load_camera_views`, the OXE kwargs factory's;
    without, each dataset loads the views its config has, as in JAX."""
    mixture = OXE_NAMED_MIXTURES.get(data_mix, [(data_mix, 1.0)])
    if load_camera_views is not None:
        per_dataset_kwargs, weights = get_oxe_dataset_kwargs_and_weights(
            data_dir, mixture, load_camera_views=load_camera_views, load_pointcloud=load_pointcloud,
            load_tactile=load_tactile, action_proprio_normalization_type=T.NormalizationType.BOUNDS_Q99)
    else:
        per_dataset_kwargs, weights, seen = [], [], set()
        for ds_name, w in mixture:
            if ds_name in seen:
                overwatch.warning(f"Skipping duplicate dataset `{(ds_name, w)}`")
                continue
            seen.add(ds_name)
            per_dataset_kwargs.append({"name": ds_name, "data_dir": data_dir, "load_pointcloud": load_pointcloud,
                                       "load_tactile": load_tactile})
            weights.append(w)
    return [(kw, kw.pop("dataset_frame_transform_kwargs", {})) for kw in per_dataset_kwargs], weights


def fit_mixture(per_dataset_kwargs: Sequence[Dict], all_stats: Dict[str, Dict], proprio_dim: int) -> List[bool]:
    """Fit the mixture's frames to one structure and to the model's proprio
    width, where JAX refuses (ROADMAP.md section 3):
      * each dataset loads only the camera views that every dataset of the
        mixture has (JAX's tf.data refuses to interleave frames of
        different views); a dataset alone keeps its own, as in JAX. Sets
        each kwargs' `image_obs_keys`.
      * a dataset whose proprio is not `proprio_dim` floats wide (the OXE
        datasets' 8-float states beside a 7-dim model) gets zeros of the
        model's width, JAX's restructure rule for a dataset without state
        keys (JAX's model raises on such a batch).
    Logs once per dataset what it drops; returns, per dataset, whether its
    proprio is zeroed."""
    views = [kw.get("image_obs_keys") or {k: v for k, v in OXE_DATASET_CONFIGS.get(kw["name"], {})
                                          .get("image_obs_keys", {}).items() if v is not None}
             for kw in per_dataset_kwargs]
    common = [k for k in views[0] if all(k in v for v in views[1:])]
    if len(views) > 1 and not common:
        raise ValueError(f"the datasets of the mixture share no camera view: {views}")
    zero = []
    for kw, v in zip(per_dataset_kwargs, views):
        kw["image_obs_keys"] = {k: v[k] for k in common}
        width = len(all_stats[kw["name"]]["proprio"]["q01"])
        zero.append(width != proprio_dim)
        dropped = [k for k in v if k not in common]
        if dropped:
            overwatch.warning(f"data: `{kw['name']}` drops camera views {dropped}, not in every dataset of the mix")
        if zero[-1]:
            overwatch.warning(f"data: `{kw['name']}` has a {width}-float proprio, the model embeds {proprio_dim}: "
                              "its frames carry a zero proprio")
    return zero


def _zero_proprio(traj: Dict, width: int) -> Dict:
    obs = dict(traj["observation"])
    obs["proprio"] = np.zeros((len(obs["proprio"]), width), np.float32)
    return {**traj, "observation": obs}


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
    proprio_dim: int,
    data_shard: Optional[Tuple[int, int]] = None,
) -> Tuple[Dataset, int, Dict]:
    """The mixture's frame stream: (dataset, effective length, per-dataset
    statistics), its frames fitted to a model that embeds a `proprio_dim`
    proprio (`fit_mixture`). With `balance_weights` each raw weight is
    multiplied by the dataset's transition count; the datasets' frames are
    interleaved by those weights, each stage of a dataset in a pool of its
    share of `traj_transform_threads`. The train-time transforms draw from
    `seed` (dataset k's trajectories from seed + k), folded with the data
    rank of `data_shard` (make_dataset_from_rlds's)."""
    data_shard = _data_shard(data_shard)
    per_dataset, raw_weights = _dataset_kwargs_for_mix(
        data_mix, data_dir, load_camera_views=load_camera_views, load_pointcloud=load_pointcloud,
        load_tactile=load_tactile)
    if not per_dataset:
        raise ValueError(f"Mixture `{data_mix}` resolved to zero loadable datasets")

    # pass 1: statistics (cached), and the sizes for the weights
    all_stats: Dict[str, Dict] = {}
    sizes = []
    for kwargs, _ in per_dataset:
        _, stats = make_dataset_from_rlds(**kwargs, train=train, stats_sample_trajectories=stats_sample_trajectories,
                                          stats_cache_dir=stats_cache_dir, data_shard=data_shard)
        all_stats[kwargs["name"]] = stats
        sizes.append(int(stats["num_transitions"]))
    weights, dataset_len = compute_sample_weights(raw_weights, sizes, balance_weights)
    threads_per = T.allocate_threads(traj_transform_threads, np.array(weights))
    zero_proprio = fit_mixture([kwargs for kwargs, _ in per_dataset], all_stats, proprio_dim)

    datasets = []
    for k, ((kwargs, frame_kwargs), zero, n_threads) in enumerate(zip(per_dataset, zero_proprio, threads_per)):
        ds, stats = make_dataset_from_rlds(**kwargs, train=train, dataset_statistics=all_stats[kwargs["name"]],
                                           num_parallel_calls=int(n_threads), data_shard=data_shard)
        if zero:
            ds = ds.map(partial(_zero_proprio, width=proprio_dim), num_parallel_calls=int(n_threads))
        ds = apply_trajectory_transforms(
            ds.repeat() if train else ds, train=train, window_size=window_size,
            future_action_window_size=future_action_window_size, goal_relabeling_strategy=goal_relabeling_strategy,
            task_augment_strategy=task_augment_strategy, task_augment_kwargs=task_augment_kwargs,
            subsample_length=subsample_length, max_action=max_action, max_proprio=max_proprio,
            dataset_statistics=stats, num_parallel_calls=int(n_threads), seed=seed + k, data_rank=data_shard[0],
        )
        datasets.append(apply_per_dataset_frame_transforms(flatten_to_frames(ds), **frame_kwargs))

    ds = datasets[0] if len(datasets) == 1 else Dataset.sample_from_datasets(datasets, weights.tolist(), seed=seed)
    if not train:
        # one buffer of validation data, fixed and cached
        ds = ds.take(shuffle_buffer_size).cache()
    ds = ds.shuffle(shuffle_buffer_size, seed=seed)
    ds = apply_frame_transforms(ds, image_size=image_size, resize_size=resize_size, train=train, augment=augment,
                                image_augment_kwargs=image_augment_kwargs, seed=seed, data_rank=data_shard[0])
    return ds, dataset_len, all_stats


class RLDSDataset:
    """Iterable frame stream over the interleaved pipeline."""

    def __init__(self, data_root_dir: str, data_mix: str, *, train: bool = True, shuffle_buffer_size: int = 10_000,
                 future_action_window_size: int = 15, load_pointcloud: bool = True, load_tactile: bool = False,
                 image_size: int = 672, augment: bool = False, seed: int = 0, balance_weights: bool = True,
                 load_camera_views: Optional[Sequence[str]] = None, proprio_dim: int) -> None:
        self.dataset, self.dataset_length, self.dataset_statistics = make_interleaved_dataset(
            data_mix, data_root_dir, train=train, shuffle_buffer_size=shuffle_buffer_size,
            future_action_window_size=future_action_window_size, load_pointcloud=load_pointcloud,
            load_tactile=load_tactile, image_size=image_size, augment=augment, seed=seed,
            balance_weights=balance_weights, load_camera_views=load_camera_views, proprio_dim=proprio_dim,
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
