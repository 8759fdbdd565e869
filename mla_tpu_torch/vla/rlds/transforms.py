"""Trajectory and frame transforms, in numpy.

The port's copy of mla_tpu/vla/rlds/transforms.py, which builds TensorFlow
graph ops. A trajectory is a nested dict of numpy arrays with time leading;
strings are object arrays of bytes.

  * binarize_gripper_actions, invert_gripper_actions,
    rel2abs_gripper_actions: the gripper conventions of the OXE transforms,
    TensorFlow's scans as fills.
  * normalize_action_and_proprio, to_padding, tree_merge, add_pad_mask_dict,
    chunk_act_obs: TensorFlow meets a float64 numpy operand (the q01/q99
    bounds, high - low + 1e-8, chunk_act_obs's normalized zero action) by
    converting it to float32 first; so does this copy, and the normalized
    actions and proprio come out bit for bit as JAX's pipeline gives them.
  * decode_and_resize_image: the decode of tf.io.decode_image(channels=3)
    by the stream's signature (frames.py: PNG, JPEG with the fast IDCT
    TensorFlow runs, GIF, BMP, WebP), then TensorFlow's
    tf.image.resize(method="lanczos3") with antialias off, which is
    ScaleAndTranslate: each axis a float32 sum over at most 7 taps of the
    Lanczos-3 kernel (weights normalized to sum 1), the vertical pass first,
    in TensorFlow's tap order, through the host helper; then round half to
    even, clip to 0..255 and cast to uint8. An empty string gives zeros.
  * goal_relabel_uniform, delete_task_conditioning, subsample: JAX's
    trajectory rules; their draws come from a seeded numpy generator
    (JAX's come from TensorFlow's stateful RNG, which nothing replays), or
    are injected.
  * augment_image: the train-time frame augmentation, TensorFlow's
    stateless ops bit for bit: the Philox-4x32-10 stream of
    StatelessRandomGetKeyCounter, crop_and_resize, AdjustContrastv2,
    AdjustSaturation, AdjustHue, the flip and convert_image_dtype.
  * compute_dataset_statistics, cached_dataset_statistics,
    get_dataset_statistics (full pass, a JSON cache keyed by a hash of the
    builder info, split, state keys and transform source), allocate_threads.
"""

from __future__ import annotations

import functools
import hashlib
import json
import math
import os
from enum import Enum
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mla_tpu_torch.native import rlds_host
from mla_tpu_torch.vla.rlds import frames


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


def binarize_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """A continuous [0, 1] gripper -> 0/1 (float32): above 0.95 open, below
    0.05 closed, and a value in between takes the next decided one (the
    last step's own value where none follows): TensorFlow's reverse scan,
    as a fill from the right."""
    a = np.asarray(actions)
    is_open = (a > 0.95).astype(np.float32)
    decided = (a > 0.95) | (a < 0.05)
    n = len(a)
    nxt = np.minimum.accumulate(np.where(decided, np.arange(n), n)[::-1])[::-1]
    return np.where(nxt < n, is_open[np.minimum(nxt, n - 1)], a[-1]).astype(np.float32)


def invert_gripper_actions(actions: np.ndarray) -> np.ndarray:
    return 1 - np.asarray(actions)


def rel2abs_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """A relative gripper (+1 close, -1 open, 0 hold) -> absolute (0 closed,
    1 open) float32: each step holds the last nonzero command, and before
    the first the opposite of the first (open where there is none):
    TensorFlow's forward scan, as a fill from the left."""
    a = np.asarray(actions)
    thresholded = np.where(a < -0.1, 1, np.where(a > 0.1, -1, 0)).astype(np.int32)
    nonzero = thresholded != 0
    start = -thresholded[int(np.argmax(nonzero))]
    start = 1 if start == 0 else start
    last = np.maximum.accumulate(np.where(nonzero, np.arange(len(a)), -1))
    held = np.where(last >= 0, thresholded[np.maximum(last, 0)], start)
    return held.astype(np.float32) / 2 + 0.5


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


def decode_image(data) -> np.ndarray:
    """Encoded bytes -> uint8 [H, W, 3], as tf.io.decode_image(data,
    channels=3, expand_animations=False) decodes PNG, JPEG, GIF, BMP and
    WebP (`frames.decode`); JPEG XL and unknown formats raise."""
    return frames.decode(data, "tf")


def decode_and_resize_image(image, size=672) -> np.ndarray:
    """Encoded bytes (or a uint8 [H, W, 3] array) -> uint8 [h, w, 3]; an
    empty string, a padded view, decodes to zeros."""
    if isinstance(size, int):
        size = (size, size)
    if isinstance(image, (bytes, bytearray, memoryview)):
        if len(image) == 0:
            return np.zeros((*size, 3), np.uint8)
        image = decode_image(image)
    out = resize_lanczos3(image, size)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------- #
# train-time trajectory transforms: goal relabelling, task augmentation,
# subsampling
# --------------------------------------------------------------------------- #


def _rng(rng) -> np.random.Generator:
    return rng if isinstance(rng, np.random.Generator) else np.random.default_rng(rng)


def goal_relabel_uniform(traj: Dict, rng=None, goal_idxs: Optional[np.ndarray] = None) -> Dict:
    """Mirror each observation key into `task` at a goal index drawn
    uniformly from the strict future (the last frame keeps itself), JAX's
    rule: floor(u * (T - (t + 1)) + t + 1) in float32, capped at T - 1.
    The draw u comes from `rng` (JAX draws from TensorFlow's stateful RNG,
    which no other program can replay); `goal_idxs` replaces the draw."""
    traj_len = len(traj["action"])
    if goal_idxs is None:
        u = _rng(rng).random(traj_len, dtype=np.float32)
        low = np.arange(1, traj_len + 1, dtype=np.float32)
        goal_idxs = (u * (np.float32(traj_len) - low) + low).astype(np.int32)
    goal_idxs = np.minimum(np.asarray(goal_idxs, np.int32), traj_len - 1)
    goal = tree_map(lambda x: np.asarray(x)[goal_idxs], traj["observation"])
    traj["task"] = tree_merge(traj["task"], goal)
    return traj


def delete_task_conditioning(traj: Dict, keep_image_prob: float, rng=None,
                             keep_images: Optional[np.ndarray] = None) -> Dict:
    """Per frame keep either the goal images (with probability
    keep_image_prob; always where the frame has no instruction) or the
    language instruction, and pad the other out (its pad mask cleared); a
    frame without goal images takes the last frame as its goal timestep.
    `keep_images` [T] bool replaces the draw."""
    task = traj["task"]
    if "language_instruction" not in task:
        return traj
    image_keys = {k for k in task if k.startswith("image_") or k.startswith("depth_")}
    if not image_keys:
        return traj
    traj_len = len(traj["action"])
    if keep_images is None:
        keep_images = _rng(rng).random(traj_len, dtype=np.float32) < keep_image_prob
    keep_images = np.asarray(keep_images, bool) | ~np.asarray(task["pad_mask_dict"]["language_instruction"], bool)

    def where(keep, a):
        a = np.asarray(a)
        k = keep.reshape((-1,) + (1,) * (a.ndim - 1))
        return np.where(k, a, to_padding(a))

    for key in sorted(image_keys | {"language_instruction"}):
        keep = keep_images if key in image_keys else ~keep_images
        task[key] = where(keep, task[key])
        task["pad_mask_dict"][key] = where(keep, task["pad_mask_dict"][key])
    if "timestep" in task:
        task["timestep"] = np.where(keep_images, np.asarray(task["timestep"]), traj_len - 1).astype(
            np.asarray(task["timestep"]).dtype)
    return traj


def subsample(traj: Dict, subsample_length: Optional[int], rng=None, indices: Optional[np.ndarray] = None) -> Dict:
    """A sorted random subset of subsample_length frames when the trajectory
    is longer, else every frame. `indices` replaces the draw."""
    if subsample_length is None:
        return traj
    traj_len = len(traj["action"])
    if indices is None:
        indices = (np.sort(_rng(rng).permutation(traj_len)[:subsample_length]) if traj_len > subsample_length
                   else np.arange(traj_len))
    indices = np.asarray(indices)
    return tree_map(lambda x: np.asarray(x)[indices], traj)


# --------------------------------------------------------------------------- #
# train-time image augmentation: TensorFlow's stateless ops, bit for bit
# --------------------------------------------------------------------------- #

# Philox-4x32-10 (Salmon et al. 2011), as tensorflow/core/lib/random/philox_random.h
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _philox(ctr: Sequence[int], key: Sequence[int]) -> Tuple[int, int, int, int]:
    c, k = list(ctr), list(key)
    for r in range(10):
        p0, p1 = _PHILOX_M[0] * c[0], _PHILOX_M[1] * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k[0]) & _U32, p1 & _U32, ((p0 >> 32) ^ c[3] ^ k[1]) & _U32, p0 & _U32]
        if r < 9:
            k = [(k[0] + _PHILOX_W[0]) & _U32, (k[1] + _PHILOX_W[1]) & _U32]
    return tuple(c)


def _key_counter(seed) -> Tuple[List[int], List[int]]:
    """StatelessRandomGetKeyCounter of an int32 [2] seed: the seed (each
    sign-extended to 64 bits) as the counter, one Philox round under a fixed
    key, whose output gives the key and the high half of the counter."""
    s0, s1 = (int(v) & 0xFFFFFFFFFFFFFFFF for v in np.asarray(seed, np.int64).reshape(2))
    mix = _philox([s0 & _U32, s0 >> 32, s1 & _U32, s1 >> 32], [0x3EC8F720, 0x02461E29])
    return [mix[0], mix[1]], [0, 0, mix[2], mix[3]]


def stateless_random_bits(seed, n: int) -> np.ndarray:
    """The first n uint32 of TensorFlow's stateless Philox stream for seed:
    four a counter, the 128-bit counter counting up."""
    key, ctr = _key_counter(seed)
    out: List[int] = []
    while len(out) < n:
        out.extend(_philox(ctr, key))
        for j in range(4):
            ctr[j] = (ctr[j] + 1) & _U32
            if ctr[j]:
                break
    return np.array(out[:n], np.uint32)


def stateless_uniform(shape, seed, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """tf.random.stateless_uniform(shape, seed, minval, maxval) in float32:
    each uint32's 23 low bits as a mantissa in [1, 2), minus 1, times
    (maxval - minval), plus minval."""
    shape = tuple(np.atleast_1d(shape)) if np.ndim(shape) else ()
    bits = stateless_random_bits(seed, int(np.prod(shape, dtype=np.int64)))
    u = ((bits & np.uint32(0x7FFFFF)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return (u * (hi - lo) + lo).reshape(shape)


def _f(x) -> np.float32:
    return np.float32(x)


@functools.lru_cache(maxsize=1)
def _libm_expf():
    import ctypes
    import ctypes.util

    try:
        fn = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").expf
    except (OSError, AttributeError):
        return None
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


def _expf(x) -> np.float32:
    """exp of one float32 as TensorFlow computes a scalar's: the C library's
    expf (numpy's vectorized exp may differ by an ulp)."""
    fn = _libm_expf()
    return np.float32(fn(float(x))) if fn is not None else np.float32(math.exp(float(x)))


def crop_and_resize(image: np.ndarray, box: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """tf.image.crop_and_resize of one float32 [H, W, C] image by one box
    (y1, x1, y2, x2 in [0, 1]) to `size`, bilinear, zeros outside: the CPU
    kernel's float32 arithmetic term for term."""
    H, W = image.shape[:2]
    ch, cw = size
    y1, x1, y2, x2 = (np.float32(v) for v in box)

    def coords(a, b, n_in, n_out):
        if n_out > 1:
            scale = (b - a) * _f(n_in - 1) / _f(n_out - 1)
            return a * _f(n_in - 1) + np.arange(n_out).astype(np.float32) * scale
        return np.full([1], _f(0.5) * (a + b) * _f(n_in - 1), np.float32)

    ys, xs = coords(y1, y2, H, ch), coords(x1, x2, W, cw)
    y_in, x_in = (ys >= 0) & (ys <= _f(H - 1)), (xs >= 0) & (xs <= _f(W - 1))
    yc, xc = np.clip(ys, 0, H - 1), np.clip(xs, 0, W - 1)
    top, bot = np.floor(yc).astype(np.int64), np.ceil(yc).astype(np.int64)
    left, right = np.floor(xc).astype(np.int64), np.ceil(xc).astype(np.int64)
    y_lerp = (ys - top.astype(np.float32))[:, None, None]
    x_lerp = (xs - left.astype(np.float32))[None, :, None]
    img = image.astype(np.float32)
    rows_t, rows_b = img[top], img[bot]
    t = rows_t[:, left] + (rows_t[:, right] - rows_t[:, left]) * x_lerp
    b = rows_b[:, left] + (rows_b[:, right] - rows_b[:, left]) * x_lerp
    out = t + (b - t) * y_lerp
    return np.where((y_in[:, None] & x_in[None, :])[..., None], out, np.float32(0)).astype(np.float32)


def adjust_contrast(image: np.ndarray, factor) -> np.ndarray:
    """AdjustContrastv2 (float): mean + factor * (x - mean) per channel, the
    mean the kernel's sum by folding the image in halves, times 1 / (H * W)."""
    H, W, C = image.shape
    n = H * W
    x = image.reshape(n, C).astype(np.float32)
    s = np.empty_like(x)
    remaining, first = n, True
    while True:
        right = remaining // 2
        left = remaining - right
        if first:
            s[:right] = x[left : left + right] + x[:right]
            if left > right:
                s[right] = x[right]
            first = False
        else:
            s[:right] += s[left : left + right]
        remaining = left
        if remaining <= 1:
            break
    mean = s[0] * (_f(1.0) / _f(n))
    return (mean + _f(factor) * (x - mean)).reshape(H, W, C)


def _rgb_to_hsv(r, g, b):
    """AdjustSaturation's rgb_to_hsv (float, the 2/6 and 4/6 offsets added
    in double)."""
    v = np.maximum(r, np.maximum(g, b))
    rng = v - np.minimum(r, np.minimum(g, b))
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(v > 0, rng / v, _f(0))
        norm = _f(1.0) / (_f(6.0) * rng)
        h = np.where(r == v, norm * (g - b),
                     np.where(g == v, ((norm * (b - r)).astype(np.float64) + 2.0 / 6.0).astype(np.float32),
                              ((norm * (r - g)).astype(np.float64) + 4.0 / 6.0).astype(np.float32)))
    h = np.where(rng <= 0, _f(0), h)
    h = np.where(h < 0, h + _f(1), h)
    return h.astype(np.float32), s.astype(np.float32), v


def _hsv_to_rgb(h, s, v):
    c = s * v
    m = v - c
    dh = h * _f(6)
    cat = dh.astype(np.int32)
    fm = dh
    for _ in range(4):  # h in [0, 1]: a few steps bring dh into (0, 2)
        fm = np.where(fm <= 0, fm + _f(2), fm)
    for _ in range(4):
        fm = np.where(fm >= _f(2), fm - _f(2), fm)
    x = c * (_f(1) - np.abs(fm - _f(1)))
    z = np.zeros_like(c)
    sel = [cat == k for k in range(6)]
    r = np.select(sel, [c, x, z, z, x, c], z)
    g = np.select(sel, [x, c, c, x, z, z], z)
    b = np.select(sel, [z, z, x, c, c, x], z)
    return r + m, g + m, b + m


def adjust_saturation(image: np.ndarray, factor) -> np.ndarray:
    """AdjustSaturation (float): s * factor clamped to [0, 1] in HSV."""
    r, g, b = (image[..., i].astype(np.float32) for i in range(3))
    h, s, v = _rgb_to_hsv(r, g, b)
    s = np.minimum(_f(1), np.maximum(_f(0), s * _f(factor)))
    return np.stack(_hsv_to_rgb(h, s, v), -1).astype(np.float32)


def adjust_hue(image: np.ndarray, delta) -> np.ndarray:
    """AdjustHue (float): the kernel's hue in [0, 6) from the sorted channels
    (rgb_to_hv_range), shifted by 6 * delta and wrapped, and back."""
    r, g, b = (image[..., i].astype(np.float32) for i in range(3))
    rg = r < g
    conds = [rg & (b < r), rg & ~(b < r) & (b > g), rg & ~(b < r) & ~(b > g),
             ~rg & (b < g), ~rg & ~(b < g) & (b > r), ~rg & ~(b < g) & ~(b > r)]
    vmax = np.select(conds, [g, b, g, r, b, r])
    vmid = np.select(conds, [r, g, b, g, r, b])
    vmin = np.select(conds, [b, r, r, b, g, g])
    cat = np.select(conds, [1, 3, 2, 0, 4, 5])
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = (vmid - vmin) / (vmax - vmin)
    h = np.where((cat & 1) == 0, cat.astype(np.float32) + ratio, cat.astype(np.float32) + (_f(1) - ratio))
    h = np.where(vmax == vmin, _f(0), h).astype(np.float32)
    h = h + _f(delta) * _f(6)
    for _ in range(2):
        h = np.where(h < 0, h + _f(6), h)
    for _ in range(2):
        h = np.where(h >= _f(6), h - _f(6), h)
    hc = h.astype(np.int32)
    ratio = h - hc.astype(np.float32)
    ratio = np.where((hc & 1) == 0, ratio, _f(1) - ratio)
    vmid = vmin + ratio * (vmax - vmin)
    sel = [hc == k for k in range(5)]
    out_r = np.select(sel, [vmax, vmid, vmin, vmin, vmid], vmax)
    out_g = np.select(sel, [vmid, vmax, vmax, vmid, vmin], vmin)
    out_b = np.select(sel, [vmin, vmin, vmid, vmax, vmax], vmid)
    return np.stack([out_r, out_g, out_b], -1).astype(np.float32)


def random_resized_crop(image: np.ndarray, scale, ratio, seed) -> np.ndarray:
    """JAX's _random_resized_crop: the area scale and log aspect ratio drawn
    with seeds seed and seed + 1, the offsets with seed + 2 and seed + 3,
    the box in [0, 1] coordinates, crop_and_resize back to the input size,
    clipped to [0, 255] (TensorFlow's graph ops, in its float32 order)."""
    seed = np.asarray(seed, np.int32)
    H, W = image.shape[:2]
    height, width = _f(H), _f(W)
    s = stateless_uniform([], seed, scale[0], scale[1])
    log_r = stateless_uniform([], seed + np.int32(1), math.log(ratio[0]), math.log(ratio[1]))
    r = _expf(log_r)
    crop_h = np.sqrt(s * height * width / r).astype(np.float32)
    crop_w = crop_h * r
    crop_h, crop_w = np.minimum(crop_h, height), np.minimum(crop_w, width)
    off_y = stateless_uniform([], seed + np.int32(2), 0.0, height - crop_h + _f(1e-6))
    off_x = stateless_uniform([], seed + np.int32(3), 0.0, width - crop_w + _f(1e-6))
    box = np.array([off_y / (height - _f(1)), off_x / (width - _f(1)),
                    (off_y + crop_h - _f(1)) / (height - _f(1)), (off_x + crop_w - _f(1)) / (width - _f(1))],
                   np.float32)
    return np.clip(crop_and_resize(image, box, (H, W)), 0, 255)


def augment_image(image: np.ndarray, seed, **augment_kwargs) -> np.ndarray:
    """JAX's augment_image on one [H, W, 3] frame (uint8, or float in [0,
    1]): in `augment_order`, op i seeded seed + 7 * i, TensorFlow's
    stateless random_resized_crop / brightness / contrast / saturation /
    hue / flip (the draws by stateless_uniform), then clipped to [0, 1]; a
    uint8 frame is divided by 255 first and converted back as
    convert_image_dtype(saturate=True) does: trunc(clip(x * 255.5, 0,
    255)). The same pixels as JAX's for the same frame and seed."""
    if not augment_kwargs:
        augment_kwargs = {"random_brightness": [0.1], "random_contrast": [0.9, 1.1],
                          "augment_order": ["random_brightness", "random_contrast"]}
    order = augment_kwargs.get("augment_order", list(augment_kwargs))
    is_u8 = np.asarray(image).dtype == np.uint8
    img = np.asarray(image).astype(np.float32)
    if is_u8:
        img = img / _f(255.0)
    seed = np.asarray(seed, np.int32)
    for i, op in enumerate(order):
        if op not in augment_kwargs:
            continue
        args = augment_kwargs[op]
        op_seed = seed + np.int32(7 * i)
        if op == "random_resized_crop":
            img = random_resized_crop(img, args["scale"], args["ratio"], op_seed)
        elif op == "random_brightness":
            img = img + stateless_uniform([], op_seed, -args[0], args[0])
        elif op == "random_contrast":
            img = adjust_contrast(img, stateless_uniform([], op_seed, args[0], args[1]))
        elif op == "random_saturation":
            img = adjust_saturation(img, stateless_uniform([], op_seed, args[0], args[1]))
        elif op == "random_hue":
            img = adjust_hue(img, stateless_uniform([], op_seed, -args[0], args[0]))
        elif op == "random_flip":
            if stateless_uniform([], op_seed, 0.0, 1.0) < _f(0.5):
                img = img[:, ::-1]
        else:
            raise ValueError(f"Unknown augmentation op: {op}")
    img = np.clip(img, 0, 1).astype(np.float32)
    if is_u8:
        return np.trunc(np.clip(img * _f(255.5), 0, 255)).astype(np.uint8)
    return img.astype(np.asarray(image).dtype)


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
    """A JSON cache keyed by a sha256 over the dependency strings. The file
    is written whole and renamed into place, so the ranks of a distributed
    run may share one cache directory."""
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha256("".join(hash_dependencies).encode("utf-8")).hexdigest()[:32]
    path = cache_dir / f"dataset_statistics_{h}.json"
    if path.exists():
        return json.loads(path.read_text())
    stats = compute_fn()
    tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}")
    tmp.write_text(json.dumps(stats))
    os.replace(tmp, path)
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
