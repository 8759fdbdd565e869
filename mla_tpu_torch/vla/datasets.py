"""The frame -> model-batch transform and the fixed-shape collator.

Counterpart of mla_tpu/vla/datasets.py:
  * resize_center_crop: shortest-side bicubic resize and center crop. The
    JAX package calls Pillow's Image.resize(BICUBIC); the port needs no
    imaging package, so this is a numpy copy of Pillow's 8-bit resampler
    (libImaging/Resample.c), pixel for pixel. Each axis that changes size is
    a separable pass, horizontal first: the bicubic kernel (a = -0.5)
    widened by the scale when shrinking, its taps normalized in float64 and
    rounded to 22-bit fixed point, each output the rounded integer sum of
    its taps, clamped to 0..255, so the vertical pass reads the horizontal
    pass's uint8 image, as Pillow's does. An axis of the same size is left
    as it is, as Pillow returns a copy.
  * clip_preprocess and add_mask_channel: CLIP normalization to float CHW
    and the all-ones mask channel.
  * RLDSBatchTransform: CLIP images with the mask channel, tactile's 65535
    sentinel zeroed and divided by 100, the prompt "What action should the
    robot take to {lang}?" with "<BOD><EOD>{action tokens}" when an action
    tokenizer is given, labels masked to the last action_dim + 1 tokens (or
    to the EOS alone). A pure function of its frame: `_fix_num_points`
    draws from its own default_rng(0), so frames can be transformed in any
    thread.
  * PaddedCollatorForActionPrediction: input ids padded to a fixed
    max_prompt_len (a longer prompt raises) and `splice_idx`, the last tag
    token's position, computed on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from mla_tpu_torch.vla.action_tokenizer import ActionTokenizer
from mla_tpu_torch.vla.tokenizer import EMPTY_ID, EOS_ID, PAD_ID

IGNORE_INDEX = -100
# CLIP normalization constants (CLIPImageProcessor's defaults)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit images
_SUPPORT = 2.0  # the bicubic kernel's half-width


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic_filter (a = -0.5), in its evaluation order."""
    x = np.abs(x)
    near = ((-0.5 + 2.0) * x - (-0.5 + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for the box [0,
    in_size): (first tap index [out], fixed-point taps [out, ksize], zero
    past each output's tap count)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero; the clamp at 0 follows
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)[None, :]
    live = taps < xmax[:, None]
    w = np.where(live, _bicubic(((taps + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale)), 0.0)
    total = np.zeros(out_size)
    for x in range(ksize):  # summed tap by tap, in Pillow's order
        total = total + w[:, x]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    one = float(1 << _PRECISION_BITS)
    k = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one)).astype(np.int64)
    return xmin, k


def _resample_axis(img: np.ndarray, out_size: int, axis: int, lo: int = 0, hi: int = None) -> np.ndarray:
    """One 8-bit pass of Pillow's resampler along `axis` of a uint8 image,
    outputs lo..hi of out_size only (each output is its own sum, so a crop
    can skip the rest). int32 sums, as Pillow's."""
    xmin, k = _coeffs(img.shape[axis], out_size)
    xmin, k = xmin[lo:hi], k[lo:hi].astype(np.int32)
    src = np.moveaxis(img, axis, 0).astype(np.int32)
    acc = np.full((len(xmin),) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int32)
    kshape = (len(xmin),) + (1,) * (src.ndim - 1)
    for tap in range(k.shape[1]):  # a tap past an output's count has weight 0
        acc += src[np.minimum(xmin + tap, src.shape[0] - 1)] * k[:, tap].reshape(kshape)
    return np.moveaxis(np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8), 0, axis)


def resize_bicubic(image: np.ndarray, width: int, height: int, crop: Tuple[int, int, int, int] = None) -> np.ndarray:
    """uint8 HWC -> uint8 [height, width, C], as Pillow's
    Image.resize((width, height), BICUBIC) gives it; with crop (left, top,
    right, bottom), that window of the result only."""
    left, top, right, bottom = crop or (0, 0, width, height)
    out = np.asarray(image, np.uint8)
    if width != out.shape[1]:
        out = _resample_axis(out, width, 1, left, right)
    else:
        out = out[:, left:right]
    if height != out.shape[0]:
        out = _resample_axis(out, height, 0, top, bottom)
    else:
        out = out[top:bottom]
    return out


def resize_center_crop(image: np.ndarray, size: int) -> np.ndarray:
    """uint8 HWC -> uint8 [size, size, C]: shortest-side bicubic scale, then
    a center crop to `size` (the geometric half of CLIPImageProcessor), the
    arithmetic of the training transform, so the serving host sees what the
    model was trained on."""
    h, w = image.shape[:2]
    scale = size / min(w, h)
    w2, h2 = round(w * scale), round(h * scale)
    left, top = (w2 - size) // 2, (h2 - size) // 2
    return resize_bicubic(image, w2, h2, (left, top, left + size, top + size))


def clip_preprocess(image: np.ndarray, size: int = 672) -> np.ndarray:
    """uint8 HWC -> float32 CHW: resized shortest side first and center
    cropped to `size`, then CLIP-normalized."""
    if image.dtype != np.uint8:
        image = np.clip(image, 0, 255).astype(np.uint8)
    arr = resize_center_crop(image, size).astype(np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return arr.transpose(2, 0, 1)


def add_mask_channel(chw: np.ndarray) -> np.ndarray:
    """Append the all-ones mask channel."""
    mask = np.ones((1,) + chw.shape[1:], np.float32)
    return np.concatenate([chw, mask], axis=0)


@dataclass
class RLDSBatchTransform:
    action_tokenizer: Optional[ActionTokenizer]
    base_tokenizer: Any  # HF-style tokenizer: (text) -> {"input_ids": [...]}
    image_size: int = 672
    predict_stop_token: bool = True
    use_pointcloud: bool = False
    use_tactile: bool = False
    num_points: int = 1024

    def __call__(self, rlds_batch: Dict[str, Any]) -> Dict[str, Any]:
        obs = rlds_batch["observation"]
        action = np.asarray(rlds_batch["action"], np.float32)
        proprio = np.asarray(obs["proprio"], np.float32)

        out: Dict[str, Any] = {}
        images: Dict[str, np.ndarray] = {}
        images["front_image"] = add_mask_channel(clip_preprocess(np.asarray(obs["image_primary"][0]), self.image_size))
        if "image_next_primary" in obs:
            out["next_images"] = clip_preprocess(np.asarray(obs["image_next_primary"][0]), self.image_size)
        for key, name in (("image_wrist_right", "wrist_right_image"), ("image_wrist_left", "wrist_left_image")):
            if key in obs:
                images[name] = add_mask_channel(clip_preprocess(np.asarray(obs[key][0]), self.image_size))
        out["images"] = images

        if self.use_tactile:
            def clean(x):
                x = np.asarray(x, np.float32)
                return np.where(x == 65535, 0.0, x) / 100.0

            out["tactile"] = np.concatenate([clean(obs["tactile_right"][0]), clean(obs["tactile_left"][0])])
            if "next_tactile_right" in obs:
                out["next_tactile"] = np.concatenate(
                    [clean(obs["next_tactile_right"][0]), clean(obs["next_tactile_left"][0])])
            out["gripper_xyz"] = np.asarray(obs["gripper_xyz"][0], np.float32)

        if self.use_pointcloud:
            out["point_cloud"] = _fix_num_points(np.asarray(obs["point_cloud"][0], np.float32), self.num_points)
            if "next_point_cloud" in obs:
                out["next_point_cloud"] = _fix_num_points(np.asarray(obs["next_point_cloud"][0], np.float32),
                                                          self.num_points)

        lang = rlds_batch["task"]["language_instruction"]
        if isinstance(lang, bytes):
            lang = lang.decode()
        lang = str(lang).lower()

        if self.action_tokenizer is None:
            gpt_value = ""
        else:
            gpt_value = "<BOD><EOD>" + "".join(self.action_tokenizer(a) for a in action)
        prompt = f"In: What action should the robot take to {lang}?\nOut: {gpt_value}".rstrip()
        input_ids = list(self.base_tokenizer(prompt, add_special_tokens=True)["input_ids"]) + [EOS_ID]
        input_ids = np.asarray(input_ids, np.int32)
        labels = input_ids.copy()
        if self.action_tokenizer is None:
            labels[:-1] = IGNORE_INDEX
        else:
            labels[: -(action.shape[-1] + 1)] = IGNORE_INDEX
        if not self.predict_stop_token:
            labels[-1] = IGNORE_INDEX

        out.update(
            input_ids=input_ids,
            labels=labels,
            actions=action,
            proprio=proprio.reshape(1, -1) if proprio.ndim == 1 else proprio[:1],
            dataset_name=rlds_batch.get("dataset_name", "unknown"),
        )
        return out


def _fix_num_points(pc: np.ndarray, n: int) -> np.ndarray:
    """Exactly n points: a subsample without replacement drawn by
    default_rng(0), or the cloud repeated."""
    m = pc.shape[0]
    if m == n:
        return pc
    if m > n:
        return pc[np.random.default_rng(0).choice(m, n, replace=False)]
    reps = int(np.ceil(n / max(m, 1)))
    return np.tile(pc, (reps, 1))[:n]


@dataclass
class PaddedCollatorForActionPrediction:
    """Stack transformed frames into a fixed-shape batch."""

    max_prompt_len: int = 192
    pad_token_id: int = PAD_ID
    training: bool = True

    def __call__(self, instances: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        B, L = len(instances), self.max_prompt_len
        ids = np.full((B, L), self.pad_token_id, np.int32)
        labels = np.full((B, L), IGNORE_INDEX, np.int32)
        attn = np.zeros((B, L), bool)
        splice = np.zeros((B,), np.int32)
        for i, inst in enumerate(instances):
            seq = inst["input_ids"]
            n = len(seq)
            if n > L:
                # truncating would drop the supervised action tokens and the
                # EOS splice anchor
                raise ValueError(
                    f"prompt of {n} tokens exceeds max_prompt_len={L}; raise "
                    "PaddedCollatorForActionPrediction.max_prompt_len (and the serving graph's prompt bucket) "
                    "or shorten the instruction")
            ids[i, :n] = seq
            labels[i, :n] = inst["labels"][:n]
            attn[i, :n] = True
            tag_pos = np.nonzero(seq == (EOS_ID if self.training else EMPTY_ID))[0]
            splice[i] = tag_pos[-1] if len(tag_pos) else n - 1

        batch: Dict[str, Any] = {
            "input_ids": ids,
            "labels": labels,
            "attention_mask": attn,
            "splice_idx": splice,
            "images": {key: np.stack([i["images"][key] for i in instances]) for key in instances[0]["images"]},
            "actions": np.stack([i["actions"] for i in instances]),
            "proprio": np.stack([i["proprio"] for i in instances]),
        }
        for key in ("point_cloud", "next_point_cloud", "tactile", "next_tactile", "gripper_xyz", "next_images"):
            if key in instances[0]:
                batch[key] = np.stack([i[key] for i in instances])
        return batch
