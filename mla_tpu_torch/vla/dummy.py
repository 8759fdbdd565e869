"""Synthetic training batches with the training token layout.

Counterpart of mla_tpu/vla/dummy.py (`synthetic_batch`, `DummyDataset`),
with its own copy of the special token ids, for smoke-testing training
without data. The same arguments give the same arrays as the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np

# special token ids of the Llama-2 + MLA vocabulary
BOS_ID = 1
EOS_ID = 2
EMPTY_ID = 29871
PAD_ID = 32000
BOD_ID = 32001
EOD_ID = 32002


def synthetic_batch(cfg, B: int = 2, L: int = 16, seed: int = 0, training: bool = True) -> Dict[str, Any]:
    """Random batch with the training token layout:
    [BOS, prompt..., 29871, BOD, EOD, action ids x action_dim, EOS, pad..].

    `splice_idx` follows the reference's tag convention: training splices at
    the last EOS, inference at the last 29871. With cfg.use_generation the
    batch also holds the enabled heads' targets: next_images, next_point_cloud
    and next_tactile."""
    rng = np.random.default_rng(seed)
    ad = cfg.action_dim
    if L < ad + 7:
        raise ValueError(f"L={L} too short for the action span")
    ids = np.full((B, L), PAD_ID, dtype=np.int32)
    n_real = L - 2
    for b in range(B):
        ids[b, 0] = BOS_ID
        ids[b, 1 : n_real - ad - 3] = rng.integers(100, 20000, n_real - ad - 4)
        ids[b, n_real - ad - 3] = EMPTY_ID
        ids[b, n_real - ad - 2] = BOD_ID
        ids[b, n_real - ad - 1] = EOD_ID
        ids[b, n_real - ad : n_real] = rng.integers(31744, 32000, ad)
        ids[b, n_real] = EOS_ID
    attn = ids != PAD_ID
    labels = np.where(attn, ids, -100).astype(np.int32)
    labels[:, : n_real - ad] = -100
    splice = np.full((B,), n_real if training else n_real - ad - 3, dtype=np.int32)

    img = rng.normal(size=(B, 3, cfg.vision.image_size, cfg.vision.image_size)).astype(np.float32)
    mask = np.ones((B, 1, cfg.vision.image_size, cfg.vision.image_size), np.float32)
    batch: Dict[str, Any] = {
        "input_ids": ids,
        "attention_mask": attn,
        "labels": labels,
        "splice_idx": splice,
        "images": {"front_image": np.concatenate([img, mask], axis=1)},
        "proprio": rng.normal(size=(B, 1, ad)).astype(np.float32),
        "actions": rng.uniform(-1, 1, size=(B, cfg.action_horizon, ad)).astype(np.float32),
    }
    if cfg.use_pointcloud:
        batch["point_cloud"] = rng.uniform(
            [-0.3, -0.45, 0.75], [0.7, 0.45, 1.6], size=(B, cfg.point.input_points, 3)
        ).astype(np.float32)
    if cfg.use_tactile:
        batch["tactile"] = rng.normal(size=(B, cfg.tactile_dim * cfg.n_arms)).astype(np.float32)
        batch["gripper_xyz"] = rng.uniform(
            [0.0, -0.2, 0.9], [0.4, 0.2, 1.3], size=(B, 3 * cfg.n_arms)
        ).astype(np.float32)
    if cfg.use_generation:
        if cfg.gen.use_image:
            batch["next_images"] = rng.normal(
                size=(B, 3, cfg.vision.image_size, cfg.vision.image_size)
            ).astype(np.float32)
        if cfg.gen.use_pointcloud:
            batch["next_point_cloud"] = rng.normal(size=(B, cfg.point.input_points, 3)).astype(np.float32)
        if cfg.gen.use_tactile:
            batch["next_tactile"] = rng.normal(size=(B, cfg.tactile_dim)).astype(np.float32)
    return batch


def add_extra_views(batch: Dict[str, Any], cfg, seed: int = 1) -> Dict[str, Any]:
    """`batch` with cfg.num_extra_views seeded camera views beside the front
    frame ('wrist_image', then 'wrist_image_1', ...), each a normal [B, 3,
    S, S] frame with the all-ones mask channel."""
    front = batch["images"]["front_image"]
    B, S = front.shape[0], front.shape[-1]
    rng = np.random.default_rng(seed)
    views = dict(batch["images"])
    for i in range(cfg.num_extra_views):
        img = rng.normal(size=(B, 3, S, S)).astype(np.float32)
        views["wrist_image" if i == 0 else f"wrist_image_{i}"] = np.concatenate(
            [img, np.ones((B, 1, S, S), np.float32)], axis=1)
    return {**batch, "images": views}


class DummyDataset:
    """Iterable of synthetic batches (the JAX package's DummyDataset): batch
    i is synthetic_batch(cfg, batch_size, seq_len, seed=seed + i)."""

    def __init__(self, cfg, batch_size: int = 8, seq_len: int = 16, seed: int = 0) -> None:
        self.cfg, self.batch_size, self.seq_len, self.seed = cfg, batch_size, seq_len, seed

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        i = 0
        while True:
            yield synthetic_batch(self.cfg, self.batch_size, self.seq_len, seed=self.seed + i)
            i += 1
