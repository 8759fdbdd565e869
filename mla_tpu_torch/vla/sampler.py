"""Length-grouped sampler and LM collator for the map-style VLM data.

Counterpart of mla_tpu/vla/sampler.py, the port's own copy. The VLM
pretraining loop (train.train_vlm) draws its batches through
SplitModalitySampler, which (a) keeps multimodal and language-only
examples in separate batches and (b) groups examples of similar length
to pad less, deterministic per (seed, epoch): it draws from
np.random.default_rng(seed + epoch), so the index order is JAX's exactly.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


class SplitModalitySampler:
    def __init__(
        self,
        modality_lengths: Sequence[tuple],
        global_batch_size: int,
        num_replicas: int = 1,
        rank: int = 0,
        seed: int = 0,
        drop_last: bool = True,
    ) -> None:
        """modality_lengths: per-example (is_multimodal: bool, length: int)
        (the reference reads dataset.modality_lengths)."""
        self.modality_lengths = list(modality_lengths)
        self.global_batch_size = global_batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _grouped_indices(self) -> List[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        mm = [i for i, (m, _) in enumerate(self.modality_lengths) if m]
        uni = [i for i, (m, _) in enumerate(self.modality_lengths) if not m]
        out_batches: List[List[int]] = []
        for group in (mm, uni):
            if not group:
                continue
            group = list(rng.permutation(group))
            g = self.global_batch_size
            # length-group within megabatches of 8*g (reference strategy):
            # sort each megabatch by length so co-batched examples pad less
            for start in range(0, len(group), 8 * g):
                mega = group[start : start + 8 * g]
                mega.sort(key=lambda i: self.modality_lengths[i][1], reverse=True)
                for bstart in range(0, len(mega), g):
                    batch = mega[bstart : bstart + g]
                    if len(batch) == g or not self.drop_last:
                        out_batches.append(batch)
        # __iter__ re-chunks the flat list by fixed stride g, so EVERY batch
        # must be exactly g long: a short drop_last=False remainder shuffled
        # into the middle would misalign every later window (mixing
        # modalities within a "global batch" and handing replicas rows from
        # different logical batches). Pad short batches by cycling their own
        # rows (torch DistributedSampler's drop_last=False convention).
        g = self.global_batch_size
        out_batches = [
            b if len(b) == g else (b * (g // len(b) + 1))[:g] for b in out_batches
        ]
        order = rng.permutation(len(out_batches))
        indices: List[int] = []
        for bi in order:
            indices.extend(out_batches[bi])
        return indices

    def __iter__(self):
        indices = self._grouped_indices()
        # shard contiguously per batch so each replica gets its slice of
        # every global batch
        g = self.global_batch_size
        per = g // self.num_replicas
        for bstart in range(0, len(indices) - g + 1, g):
            batch = indices[bstart : bstart + g]
            yield from batch[self.rank * per : (self.rank + 1) * per]

    def __len__(self) -> int:
        n_batches = len(self._grouped_indices()) // self.global_batch_size
        return n_batches * (self.global_batch_size // self.num_replicas)


class PaddedCollatorForLanguageModeling:
    """LM collator for the VLM pretraining path (util/data_utils.py:30-93):
    pads ids/labels, stacks pixel values, tracks multimodal indices."""

    def __init__(self, max_length: int, pad_token_id: int = 32000) -> None:
        self.max_length = max_length
        self.pad_token_id = pad_token_id

    def __call__(self, instances: Sequence[Dict]) -> Dict:
        B = len(instances)
        L = self.max_length
        ids = np.full((B, L), self.pad_token_id, np.int32)
        labels = np.full((B, L), -100, np.int32)
        attn = np.zeros((B, L), bool)
        mm_indices = []
        pixel_values = []
        for i, inst in enumerate(instances):
            seq = np.asarray(inst["input_ids"])[:L]
            n = len(seq)
            ids[i, :n] = seq
            labels[i, :n] = np.asarray(inst["labels"])[:n]
            attn[i, :n] = True
            if inst.get("pixel_values") is not None:
                mm_indices.append(i)
                pixel_values.append(inst["pixel_values"])
        batch = {
            "input_ids": ids,
            "labels": labels,
            "attention_mask": attn,
            "multimodal_indices": np.asarray(mm_indices, np.int32),
        }
        if pixel_values:
            batch["pixel_values"] = np.stack(pixel_values)
        return batch
