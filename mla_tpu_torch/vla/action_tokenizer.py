"""Continuous-action <-> discrete-token codec.

The port's own copy of mla_tpu/vla/action_tokenizer.py (the port imports
nothing of the JAX package): 256 uniform bins on [-1, 1] mapped onto the
last 256 ids of the base vocabulary, token_id = vocab_size -
digitize(action); decoding maps back through the bin centers with the
reference's off-by-one clip. Pure numpy: it runs on the host, at the edges
of a request.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np


class ActionTokenizer:
    def __init__(
        self, tokenizer=None, bins: int = 256, min_action: float = -1.0, max_action: float = 1.0,
        vocab_size: Optional[int] = None,
    ) -> None:
        """`tokenizer` is any HF-style tokenizer (used only to decode to text);
        pass `vocab_size` to run without one."""
        self.tokenizer = tokenizer
        self.n_bins = bins
        self.min_action, self.max_action = min_action, max_action
        if vocab_size is None:
            if tokenizer is None:
                raise ValueError("need `tokenizer` or explicit `vocab_size`")
            vocab_size = int(tokenizer.vocab_size)
        self._vocab_size = vocab_size
        self.bins = np.linspace(min_action, max_action, self.n_bins)
        self.bin_centers = (self.bins[:-1] + self.bins[1:]) / 2.0
        self.action_token_begin_idx: int = int(self._vocab_size - (self.n_bins + 1))

    def encode_to_ids(self, action: np.ndarray) -> np.ndarray:
        """Continuous action -> token ids."""
        action = np.clip(action, self.min_action, self.max_action)
        return self._vocab_size - np.digitize(action, self.bins)

    def __call__(self, action: np.ndarray) -> Union[str, List[str]]:
        """Continuous action -> the decoded token string(s)."""
        if self.tokenizer is None:
            raise ValueError("text decode requires a base tokenizer")
        ids = self.encode_to_ids(np.asarray(action))
        if ids.ndim == 1:
            return self.tokenizer.decode(list(ids))
        return self.tokenizer.batch_decode(ids.tolist())

    def decode_token_ids_to_actions(self, action_token_ids: np.ndarray) -> np.ndarray:
        """Token ids -> continuous actions via the bin centers: digitize's
        [1, n_bins] index minus one, clipped to [0, n_bins - 2]."""
        discretized = self._vocab_size - np.asarray(action_token_ids)
        discretized = np.clip(discretized - 1, a_min=0, a_max=self.bin_centers.shape[0] - 1)
        return self.bin_centers[discretized]

    @property
    def vocab_size(self) -> int:
        return self.n_bins
