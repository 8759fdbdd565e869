"""Rotary position embeddings, HF-Llama convention (rotate_half layout).

Counterpart of mla_tpu/ops/rope.py: the tables are built in float64 numpy
and kept as fp32; the rotation runs in fp32 and casts back. Phi's partial
rotation (the first rotary_dim dims of each head) is models/phi.py's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def rope_tables(head_dim: int, max_len: int, theta: float = 10000.0):
    """cos/sin tables [max_len, head_dim] (fp32 numpy)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    t = np.arange(max_len, dtype=np.float64)
    freqs = np.outer(t, inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


@functools.lru_cache(maxsize=8)
def rope_tables_on(dim: int, max_len: int, theta: float, device: str):
    """rope_tables of the rotated width `dim` (llama's head_dim, phi's
    rotary_dim) as tensors on `device`, built once per configuration,
    outside inference mode even when first asked for by a serving call, so
    a training forward in the same process can use them under autograd."""
    cos, sin = rope_tables(dim, max_len, theta)
    with torch.inference_mode(False):
        return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q, k, cos_table, sin_table, positions):
    """RoPE on q, k [B, H, S, hd] at positions [B, S] or [S]."""
    cos = cos_table[positions]
    sin = sin_table[positions]
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, None], sin[:, None]
    qf, kf = q.float(), k.float()
    q_out = qf * cos + rotate_half(qf) * sin
    k_out = kf * cos + rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)
