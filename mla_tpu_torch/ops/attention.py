"""Scaled-dot-product attention for the decoder.

Counterpart of mla_tpu/ops/attention.py: `sdpa_reference` is the einsum
softmax with fp32 scores, causal from an offset (a decode step's queries sit
at cache_len and attend over the whole cache; JAX runs that in XLA, and so
the port in plain PyTorch); `sdpa` is the causal attention with no offset
(the static prefill and the uncached forward) and sends a CUDA tensor to the
flash kernel and a CPU tensor to the reference, as the JAX package does off
the TPU.

Mask convention: boolean [B, 1, Sq, Sk] or [B, Sq, Sk], True = may attend.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mla_tpu_torch.ops.flash_attention import flash_attention

NEG_INF = -2.3819763e38  # most negative bf16-representable


def sdpa_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None,
    causal: bool = True, causal_offset: int = 0,
) -> torch.Tensor:
    """q [B,H,Sq,hd], k/v [B,H,Sk,hd] -> [B,H,Sq,hd]; softmax in fp32, the
    probabilities cast to v's dtype before PV. With `causal`, query i (at
    absolute position i + causal_offset) sees keys 0..i + causal_offset."""
    Sq, Sk, hd = q.shape[2], k.shape[2], q.shape[3]
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None] + causal_offset
        scores = torch.where((torch.arange(Sk, device=q.device)[None, :] <= q_pos)[None, None], scores, NEG_INF)
    if mask is not None:
        if mask.dim() == 3:
            mask = mask[:, None]
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return probs @ v


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal attention: the flash kernel on CUDA, the reference on the CPU."""
    if q.is_cuda:
        return flash_attention(q, k, v, mask=mask)
    return sdpa_reference(q, k, v, mask=mask)
