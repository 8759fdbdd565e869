"""Scaled-dot-product attention for the decoder.

Counterpart of mla_tpu/ops/attention.py, for the causal attention the port
runs with no cache offset (the static prefill and the uncached forward):
`sdpa_reference` is the einsum softmax with fp32 scores; `sdpa` sends a CUDA
tensor to the flash kernel and a CPU tensor to the reference, as the JAX
package does off the TPU.

Mask convention: boolean [B, 1, Sq, Sk] or [B, Sq, Sk], True = may attend.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mla_tpu_torch.ops.flash_attention import flash_attention

NEG_INF = -2.3819763e38  # most negative bf16-representable


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal attention, q/k/v [B,H,S,hd] -> [B,H,S,hd]; softmax in fp32,
    the probabilities cast to v's dtype before PV."""
    S, hd = q.shape[2], q.shape[3]
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    scores = torch.where((pos[None, :] <= pos[:, None])[None, None], scores, NEG_INF)
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
