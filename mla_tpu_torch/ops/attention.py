"""Scaled-dot-product attention for the decoder.

Counterpart of mla_tpu/ops/attention.py: `sdpa_reference` is the einsum
softmax with fp32 scores, causal from an offset (a decode step's queries sit
at cache_len and attend over the whole cache; JAX runs that in XLA, and so
the port in plain PyTorch); `sdpa` is the causal attention with no offset
(the static prefill and the uncached forward): it sends a CUDA tensor of a
shape the flash kernel takes (at least 256 queries, head_dim 64 or 128:
JAX's shape rule) to the kernel, and any other tensor to the reference, as
the JAX package does off the TPU, for short blocks and for Phi-2's head_dim
80 on it. `decoder_attention` is a decoder layer's
attention in each of its cache modes, shared by the llama and phi decoders.

Mask convention: boolean [B, 1, Sq, Sk] or [B, Sq, Sk], True = may attend.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from mla_tpu_torch.ops.flash_attention import flash_attention

NEG_INF = -2.3819763e38  # most negative bf16-representable


def sdpa_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None,
    causal: bool = True, causal_offset: int = 0, scores_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """q [B,H,Sq,hd], k/v [B,H,Sk,hd] -> [B,H,Sq,hd]; softmax in fp32, the
    probabilities cast to v's dtype before PV. With `causal`, query i (at
    absolute position i + causal_offset) sees keys 0..i + causal_offset.
    scores_dtype (the serving prefill's bf16) holds the score tensor in that
    dtype, scaled there and masked with its most negative value, as JAX's
    einsum with preferred_element_type does; the softmax still reduces in
    fp32. None and torch.float32 are the fp32 path."""
    Sq, Sk, hd = q.shape[2], k.shape[2], q.shape[3]
    if scores_dtype not in (None, torch.float32):
        # the scale rounded to scores_dtype first, as JAX's asarray(scale, dtype)
        scale = float(torch.tensor(1.0 / math.sqrt(hd)).to(scores_dtype))
        scores = (q.float() @ k.float().transpose(-1, -2)).to(scores_dtype) * scale
        neg = torch.finfo(scores_dtype).min
    else:
        scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
        neg = NEG_INF
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None] + causal_offset
        scores = torch.where((torch.arange(Sk, device=q.device)[None, :] <= q_pos)[None, None], scores, neg)
    if mask is not None:
        if mask.dim() == 3:
            mask = mask[:, None]
        scores = torch.where(mask, scores, neg)
    probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    return probs @ v


FLASH_HEAD_DIMS = (64, 128)
FLASH_MIN_S = 256


def flash_fits(seq_len: int, head_dim: int) -> bool:
    """JAX's shape rule for its flash kernel (mla_tpu/ops/attention.py): a
    causal self-attending block of at least 256 queries, head_dim 64 or 128;
    a shorter block or any other head_dim (Phi-2's 80) goes to the
    reference."""
    return seq_len >= FLASH_MIN_S and head_dim in FLASH_HEAD_DIMS


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None,
         scores_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Causal attention: the flash kernel for a CUDA tensor it fits (it never
    materializes scores, so scores_dtype does not reach it), the reference
    otherwise."""
    if q.is_cuda and flash_fits(q.shape[-2], q.shape[-1]):
        return flash_attention(q, k, v, mask=mask)
    return sdpa_reference(q, k, v, mask=mask, scores_dtype=scores_dtype)


def decoder_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]],
    cache_len: int, key_mask: Optional[torch.Tensor], cache_read_only: bool = False,
    inflight_mask: Optional[torch.Tensor] = None, scores_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """A decoder layer's attention: q [B, H, S, hd], the block's k/v [B,
    Hkv, S, hd] (repeated to H heads), cache_kv this layer's (k_cache,
    v_cache) [B, Hkv, S_max, hd] views or None, key_mask [B, S_keys]. Four
    modes:
      * read-only suffix (cache_read_only): one softmax over the cache's
        [0, cache_len) under the key mask and the in-flight block (causal,
        under inflight_mask); nothing is written;
      * decode step (cache_len > 0): k/v written in place at [cache_len,
        cache_len + S), then the whole cache attended, causal from
        cache_len, under the key mask (plain attention: JAX runs it in XLA);
      * static prefill (cache_len 0): k/v written at [0, S), the in-flight
        block attended through `sdpa`;
      * uncached (no cache): the block through `sdpa`.
    scores_dtype reaches `sdpa` only (the prefill and the uncached
    forward), as in JAX."""
    B, H, S, hd = q.shape
    rep = H // k.shape[1]
    if cache_kv is not None and cache_read_only:
        k_cache, v_cache = cache_kv
        if rep > 1:
            k_cache, v_cache = k_cache.repeat_interleave(rep, 1), v_cache.repeat_interleave(rep, 1)
            k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        scale = 1.0 / math.sqrt(hd)
        qf = q.float()
        Sc = k_cache.shape[2]
        s_cache = (qf @ k_cache.float().transpose(-1, -2)) * scale
        stale = torch.arange(Sc, device=q.device)[None, None, None, :] >= cache_len
        if key_mask is not None:
            stale = stale | ~key_mask[:, None, None, :Sc]
        s_cache = s_cache.masked_fill(stale, float("-inf"))
        s_new = (qf @ k.float().transpose(-1, -2)) * scale
        causal = torch.arange(S, device=q.device)[None, :] > torch.arange(S, device=q.device)[:, None]
        s_new = s_new.masked_fill(causal[None, None], float("-inf"))
        if inflight_mask is not None:
            s_new = s_new.masked_fill(~inflight_mask[:, None, None, :], float("-inf"))
        attn = torch.softmax(torch.cat([s_cache, s_new], dim=-1), dim=-1).to(v.dtype)
        return attn[..., :Sc] @ v_cache + attn[..., Sc:] @ v
    if cache_kv is not None and cache_len > 0:
        k_cache, v_cache = cache_kv
        k_cache[:, :, cache_len : cache_len + S] = k
        v_cache[:, :, cache_len : cache_len + S] = v
        if rep > 1:
            k_cache, v_cache = k_cache.repeat_interleave(rep, 1), v_cache.repeat_interleave(rep, 1)
        mask = key_mask[:, None, None, :] if key_mask is not None else None
        return sdpa_reference(q, k_cache, v_cache, mask=mask, causal_offset=cache_len)
    if cache_kv is not None:
        cache_kv[0][:, :, :S] = k
        cache_kv[1][:, :, :S] = v
    if rep > 1:
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    mask = key_mask[:, None, None, :S] if key_mask is not None else None
    return sdpa(q, k, v, mask=mask, scores_dtype=scores_dtype)
