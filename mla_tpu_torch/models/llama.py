"""Llama-family decoder, with GQA for the Mistral backbone.

Counterpart of mla_tpu/models/llama.py. Layer parameters stay stacked on a
leading [num_layers] axis, as in the JAX tree; the layers run as a Python
loop over per-layer views (one unbind per leaf, so the backward stacks the
layer gradients in one op). The KV cache is a preallocated
[L, B, Hkv, S_max, hd] pair that prefill updates IN PLACE (the JAX version
returns a new cache); the read-only suffix path never writes it. Training
runs the uncached forward under autograd, each layer optionally under
non-reentrant torch.utils.checkpoint (the JAX package's per-layer
jax.checkpoint), which reruns the layer, its flash forward included, in
the backward. A decode step (cache_len > 0, cache written) writes its k/v
into the cache in place and attends over the whole cache, causal from
cache_len, under the key mask. `int8_mode` picks the product of the int8
linears (nn.linear). The layer loop (`run_layers`) and the attention of
each cache mode (ops/attention.decoder_attention) are shared with the phi
decoder (models/phi.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mla_tpu_torch import nn
from mla_tpu_torch.ops import attention as attn_ops
from mla_tpu_torch.ops import quantization
from mla_tpu_torch.ops import rope as rope_ops


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32064
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    contrastive_layer: int = 8
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


LLAMA2_7B = LlamaConfig()
MISTRAL_7B = LlamaConfig(
    vocab_size=32064, hidden_size=4096, intermediate_size=14336, num_layers=32,
    num_heads=32, num_kv_heads=8, max_position_embeddings=32768,
)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None, device=None) -> Dict[str, torch.Tensor]:
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    dtype = dtype or cfg.compute_dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}


def _mlp_block(lp, h, cfg, int8_mode="w8a8"):
    x = nn.rms_norm(lp["post_ln"], h, cfg.rms_eps)
    if "gateup_fused" in lp["mlp"]:
        gu = nn.linear(lp["mlp"]["gateup_fused"], x, int8_mode=int8_mode)
        I = gu.shape[-1] // 2
        gated = nn.silu(gu[..., :I]) * gu[..., I:]
    else:
        gated = nn.silu(nn.linear(lp["mlp"]["gate"], x, int8_mode=int8_mode)) * nn.linear(
            lp["mlp"]["up"], x, int8_mode=int8_mode)
    return h + nn.linear(lp["mlp"]["down"], gated, int8_mode=int8_mode)


def _layer_fn(lp, h, cache_kv, cfg, cos_table, sin_table, positions, key_mask, cache_len,
              cache_read_only=False, inflight_mask=None, int8_mode="w8a8", scores_dtype=None):
    """One decoder layer. cache_kv: this layer's (k_cache, v_cache)
    [B, Hkv, S_max, hd] views, or None. Returns h."""
    B, S, D = h.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = nn.rms_norm(lp["input_ln"], h, cfg.rms_eps)
    kvd = Hkv * hd
    if "qkv_fused" in lp["attn"]:
        qkv = nn.linear(lp["attn"]["qkv_fused"], x, int8_mode=int8_mode)
        q, k, v = qkv[..., :D], qkv[..., D : D + kvd], qkv[..., D + kvd :]
    else:
        q = nn.linear(lp["attn"]["q"], x, int8_mode=int8_mode)
        k = nn.linear(lp["attn"]["k"], x, int8_mode=int8_mode)
        v = nn.linear(lp["attn"]["v"], x, int8_mode=int8_mode)
    q = q.reshape(B, S, H, hd).transpose(1, 2)
    k = k.reshape(B, S, Hkv, hd).transpose(1, 2)
    v = v.reshape(B, S, Hkv, hd).transpose(1, 2)
    q, k = rope_ops.apply_rope(q, k, cos_table, sin_table, positions)
    out = attn_ops.decoder_attention(q, k, v, cache_kv, cache_len, key_mask, cache_read_only, inflight_mask,
                                     scores_dtype)
    out = out.transpose(1, 2).reshape(B, S, D)
    h = h + nn.linear(lp["attn"]["o"], out, int8_mode=int8_mode)
    return _mlp_block(lp, h, cfg, int8_mode)


def unstack_layers(layers: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per-layer views of a stacked layer tree."""
    if isinstance(layers, dict):
        subs = {k: unstack_layers(v) for k, v in layers.items()}
        n = len(next(iter(subs.values())))
        return [{k: sub[i] for k, sub in subs.items()} for i in range(n)]
    return list(layers.unbind(0))


def run_layers(
    layer_fn: Callable[..., torch.Tensor], layers: Dict[str, Any], cfg: Any, inputs_embeds: torch.Tensor,
    rope_dim: int, *, positions: Optional[torch.Tensor], key_mask: Optional[torch.Tensor],
    kv_cache: Optional[Dict[str, torch.Tensor]], cache_len: int, cache_read_only: bool, remat: bool,
    int8_mode: str, scores_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder's layer loop, shared by the llama and phi families: the
    embeddings cast to cfg.compute_dtype, RoPE tables of `rope_dim`, each
    stacked layer's view through layer_fn(lp, h, cache_kv, cfg, cos, sin,
    positions, key_mask, cache_len, cache_read_only, inflight_mask,
    int8_mode, scores_dtype), under torch.utils.checkpoint with remat. Returns (h,
    hidden_mid), hidden_mid taken before layer cfg.contrastive_layer (the
    last h when that is past the last layer)."""
    S = inputs_embeds.shape[1]
    h = inputs_embeds.to(cfg.compute_dtype)
    dev = h.device
    if positions is None:
        positions = torch.arange(S, device=dev) + cache_len
    cos_table, sin_table = rope_ops.rope_tables_on(rope_dim, cfg.max_position_embeddings, cfg.rope_theta, str(dev))
    inflight_mask = None
    if cache_read_only and key_mask is not None:
        inflight_mask = key_mask[:, cache_len : cache_len + S]
    if remat and kv_cache is not None:
        raise ValueError("remat is for the uncached training forward")
    hidden_mid = h
    for i, lp in enumerate(unstack_layers(layers)):
        if i == cfg.contrastive_layer:
            hidden_mid = h
        ck = (kv_cache["k"][i], kv_cache["v"][i]) if kv_cache is not None else None
        args = (lp, h, ck, cfg, cos_table, sin_table, positions, key_mask, cache_len, cache_read_only, inflight_mask,
                int8_mode, scores_dtype)
        h = checkpoint(layer_fn, *args, use_reentrant=False) if remat else layer_fn(*args)
    if cfg.contrastive_layer >= cfg.num_layers:
        hidden_mid = h
    return h, hidden_mid


def llama_forward(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,
    *,
    positions: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    kv_cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_len: int = 0,
    compute_logits: bool = True,
    cache_read_only: bool = False,
    remat: bool = False,
    int8_mode: str = "w8a8",
    scores_dtype: Optional[torch.dtype] = None,
) -> Dict[str, Any]:
    """Decoder forward from embeddings [B, S, D] (cast to compute_dtype).

    key_mask: [B, S_keys] boolean key validity; with a cache S_keys is the
    cache length. kv_cache: {'k','v'} [L,B,Hkv,Smax,hd]. Three cached modes:
    the static prefill (cache_len 0) writes [0, S) in place; a decode step
    (cache_len > 0) writes [cache_len, cache_len + S) in place and attends
    over the whole cache; the read-only suffix (cache_read_only) attends over
    the cache's [0, cache_len) and the in-flight block without writing.
    remat (uncached only) checkpoints each layer. int8_mode: the product of
    the int8 linears (nn.linear). scores_dtype: the score dtype of the
    plain attention of the prefill and the uncached forward (None: fp32).
    Returns {'last_hidden', 'hidden_mid',
    'logits'?, 'kv_cache'?}."""
    h, hidden_mid = run_layers(_layer_fn, params["layers"], cfg, inputs_embeds, cfg.head_dim, positions=positions,
                               key_mask=key_mask, kv_cache=kv_cache, cache_len=cache_len,
                               cache_read_only=cache_read_only, remat=remat, int8_mode=int8_mode,
                               scores_dtype=scores_dtype)
    out: Dict[str, Any] = {
        "last_hidden": nn.rms_norm(params["final_ln"], h, cfg.rms_eps),
        "hidden_mid": hidden_mid,
    }
    if kv_cache is not None:
        out["kv_cache"] = kv_cache
    if compute_logits:
        out["logits"] = lm_head_logits(params, out["last_hidden"])
    return out


def lm_head_logits(params: Dict[str, Any], hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits from final-normed hidden states [..., D]. An int8 head
    takes JAX's formula, (hf @ float(w_q)) * w_scale with the scale after
    the dot, through the weight-only product in fp32 (on the card its
    kernel reads the int8 bytes; nothing widens the head)."""
    head = params["lm_head"]
    hf = hidden.float()
    if "w_q" in head:
        y = quantization.int8_matmul(hf.reshape(-1, hf.shape[-1]).contiguous(), head["w_q"], head["w_scale"])
        return y.reshape(*hf.shape[:-1], y.shape[-1])
    return hf @ head["w"].float()


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100) -> torch.Tensor:
    """Shifted cross-entropy, mean over the labels that are not ignored."""
    shift_logits, shift_labels = logits[:, :-1].float(), labels[:, 1:].long()
    valid = shift_labels != ignore_index
    nll = F.cross_entropy(shift_logits.transpose(1, 2), torch.where(valid, shift_labels, 0), reduction="none")
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)


def embed_tokens(params: Dict[str, Any], ids: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    if "table_q" in emb:
        # int8 rows come back in bf16 whatever the compute dtype, as in JAX
        rows = emb["table_q"][ids].to(torch.bfloat16)
        return rows * emb["table_scale"][ids].to(torch.bfloat16)
    return nn.embedding(emb, ids)


def fuse_for_serving(params: Dict[str, Any], k_major: bool = False) -> Dict[str, Any]:
    """Concatenate q|k|v and gate|up on the output dim (fp or int8 leaves;
    per-output-channel scales concatenate too).

    k_major (the W8A8 serving tree): the int8 decoder weights are also laid
    out K-major, 'w_qt' int8 [L, out, in], the layout the W8A8 kernel reads
    (the card's int8 tensor cores take both operands K-major). The fused
    leaves hold only that copy; o and down keep JAX's w_q beside it. Built
    once, on the leaves' device."""

    def cat(leaves):
        if "w" in leaves[0]:
            return {"w": torch.cat([l["w"] for l in leaves], dim=-1)}
        out = {"w_scale": torch.cat([l["w_scale"] for l in leaves], dim=-1)}
        if k_major:
            out["w_qt"] = torch.cat([l["w_q"].transpose(-1, -2) for l in leaves], dim=-2)
        else:
            out["w_q"] = torch.cat([l["w_q"] for l in leaves], dim=-1)
        return out

    def with_k_major(leaf):
        if not k_major or "w_q" not in leaf:
            return leaf
        return {**leaf, "w_qt": leaf["w_q"].transpose(-1, -2).contiguous()}

    lp = params["layers"]
    attn = {k: v for k, v in lp["attn"].items() if k not in ("q", "k", "v")}
    attn["o"] = with_k_major(lp["attn"]["o"])
    attn["qkv_fused"] = cat([lp["attn"]["q"], lp["attn"]["k"], lp["attn"]["v"]])
    mlp = {k: v for k, v in lp["mlp"].items() if k not in ("gate", "up")}
    mlp["down"] = with_k_major(lp["mlp"]["down"])
    mlp["gateup_fused"] = cat([lp["mlp"]["gate"], lp["mlp"]["up"]])
    return {**params, "layers": {**lp, "attn": attn, "mlp": mlp}}


# the decoder-module interface (models/prismatic.get_decoder), as in JAX
forward = llama_forward
