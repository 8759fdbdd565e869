"""Phi-2 decoder, the third decoder family of the composed model.

Counterpart of mla_tpu/models/phi.py. Phi-2's block differs from Llama's:
  * attention and MLP run in PARALLEL off one biased LayerNorm:
        h = h + attn(ln(h)) + mlp(ln(h)),
    and hidden_mid is h before layer `contrastive_layer`;
  * partial rotary embeddings: the tables are built at rotary_dim (0.4 of
    head_dim, 32 of Phi-2's 80), the first rotary_dim dims of q and k are
    rotated (rotate_half within them) and the rest pass through
    (`apply_partial_rope`; ops/rope is the llama rotation at any width);
  * every projection has a bias; a GELU(tanh) MLP without a gate; a final
    LayerNorm and a biased lm_head, fp32 logits.

The interface is llama's (models/llama.py): the same keyword arguments,
stacked [L, ...] leaves run as a loop over per-layer views
(`llama.run_layers`, per-layer torch.utils.checkpoint under remat), and an
in-place KV cache whose modes `ops/attention.decoder_attention` shares with
llama. JAX's phi_forward ignores cache_read_only and writes the suffix into
a functional cache copy that the denoise loop discards; here the cache is
updated in place, so the read-only suffix takes llama's branch instead,
with the same values: one softmax over [cached prefix | in-flight block],
nothing written. Attention at head_dim 80 is plain PyTorch on the card too
(`attention.sdpa`), as JAX leaves it to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from mla_tpu_torch import nn
from mla_tpu_torch import params as P
from mla_tpu_torch.models import llama as llama_mod
from mla_tpu_torch.ops import attention as attn_ops
from mla_tpu_torch.ops import rope as rope_ops


@dataclass(frozen=True)
class PhiConfig:
    vocab_size: int = 51200
    hidden_size: int = 2560
    intermediate_size: int = 10240
    num_layers: int = 32
    num_heads: int = 32
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 0.4
    ln_eps: float = 1e-5
    contrastive_layer: int = 8
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)


PHI_2 = PhiConfig()
PHI_TEST = PhiConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=4, num_heads=4,
                     contrastive_layer=2, compute_dtype=torch.float32)


def init_kv_cache(cfg: PhiConfig, batch: int, max_len: int, dtype=None, device=None) -> Dict[str, torch.Tensor]:
    shape = (cfg.num_layers, batch, cfg.num_heads, max_len, cfg.head_dim)
    dtype = dtype or cfg.compute_dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}


def apply_partial_rope(q, k, cos_table, sin_table, positions, rotary_dim: int):
    """RoPE on the first rotary_dim dims of q, k [B, H, S, hd] (tables of
    width rotary_dim); the other dims pass through."""
    q_rot, k_rot = rope_ops.apply_rope(q[..., :rotary_dim], k[..., :rotary_dim], cos_table, sin_table, positions)
    return torch.cat([q_rot, q[..., rotary_dim:]], -1), torch.cat([k_rot, k[..., rotary_dim:]], -1)


def _layer_fn(lp, h, cache_kv, cfg, cos_table, sin_table, positions, key_mask, cache_len,
              cache_read_only=False, inflight_mask=None, int8_mode="w8a8", scores_dtype=None):
    """One parallel block; cache_kv as in llama._layer_fn. Returns h."""
    B, S, D = h.shape
    H, hd = cfg.num_heads, cfg.head_dim
    x = nn.layer_norm(lp["ln"], h, cfg.ln_eps)
    q, k, v = (nn.linear(lp["attn"][n], x, int8_mode=int8_mode).reshape(B, S, H, hd).transpose(1, 2)
               for n in ("q", "k", "v"))
    q, k = apply_partial_rope(q, k, cos_table, sin_table, positions, cfg.rotary_dim)
    out = attn_ops.decoder_attention(q, k, v, cache_kv, cache_len, key_mask, cache_read_only, inflight_mask,
                                     scores_dtype)
    attn_out = nn.linear(lp["attn"]["o"], out.transpose(1, 2).reshape(B, S, D), int8_mode=int8_mode)
    mlp_out = nn.linear(lp["mlp"]["fc2"], nn.gelu_tanh(nn.linear(lp["mlp"]["fc1"], x, int8_mode=int8_mode)),
                        int8_mode=int8_mode)
    # parallel residual: both branches read the same ln(h)
    return h + attn_out + mlp_out


def phi_forward(
    params: Dict[str, Any],
    cfg: PhiConfig,
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
    """Decoder forward from embeddings [B, S, D]; the arguments and the
    cache modes are llama_forward's. Returns {'last_hidden', 'hidden_mid',
    'logits'?, 'kv_cache'?}."""
    h, hidden_mid = llama_mod.run_layers(
        _layer_fn, params["layers"], cfg, inputs_embeds, cfg.rotary_dim, positions=positions, key_mask=key_mask,
        kv_cache=kv_cache, cache_len=cache_len, cache_read_only=cache_read_only, remat=remat, int8_mode=int8_mode,
        scores_dtype=scores_dtype,
    )
    out: Dict[str, Any] = {"last_hidden": nn.layer_norm(params["final_ln"], h, cfg.ln_eps), "hidden_mid": hidden_mid}
    if kv_cache is not None:
        out["kv_cache"] = kv_cache
    if compute_logits:
        out["logits"] = lm_head_logits(params, out["last_hidden"])
    return out


def lm_head_logits(params: Dict[str, Any], hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits from final-normed hidden states [..., D]: the fp32 head
    plus its fp32 bias."""
    head = params["lm_head"]
    return hidden.float() @ head["w"].float() + head["b"].float()


def embed_tokens(params: Dict[str, Any], ids: torch.Tensor) -> torch.Tensor:
    return nn.embedding(params["embed"], ids)


def phi_init(cfg: PhiConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """A seeded phi tree with JAX phi_init's distributions (params._phi)."""
    return P._phi(P._Init(seed, device), cfg)


def convert_hf_phi(sd, num_layers: int, prefix: str = "") -> Dict[str, Any]:
    """HF PhiForCausalLM state dict (model.layers.N.{self_attn.{q,k,v}_proj,
    self_attn.dense, mlp.fc1, mlp.fc2, input_layernorm}, model.final_layernorm,
    lm_head) -> the stacked phi tree: linears transposed to [in, out], each
    leaf in its source dtype."""

    def k(s):
        return f"{prefix}{s}"

    def stack(fmt: str, transpose: bool = False) -> torch.Tensor:
        return torch.stack([sd[k(fmt.format(i=i))].t() if transpose else sd[k(fmt.format(i=i))]
                            for i in range(num_layers)])

    def stack_lin(fmt: str) -> Dict[str, torch.Tensor]:
        return {"w": stack(fmt + ".weight", transpose=True), "b": stack(fmt + ".bias")}

    return {
        "embed": {"table": sd[k("model.embed_tokens.weight")]},
        "layers": {
            "attn": {
                "q": stack_lin("model.layers.{i}.self_attn.q_proj"),
                "k": stack_lin("model.layers.{i}.self_attn.k_proj"),
                "v": stack_lin("model.layers.{i}.self_attn.v_proj"),
                "o": stack_lin("model.layers.{i}.self_attn.dense"),
            },
            "mlp": {"fc1": stack_lin("model.layers.{i}.mlp.fc1"), "fc2": stack_lin("model.layers.{i}.mlp.fc2")},
            "ln": {"scale": stack("model.layers.{i}.input_layernorm.weight"),
                   "bias": stack("model.layers.{i}.input_layernorm.bias")},
        },
        "final_ln": {"scale": sd[k("model.final_layernorm.weight")], "bias": sd[k("model.final_layernorm.bias")]},
        "lm_head": {"w": sd[k("lm_head.weight")].t().contiguous(), "b": sd[k("lm_head.bias")]},
    }


# the decoder-module interface (models/prismatic.get_decoder)
init = phi_init
forward = phi_forward
Config = PhiConfig
