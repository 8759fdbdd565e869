"""Functional layer library on plain dicts of tensors.

Counterpart of mla_tpu/nn.py. Parameters keep the JAX
layout: linear weights are [in, out] (the transpose of torch's
nn.Linear.weight), int8 leaves are {'w_q','w_scale'}. Norm math runs in
fp32 and casts back, as in the JAX package.

An int8 leaf runs one of three products, chosen by `int8_mode` on the CPU
and on the card alike (JAX's MLA_INT8_MODE value in brackets); a W8A8
serving tree's leaves may also, or only, hold the weight K-major ('w_qt'
[..., out, in], models/llama.fuse_for_serving(k_major=True)), which W8A8
reads:
  "w8a8"        W8A8 (ops/quantization.w8a8_matmul) [w8a8, w8a8_pallas];
  "weight_only" the weight-only int8 product (ops/quantization.int8_matmul)
                for 2-D leaves whose K and N are multiples of 128, the
                dequantizing branch for any other leaf, as in JAX [pallas];
  "dequant"     `x @ w_q * scale` in x's dtype [dequant].
An int4 leaf ({'w_q4','w_scale4'}) runs ops/quantization.int4_linear
whatever the mode, as in JAX.

`row_parallel` marks a leaf that holds this rank's rows of a weight split
on K over the active tp group (parallel/tensor.py; o and down): W8A8 runs
its row-parallel mode, the weight-only product its fp32 partials; the
other products run in x's dtype, as without a group, and their partials
are widened to fp32. Each is summed over the group in fp32 and rounded to
x's dtype once, and a bias is added after. A leaf split on N (q|k|v,
gate|up) runs its product as it is.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from mla_tpu_torch.ops.quantization import int4_linear, int8_linear, w8a8_linear
from mla_tpu_torch.parallel import collectives
from mla_tpu_torch.parallel import tensor as tp

Params = Dict[str, Any]

INT8_MODES = ("w8a8", "weight_only", "dequant")


def weight_only_eligible(p: Params, k_split: int = 1) -> bool:
    """JAX's rule for its weight-only kernel: a 2-D leaf, K and N multiples
    of 128; K is the whole leaf's, k_split times the rows of a leaf split
    on K."""
    wq = p["w_q"]
    return wq.dim() == 2 and wq.shape[0] * k_split % 128 == 0 and wq.shape[1] % 128 == 0


def _summed(y: torch.Tensor, row_parallel: bool) -> torch.Tensor:
    """y, or for a leaf split on K the ranks' partial products summed over
    the tp group in fp32 and rounded to y's dtype once."""
    return tp.reduce_from_tp(y.float()).to(y.dtype) if row_parallel else y


def linear(p: Params, x: torch.Tensor, *, int8_mode: str = "w8a8", row_parallel: bool = False) -> torch.Tensor:
    if "w_q4" in p:
        if row_parallel:
            raise ValueError("an int4 leaf is never split over a tp group (JAX keeps w_q4 whole)")
        return int4_linear(p, x)
    if "w_q" in p or "w_qt" in p:
        if int8_mode not in INT8_MODES:
            raise ValueError(f"int8_mode must be one of {INT8_MODES}, got {int8_mode!r}")
        if int8_mode == "w8a8":
            return w8a8_linear(p, x, row_parallel)
        if "w_q" not in p:
            raise ValueError(f"int8_mode {int8_mode!r} reads w_q [K, N]; this leaf holds only the K-major W8A8 "
                             "copy (w_qt) of a W8A8 serving tree")
        if int8_mode == "weight_only" and weight_only_eligible(p, tp.size() if row_parallel else 1):
            return int8_linear(p, x, row_parallel)
        y = _summed(x @ p["w_q"].to(x.dtype), row_parallel) * p["w_scale"][..., 0, :].to(x.dtype)
    else:
        y = _summed(x @ p["w"].to(x.dtype), row_parallel)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def layer_norm_noaffine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without scale and bias (the DiT blocks)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Llama RMSNorm: fp32 variance, cast back, then scale in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return y * p["scale"].to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def mlp(p: Params, x: torch.Tensor, act=gelu_tanh) -> torch.Tensor:
    return linear(p["fc2"], act(linear(p["fc1"], x)))


def mlp_gelu(p: Params, x: torch.Tensor) -> torch.Tensor:
    """MLP_GELU projector: Linear, then (depth-1) x [GELU, Linear]."""
    x = linear(p["layers"][0], x)
    for lp in p["layers"][1:]:
        x = linear(lp, gelu_exact(x))
    return x


def proj_head(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Linear -> ReLU -> Linear (the contrastive projection heads)."""
    return linear(p["fc2"], torch.relu(linear(p["fc1"], x)))


def _promoted_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w in the wider of the two dtypes, as jnp's `@` promotes."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def mha(p: Params, x: torch.Tensor, num_heads: int, kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unmasked attention with a packed qkv linear (the DiT blocks and the
    generation heads): self-attention, or cross-attention over `kv` [B, Sk,
    D], where q comes from x @ w[:, :D] and k, v from kv @ w[:, D:2D] and
    kv @ w[:, 2D:] (plus the bias slices), each product in the wider of its
    operands' dtypes, as the JAX package slices the packed weight. fp32
    scores and softmax, the probabilities cast to v's dtype."""
    B, Sq, D = x.shape
    hd = D // num_heads
    if kv is None:
        qkv = linear(p["qkv"], x).reshape(B, Sq, 3, num_heads, hd)
        q, k, v = (qkv[:, :, i] for i in range(3))
    else:
        w, b = p["qkv"]["w"], p["qkv"].get("b")
        q, k, v = _promoted_mm(x, w[:, :D]), _promoted_mm(kv, w[:, D : 2 * D]), _promoted_mm(kv, w[:, 2 * D :])
        if b is not None:
            q, k, v = q + b[:D], k + b[D : 2 * D], v + b[2 * D :]
        q = q.reshape(B, Sq, num_heads, hd)
        k, v = (t.reshape(B, kv.shape[1], num_heads, hd) for t in (k, v))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
    out = torch.softmax(scores, dim=-1).to(v.dtype) @ v
    return linear(p["proj"], out.transpose(1, 2).reshape(B, Sq, D))


def embedding(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]


def batch_norm(
    p: Params, s: Params, x: torch.Tensor, training: bool = False, momentum: float = 0.1, eps: float = 1e-5,
) -> Tuple[torch.Tensor, Params]:
    """BatchNorm over every axis but the last (channels last); returns
    (y, new_state). Eval mode normalizes with the running statistics and
    returns the state as it is. Training mode normalizes with the batch mean
    and biased variance, and moves the running mean and the unbiased
    variance by `momentum`, outside the autograd graph. Inside a
    distributed step the batch is the global one: the sums and the count
    are reduced over the ranks (parallel/collectives.py), as GSPMD reduces
    them in JAX."""
    xf = x.float()
    if training:
        dims = tuple(range(x.dim() - 1))
        n = math.prod(x.shape[:-1])
        if collectives.active("batch_norm") is None:
            mean = xf.mean(dims)
            var = xf.var(dims, unbiased=False)
        else:
            n = int(collectives.global_count(torch.tensor(n, device=x.device), "batch_norm"))
            mean = collectives.all_sum(xf.sum(dims), "batch_norm") / n
            var = collectives.all_sum(((xf - mean) ** 2).sum(dims), "batch_norm") / n
        with torch.no_grad():
            new_s = {
                "mean": (1 - momentum) * s["mean"] + momentum * mean,
                "var": (1 - momentum) * s["var"] + momentum * (var * (n / max(n - 1, 1))),
            }
    else:
        mean, var, new_s = s["mean"].float(), s["var"].float(), s
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype), new_s
