"""Causal flash-attention forward with a key-padding mask.

Counterpart of the forward of mla_tpu/ops/flash_attention.py (the backward
kernels belong to the training slice). `flash_attention` normalizes the mask
as the JAX wrapper does and then, on a CUDA tensor, launches the
hand-written kernel (csrc/flash_fwd.cu: bf16 q/k/v, head_dim 64 or 128,
ragged S masked in the kernel); on a CPU tensor it runs `flash_fwd_plain`,
the JAX kernel's blocked online softmax with the JAX wrapper's padding to the
lcm of the two block sizes.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from mla_tpu_torch.ops import cuda

NEG_INF = -1e30
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128


def _key_mask(mask: Optional[torch.Tensor], B: int, S: int, device) -> torch.Tensor:
    """[B, S] int32 key-validity from a mask given as [B, S], [B, 1, 1, S]
    or [B, 1, Sq, Sk] (row-constant)."""
    if mask is None:
        return torch.ones((B, S), dtype=torch.int32, device=device)
    if mask.dim() == 4:
        mask = mask[:, 0, 0, :] if mask.shape[2] == 1 else mask[:, 0, -1, :]
    elif mask.dim() == 3:
        mask = mask[:, -1, :]
    return mask.to(torch.int32)


def flash_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor,
    block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version. q/k/v [BH, S, hd], key_mask int32 [BH, S] ->
    (o [BH, S, hd] in q's dtype, lse fp32 [BH, S]). Pads S to
    lcm(block_q, block_k) and runs the TPU kernel's loop: fp32 scores, P
    rounded to v's dtype before PV, l clamped to 1e-30."""
    BH, S, hd = q.shape
    sm_scale = 1.0 / math.sqrt(hd)
    Sp = -(-S // math.lcm(block_q, block_k)) * math.lcm(block_q, block_k)
    pad = Sp - S
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        key_mask = torch.nn.functional.pad(key_mask, (0, pad))
    o = torch.empty((BH, Sp, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((BH, Sp), dtype=torch.float32, device=q.device)
    kf, vf = k.float(), v
    kvalid = key_mask > 0
    for qi in range(Sp // block_q):
        q0 = qi * block_q
        qb = q[:, q0 : q0 + block_q].float()
        m = torch.full((BH, block_q), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((BH, block_q), dtype=torch.float32, device=q.device)
        acc = torch.zeros((BH, block_q, hd), dtype=torch.float32, device=q.device)
        nk = -(-(qi + 1) * block_q // block_k)
        q_pos = q0 + torch.arange(block_q, device=q.device)[:, None]
        for ki in range(nk):
            k0 = ki * block_k
            s = (qb @ kf[:, k0 : k0 + block_k].transpose(1, 2)) * sm_scale
            s = torch.where(kvalid[:, None, k0 : k0 + block_k], s, NEG_INF)
            k_pos = k0 + torch.arange(block_k, device=q.device)[None, :]
            s = torch.where(k_pos <= q_pos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            pv = p.to(vf.dtype).float() @ vf[:, k0 : k0 + block_k].float()
            acc = acc * alpha[..., None] + pv
            m = m_new
        l_safe = l.clamp_min(1e-30)
        o[:, q0 : q0 + block_q] = (acc / l_safe[..., None]).to(q.dtype)
        lse[:, q0 : q0 + block_q] = m + torch.log(l_safe)
    return o[:, :S], lse[:, :S]


def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor,
    block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) for q/k/v [BH, S, hd] and key_mask int32 [BH, S]: the kernel
    on CUDA (its own 64x64 tiles; block_q/block_k shape the plain version
    only), the plain version on the CPU."""
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, key_mask, block_q, block_k)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        cuda.check(t, f"flash_fwd {name}", torch.bfloat16, 3)
    cuda.check(key_mask, "flash_fwd key_mask", torch.int32, 2)
    BH, S, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape or key_mask.shape != (BH, S):
        raise ValueError(f"flash_fwd: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} mask {tuple(key_mask.shape)}")
    if hd not in (64, 128):
        raise ValueError(f"flash_fwd: head_dim must be 64 or 128, got {hd}")
    o = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    if BH > 0 and S > 0:
        cuda.call(
            "flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
            o.data_ptr(), lse.data_ptr(), BH, S, hd, 1.0 / math.sqrt(hd),
        )
        cuda.launches["flash_attention"] += 1
    return o, lse


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None,
    block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """q/k/v [B, H, S, hd] -> [B, H, S, hd]; `mask` a boolean key-padding
    mask ([B, S], [B, 1, 1, S] or row-constant [B, 1, Sq, Sk])."""
    B, H, S, hd = q.shape
    key_mask = _key_mask(mask, B, S, q.device)
    mask_bh = key_mask.repeat_interleave(H, dim=0).contiguous()
    o, _ = flash_fwd(
        q.reshape(B * H, S, hd).contiguous(), k.reshape(B * H, S, hd).contiguous(),
        v.reshape(B * H, S, hd).contiguous(), mask_bh, block_q, block_k,
    )
    return o.reshape(B, H, S, hd)
