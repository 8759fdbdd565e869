"""Causal flash attention with a key-padding mask, forward and backward.

Counterpart of mla_tpu/ops/flash_attention.py. `flash_attention` normalizes
the mask as the JAX wrapper does and runs `FlashAttention`, an autograd
Function whose forward saves (q, k, v, mask, o, lse) as `_flash_fwd` does
and whose backward recomputes P from lse.

On a CUDA tensor the forward launches csrc/flash_fwd.cu and the backward
csrc/flash_bwd.cu (dQ, then dK/dV): bf16 q/k/v, head_dim 64 or 128, ragged S
masked in the kernels. delta = rowsum(dO * O) is a plain torch reduction
between them, as it is an XLA op outside the kernels in JAX. On a CPU tensor
they run `flash_fwd_plain` and `flash_bwd_plain`, the JAX kernels' blocked
loops with the JAX wrapper's padding to the lcm of the two block sizes.
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


class _PlainBwd:
    """The TPU backward kernels' shared block arithmetic over S padded to
    lcm(block_q, block_k): P = exp(s - lse) with the forward's masks and
    dS = P (dP - delta) scale, both fp32."""

    def __init__(self, q, k, v, key_mask, o, lse, do, block_q, block_k):
        BH, S, hd = q.shape
        self.S, self.bq, self.bk = S, block_q, block_k
        self.scale = 1.0 / math.sqrt(hd)
        delta = (do.float() * o.float()).sum(-1)
        lcm = math.lcm(block_q, block_k)
        self.Sp = -(-S // lcm) * lcm
        if self.Sp != S:
            pad = self.Sp - S
            q, k, v, do = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (q, k, v, do))
            key_mask, lse, delta = (torch.nn.functional.pad(t, (0, pad)) for t in (key_mask, lse, delta))
        self.q, self.k, self.v, self.do, self.lse, self.delta = q, k, v, do, lse, delta
        self.kvalid = key_mask > 0
        self.q_iota = torch.arange(block_q, device=q.device)[:, None]
        self.k_iota = torch.arange(block_k, device=q.device)[None, :]

    def probs(self, qi: int, ki: int):
        """(P, dS) of query block qi against key block ki."""
        q0, k0, bq, bk = qi * self.bq, ki * self.bk, self.bq, self.bk
        s = (self.q[:, q0 : q0 + bq].float() @ self.k[:, k0 : k0 + bk].float().transpose(1, 2)) * self.scale
        s = torch.where(self.kvalid[:, None, k0 : k0 + bk], s, NEG_INF)
        s = torch.where(k0 + self.k_iota <= q0 + self.q_iota, s, NEG_INF)
        p = torch.exp(s - self.lse[:, q0 : q0 + bq, None])
        dp = self.do[:, q0 : q0 + bq].float() @ self.v[:, k0 : k0 + bk].float().transpose(1, 2)
        return p, p * (dp - self.delta[:, q0 : q0 + bq, None]) * self.scale

    def zeros(self):
        return torch.zeros(self.q.shape, dtype=torch.float32, device=self.q.device)


def flash_bwd_dq_plain(q, k, v, key_mask, o, lse, do, block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K):
    """The plain version of the dQ kernel (_bwd_dq_kernel): per query block,
    key blocks up to the diagonal (ceil-div); dS rounded to k's dtype before
    dS K; fp32 sums; dQ in q's dtype."""
    b = _PlainBwd(q, k, v, key_mask, o, lse, do, block_q, block_k)
    dq = b.zeros()
    for qi in range(b.Sp // block_q):
        for ki in range(-(-(qi + 1) * block_q // block_k)):
            _, ds = b.probs(qi, ki)
            dq[:, qi * block_q : (qi + 1) * block_q] += ds.to(k.dtype).float() @ b.k[:, ki * block_k : (ki + 1) * block_k].float()
    return dq[:, : b.S].to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, key_mask, o, lse, do, block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K):
    """The plain version of the dK/dV kernel (_bwd_dkv_kernel): per key
    block, query blocks from k_offset // block_q; P rounded to dO's dtype
    before P^T dO, dS to q's dtype before dS^T Q; fp32 sums."""
    b = _PlainBwd(q, k, v, key_mask, o, lse, do, block_q, block_k)
    dk, dv = b.zeros(), b.zeros()
    for ki in range(b.Sp // block_k):
        k0 = ki * block_k
        for qi in range(k0 // block_q, b.Sp // block_q):
            p, ds = b.probs(qi, ki)
            q0 = qi * block_q
            dv[:, k0 : k0 + block_k] += p.to(do.dtype).float().transpose(1, 2) @ b.do[:, q0 : q0 + block_q].float()
            dk[:, k0 : k0 + block_k] += ds.to(q.dtype).float().transpose(1, 2) @ b.q[:, q0 : q0 + block_q].float()
    return dk[:, : b.S].to(k.dtype), dv[:, : b.S].to(v.dtype)


def flash_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor,
    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the backward: (dq, dk, dv) in the inputs' dtypes
    for q/k/v/o/do [BH, S, hd], key_mask int32 [BH, S], lse fp32 [BH, S]."""
    dq = flash_bwd_dq_plain(q, k, v, key_mask, o, lse, do, block_q, block_k)
    return (dq, *flash_bwd_dkv_plain(q, k, v, key_mask, o, lse, do, block_q, block_k))


def flash_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor,
    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the two kernels on CUDA (their own tiles; block_q and
    block_k shape the plain version only), the plain version on the CPU."""
    if not q.is_cuda:
        return flash_bwd_plain(q, k, v, key_mask, o, lse, do, block_q, block_k)
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (do, "do")):
        cuda.check(t, f"flash_bwd {name}", torch.bfloat16, 3)
    cuda.check(key_mask, "flash_bwd key_mask", torch.int32, 2)
    cuda.check(lse, "flash_bwd lse", torch.float32, 2)
    BH, S, hd = q.shape
    if any(t.shape != q.shape for t in (k, v, o, do)) or key_mask.shape != (BH, S) or lse.shape != (BH, S):
        raise ValueError(f"flash_bwd: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"o {tuple(o.shape)} do {tuple(do.shape)} mask {tuple(key_mask.shape)} lse {tuple(lse.shape)}")
    if hd not in (64, 128):
        raise ValueError(f"flash_bwd: head_dim must be 64 or 128, got {hd}")
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if BH > 0 and S > 0:
        scale = 1.0 / math.sqrt(hd)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr())
        cuda.call("flash_bwd", *ptrs, dq.data_ptr(), BH, S, hd, scale, symbol="flash_bwd_dq")
        cuda.launches["flash_attention_bwd_dq"] += 1
        cuda.call("flash_bwd", *ptrs, dk.data_ptr(), dv.data_ptr(), BH, S, hd, scale, symbol="flash_bwd_dkv")
        cuda.launches["flash_attention_bwd_dkv"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) for [BH, S, hd] with an int32 [BH, S] key mask.
    Saves (q, k, v, mask, o, lse) and recomputes P in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K):
        o, lse = flash_fwd(q, k, v, key_mask, block_q, block_k)
        ctx.save_for_backward(q, k, v, key_mask, o, lse)
        ctx.blocks = (block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, key_mask, o, lse, do.contiguous(), *ctx.blocks)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None,
    block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """q/k/v [B, H, S, hd] -> [B, H, S, hd], differentiable in q, k and v;
    `mask` a boolean key-padding mask ([B, S], [B, 1, 1, S] or row-constant
    [B, 1, Sq, Sk])."""
    B, H, S, hd = q.shape
    key_mask = _key_mask(mask, B, S, q.device)
    mask_bh = key_mask.repeat_interleave(H, dim=0).contiguous()
    o = FlashAttention.apply(
        q.reshape(B * H, S, hd).contiguous(), k.reshape(B * H, S, hd).contiguous(),
        v.reshape(B * H, S, hd).contiguous(), mask_bh, block_q, block_k,
    )
    return o.reshape(B, H, S, hd)
