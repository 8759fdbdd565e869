"""Flash-attention backward of the port: `FlashAttention` on the CPU (the
plain forward and backward) against jax.grad of the JAX package's
flash_attention (Pallas in interpret mode) and against the gradients of the
einsum reference; on a machine with a card, the CUDA kernels against the
plain version.

Gradients are compared at valid rows only, through a loss that ignores the
padded rows, as tests/test_flash_attention.py does. fp32 tolerances are that
test's (atol 5e-4, rtol 1e-3): the blocked loops sum in another order than
the einsum reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu.ops import attention as jattn
from mla_tpu.ops.flash_attention import flash_attention as jflash
from mla_tpu_torch.ops import attention as tattn
from mla_tpu_torch.ops import cuda
from mla_tpu_torch.ops import flash_attention as tflash

ATOL, RTOL = 5e-4, 1e-3


def _inputs(B, H, S, hd, seed, valid):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, S, hd)).astype(np.float32) for _ in range(3))
    mask = np.broadcast_to(np.arange(S) < valid, (B, S)).copy()
    return q, k, v, mask


def _jax_grads(fn, q, k, v, mask):
    m = jnp.asarray(mask)

    def loss(q, k, v):
        o = fn(q, k, v, m)
        return jnp.sum(jnp.where(m[:, None, :, None], o, 0.0) ** 2)

    return [np.asarray(g, np.float32) for g in jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]


def _torch_grads(fn, q, k, v, mask, dtype=torch.float32):
    ts = [torch.from_numpy(np.array(x)).to(dtype).requires_grad_(True) for x in (q, k, v)]
    m = torch.from_numpy(mask)
    o = fn(*ts, m)
    (torch.where(m[:, None, :, None], o.float(), 0.0) ** 2).sum().backward()
    return [t.grad.float().numpy() for t in ts]


def _valid(g, mask):
    return g[:, :, mask[0]]


@pytest.mark.parametrize(
    "S,valid,bq,bk",
    [(256, 230, 128, 128), (200, 181, 128, 128), (256, 230, 64, 128), (256, 256, 128, 96), (563, 523, 64, 128)],
    ids=["padding-mask", "ragged-S", "blocks-64-128", "blocks-128-96", "dkv-kernel-tiles-ragged"],
)
def test_flash_grads_match_jax(S, valid, bq, bk, record_property):
    q, k, v, mask = _inputs(1, 2, S, 64, S + bq + bk, valid)
    got = _torch_grads(lambda q, k, v, m: tflash.flash_attention(q, k, v, mask=m, block_q=bq, block_k=bk), q, k, v, mask)
    want = _jax_grads(lambda q, k, v, m: jflash(q, k, v, mask=m, block_q=bq, block_k=bk), q, k, v, mask)
    ref = _jax_grads(lambda q, k, v, m: jattn.sdpa_reference(q, k, v, mask=m[:, None, None, :]), q, k, v, mask)
    record_property("max_abs_err_vs_jax_flash", max(float(np.abs(_valid(g, mask) - _valid(w, mask)).max()) for g, w in zip(got, want)))
    record_property("max_abs_err_vs_reference", max(float(np.abs(_valid(g, mask) - _valid(r, mask)).max()) for g, r in zip(got, ref)))
    for g, w, r, name in zip(got, want, ref, "qkv"):
        np.testing.assert_allclose(_valid(g, mask), _valid(w, mask), atol=ATOL, rtol=RTOL, err_msg=f"d{name} vs jax flash")
        np.testing.assert_allclose(_valid(g, mask), _valid(r, mask), atol=ATOL, rtol=RTOL, err_msg=f"d{name} vs jax reference")


def test_flash_grads_match_port_reference():
    """The plain pair against torch autograd through the port's own einsum
    reference, at the head_dim of the model (128) and a padded tail."""
    q, k, v, mask = _inputs(2, 2, 160, 128, 7, 141)
    got = _torch_grads(lambda q, k, v, m: tflash.flash_attention(q, k, v, mask=m), q, k, v, mask)
    ref = _torch_grads(lambda q, k, v, m: tattn.sdpa_reference(q, k, v, mask=m[:, None, None, :]), q, k, v, mask)
    for g, r, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(_valid(g, mask), _valid(r, mask), atol=ATOL, rtol=RTOL, err_msg=f"d{name}")


def test_flash_grads_bf16_match_jax(record_property):
    """bf16 inputs: both versions round P and dS to bf16 at the same places
    and write bf16 gradients; their fp32 sums run in different orders, so a
    gradient may land one bf16 step (2^-8 relative) away: atol 3e-2 at
    gradients of magnitude ~1-4, as test_flash_attention's bf16 test."""
    S, valid = 256, 240
    q, k, v, mask = _inputs(1, 1, S, 64, 11, valid)
    q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v))
    got = _torch_grads(lambda q, k, v, m: tflash.flash_attention(q, k, v, mask=m), q, k, v, mask, torch.bfloat16)
    want = _jax_grads(
        lambda q, k, v, m: jflash(q.astype(jnp.bfloat16), k.astype(jnp.bfloat16), v.astype(jnp.bfloat16), mask=m).astype(jnp.float32),
        q, k, v, mask,
    )
    for g, w, name in zip(got, want, "qkv"):
        scale = np.abs(_valid(w, mask)).max()
        err = np.abs(_valid(g, mask) - _valid(w, mask)).max()
        record_property(f"max_abs_err_d{name}", float(err))
        assert err <= 3e-2 * max(scale, 1.0), f"d{name}: max abs err {err} at scale {scale}"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    cuda.build(("flash_fwd", "flash_bwd"))
    return torch.device("cuda")


@pytest.mark.gpu
def test_flash_bwd_kernels_match_plain_on_card(card):
    """dQ/dK/dV of csrc/flash_bwd.cu against the plain version at valid rows,
    each row (a query of dQ, a key of dK, dV) within 1e-2 of its own norm,
    floored at 1e-2 of the median row norm for rows whose true gradient is
    zero (query 0 of dQ): bf16 outputs whose fp32 sums run in another order
    land an entry a bf16 step (2^-8 relative) away at most. Bit-identical
    over two launches."""
    g = torch.Generator(device=card).manual_seed(0)
    for BH, S, hd, valid in ((4, 563, 128, 563), (3, 300, 128, 260), (2, 129, 64, 100), (256, 563, 128, 563),
                             (256, 563, 128, 523)):
        q, k, v, do = (torch.randn((BH, S, hd), generator=g, device=card).to(torch.bfloat16) for _ in range(4))
        mask = (torch.arange(S, device=card) < valid).to(torch.int32)[None].expand(BH, S).contiguous()
        o, lse = tflash.flash_fwd(q, k, v, mask)
        got = tflash.flash_bwd(q, k, v, mask, o, lse, do)
        again = tflash.flash_bwd(q, k, v, mask, o, lse, do)
        want = tflash.flash_bwd_plain(q, k, v, mask, o, lse, do)
        torch.cuda.synchronize()
        for a, b, w, name in zip(got, again, want, "qkv"):
            assert torch.equal(a, b), f"d{name}: two launches differ"
            a, w = a[:, :valid].float(), w[:, :valid].float()
            n = w.norm(dim=-1)
            rel = float(((a - w).norm(dim=-1) / n.clamp_min(1e-2 * float(n.median()))).max())
            assert rel <= 1e-2, f"S={S} d{name}: a row is {rel} of its norm from the plain version"
