"""The port's kernel-bearing ops: each plain PyTorch version held against the
JAX function as the JAX tests run it on the CPU (Pallas in interpret mode),
plus, on a machine with a card, each CUDA kernel against its plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu.ops import attention as jattn
from mla_tpu.ops import quantization as jq
from mla_tpu.ops.flash_attention import flash_attention as jflash
from mla_tpu.ops.pointops import furthest_point_sample as jfps
from mla_tpu.ops.pointops_pallas import fps_pallas
from mla_tpu_torch.ops import cuda
from mla_tpu_torch.ops import flash_attention as tflash
from mla_tpu_torch.ops import pointops as tpo
from mla_tpu_torch.ops import quantization as tq


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------- #
# FPS: indices identical to fps_pallas (interpret mode)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("B,N,npoint", [(3, 256, 32), (2, 1024, 64)])
def test_fps_plain_matches_pallas_start0(B, N, npoint):
    xyz = np.random.default_rng(N).normal(size=(B, N, 3)).astype(np.float32)
    want = np.asarray(fps_pallas(jnp.asarray(xyz), npoint))
    got = tpo.furthest_point_sample(_t(xyz), npoint).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jfps(jnp.asarray(xyz), npoint, use_pallas=False)))


def test_fps_plain_matches_pallas_random_start():
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(4, 128, 3)).astype(np.float32)
    start = rng.integers(0, 128, size=4).astype(np.int32)
    want = np.asarray(fps_pallas(jnp.asarray(xyz), 16, start=jnp.asarray(start)))
    got = tpo.furthest_point_sample(_t(xyz), 16, _t(start)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == start).all()


def test_fps_ties_take_lowest_index():
    """Duplicated points tie exactly; both versions must pick the first."""
    rng = np.random.default_rng(2)
    base = rng.normal(size=(1, 64, 3)).astype(np.float32)
    xyz = np.concatenate([base, base], axis=1)
    want = np.asarray(fps_pallas(jnp.asarray(xyz), 40))
    got = tpo.furthest_point_sample(_t(xyz), 40).numpy()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# W8A8: int32 part exact; output within ~1 ulp of w8a8_matmul (interpret)
# --------------------------------------------------------------------------- #


def _exact_w8a8(x, w_q):
    sx = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-8).astype(np.float32) / np.float32(127.0)
    xq = np.clip(np.round(x / sx), -127, 127).astype(np.int64)
    return xq @ w_q.astype(np.int64)


@pytest.mark.parametrize("M,K,N", [(19, 256, 384), (534 // 8, 128, 256), (18, 512, 128)])
def test_w8a8_plain_matches_pallas(M, K, N, record_property):
    rng = np.random.default_rng(M * K)
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.04
    x = rng.normal(size=(M, K)).astype(np.float32)
    pq = jq.quantize_weight(jnp.asarray(w))
    tp = tq.quantize_weight(_t(w))
    np.testing.assert_array_equal(tp["w_q"].numpy(), np.asarray(pq["w_q"]))
    np.testing.assert_array_equal(tp["w_scale"].numpy(), np.asarray(pq["w_scale"]))

    # the port's W8A8 takes the weight K-major, [N, K]
    y, acc = tq.w8a8_matmul(_t(x), tp["w_q"].t().contiguous(), tp["w_scale"], return_acc=True)
    np.testing.assert_array_equal(acc.numpy(), _exact_w8a8(x, np.asarray(pq["w_q"])))
    y_jax = np.asarray(jq.w8a8_matmul(jnp.asarray(x), pq["w_q"], pq["w_scale"], interpret=True))
    # ~1 ulp: XLA may fold the two scale multiplies into one (reassociation)
    record_property("max_abs_err", float(np.abs(y.numpy() - y_jax).max()))
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=3e-7, atol=1e-7)


def test_w8a8_bf16_activations():
    rng = np.random.default_rng(5)
    K, N, M = 128, 192, 18
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.04
    x = rng.normal(size=(M, K)).astype(np.float32)
    pq = jq.quantize_weight(jnp.asarray(w))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    y_jax = np.asarray(jq.w8a8_matmul(xb, pq["w_q"], pq["w_scale"], interpret=True).astype(jnp.float32))
    y = tq.w8a8_matmul(_t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16),
                       _t(np.asarray(pq["w_q"]).T), _t(np.asarray(pq["w_scale"])))
    assert y.dtype == torch.bfloat16
    # one bf16 rounding of the same fp32 value, up to the 1-ulp fp32 fold above
    np.testing.assert_allclose(y.float().numpy(), y_jax, rtol=8e-3, atol=1e-6)


def test_cpu_wrappers_launch_nothing():
    cuda.launches.clear()
    x = torch.randn(4, 64)
    tq.w8a8_matmul(x, torch.ones(64, 64, dtype=torch.int8), torch.ones(64))
    tpo.furthest_point_sample(torch.randn(1, 32, 3), 4)
    tflash.flash_attention(*(torch.randn(1, 1, 8, 64) for _ in range(3)))
    assert sum(cuda.launches.values()) == 0


# --------------------------------------------------------------------------- #
# Flash forward: matches flash_attention (interpret) and sdpa_reference
# --------------------------------------------------------------------------- #


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("S,valid,bq,bk", [
    (256, 256, 128, 128),   # one multiple of the block
    (200, 200, 128, 128),   # S not a multiple of the block: padding path
    (256, 200, 128, 128),   # key padding
    (256, 230, 64, 128),    # asymmetric blocks: ceil-div diagonal, lcm padding
    (256, 230, 128, 96),
    (150, 140, 128, 64),
    (534, 494, 64, 64),     # the card kernel's 64 x 64 tiles: ragged S, padded keys
    (563, 523, 64, 64),     # the same at the training length
])
def test_flash_plain_matches_jax(S, valid, bq, bk, record_property):
    B, H, hd = 1, 2, 64
    q, k, v = _qkv((B, H, S, hd), S + valid + bq)
    mask = np.arange(S)[None, :] < valid
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask),
                             block_q=bq, block_k=bk))
    ref = np.asarray(jattn.sdpa_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          mask=jnp.asarray(mask)[:, None, None, :], causal=True))
    got = tflash.flash_attention(_t(q), _t(k), _t(v), mask=_t(mask), block_q=bq, block_k=bk).numpy()
    # fp32 throughout; the tolerances of tests/test_flash_attention.py. Fully
    # masked padding rows are 0 here but a uniform average in the reference:
    # compare valid rows only
    record_property("max_abs_err", float(np.abs(got - want)[:, :, :valid].max()))
    record_property("max_abs_err_vs_sdpa_reference", float(np.abs(got - ref)[:, :, :valid].max()))
    np.testing.assert_allclose(got[:, :, :valid], want[:, :, :valid], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got[:, :, :valid], ref[:, :, :valid], atol=2e-5, rtol=1e-4)


def test_flash_plain_lse_and_bf16(record_property):
    BH, S, hd = 2, 160, 128
    q, k, v = _qkv((BH, S, hd), 9)
    mask = np.ones((BH, S), np.int32)
    o, lse = tflash.flash_fwd_plain(_t(q), _t(k), _t(v), _t(mask))
    s = np.einsum("bqd,bkd->bqk", q, k) / np.sqrt(hd)
    s = np.where(np.tril(np.ones((S, S), bool))[None], s, -np.inf)
    np.testing.assert_allclose(lse.numpy(), np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1),
                               rtol=1e-5, atol=1e-5)
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jflash(qb[None], kb[None], vb[None]).astype(jnp.float32))[0]
    got = tflash.flash_fwd_plain(*(_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16) for a in (qb, kb, vb)),
                                 _t(mask))[0]
    assert got.dtype == torch.bfloat16
    # bf16 out; P rounded to bf16 in both; fp32 accumulation order differs
    record_property("max_abs_err", float(np.abs(got.float().numpy() - want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


# --------------------------------------------------------------------------- #
# On the card: each kernel against its plain version
# --------------------------------------------------------------------------- #


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    cuda.build()
    return torch.device("cuda")


@pytest.mark.gpu
def test_w8a8_kernel_matches_plain_on_card(card):
    """Both paths (narrow up to 64 rows, wide above) and their split of K
    (the N = 4096 products split on both), the smallest leaf and a ragged
    wide tile: int32 accumulators and outputs identical to the plain
    version's."""
    g = torch.Generator(device=card).manual_seed(0)
    shapes = [(M, 4096, 4096) for M in (1, 18, 33, 64, 65, 534)] + [(18, 11008, 4096), (1, 128, 64),
                                                                       (534, 1024, 3072)]
    for M, K, N in shapes:
        x = torch.randn((M, K), generator=g, device=card).to(torch.bfloat16)
        w_qt = torch.randint(-127, 128, (N, K), generator=g, device=card, dtype=torch.int8)
        ws = torch.rand((N,), generator=g, device=card) * 1e-3
        y, acc = tq.w8a8_matmul(x, w_qt, ws, return_acc=True)
        again = tq.w8a8_matmul(x, w_qt, ws)
        yp, accp = tq.w8a8_matmul_plain(x, w_qt, ws, return_acc=True)
        assert torch.equal(acc, accp) and torch.equal(y, yp) and torch.equal(y, again), (M, K, N)


@pytest.mark.gpu
def test_fps_kernel_matches_plain_on_card(card):
    g = torch.Generator(device=card).manual_seed(1)
    xyz = torch.rand((2, 1024, 3), generator=g, device=card)
    start = torch.tensor([0, 5], dtype=torch.int32, device=card)
    assert torch.equal(tpo.furthest_point_sample(xyz, 512, start), tpo.furthest_point_sample_plain(xyz, 512, start))


@pytest.mark.gpu
def test_fps_kernel_batched_and_large_clouds_on_card(card):
    """The training batch (B = 8) at both stages, a cloud whose points do
    not fill the last warp, and clouds past 4096 points (their coordinates
    read from shared memory, not registers): indices identical."""
    g = torch.Generator(device=card).manual_seed(3)
    for B, N, npoint in ((8, 1024, 512), (8, 512, 256), (3, 40, 17), (2, 5000, 300), (1, 14528, 64)):
        xyz = torch.rand((B, N, 3), generator=g, device=card)
        start = torch.randint(0, N, (B,), generator=g, device=card, dtype=torch.int32)
        got = tpo.furthest_point_sample(xyz, npoint, start)
        assert torch.equal(got, tpo.furthest_point_sample_plain(xyz, npoint, start)), (B, N, npoint)


@pytest.mark.gpu
def test_flash_kernel_matches_plain_on_card(card):
    g = torch.Generator(device=card).manual_seed(2)
    # a few heads, the serving prefill and the training shape, each with a
    # padded key tail; hd 64 at a ragged S
    for BH, S, hd, valid in ((4, 534, 128, 500), (32, 534, 128, 494), (256, 563, 128, 523), (3, 129, 64, 100)):
        q, k, v = (torch.randn((BH, S, hd), generator=g, device=card).to(torch.bfloat16) for _ in range(3))
        mask = torch.ones((BH, S), dtype=torch.int32, device=card)
        mask[:, valid:] = 0
        o, lse = tflash.flash_fwd(q, k, v, mask)
        op, lsep = tflash.flash_fwd_plain(q, k, v, mask)
        # bf16 out, different tiles: about one bf16 ulp
        assert float((o.float() - op.float())[:, :valid].abs().max()) <= 2e-2, (BH, S)
        assert float((lse - lsep)[:, :valid].abs().max()) <= 1e-3, (BH, S)
