"""The weight-only int8 product: the port's plain version and nn.linear's
"weight_only" mode against the JAX package's int8_matmul (its Pallas kernel
in interpret mode, as the JAX tests run it on the CPU) and nn.linear under
MLA_INT8_MODE=pallas; the int8 lm_head, which the port sends through the
same product in fp32, against JAX's lm_head_logits; the kernel's choice of
path and split of K; on a machine with a card, the kernel
(csrc/int8_mm.cu) against the plain version on both paths and at the
lm_head's shape."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu import nn as jnn
from mla_tpu.models import llama as jllama
from mla_tpu.ops import quantization as jq
from mla_tpu_torch import nn as tnn
from mla_tpu_torch.models import llama as tllama
from mla_tpu_torch.ops import cuda
from mla_tpu_torch.ops import quantization as tq


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), np.float32(2.0**-126))))
    return np.exp2(e - 7).astype(np.float32)


def _weights(K, N, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.04
    return jq.quantize_weight(jnp.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 5, 37])
def test_int8_matmul_plain_matches_jax(M, dtype, record_property):
    K, N = 256, 384  # N not a multiple of the JAX kernel's 256-column block
    pq = _weights(K, N, M)
    x = np.random.default_rng(M + 1).normal(size=(M, K)).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(jq.int8_matmul(xj, pq["w_q"], pq["w_scale"], interpret=True).astype(jnp.float32))
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tq.int8_matmul(xt, _t(pq["w_q"]), _t(pq["w_scale"]))
    assert got.dtype == xt.dtype and got.shape == (M, N)
    got = got.float().numpy()
    err = np.abs(got - want)
    record_property("max_abs_err", float(err.max()))
    if dtype == "float32":
        # exact products, fp32 sums in another order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        # the same fp32 value up to summation order, each rounded once to
        # bf16: at most one bf16 ulp apart
        assert (err <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all()


def test_int8_matmul_plain_is_the_dequantized_product():
    """y = (x @ float(w_q)) * w_scale, the scale after the dot."""
    pq = _weights(128, 128, 3)
    x = np.random.default_rng(4).normal(size=(3, 128)).astype(np.float32)
    want = (x.astype(np.float64) @ np.asarray(pq["w_q"], np.float64)) * np.asarray(pq["w_scale"], np.float64)
    got = tq.int8_matmul_plain(_t(x), _t(pq["w_q"]), _t(pq["w_scale"])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N,eligible", [(256, 384, True), (128, 96, False), (64, 128, False)])
def test_weight_only_linear_matches_jax_pallas(monkeypatch, K, N, eligible, dtype, record_property):
    """nn.linear(int8_mode='weight_only') against JAX nn.linear under
    MLA_INT8_MODE=pallas: an eligible leaf (K and N multiples of 128) takes
    the weight-only product, any other the dequantizing branch, on both
    sides."""
    monkeypatch.setenv("MLA_INT8_MODE", "pallas")
    pq = dict(_weights(K, N, K + N))
    pq["b"] = jnp.asarray(np.random.default_rng(1).normal(size=(N,)).astype(np.float32))
    x = np.random.default_rng(2).normal(size=(2, 7, K)).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(jnn.linear(pq, xj).astype(jnp.float32))

    calls = []
    real = tq.int8_matmul
    monkeypatch.setattr(tq, "int8_matmul", lambda *a: calls.append(1) or real(*a))
    pt = {k: _t(v) for k, v in pq.items()}
    got = tnn.linear(pt, _t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype)), int8_mode="weight_only")
    assert bool(calls) == eligible
    assert tnn.weight_only_eligible(pt) == eligible
    got = got.float().numpy()
    record_property("max_abs_err", float(np.abs(got - want).max()))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # bf16 rounds the product (and, on the dequant branch, the scaled
        # product and the bias sum): a few bf16 ulps of the output
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_int8_mode_is_checked():
    pq = {k: _t(v) for k, v in _weights(128, 128, 0).items()}
    with pytest.raises(ValueError, match="int8_mode"):
        tnn.linear(pq, torch.zeros(1, 128), int8_mode="pallas")


def test_cpu_int8_matmul_launches_nothing():
    cuda.launches.clear()
    pq = {k: _t(v) for k, v in _weights(128, 256, 1).items()}
    tnn.linear(pq, torch.randn(2, 128), int8_mode="weight_only")
    assert sum(cuda.launches.values()) == 0


@pytest.mark.parametrize("lead", [(1,), (4,), (2, 1)])
def test_int8_lm_head_matches_jax(monkeypatch, lead, record_property):
    """lm_head_logits on an int8 head: JAX's formula (hf @ float(w_q)) *
    w_scale in fp32, which the port runs through int8_matmul (a decode
    step's [B, 1, D] hidden state reshaped to rows and back)."""
    D, V = 128, 400  # V not a multiple of the kernel's 128-column strips
    head = _weights(D, V, 5)
    h = np.random.default_rng(6).normal(size=(*lead, D)).astype(np.float32)
    want = np.asarray(jllama.lm_head_logits({"lm_head": head}, jnp.asarray(h)))
    calls = []
    real = tq.int8_matmul
    monkeypatch.setattr(tq, "int8_matmul", lambda *a: calls.append(a[0].shape) or real(*a))
    got = tllama.lm_head_logits({"lm_head": {k: _t(v) for k, v in head.items()}}, _t(h))
    assert calls == [(int(np.prod(lead)), D)]
    assert got.dtype == torch.float32 and got.shape == (*lead, V)
    record_property("max_abs_err", float(np.abs(got.numpy() - want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_float_lm_head_is_unchanged():
    """A float head keeps its fp32 product and launches nothing."""
    w = np.random.default_rng(7).normal(size=(64, 96)).astype(np.float32)
    h = np.random.default_rng(8).normal(size=(3, 64)).astype(np.float32)
    cuda.launches.clear()
    got = tllama.lm_head_logits({"lm_head": {"w": _t(w)}}, _t(h))
    np.testing.assert_allclose(got.numpy(), h @ w, rtol=1e-5, atol=1e-5)
    assert sum(cuda.launches.values()) == 0


# the int8 mla-7b's four decoder linears (K, N) and its lm_head
LINEARS = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)]
LM_HEAD = (4096, 32064)
SMS = 132  # an H100 SXM


@pytest.mark.parametrize("M", [1, 3, 4, 5, 8, 9, 65, 535, 1070])
@pytest.mark.parametrize("K,N", LINEARS + [LM_HEAD])
def test_int8_mm_plan(M, K, N):
    plan = tq.int8_mm_plan(M, K, N, SMS, False)
    kt = -(-K // 64)
    assert plan.narrow == (M <= tq.INT8_NARROW_MAX_M)
    assert 1 <= plan.splits <= kt
    if plan.narrow:
        # the smallest row group of 1, 2, 4 or 8 that holds M (more rows take more groups)
        assert plan.rows == min(8, 1 << (M - 1).bit_length())
        cols = 256 if plan.rows <= 4 else 128
        assert plan.tiles == -(-N // cols) * -(-M // plan.rows)
        assert plan.splits == 1 or kt // plan.splits >= 4
        assert plan.part_floats == (plan.tiles * plan.splits * 1024 if plan.splits > 1 else 0)
    else:
        # as few 64-row blocks a tile (at most 3) as cover M in the fewest tiles
        mb = plan.rows // 64
        assert plan.rows % 64 == 0 and 1 <= mb <= 3
        assert -(-M // plan.rows) == -(-M // 192) and (mb == 1 or -(-M // (plan.rows - 64)) > -(-M // 192))
        assert plan.tiles == -(-M // plan.rows) * -(-N // 128)
        assert plan.splits <= 4 and (plan.splits == 1 or kt // plan.splits >= 8)
        assert plan.part_floats == (plan.tiles * plan.splits * plan.rows * 128 if plan.splits > 1 else 0)


def test_int8_mm_plan_splits_k_where_the_columns_are_few():
    """The N = 4096 products have 16 strips of 256 columns: K is split until
    the blocks fill the SMs (two blocks an SM at 1 row, one at 4); the wide
    q|k|v, gate|up and the lm_head take fewer splits; the AR prefill takes
    three 64-row blocks a tile (192 rows: 576 for 535, 1152 for 1070)."""
    assert tq.int8_mm_plan(1, 4096, 4096, SMS, False).splits == 16
    assert tq.int8_mm_plan(1, 11008, 4096, SMS, False).splits == 16
    assert tq.int8_mm_plan(4, 4096, 4096, SMS, False).splits == 8
    assert tq.int8_mm_plan(1, 4096, 12288, SMS, False).splits == 5
    assert tq.int8_mm_plan(1, 4096, 22016, SMS, False).splits == 3
    assert tq.int8_mm_plan(1, *LM_HEAD, SMS, True).splits == 2
    assert tq.int8_mm_plan(535, 4096, 22016, SMS, False)[:4] == (False, 192, 3 * 172, 1)
    assert tq.int8_mm_plan(1070, 4096, 12288, SMS, False)[:3] == (False, 192, 6 * 96)


@pytest.mark.parametrize("M", [1, 4, 9, 535])
def test_int8_mm_plan_fp32_takes_the_weight_stream(M):
    """fp32 x (the lm_head, fp32 models) always takes the CUDA-core path:
    the wgmma path multiplies bf16 only; more than 8 rows take row groups."""
    plan = tq.int8_mm_plan(M, *LM_HEAD, SMS, True)
    assert plan.narrow and plan.rows == min(8, 1 << (M - 1).bit_length())
    assert plan.tiles == -(-LM_HEAD[1] // (256 if plan.rows <= 4 else 128)) * -(-M // plan.rows)
    assert tq.int8_mm_plan(M, *LM_HEAD, SMS, True, False) == plan  # no wgmma for fp32


def test_int8_mm_plan_can_force_a_path():
    """chip_smoke.py times both paths around the line through a forced plan."""
    assert tq.int8_mm_plan(4, 4096, 4096, SMS, False, False).narrow is False
    assert tq.int8_mm_plan(16, 4096, 4096, SMS, False, True).narrow is True
    assert tq.int8_mm_plan(16, 4096, 4096, SMS, False, True).rows == 8


# --------------------------------------------------------------------------- #
# On the card: the kernel against its plain version
# --------------------------------------------------------------------------- #


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    cuda.build(("int8_mm",))
    return torch.device("cuda")


@pytest.mark.gpu
def test_int8_matmul_kernel_matches_plain_on_card(card):
    g = torch.Generator(device=card).manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for M, K, N in ((1, 4096, 4096), (4, 1024, 400), (18, 512, 1024), (535, 1024, 400)):
            x = torch.randn((M, K), generator=g, device=card).to(dtype)
            w_q = torch.randint(-127, 128, (K, N), generator=g, device=card, dtype=torch.int8)
            ws = torch.rand((N,), generator=g, device=card) * 1e-3 + 1e-4
            before = cuda.launches["int8_matmul"]
            y = tq.int8_matmul(x, w_q, ws)
            again = tq.int8_matmul(x, w_q, ws)
            yp = tq.int8_matmul_plain(x, w_q, ws)
            torch.cuda.synchronize()
            assert cuda.launches["int8_matmul"] == before + 2
            assert torch.equal(y, again), (dtype, M, K, N)
            # each column within one bf16 step (at most 2^-7 of a value) of
            # its own norm, norms floored at 1e-2 of the median (a one-row
            # column can cancel to ~0, where only the fp32 sum order is left,
            # ~1e-3 of the floor); fp32 x: the sums in another order
            n = yp.float().norm(dim=0)
            col = (y.float() - yp.float()).norm(dim=0) / n.clamp_min(1e-2 * float(n.median()))
            tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
            assert float(col.max()) <= tol, (dtype, M, K, N, float(col.max()))


@pytest.mark.gpu
def test_int8_lm_head_runs_the_kernel_on_card(card):
    """The int8 lm_head at the mla-7b's shape (fp32 hidden states, 1 and 4
    rows): one launch a call, each logit column within 1e-2 of its norm of
    the plain product's (fp32 sums in another order; a one-row column near
    the norm floor reads ~1e-4), bit-identical repeats."""
    g = torch.Generator(device=card).manual_seed(1)
    head = {"w_q": torch.randint(-127, 128, LM_HEAD, generator=g, device=card, dtype=torch.int8),
            "w_scale": torch.rand((1, LM_HEAD[1]), generator=g, device=card) * 1e-3 + 1e-4}
    for B in (1, 4):
        h = torch.randn((B, 1, LM_HEAD[0]), generator=g, device=card)
        before = cuda.launches["int8_matmul"]
        got = tllama.lm_head_logits({"lm_head": head}, h)
        again = tllama.lm_head_logits({"lm_head": head}, h)
        want = tq.int8_matmul_plain(h[:, 0], head["w_q"], head["w_scale"])
        torch.cuda.synchronize()
        assert cuda.launches["int8_matmul"] == before + 2
        assert got.shape == (B, 1, LM_HEAD[1]) and torch.equal(got, again)
        n = want.norm(dim=0)
        col = (got[:, 0] - want).norm(dim=0) / n.clamp_min(1e-2 * float(n.median()))
        assert float(col.max()) <= 1e-2, (B, float(col.max()))


@pytest.mark.gpu
def test_int8_matmul_kernel_paths_on_card(card):
    """bf16 on both paths, each forced on either side of the line (up to 4
    rows the weight stream, wgmma above), with split K, ragged K (1040 = 16 x
    65), ragged columns (400) and row tiles of 1 to 3 64-row blocks; fp32
    (the weight stream, row groups past 8 rows) at the mla-tiny head's K =
    64. Each column within 1e-2 of its norm (bf16: one bf16 step; fp32: the
    sums in another order, of which a one-row column near the norm floor
    reads ~1e-4), bit-identical repeats."""
    g = torch.Generator(device=card).manual_seed(2)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    cases = [(M, 4096, 4096, torch.bfloat16) for M in (1, 2, 3, 4, 5, 8, 9, 64, 65, 129, 193, 257, 535)]
    cases += [(3, 1040, 400, torch.bfloat16), (130, 1040, 400, torch.bfloat16), (1, 64, 32064, torch.float32),
              (9, 2048, 1024, torch.float32)]
    for M, K, N, dtype in cases:
        x = torch.randn((M, K), generator=g, device=card).to(dtype)
        w_q = torch.randint(-127, 128, (K, N), generator=g, device=card, dtype=torch.int8)
        ws = torch.rand((N,), generator=g, device=card) * 1e-3 + 1e-4
        yp = tq.int8_matmul_plain(x, w_q, ws)
        n = yp.float().norm(dim=0)
        for narrow in ((None,) if dtype == torch.float32 else (None, True, False)):
            plan = tq.int8_mm_plan(M, K, N, sms, dtype == torch.float32, narrow)
            y, again = torch.empty_like(yp), torch.empty_like(yp)
            tq.int8_mm_launch(x, w_q, ws, y, plan)
            tq.int8_mm_launch(x, w_q, ws, again, plan)
            torch.cuda.synchronize()
            assert torch.equal(y, again), (M, K, N, plan)
            col = (y.float() - yp.float()).norm(dim=0) / n.clamp_min(1e-2 * float(n.median()))
            assert float(col.max()) <= 1e-2, (M, K, N, plan, float(col.max()))
