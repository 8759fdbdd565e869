"""The weight-only int8 product: the port's plain version and nn.linear's
"weight_only" mode against the JAX package's int8_matmul (its Pallas kernel
in interpret mode, as the JAX tests run it on the CPU) and nn.linear under
MLA_INT8_MODE=pallas; on a machine with a card, the kernel
(csrc/int8_mm.cu) against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu import nn as jnn
from mla_tpu.ops import quantization as jq
from mla_tpu_torch import nn as tnn
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
