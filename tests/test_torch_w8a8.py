"""The W8A8 serving layout of the port: the K-major weight copy that the
serving tree builds for csrc/w8a8.cu, the kernel's choice of path and split
of K, and the build's staleness rule for the headers the kernels share.

JAX keeps w_q [K, N]; the port's W8A8 reads w_qt [N, K] (the card's int8
tensor cores take both operands K-major). Through that leaf the plain
version must give JAX's w8a8_matmul (Pallas in interpret mode): the int32
accumulators exactly, the output within test_torch_kernels' tolerance."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu.models import llama as jllama
from mla_tpu.ops import quantization as jq
from mla_tpu_torch import nn as tnn
from mla_tpu_torch.models import llama as tllama
from mla_tpu_torch.ops import cuda
from mla_tpu_torch.ops import quantization as tq
from mla_tpu_torch.params import from_jax

# the int8 mla-7b's four decoder linears (K, N): q|k|v, o, gate|up, down
LINEARS = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)]
SMS = 132  # an H100 SXM


def _exact(x, w_q):
    sx = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-8).astype(np.float32) / np.float32(127.0)
    xq = np.clip(np.round(x / sx), -127, 127).astype(np.int64)
    return xq @ w_q.astype(np.int64)


@pytest.fixture(scope="module")
def trees():
    """A small llama quantized by JAX, the JAX serving fusion of it, the
    port's W8A8 serving tree of the same leaves and the port's default one."""
    cfg = jllama.LlamaConfig(vocab_size=128, hidden_size=128, intermediate_size=192, num_layers=2, num_heads=4,
                             num_kv_heads=2, max_position_embeddings=64, contrastive_layer=1,
                             compute_dtype=jnp.float32)
    jp = jq.quantize_llama(jllama.llama_init(jax.random.PRNGKey(3), cfg))
    return (jllama.fuse_for_serving(jp), tllama.fuse_for_serving(from_jax(jp), k_major=True),
            tllama.fuse_for_serving(from_jax(jp)))


@pytest.mark.parametrize("group,leaf", [("attn", "qkv_fused"), ("attn", "o"), ("mlp", "gateup_fused"),
                                        ("mlp", "down")])
def test_k_major_serving_leaf_matches_pallas(trees, group, leaf, record_property):
    jtree, ttree, _ = trees
    jleaf, tleaf = jtree["layers"][group][leaf], ttree["layers"][group][leaf]
    for layer in range(2):
        w_q = np.asarray(jleaf["w_q"][layer])
        w_qt = tleaf["w_qt"][layer]
        assert w_qt.is_contiguous() and w_qt.dtype == torch.int8
        np.testing.assert_array_equal(w_qt.numpy(), w_q.T)
        K = w_q.shape[0]
        x = np.random.default_rng(layer).normal(size=(19, K)).astype(np.float32)
        y, acc = tq.w8a8_matmul(torch.from_numpy(x), w_qt, tleaf["w_scale"][layer], return_acc=True)
        np.testing.assert_array_equal(acc.numpy(), _exact(x, w_q))
        y_jax = np.asarray(jq.w8a8_matmul(jnp.asarray(x), jleaf["w_q"][layer], jleaf["w_scale"][layer],
                                          interpret=True))
        record_property("max_abs_err", float(np.abs(y.numpy() - y_jax).max()))
        np.testing.assert_allclose(y.numpy(), y_jax, rtol=3e-7, atol=1e-7)
        # nn.linear reads the same leaf in the W8A8 mode
        lin = tnn.linear({k: v[layer] for k, v in tleaf.items()}, torch.from_numpy(x), int8_mode="w8a8")
        np.testing.assert_array_equal(lin.numpy(), y.numpy())


def test_k_major_tree_keeps_jax_layout_where_other_modes_read_it(trees):
    _, ttree, _ = trees
    attn, mlp = ttree["layers"]["attn"], ttree["layers"]["mlp"]
    # the fused leaves hold only the K-major copy; o and down keep w_q beside it
    assert set(attn["qkv_fused"]) == {"w_qt", "w_scale"} and set(mlp["gateup_fused"]) == {"w_qt", "w_scale"}
    assert {"w_q", "w_qt"} <= set(attn["o"]) and {"w_q", "w_qt"} <= set(mlp["down"])
    x = torch.randn(3, attn["qkv_fused"]["w_qt"].shape[-1])
    with pytest.raises(ValueError, match="K-major"):
        tnn.linear({k: v[0] for k, v in attn["qkv_fused"].items()}, x, int8_mode="weight_only")


def test_default_serving_tree_is_unchanged(trees):
    jtree, _, plain = trees
    for group, leaf in (("attn", "qkv_fused"), ("mlp", "gateup_fused")):
        assert "w_qt" not in plain["layers"][group][leaf]
        np.testing.assert_array_equal(plain["layers"][group][leaf]["w_q"].numpy(),
                                      np.asarray(jtree["layers"][group][leaf]["w_q"]))


@pytest.mark.parametrize("M", [1, 18, 64, 65, 534])
@pytest.mark.parametrize("K,N", LINEARS)
def test_w8a8_plan(M, K, N):
    plan = tq.w8a8_plan(M, K, N, SMS)
    kt = -(-K // 128)
    assert plan.narrow == (M <= tq.W8A8_NARROW_MAX_M)
    assert 1 <= plan.splits and (plan.splits == 1 or kt // plan.splits >= 4)
    if plan.narrow:
        assert plan.tiles == N // 64
        # every block resident at once: three narrow blocks an SM
        assert plan.tiles * plan.splits <= 3 * SMS or plan.splits == 1
        regs = 16 if M <= 32 else 32
        assert plan.part_ints == (plan.tiles * plan.splits * 128 * regs if plan.splits > 1 else 0)
    else:
        assert plan.tiles == -(-M // 128) * -(-N // 128)
        assert plan.part_ints == (plan.tiles * plan.splits * 256 * 64 if plan.splits > 1 else 0)


def test_w8a8_plan_splits_the_narrow_n4096_products():
    """The o and down products have 64 narrow tiles: K is split until the
    blocks fill the SMs; the wide q|k|v and gate|up keep one block a tile."""
    assert tq.w8a8_plan(18, 4096, 4096, SMS).splits == 6
    assert tq.w8a8_plan(18, 11008, 4096, SMS).splits == 6
    assert tq.w8a8_plan(18, 4096, 12288, SMS).splits == 2
    assert tq.w8a8_plan(534, 4096, 12288, SMS).splits == 1
    assert tq.w8a8_plan(534, 4096, 22016, SMS).splits == 1
    assert tq.w8a8_plan(534, 11008, 4096, SMS).splits > 1


def test_w8a8_cpu_takes_jax_leaves_through_a_view():
    """A leaf without the K-major copy (a tree not built for serving) still
    runs the plain version on the CPU, through a transposed view of w_q."""
    w = torch.randn(64, 128) * 0.05
    p = tq.quantize_weight(w)
    x = torch.randn(5, 64)
    got = tq.w8a8_linear(p, x)
    want = tq.w8a8_matmul_plain(x, p["w_q"].t().contiguous(), p["w_scale"])
    assert torch.equal(got, want)


def _touch(path, t):
    path.write_text("//\n")
    os.utime(path, (t, t))


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(cuda, "CSRC", csrc)
    monkeypatch.setattr(cuda, "BUILD_DIR", build)
    _touch(csrc / "k.cu", 1000)
    _touch(csrc / "hopper.cuh", 1000)
    return csrc, build


def test_stale_when_missing(tree):
    assert cuda._stale("k")


def test_fresh_library_is_not_stale(tree):
    _, build = tree
    _touch(build / "libk.so", 2000)
    assert not cuda._stale("k")


@pytest.mark.parametrize("newer", ["k.cu", "hopper.cuh", "another.cuh"])
def test_stale_when_a_source_or_header_is_newer(tree, newer):
    csrc, build = tree
    _touch(build / "libk.so", 2000)
    _touch(csrc / newer, 3000)
    assert cuda._stale("k")
