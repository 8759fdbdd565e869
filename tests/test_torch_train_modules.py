"""The modules of the training slice, each against its JAX counterpart on
the same inputs from numpy seeds, in fp32: training-mode batch norm, the
camera projection, the coordinate contrastive loss (value and gradients),
the static splice map, the point tokenizer in training mode with the FPS
starts the JAX run draws, the label embedder, q_sample and the MFU
accounting. fp32 tolerances (rtol 1e-5 for values, 1e-4 / atol 1e-6 for
gradients) cover the frameworks' different summation orders; indices and
masks must be identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu import nn as jnn
from mla_tpu.conf.models import get_model_config as jconfig
from mla_tpu.diffusion import gaussian as jgd
from mla_tpu.models import contrastive as jcon
from mla_tpu.models import embedders as jemb
from mla_tpu.models import point_tokenizer as jpt
from mla_tpu.models import prismatic as jprismatic
from mla_tpu.ops import projection as jproj
from mla_tpu.training import metrics as jmetrics
from mla_tpu_torch import nn as tnn
from mla_tpu_torch.conf.models import get_model_config as tconfig
from mla_tpu_torch.diffusion import gaussian as tgd
from mla_tpu_torch.models import contrastive as tcon
from mla_tpu_torch.models import embedders as temb
from mla_tpu_torch.models import point_tokenizer as tpt
from mla_tpu_torch.models import prismatic as tprismatic
from mla_tpu_torch.ops import projection as tproj
from mla_tpu_torch.params import from_jax, tree_items
from mla_tpu_torch.training import metrics as tmetrics


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_trees(got, want, rtol, atol):
    want = dict(tree_items(want))
    for path, leaf in tree_items(got):
        np.testing.assert_allclose(leaf.detach().numpy(), want[path].numpy(), rtol=rtol, atol=atol, err_msg=path)


def test_batch_norm_training_matches_jax(record_property):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 7, 16)) * 2 + 0.5).astype(np.float32)
    p = {"scale": rng.normal(size=16).astype(np.float32), "bias": rng.normal(size=16).astype(np.float32)}
    s = {"mean": rng.normal(size=16).astype(np.float32), "var": rng.uniform(0.5, 2, size=16).astype(np.float32)}
    jy, js = jnn.batch_norm(jax.tree_util.tree_map(jnp.asarray, p), jax.tree_util.tree_map(jnp.asarray, s),
                            jnp.asarray(x), training=True)
    xt = _t(x).requires_grad_(True)
    ty, ts = tnn.batch_norm(from_jax(p), from_jax(s), xt, training=True)
    record_property("max_abs_err_y", float(np.abs(ty.detach().numpy() - np.asarray(jy)).max()))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-5, atol=1e-6, err_msg=k)
        assert not ts[k].requires_grad, "the running state must stay out of the autograd graph"
    jg = jax.grad(lambda x: jnp.sum(jnn.batch_norm(jax.tree_util.tree_map(jnp.asarray, p),
                                                   jax.tree_util.tree_map(jnp.asarray, s), x, True)[0] ** 3))(jnp.asarray(x))
    (ty**3).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("camera", ["rlbench_front", "franka_right", "franka_front"])
def test_project_3d_to_2d_matches_jax(camera):
    rng = np.random.default_rng(len(camera))
    # world points around each camera's workspace, some behind or outside it
    pts = rng.uniform([-1.0, -1.0, -0.5], [2.0, 1.0, 2.5], size=(2, 300, 3)).astype(np.float32)
    jidx, jvalid = jproj.project_3d_to_2d(jnp.asarray(pts), jproj.get_camera_params(camera))
    tidx, tvalid = tproj.project_3d_to_2d(_t(pts), tproj.get_camera_params(camera))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert 0 < int(tvalid.sum()) < tvalid.numel()


def test_coordinate_contrastive_loss_matches_jax(record_property):
    rng = np.random.default_rng(1)
    B, N, D = 2, 16, 24
    params = jcon.coordinate_contrastive_init(jax.random.PRNGKey(3), D, projection_dim=8)
    img = rng.normal(size=(B, N, D)).astype(np.float32)
    pc = rng.normal(size=(B, N, D)).astype(np.float32)
    idx = rng.integers(0, 4, size=(B, N, 2)).astype(np.int32)
    valid = rng.uniform(size=(B, N)) < 0.7

    def jloss(p, i, q):
        return jcon.coordinate_contrastive_loss(p, i, q, jnp.asarray(idx), jnp.asarray(valid))

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(params, jnp.asarray(img), jnp.asarray(pc))
    tp = from_jax(params)
    leaves = [leaf.requires_grad_(True) for _, leaf in tree_items(tp)]
    ti, tq = _t(img).requires_grad_(True), _t(pc).requires_grad_(True)
    tval = tcon.coordinate_contrastive_loss(tp, ti, tq, _t(idx), _t(valid))
    tval.backward()
    record_property("rel_err_loss", abs(float(tval) / float(jval) - 1))
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-5)
    jp = dict(tree_items(from_jax(jax.device_get(jgrads[0]))))
    for (path, _), leaf in zip(tree_items(tp), leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), jp[path].numpy(), rtol=1e-4, atol=1e-6, err_msg=path)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(jgrads[1]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jgrads[2]), rtol=1e-4, atol=1e-6)
    none_valid = tcon.coordinate_contrastive_loss(tp, ti, tq, _t(idx), torch.zeros((B, N), dtype=torch.bool))
    assert float(none_valid) == 0.0


def test_build_splice_map_matches_jax():
    splice = np.array([3, 9, 14, 15], np.int32)
    for L, F, d in ((16, 10, 18), (16, 10, 0)):
        want = np.asarray(jprismatic.build_splice_map(L, F, d, jnp.asarray(splice)))
        got = tprismatic.build_splice_map(L, F, d, _t(splice))
        np.testing.assert_array_equal(got.numpy(), want)
        src = np.random.default_rng(2).normal(size=(4, L + F + d, 5)).astype(np.float32)
        np.testing.assert_array_equal(tprismatic._gather_seq(_t(src), got).numpy(),
                                      np.asarray(jprismatic._gather_seq(jnp.asarray(src), jnp.asarray(want))))


def test_point_tokenizer_training_matches_jax(record_property):
    """Training mode: batch statistics, the moved running state, and FPS
    from the starts the JAX run draws (fold_in(key, stage) -> randint)."""
    jc, tc = jconfig("mla-tiny").point, tconfig("mla-tiny").point
    params, state = jpt.point_tokenizer_init(jax.random.PRNGKey(4), jc)
    pc = np.random.default_rng(5).uniform(-0.5, 0.5, size=(3, jc.input_points, 3)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    jtok, jcen, jstate = jpt.point_tokenizer(params, state, jnp.asarray(pc), jc, training=True, fps_key=key)
    starts = [_t(jax.random.randint(jax.random.fold_in(key, si), (3,), 0, jc.input_points >> si, dtype=jnp.int32))
              for si in range(jc.num_stages)]
    assert any(int(s.max()) > 0 for s in starts)
    ttok, tcen, tstate = tpt.point_tokenizer(from_jax(params), from_jax(state), _t(pc), tc, training=True,
                                             fps_start=starts)
    np.testing.assert_array_equal(tcen.numpy(), np.asarray(jcen))
    record_property("max_abs_err_tokens", float(np.abs(ttok.numpy() - np.asarray(jtok)).max()))
    np.testing.assert_allclose(ttok.numpy(), np.asarray(jtok), rtol=1e-4, atol=1e-5)
    _close_trees(tstate, from_jax(jax.device_get(jstate)), rtol=1e-5, atol=1e-6)


def test_label_embedder_dropout():
    """force_drop_ids as in JAX; training dropout replaces exactly the rows
    whose generator draw falls under the probability; no drop in eval."""
    rng = np.random.default_rng(7)
    cond = rng.normal(size=(6, 3, 8)).astype(np.float32)
    p = {"uncondition": rng.normal(size=(1, 8)).astype(np.float32)}
    ids = np.array([1, 0, 0, 1, 0, 1], np.int32)
    want = jemb.label_embedder(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(cond), force_drop_ids=jnp.asarray(ids))
    np.testing.assert_array_equal(temb.label_embedder(from_jax(p), _t(cond), force_drop_ids=_t(ids)).numpy(), np.asarray(want))
    g = torch.Generator().manual_seed(8)
    got = temb.label_embedder(from_jax(p), _t(cond), dropout_prob=0.5, training=True, generator=g)
    drop = torch.rand((6,), generator=torch.Generator().manual_seed(8)) < 0.5
    for b in range(6):
        np.testing.assert_array_equal(got[b].numpy(), np.broadcast_to(p["uncondition"], (3, 8)) if drop[b] else cond[b])
    assert torch.equal(temb.label_embedder(from_jax(p), _t(cond), dropout_prob=0.5, training=False), _t(cond))


def test_q_sample_and_flops_match_jax():
    rng = np.random.default_rng(9)
    x0, noise = rng.normal(size=(2, 5, 16, 7)).astype(np.float32)
    t = np.array([0, 37, 61, 99, 3], np.int32)
    want = jgd.q_sample(jgd.create_schedule("", diffusion_steps=100), jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = tgd.q_sample(tgd.create_schedule("", diffusion_steps=100), _t(x0), _t(t), _t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    params, _ = jprismatic.mla_model_init(jax.random.PRNGKey(0), jconfig("mla-tiny"))
    for use_diff in (True, False):
        assert tmetrics.decoder_flops_per_token(from_jax(params["llm_backbone"]), use_diff) == \
            jmetrics.decoder_flops_per_token(params["llm_backbone"], use_diff)
    assert tmetrics.bf16_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert tmetrics.bf16_peak_flops("NVIDIA H100 PCIe") == 756e12
