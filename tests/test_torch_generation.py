"""The post-training modules of the port against the JAX package's, one by
one, in fp32 on mla-tiny's generation config: Chamfer distances,
cross-attention, the decoder layer and the point head's block, the patch
utilities (the warp with offsets that clamp at both borders, the ROI
dilation, the ROI scatter of clamped invalid points), the three heads (the
point head in training, with its batch-norm state and with a current cloud
through FPS at start 0), the generation losses and the tactile contrastive
loss. The same weights (JAX's init, carried across with from_jax) and the
same seeded numpy inputs; outputs within rtol 1e-5 / atol 1e-6. The port's
dropout is held to its definition (the two PRNGs cannot match), and
params.init's draws of the heads to the JAX init's distributions."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu import nn as jnn
from mla_tpu.conf.models import get_model_config as jconfig
from mla_tpu.models import contrastive as jcon
from mla_tpu.models import generation as jgen
from mla_tpu.ops import chamfer as jchamfer
from mla_tpu.ops import projection as jproj
from mla_tpu_torch import nn as tnn
from mla_tpu_torch.conf.models import get_model_config as tconfig
from mla_tpu_torch.models import contrastive as tcon
from mla_tpu_torch.models import generation as tgen
from mla_tpu_torch.ops import chamfer as tchamfer
from mla_tpu_torch.params import from_jax, tree_items

RTOL, ATOL = 1e-5, 1e-6
FLAGS = dict(use_generation=True, use_tactile=True, use_roi=True)


def close(got, want, what=""):
    np.testing.assert_allclose(torch.as_tensor(got).detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def t(a):
    return torch.from_numpy(np.array(a))


def rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def heads():
    """JAX's generation heads on mla-tiny (every head on) and the port's copy."""
    cfg = jconfig("mla-tiny", **FLAGS).gen
    params, state = jgen.generation_manager_init(jax.random.PRNGKey(3), cfg)
    return cfg, params, state, from_jax(params), from_jax(state)


@pytest.mark.parametrize("kind", ["l2", "sq"])
def test_chamfer_matches_jax(kind):
    fn_j, fn_t = ((jchamfer.chamfer_distance_l2, tchamfer.chamfer_distance_l2) if kind == "l2"
                  else (jchamfer.chamfer_distance_sq, tchamfer.chamfer_distance_sq))
    pred, gt = rnd(0, 2, 32, 3), rnd(1, 2, 64, 3)
    want, want_grad = jax.value_and_grad(fn_j)(jnp.asarray(pred), jnp.asarray(gt))
    p = t(pred).requires_grad_(True)
    got = fn_t(p, t(gt))
    got.backward()
    close(got, want, "value")
    close(p.grad, want_grad, "d/dpred")


@pytest.mark.parametrize("kv", [None, "float32", "bfloat16"], ids=["self", "cross", "cross-bf16-memory"])
def test_mha_matches_jax(kv):
    """Self-attention, and cross-attention through the slices of the packed
    qkv weight; a bf16 memory meets fp32 weights, and both packages then
    compute k and v in fp32."""
    p = jnn.mha_init(jax.random.PRNGKey(0), 64, 4)
    x = rnd(2, 2, 5, 64)
    mem = None if kv is None else rnd(3, 2, 7, 64)
    jmem = None if mem is None else jnp.asarray(mem, getattr(jnp, kv))
    want = jnn.mha(p, jnp.asarray(x), 4, kv=jmem)
    tmem = None if mem is None else torch.from_numpy(np.array(jmem.astype(jnp.float32))).to(getattr(torch, kv))
    got = tnn.mha(from_jax(p), t(x), 4, kv=tmem)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    close(got, want)


def test_decoder_layer_matches_jax():
    p = jgen.decoder_layer_init(jax.random.PRNGKey(1), 64, 128)
    tgt, mem = rnd(4, 2, 4, 64), rnd(5, 2, 9, 64)
    want = jgen.decoder_layer(p, jnp.asarray(tgt), jnp.asarray(mem), 4)
    close(tgen.decoder_layer(from_jax(p), t(tgt), t(mem), 4), want)


def test_pc_block_matches_jax():
    p = jgen.pc_block_init(jax.random.PRNGKey(2), 32)
    x, pos = rnd(6, 2, 8, 32), rnd(7, 1, 8, 32, scale=0.02)
    want = jgen.pc_block(p, jnp.asarray(x), jnp.asarray(pos), 4)
    close(tgen.pc_block(from_jax(p), t(x), t(pos), 4), want)


def test_patch_round_trip_matches_jax():
    img = rnd(8, 2, 3, 168, 168)
    want = jgen.images_to_patches(jnp.asarray(img), 42)
    got = tgen.images_to_patches(t(img), 42)
    assert got.shape == (2, 16, 3 * 42 * 42)
    close(got, want)
    close(tgen.patches_to_images(got, 42), jgen.patches_to_images(want, 42))
    assert torch.equal(tgen.patches_to_images(got, 42), t(img))


def test_translate_patches_matches_jax():
    """Fractional, negative and beyond-the-patch offsets (|offset| > 8 px,
    past a 6-px patch): both clamps fire."""
    patches = rnd(9, 6, 3, 6, 6)
    offsets = np.array([[0.25, -0.5], [-1.75, 2.5], [9.5, -12.25], [-8.0, 0.0], [3.3, 7.9], [-0.01, 0.99]],
                       np.float32)
    want = jgen.translate_patches(jnp.asarray(patches), jnp.asarray(offsets))
    close(tgen.translate_patches(t(patches), t(offsets)), want)
    # an offset past the border copies the edge row / column
    np.testing.assert_array_equal(np.asarray(want)[2, :, :, :], np.asarray(want)[2, :, :, :1].repeat(6, -1))


@pytest.mark.parametrize("k", [3, 5])
def test_dilate_mask_matches_jax(k):
    mask = np.random.default_rng(10).random((3, 16, 16)) < 0.08
    want = jgen.dilate_mask(jnp.asarray(mask), k)
    got = tgen.dilate_mask(t(mask), k)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_roi_mask_scatters_clamped_invalid_points():
    """Every point lands on the grid, the invalid ones on their clamped
    edge patches (no filtering by validity)."""
    xyz = np.random.default_rng(11).uniform([-1.5, -1.5, 0.2], [1.5, 1.5, 2.0], size=(2, 64, 3)).astype(np.float32)
    idx, valid = jproj.project_3d_to_2d(jnp.asarray(xyz), jproj.get_camera_params("rlbench_front"), (672, 672), 14, 3)
    assert not bool(np.asarray(valid).all()) and bool(np.asarray(valid).any())
    want = np.asarray(jgen.create_roi_mask_from_indices(idx, 16))
    got = tgen.create_roi_mask_from_indices(t(idx), 16)
    np.testing.assert_array_equal(got.numpy(), want)
    only_valid = np.zeros_like(want)
    for b in range(2):
        for (y, x), v in zip(np.asarray(idx)[b], np.asarray(valid)[b]):
            only_valid[b, y, x] |= bool(v)
    assert (want & ~only_valid).any(), "no invalid point reached the mask"


@pytest.mark.parametrize("use_roi", [True, False], ids=["roi", "no-roi"])
def test_image_gen_forward_matches_jax(heads, use_roi):
    cfg, jp, _, tp, _ = heads
    icfg = replace(cfg.image, use_roi=use_roi, dropout=0.0)
    hidden, feats = rnd(12, 2, 10, 64), rnd(13, 2, 16, 64)
    patches = rnd(14, 2, 16, icfg.patch_dim)
    roi = np.random.default_rng(15).random((2, 4, 4)) < 0.2
    want = jgen.image_gen_forward(jp["image_gen_module"], icfg, jnp.asarray(hidden), jnp.asarray(feats),
                                  jnp.asarray(patches), jnp.asarray(roi))
    got = tgen.image_gen_forward(tp["image_gen_module"], icfg, t(hidden), t(feats), t(patches), t(roi))
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], k)
    # the offsets reach the warp: some patches move by a fraction of a pixel
    assert float(got["offset_all"].abs().max()) > 0


def test_point_gen_forward_matches_jax(heads):
    """Training mode (batch statistics, the moved pred_bn state), without
    and with a current cloud (its FPS centers from start 0)."""
    cfg, jp, js, tp, ts = heads
    pcfg = replace(cfg.point, dropout=0.0)
    hidden, cloud = rnd(16, 2, 10, 64), rnd(17, 2, 64, 3)
    for pc in (None, cloud):
        want, wstate = jgen.point_gen_forward(jp["pointcloud_gen_module"], js["pointcloud_gen_module"], pcfg,
                                              jnp.asarray(hidden), None if pc is None else jnp.asarray(pc),
                                              training=True)
        got, gstate = tgen.point_gen_forward(tp["pointcloud_gen_module"], ts["pointcloud_gen_module"], pcfg,
                                             t(hidden), None if pc is None else t(pc), training=True)
        close(got["pointcloud_coord_generation"], want["pointcloud_coord_generation"])
        for path, leaf in tree_items(from_jax(jax.device_get(wstate))):
            close(dict(tree_items(gstate))[path], leaf, path)
    assert not torch.equal(gstate["pred_bn"]["mean"], ts["pointcloud_gen_module"]["pred_bn"]["mean"])


def test_tactile_gen_forward_matches_jax(heads):
    cfg, jp, _, tp, _ = heads
    tcfg = replace(cfg.tactile, dropout=0.0)
    hidden = rnd(18, 2, 10, 64)
    want = jgen.tactile_gen_forward(jp["tactile_gen_module"], tcfg, jnp.asarray(hidden))
    got = tgen.tactile_gen_forward(tp["tactile_gen_module"], tcfg, t(hidden))
    assert got["tactile_generation"].shape == (2, 12)
    close(got["tactile_generation"], want["tactile_generation"])


def test_generation_losses_match_jax(heads):
    """The manager's outputs and every loss term, the ROI and background
    masked means included."""
    cfg, jp, js, tp, ts = heads
    cfg = replace(cfg, image=replace(cfg.image, dropout=0.0), point=replace(cfg.point, dropout=0.0),
                  tactile=replace(cfg.tactile, dropout=0.0))
    hidden, feats = rnd(19, 2, 10, 64), rnd(20, 2, 16, 64)
    img = rnd(21, 2, 3, 168, 168)
    patches = np.asarray(jgen.images_to_patches(jnp.asarray(img), 42))
    roi = np.random.default_rng(22).random((2, 4, 4)) < 0.3
    targets = {"next_images": rnd(23, 2, 3, 168, 168), "next_point_cloud": rnd(24, 2, 64, 3),
               "next_tactile": rnd(25, 2, 12)}
    jouts, _ = jgen.generation_manager_forward(jp, js, cfg, jnp.asarray(hidden), jnp.asarray(feats),
                                               jnp.asarray(patches), None, jnp.asarray(roi), training=True)
    want = jgen.compute_generation_losses(cfg, jouts, **{k: jnp.asarray(v) for k, v in targets.items()})
    touts, _ = tgen.generation_manager_forward(tp, ts, cfg, t(hidden), t(feats), t(patches), None, t(roi),
                                               training=True)
    got = tgen.compute_generation_losses(cfg, touts, **{k: t(v) for k, v in targets.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], k)
    assert float(want["delta_magnitude_reward"]) < 0 < float(want["bg_consistency_loss"])


def test_tactile_contrastive_loss_matches_jax():
    p = jcon.tactile_contrastive_init(jax.random.PRNGKey(4), 64)
    tac, pc, img = rnd(26, 3, 1, 64), rnd(27, 3, 16, 64), rnd(28, 3, 16, 64)
    pos_pc = np.array([[[3]], [[0]], [[15]]], np.int32)
    pos_img = np.array([[[7]], [[15]], [[1]]], np.int32)
    want = jcon.tactile_contrastive_loss(p, *(jnp.asarray(a) for a in (tac, pc, img, pos_pc, pos_img)))
    got = tcon.tactile_contrastive_loss(from_jax(p), *(t(a) for a in (tac, pc, img, pos_pc, pos_img)))
    close(got, want)


def test_dropout_keeps_and_scales():
    """Kept share ~ 0.9, kept entries x / 0.9, dropped entries exactly 0;
    no draw and no change without a generator or at rate 0."""
    x = torch.from_numpy(rnd(29, 200, 500)) + 3.0
    y = tgen._dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    share = float(kept.float().mean())
    assert abs(share - 0.9) < 0.005, share
    assert torch.equal(y[kept], x[kept] / 0.9)
    assert torch.equal(y[~kept], torch.zeros_like(y[~kept]))
    assert tgen._dropout(x, 0.1, None) is x
    assert tgen._dropout(x, 0.0, torch.Generator().manual_seed(0)) is x
    again = tgen._dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert torch.equal(again, y)



def test_init_draws_the_jax_distributions():
    """params.init's heads: the truncated normals (timm's, cut at 2 std) of
    the point head, the normal queries, the small offset head and the
    alpha bias of -3, against the JAX init's leaves of the same shape."""
    from mla_tpu.models import prismatic as jprismatic
    from mla_tpu_torch import params as tparams

    jp, _ = jprismatic.mla_model_init(jax.random.PRNGKey(0), jconfig("mla-tiny", **FLAGS))
    tp, _ = tparams.init(tconfig("mla-tiny", **FLAGS), seed=0, device="cpu")
    want, got = dict(tree_items(from_jax(jp["generation_manager"]))), dict(tree_items(tp["generation_manager"]))
    for path in ("pointcloud_gen_module/seq_to_patch/w", "pointcloud_gen_module/pos_embed",
                 "image_gen_module/mae_pos_embed", "image_gen_module/mae_offset_head/w",
                 "tactile_gen_module/decoder/0/linear1/w"):
        w, g = want[path], got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        np.testing.assert_allclose(float(g.std()), float(w.std()), rtol=0.1, err_msg=path)
        np.testing.assert_allclose(float(g.abs().max()), float(w.abs().max()), rtol=0.15, err_msg=path)
    cut = float(want["pointcloud_gen_module/seq_to_patch/w"].abs().max())
    assert cut <= 0.04 and float(got["pointcloud_gen_module/seq_to_patch/w"].abs().max()) <= 0.04
    assert torch.equal(got["image_gen_module/mae_alpha_head/b"], want["image_gen_module/mae_alpha_head/b"])
