"""The port's legacy ViT towers (models/vision_backbones.py) against the JAX
package's: the registries, convert_timm_vit bit for bit, vit_forward and
fused_vit_forward on converted weights in fp32 within rtol 1e-4 / atol
1e-5 (each token layout: CLIP's cls token, pre-norm and quick GELU,
SigLIP's no-cls, DINOv2's registers, no_embed_class and LayerScale; a
patch size that leaves pixels unread), vit_init's tree, and
vit_image_transform exactly (the port's Pillow-exact bicubic against
Pillow)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu.models import vision_backbones as jvb
from mla_tpu_torch import params as P
from mla_tpu_torch.models import vision_backbones as tvb
from test_torch_hf_load import assert_same_tree, timm_vit_sd

VARIANTS = {
    "clip": dict(use_quick_gelu=True, pre_norm=True),
    "siglip": dict(use_cls_token=False, mlp_ratio=2.0),
    "dinov2": dict(num_reg_tokens=4, no_embed_class=True, use_layerscale=True),
    "floor": dict(image_size=32, patch_size=7),  # 32 // 7 = 4: the last 4 px unread
}


def configs(name):
    kw = dict(image_size=28, patch_size=7, width=32, depth=3, num_heads=4, mlp_ratio=2.0)
    kw.update(VARIANTS[name])
    return jvb.ViTConfig(**kw), tvb.ViTConfig(**kw)


def test_registries_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in tvb.VIT_CONFIGS.items()} == {
        k: dataclasses.asdict(v) for k, v in jvb.VIT_CONFIGS.items()}
    assert tvb.FUSED_BACKBONES == jvb.FUSED_BACKBONES
    for fused, (a, b) in tvb.FUSED_BACKBONES.items():
        assert tvb.VIT_CONFIGS[a].num_patches == tvb.VIT_CONFIGS[b].num_patches, fused


def _pair(name, seed=0):
    """(jcfg, tcfg, JAX tree, port tree) from one timm state dict."""
    jcfg, tcfg = configs(name)
    sd = timm_vit_sd(jcfg, jcfg.width, seed)
    return jcfg, tcfg, jvb.convert_timm_vit(sd, jcfg), tvb.convert_timm_vit(sd, tcfg)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_convert_timm_vit_matches_jax(name):
    _, _, jp, tp = _pair(name)
    assert_same_tree(tp, jp)


@pytest.mark.parametrize("feature_layer", [-2, -1, 0])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_vit_forward_matches_jax(name, feature_layer):
    jcfg, tcfg, jp, tp = _pair(name, seed=1)
    images = np.random.default_rng(2).normal(size=(2, 3, jcfg.image_size, jcfg.image_size)).astype(np.float32)
    want = np.asarray(jvb.vit_forward(jp, jcfg, jnp.asarray(images), feature_layer=feature_layer))
    got = tvb.vit_forward(tp, tcfg, torch.from_numpy(images), feature_layer=feature_layer)
    assert got.shape == (2, tcfg.num_patches, tcfg.width)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_fused_vit_forward_matches_jax():
    """Two towers on their own views, dino's features first whatever the
    names sort to."""
    jd, td, jdp, tdp = _pair("dinov2", seed=3)
    js, ts, jsp, tsp = _pair("siglip", seed=4)
    rng = np.random.default_rng(5)
    imgs = {k: rng.normal(size=(2, 3, 28, 28)).astype(np.float32) for k in ("zz-dinov2", "aa-siglip")}
    want = np.asarray(jvb.fused_vit_forward({"zz-dinov2": jdp, "aa-siglip": jsp}, {"zz-dinov2": jd, "aa-siglip": js},
                                            {k: jnp.asarray(v) for k, v in imgs.items()}))
    got = tvb.fused_vit_forward({"zz-dinov2": tdp, "aa-siglip": tsp}, {"zz-dinov2": td, "aa-siglip": ts},
                                {k: torch.from_numpy(v) for k, v in imgs.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[..., :32].numpy(), tvb.vit_forward(tdp, td, torch.from_numpy(imgs["zz-dinov2"])).numpy())


@pytest.mark.parametrize("name", list(VARIANTS))
def test_vit_init_tree_matches_jax(name):
    """The same leaves and shapes as JAX's vit_init; LayerScale at 1e-5,
    norms at one and zero, biases zero."""
    import jax

    jcfg, tcfg = configs(name)
    want = dict(P.tree_items(jax.tree_util.tree_map(np.asarray, jvb.vit_init(jax.random.PRNGKey(0), jcfg))))
    got = dict(P.tree_items(tvb.vit_init(tcfg, seed=0, device="cpu")))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for path, leaf in got.items():
        if path.endswith(("ls1", "ls2", "/b", "norm1/scale", "norm1/bias", "norm/bias")):
            assert np.array_equal(leaf.numpy(), want[path]), path


@pytest.mark.parametrize("strategy", ["resize-naive", "letterbox"])
@pytest.mark.parametrize("shape", [(30, 60), (61, 23), (40, 40)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_vit_image_transform_matches_jax(strategy, shape):
    pytest.importorskip("PIL")
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape + (3,), np.uint8)
    for mean, std in ((tvb.CLIP_MEAN, tvb.CLIP_STD), (tvb.SIGLIP_MEAN, tvb.SIGLIP_STD)):
        want = jvb.vit_image_transform(img, 28, strategy=strategy, mean=mean, std=std)
        got = tvb.vit_image_transform(img, 28, strategy=strategy, mean=mean, std=std)
        assert got.dtype == want.dtype and np.array_equal(got, want)
