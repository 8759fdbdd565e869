"""The post-training loss of the port against the JAX package's
mla_train_loss on mla-tiny in fp32, with every flag of the Franka
post-training stage: diffusion, point cloud, contrastive, tactile input and
the tactile contrastive loss, one wrist view, and the image (with ROI),
point-cloud and tactile generation heads. Both packages get the same
weights (from_jax), the same synthetic batch with the same wrist view, and
the noise, t and FPS starts the JAX run draws from its key; the heads'
dropout is 0 in both, since the two PRNGs cannot match. Every loss key
within rtol 1e-5; every gradient leaf (the heads and the tactile
contrastive heads included) within atol 1e-6 + rtol 1e-4 of its own scale,
the largest |entry| of JAX's leaf: the heads' bias and embedding gradients
are sums over the batch of terms ~100x larger than some of their entries,
so the two frameworks' fp32 orders of summation alone move such an entry
by more than 1e-4 of itself (the tactile head's fc2 bias: 2.3e-6 on an
entry of 7.6e-3, in a leaf of scale 2.5). Also the moved batch-norm state,
with remat on and off, and the post-training stage's trainable and
no-decay masks equal to JAX's."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu.models import mla as jmla
from mla_tpu.models import prismatic as jprismatic
from mla_tpu.training import optim as joptim
from mla_tpu.utils.tree import map_with_path
from mla_tpu_torch.models import mla as tmla
from mla_tpu_torch.training import optim as toptim
from mla_tpu_torch.training.strategy import as_tensors
from mla_tpu_torch.vla.dummy import add_extra_views
from torch_train_parity import from_jax, jax_draws, jbatch, jconfig, jgd, tbatch, tconfig, tgd, trainable, tree_items

REP, B, TEXT_LEN = 2, 2, 16
FLAGS = dict(use_generation=True, use_tactile=True, use_roi=True, num_extra_views=1)


def no_dropout(cfg):
    """cfg with the generation heads' dropout at 0 (a field both packages'
    configs have)."""
    g = cfg.gen
    return replace(cfg, gen=replace(g, image=replace(g.image, dropout=0.0), point=replace(g.point, dropout=0.0),
                                    tactile=replace(g.tactile, dropout=0.0)))


def post_batch(seed: int = 3):
    """The synthetic post-training batch of both packages (asserted
    identical), with the port's seeded wrist view added (numpy)."""
    jb = jbatch(jconfig("mla-tiny", **FLAGS), B=B, L=TEXT_LEN, seed=seed)
    tb = tbatch(tconfig("mla-tiny", **FLAGS), B=B, L=TEXT_LEN, seed=seed)
    want = dict(tree_items(jb))
    assert sorted(p for p, _ in tree_items(tb)) == sorted(want)
    for path, leaf in tree_items(tb):
        assert leaf.dtype == want[path].dtype and np.array_equal(leaf, want[path]), path
    for key in ("next_images", "next_point_cloud", "next_tactile", "tactile", "gripper_xyz"):
        assert key in jb, key
    out = add_extra_views(jb, tconfig("mla-tiny", **FLAGS), seed=seed + 50)
    assert sorted(out["images"]) == ["front_image", "wrist_image"]
    assert out["images"]["wrist_image"].shape == jb["images"]["front_image"].shape
    return out


@pytest.fixture(scope="module")
def jax_run():
    cfg = no_dropout(jconfig("mla-tiny", **FLAGS))
    params, state = jprismatic.mla_model_init(jax.random.PRNGKey(0), cfg)
    # a live diffusion head: the reference zero-inits the final layer's fc2
    fc2 = params["final_layer"]["mlp"]["fc2"]
    fc2["w"] = jnp.asarray(np.random.default_rng(100).normal(size=fc2["w"].shape).astype(np.float32) * 0.05)
    b = post_batch()
    rng = jax.random.PRNGKey(7)
    sched = jgd.create_schedule("", diffusion_steps=100)

    def loss(p, s, bb, r):
        return jmla.mla_train_loss(p, s, cfg, sched, bb, r, repeated_diffusion_steps=REP, remat=True)

    (total, (ldict, new_state)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, state, jax.tree_util.tree_map(jnp.asarray, b), rng
    )
    return {"params": params, "state": state, "batch": b, "draws": jax_draws(rng, cfg, B * REP),
            "losses": {k: float(v) for k, v in ldict.items()}, "grads": from_jax(jax.device_get(grads)),
            "new_state": from_jax(jax.device_get(new_state))}


@pytest.mark.parametrize("remat", [False, True], ids=["remat-off", "remat-on"])
def test_post_train_loss_matches_jax(jax_run, remat, record_property):
    params = trainable(jax_run["params"])
    cfg = no_dropout(tconfig("mla-tiny", **FLAGS))
    total, (ldict, new_state) = tmla.mla_train_loss(
        params, from_jax(jax_run["state"]), cfg, tgd.create_schedule("", diffusion_steps=100),
        as_tensors(jax_run["batch"], "cpu"), repeated_diffusion_steps=REP, remat=remat, **jax_run["draws"],
    )
    total.backward()
    assert sorted(ldict) == sorted(tmla.LOSS_KEYS) == sorted(jax_run["losses"])
    for k in tmla.LOSS_KEYS:
        want = jax_run["losses"][k]
        if want:
            record_property(f"rel_err_{k}", abs(float(ldict[k].detach()) / want - 1))
        np.testing.assert_allclose(float(ldict[k].detach()), want, rtol=1e-5, err_msg=k)
    for k in ("tactile_contrastive_loss", "image_gen_loss", "point_cloud_gen_loss", "tactile_gen_loss"):
        assert jax_run["losses"][k] != 0.0, k
    want = dict(tree_items(jax_run["grads"]))
    assert sorted(p for p, _ in tree_items(params)) == sorted(want)
    worst, live = 0.0, set()
    for path, leaf in tree_items(params):
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        err, scale = float((g - want[path]).abs().max()), float(want[path].abs().max())
        worst = max(worst, err / (1e-6 + 1e-4 * scale))
        assert err <= 1e-6 + 1e-4 * scale, (path, err, scale)
        if want[path].abs().max() > 0:
            live.add(path.split("/")[0] if path.split("/")[0] != "contrastive" else "/".join(path.split("/")[:2]))
    assert {"generation_manager", "contrastive/tactile", "tactile_embedder"} <= live, live
    record_property("max_grad_err_share_of_tolerance", worst)
    got_state = dict(tree_items(new_state))
    want_state = dict(tree_items(jax_run["new_state"]))
    assert sorted(got_state) == sorted(want_state)
    assert any(p.startswith("generation_manager/pointcloud_gen_module/pred_bn") for p in want_state)
    for path, leaf in want_state.items():
        np.testing.assert_allclose(got_state[path].numpy(), leaf.numpy(), rtol=1e-5, atol=1e-6, err_msg=path)


def test_post_training_masks_match_jax(jax_run):
    """The post-training stage freezes both vision towers; the no-decay rule
    agrees leaf for leaf on the heads' list-indexed paths too."""
    params = jax_run["params"]
    tparams = from_jax(params)
    want = dict(tree_items(from_jax(map_with_path(lambda p, x: np.asarray(x),
                                                  joptim.trainable_mask(params, "post-training")))))
    got = toptim.trainable_mask(tparams, "post-training")
    assert got == {p: bool(v) for p, v in want.items()}
    assert not any(v for p, v in got.items() if p.startswith(("vision_tower_2d/", "vision_tower_3d/")))
    assert all(v for p, v in got.items() if p.startswith("generation_manager/"))
    want_decay = dict(tree_items(from_jax(map_with_path(lambda p, x: np.asarray(joptim.is_no_decay(p, x)), params))))
    got_decay = {path: toptim.is_no_decay(path, leaf) for path, leaf in tree_items(tparams)}
    assert got_decay == {p: bool(v) for p, v in want_decay.items()}
    assert got_decay["generation_manager/image_gen_module/mae_decoder/0/norm3/scale"]
    assert not got_decay["generation_manager/image_gen_module/intent_decoder/1/linear1/w"]
