"""Three steps of the port's make_train_step against the JAX package's on
mla-tiny in fp32: AdamW with weight decay, clipping at global norm 1,
gradient accumulation 1 and 2, EMA on, the same weights and batch, and each
micro-batch's noise, t and FPS starts as the JAX step draws them. Losses
and grad_norm within rtol 1e-4 (fp32; three Adam steps amplify the
frameworks' different summation orders a little beyond the single loss's
1e-5). The LM head gets no gradient in diffusion mode; weight decay must
still shrink it, as optax's does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu.training import optim as joptim
from mla_tpu.training import strategy as jstrategy
from mla_tpu_torch.training import optim as toptim
from mla_tpu_torch.training import strategy as tstrategy
from torch_train_parity import batch, from_jax, jax_draws, jconfig, jgd, model, tconfig, tgd, trainable, tree_items

B, REP, STEPS = 4, 1, 3
OPT = dict(learning_rate=1e-3, weight_decay=0.1, max_grad_norm=1.0, num_training_steps=10)


def _cfg(accum, mod):
    kw = dict(grad_accumulation_steps=accum, repeated_diffusion_steps=REP, enable_gradient_checkpointing=True,
              ema_decay=0.9)
    return mod.TrainConfig(use_ema=True, **kw, **OPT) if mod is jstrategy else mod.TrainConfig(**kw)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum, record_property):
    params, mstate = model(0)
    tparams, tstate_model = trainable(params), from_jax(mstate)
    head0 = tparams["llm_backbone"]["lm_head"]["w"].detach().clone()
    b = batch(B)
    rngs = [jax.random.PRNGKey(20 + i) for i in range(STEPS)]

    jcfg = jconfig("mla-tiny")
    tx, _, _ = joptim.make_optimizer(params, **OPT)
    jstep = jstrategy.make_train_step(jcfg, _cfg(accum, jstrategy), tx, jgd.create_schedule("", diffusion_steps=100))
    jst = jstrategy.init_train_state(params, tx, mstate, use_ema=True)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    jmetrics = []
    for r in rngs:
        jst, m = jstep(jst, jb, r)
        jmetrics.append({k: float(v) for k, v in m.items()})
    jhead = np.asarray(jst["params"]["llm_backbone"]["lm_head"]["w"])
    jema = from_jax(jax.device_get(jst["ema_params"]))

    opt, _, _ = toptim.make_optimizer(tparams, **OPT)
    tstep = tstrategy.make_train_step(tconfig("mla-tiny"), _cfg(accum, tstrategy), opt,
                                      tgd.create_schedule("", diffusion_steps=100))
    tst = tstrategy.init_train_state(tparams, opt, tstate_model, use_ema=True)
    rows = B // accum * REP
    worst = {}
    for i, r in enumerate(rngs):
        keys = [r] if accum == 1 else list(jax.random.split(r, accum))
        tst, m = tstep(tst, b, draws=[jax_draws(k, jcfg, rows) for k in keys])
        for k in ("total_loss", "diff_loss", "img_pc_contrastive_loss", "grad_norm"):
            worst[k] = max(worst.get(k, 0.0), abs(float(m[k]) / jmetrics[i][k] - 1))
            np.testing.assert_allclose(float(m[k]), jmetrics[i][k], rtol=1e-4, err_msg=f"step {i} {k}")
    assert tst["step"] == STEPS
    for k, v in worst.items():
        record_property(f"max_rel_err_{k}", v)
    assert max(m["grad_norm"] for m in jmetrics) > OPT["max_grad_norm"], "the clip never triggered"

    head = tparams["llm_backbone"]["lm_head"]["w"].detach()
    assert tparams["llm_backbone"]["lm_head"]["w"].grad is not None
    np.testing.assert_allclose(head.numpy(), jhead, rtol=1e-5, atol=1e-7)
    shrink = (1 - OPT["learning_rate"] * OPT["weight_decay"]) ** STEPS
    np.testing.assert_allclose(head.numpy(), head0.numpy() * shrink, rtol=1e-5, atol=1e-7)
    # EMA leaf by leaf where Adam's update is not sign noise: Adam scales a
    # near-zero gradient to a full +-lr step, whose sign may differ between
    # the frameworks in a few elements of a large leaf
    ema = dict(tree_items(tst["ema_params"]))
    for path in ("llm_backbone/lm_head/w", "x_embedder/fc1/w", "t_embedder/fc2/w"):
        np.testing.assert_allclose(ema[path].numpy(), dict(tree_items(jema))[path].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=path)


def test_lr_schedules_match_optax():
    for kind, warm in (("constant", 0.0), ("linear-warmup+cosine-decay", 0.2), ("linear-warmup+cosine-decay", 0.0)):
        want = joptim.make_lr_schedule(kind, 3e-4, 50, warm)
        got = toptim.make_lr_schedule(kind, 3e-4, 50, warm)
        for step in (0, 1, 5, 9, 10, 11, 30, 49, 50, 60):
            np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5, atol=1e-12, err_msg=f"{kind} {step}")


def test_decay_and_freeze_rules_match_jax():
    """The no-decay rule (stacked decoder leaves count one dim less) and the
    stage masks agree with the JAX package leaf for leaf."""
    from mla_tpu.utils.tree import map_with_path

    params, _ = model(0)
    tparams = from_jax(params)
    want_decay = dict(tree_items(from_jax(map_with_path(lambda p, x: np.asarray(joptim.is_no_decay(p, x)), params))))
    got = {path: toptim.is_no_decay(path, leaf) for path, leaf in tree_items(tparams)}
    assert got == {p: bool(v) for p, v in want_decay.items()}
    for stage in ("pretrain", "finetune", "vlm-align"):
        want = dict(tree_items(from_jax(map_with_path(lambda p, x: np.asarray(x), joptim.trainable_mask(params, stage)))))
        assert toptim.trainable_mask(tparams, stage) == {p: bool(v) for p, v in want.items()}, stage
    opt, _, mask = toptim.make_optimizer(tparams, stage="finetune")
    assert not mask["z_embedder/uncondition"] and not tparams["z_embedder"]["uncondition"].requires_grad
    assert not tparams["vision_tower_2d"]["patch_embedding"]["w"].requires_grad
    assert sum(len(g["params"]) for g in opt.adamw.param_groups) == sum(mask.values())


def test_post_franka_entry_builds_the_stage():
    """train_step's --post_franka: the gen config mapped from the flags as
    scripts/train.py maps them, one seeded wrist view in the batch, the
    longer sequence counted, both vision towers frozen; two steps and the
    heads' profiled function run on the CPU."""
    from dataclasses import replace

    from mla_tpu.conf.models import get_model_config as jconfig_flags
    from mla_tpu_torch import train_step as ts

    flags = {k: v for k, v in ts.POST_FRANKA.items() if k != "stage"}
    cfg = ts.model_config("mla-tiny", **flags)
    j = jconfig_flags("mla-tiny", use_tactile=True, use_generation=True, use_roi=True, num_extra_views=1)
    j = replace(j, gen=replace(j.gen, use_image=True, use_pointcloud=True, use_tactile=True))
    assert repr(cfg.gen) == repr(j.gen).replace("mla_tpu.models", "mla_tpu_torch.models")
    assert ts.model_config("mla-tiny", use_generation=True, gen_image=True).gen.use_pointcloud is False
    run = ts.build("mla-tiny", 2, 16, "cpu", **ts.POST_FRANKA)
    assert sorted(run["batch"]["images"]) == ["front_image", "wrist_image"]
    assert run["tokens_per_step"] == 2 * (16 + cfg.fused_len + cfg.diff_block_len)
    assert cfg.fused_len == 16 + 16 * 2 + 1
    frozen = [leaf for path, leaf in tree_items(run["state"]["params"])
              if path.startswith(("vision_tower_2d/", "vision_tower_3d/"))]
    assert frozen and not any(leaf.requires_grad for leaf in frozen)
    before = [leaf.clone() for leaf in frozen]
    for _ in range(2):
        run["state"], m = run["step"](run["state"], run["batch"], run["generator"])
    assert all(float(m[k]) != 0.0 for k in ("tactile_contrastive_loss", "image_gen_loss", "point_cloud_gen_loss",
                                            "tactile_gen_loss"))
    assert all(torch.equal(a, b) for a, b in zip(before, frozen))
    ts.heads_step(run)()
    assert all(p.grad is None for p in run["state"]["optimizer"].trainable)
