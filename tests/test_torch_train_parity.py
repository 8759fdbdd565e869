"""The diffusion training loss of the port against the JAX package's
mla_train_loss on mla-tiny in fp32: the same weights (from_jax), the same
synthetic batch, and the noise, t and FPS starts the JAX run draws from its
key. Losses within rtol 1e-5 and per-leaf gradients within rtol 1e-4 / atol
1e-6: fp32 throughout, the two frameworks differ only in the order of their
sums. remat must not change the port's numbers. Also the batch-norm state
the step leaves behind, and the language-only forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu.models import mla as jmla
from mla_tpu.models import prismatic as jprismatic
from mla_tpu_torch.models import mla as tmla
from mla_tpu_torch.models import prismatic as tprismatic
from mla_tpu_torch.training.strategy import as_tensors
from torch_train_parity import batch, from_jax, jax_draws, jconfig, jgd, model, tconfig, tgd, trainable, tree_items

REP, B = 2, 2


@pytest.fixture(scope="module")
def jax_run():
    params, state = model(0)
    cfg = jconfig("mla-tiny")
    b = batch(B)
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
def test_mla_train_loss_matches_jax(jax_run, remat, record_property):
    params = trainable(jax_run["params"])
    total, (ldict, new_state) = tmla.mla_train_loss(
        params, from_jax(jax_run["state"]), tconfig("mla-tiny"), tgd.create_schedule("", diffusion_steps=100),
        as_tensors(jax_run["batch"], "cpu"), repeated_diffusion_steps=REP, remat=remat, **jax_run["draws"],
    )
    total.backward()
    for k in ("total_loss", "diff_loss", "img_pc_contrastive_loss"):
        record_property(f"rel_err_{k}", abs(float(ldict[k].detach()) / jax_run["losses"][k] - 1))
        np.testing.assert_allclose(float(ldict[k].detach()), jax_run["losses"][k], rtol=1e-5, err_msg=k)
    assert jax_run["losses"]["img_pc_contrastive_loss"] > 0
    want = dict(tree_items(jax_run["grads"]))
    nonzero, worst = 0, 0.0
    for path, leaf in tree_items(params):
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        worst = max(worst, float((g - want[path]).abs().max()))
        np.testing.assert_allclose(g.numpy(), want[path].numpy(), rtol=1e-4, atol=1e-6, err_msg=path)
        nonzero += bool(want[path].abs().max() > 0)
    assert nonzero > 50, nonzero
    record_property("max_abs_grad_err", worst)
    got_state = dict(tree_items(new_state))
    for path, leaf in tree_items(jax_run["new_state"]):
        np.testing.assert_allclose(got_state[path].numpy(), leaf.numpy(), rtol=1e-5, atol=1e-6, err_msg=path)


def test_batch_norm_state_moves_only_in_training(jax_run):
    """The training step moves every running statistic; serving hands back
    the same state tensors."""
    moved = dict(tree_items(jax_run["new_state"]))
    for path, leaf in tree_items(from_jax(jax_run["state"])):
        assert not torch.equal(moved[path], leaf), path
    params, state = from_jax(jax_run["params"]), from_jax(jax_run["state"])
    b = as_tensors(jax_run["batch"], "cpu")
    with torch.no_grad():
        out = tprismatic.get_fused_tokens(params, state, tconfig("mla-tiny"), b["images"], b["point_cloud"])
    kept = dict(tree_items(out["state"]))
    assert all(kept[path] is leaf for path, leaf in tree_items(state))


def test_language_only_forward_matches_jax(jax_run):
    """A batch without images runs the plain LM forward and its shifted
    cross-entropy (the JAX package's language-only branch)."""
    cfg = jconfig("mla-tiny")
    b = {k: jax_run["batch"][k] for k in ("input_ids", "attention_mask", "labels", "splice_idx")}
    jout, _ = jprismatic.vlm_forward(jax_run["params"], jax_run["state"], cfg, jax.tree_util.tree_map(jnp.asarray, b),
                                     training=True)
    tout, _ = tprismatic.vlm_forward(from_jax(jax_run["params"]), from_jax(jax_run["state"]), tconfig("mla-tiny"),
                                     as_tensors(b, "cpu"), training=True)
    np.testing.assert_allclose(float(tout["lm_loss"]), float(jout["lm_loss"]), rtol=1e-5)
    np.testing.assert_allclose(tout["logits"].detach().numpy(), np.asarray(jout["logits"]), rtol=1e-4, atol=1e-5)


def test_training_after_serving_in_one_process():
    """Tables cached by a serving call (under inference_mode) stay usable
    by a later training forward under autograd."""
    from mla_tpu_torch.ops import rope

    rope.rope_tables_on.cache_clear()
    with torch.inference_mode():
        cos, _ = rope.rope_tables_on(16, 32, 10000.0, "cpu")
    assert not cos.is_inference()
    x = torch.ones((1, 1, 4, 16), requires_grad=True)
    q, _ = rope.apply_rope(x, x, *rope.rope_tables_on(16, 32, 10000.0, "cpu"), torch.arange(4))
    q.sum().backward()
    assert x.grad is not None


def test_condition_dropout_matches_jax(jax_run):
    """class_dropout_prob = 1 drops every row's text and fused conditions
    whatever the draw, so the port's generator and JAX's key agree (and the
    FPS starts cannot reach noise_pred)."""
    from dataclasses import replace

    b = dict(jax_run["batch"])
    b.pop("labels")
    rng = np.random.default_rng(12)
    b["x"] = rng.normal(size=(B, 16, 7)).astype(np.float32)
    b["t"] = np.array([5, 60], np.int32)
    jcfg, tcfg = replace(jconfig("mla-tiny"), class_dropout_prob=1.0), replace(tconfig("mla-tiny"), class_dropout_prob=1.0)
    fwd = jax.jit(lambda p, s, bb, r: jprismatic.vlm_forward(p, s, jcfg, bb, training=True, rng=r)[0]["noise_pred"])
    want = np.asarray(fwd(jax_run["params"], jax_run["state"], jax.tree_util.tree_map(jnp.asarray, b),
                          jax.random.PRNGKey(0)))
    with torch.no_grad():
        out, _ = tprismatic.vlm_forward(from_jax(jax_run["params"]), from_jax(jax_run["state"]), tcfg,
                                        as_tensors(b, "cpu"), training=True, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(out["noise_pred"].numpy(), want, rtol=1e-4, atol=1e-5)
