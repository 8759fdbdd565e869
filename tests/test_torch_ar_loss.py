"""The AR loss mode of the port's mla_train_loss (use_diff=False: the total
is the LM loss of the labels plus the contrastive loss) against the JAX
package's on mla-tiny in fp32: the same weights (from_jax), the same
synthetic batch and the FPS starts the JAX run draws from its key. Every
loss key within rtol 1e-5; every gradient leaf within atol 1e-6 + rtol 1e-4
of its own scale, the largest |entry| of JAX's leaf (the rule of the
post-training test: batch-summed bias gradients differ between the two
frameworks' fp32 orders of summation by more than 1e-4 of a small entry).
The LM head gets a gradient in this mode; x / t / final-layer leaves do not
exist."""

import jax
import numpy as np
import pytest
import torch

from mla_tpu.models import mla as jmla
from mla_tpu.models import prismatic as jprismatic
from mla_tpu_torch.models import mla as tmla
from mla_tpu_torch.training.strategy import as_tensors
from torch_train_parity import from_jax, jax_draws, jbatch, jconfig, jgd, tconfig, tgd, trainable, tree_items

B, TEXT_LEN = 2, 16


@pytest.fixture(scope="module")
def jax_run():
    cfg = jconfig("mla-tiny", use_diff=False)
    params, state = jprismatic.mla_model_init(jax.random.PRNGKey(0), cfg)
    b = jbatch(cfg, B=B, L=TEXT_LEN, seed=3)
    rng = jax.random.PRNGKey(7)
    sched = jgd.create_schedule("", diffusion_steps=100)

    def loss(p, s, bb, r):
        return jmla.mla_train_loss(p, s, cfg, sched, bb, r, remat=True)

    (total, (ldict, new_state)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, state, jax.tree_util.tree_map(jax.numpy.asarray, b), rng)
    return {"params": params, "state": state, "batch": b, "draws": jax_draws(rng, cfg, B),
            "losses": {k: float(v) for k, v in ldict.items()}, "grads": from_jax(jax.device_get(grads)),
            "new_state": from_jax(jax.device_get(new_state))}


@pytest.mark.parametrize("remat", [False, True], ids=["remat-off", "remat-on"])
def test_ar_loss_matches_jax(jax_run, remat, record_property):
    cfg = tconfig("mla-tiny", use_diff=False)
    params = trainable(jax_run["params"])
    assert "x_embedder" not in params and "final_layer" not in params
    total, (ldict, new_state) = tmla.mla_train_loss(
        params, from_jax(jax_run["state"]), cfg, tgd.create_schedule("", diffusion_steps=100),
        as_tensors(jax_run["batch"], "cpu"), remat=remat, fps_start=jax_run["draws"]["fps_start"],
    )
    total.backward()
    assert sorted(ldict) == sorted(jax_run["losses"])
    assert jax_run["losses"]["ar_loss"] > 0 and jax_run["losses"]["diff_loss"] == 0.0
    assert jax_run["losses"]["img_pc_contrastive_loss"] > 0
    for k, want in jax_run["losses"].items():
        if want:
            record_property(f"rel_err_{k}", abs(float(ldict[k].detach()) / want - 1))
        np.testing.assert_allclose(float(ldict[k].detach()), want, rtol=1e-5, err_msg=k)
    want = dict(tree_items(jax_run["grads"]))
    assert sorted(p for p, _ in tree_items(params)) == sorted(want)
    worst = 0.0
    for path, leaf in tree_items(params):
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        err, scale = float((g - want[path]).abs().max()), float(want[path].abs().max())
        worst = max(worst, err / (1e-6 + 1e-4 * scale))
        assert err <= 1e-6 + 1e-4 * scale, (path, err, scale)
    assert float(want["llm_backbone/lm_head/w"].abs().max()) > 0
    record_property("max_grad_err_share_of_tolerance", worst)
    got_state, want_state = dict(tree_items(new_state)), dict(tree_items(jax_run["new_state"]))
    assert sorted(got_state) == sorted(want_state)
    for path, t in got_state.items():
        np.testing.assert_allclose(t.detach().numpy(), want_state[path].numpy(), rtol=1e-5, atol=1e-6, err_msg=path)
