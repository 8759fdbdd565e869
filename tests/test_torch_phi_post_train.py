"""The Franka post-training loss on the phi decoder family against the JAX
package's mla_train_loss, in fp32: mla-tiny's front-ends with the tiny Phi
decoder of tests/test_torch_policy_phi.py (hidden 64, head_dim 16, partial
RoPE) and every flag of the stage (diffusion, point cloud, contrastive,
tactile input and the tactile contrastive loss, one wrist view, the image
head with ROI, the point-cloud and tactile heads), the composition that
`train_step --model mla-phi --post_franka` runs at full width. Both
packages get the same weights (from_jax), the same batch and the noise, t
and FPS starts of the JAX run's key; the heads' dropout is 0 in both.
Every loss within rtol 1e-5; every gradient leaf within 1e-6 + 1e-4 of its
own scale (tests/test_torch_post_train.py's rule); the batch-norm state
the step leaves behind; remat on and off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu.models import mla as jmla
from mla_tpu_torch.models import mla as tmla
from mla_tpu_torch.training.strategy import as_tensors
from test_torch_policy_phi import phi_configs, phi_model
from test_torch_post_train import FLAGS, REP, B, no_dropout, post_batch
from torch_train_parity import from_jax, jax_draws, jgd, tgd, trainable, tree_items


@pytest.fixture(scope="module")
def jax_run():
    jcfg, _ = phi_configs(**FLAGS)
    jcfg = no_dropout(jcfg)
    params, state = phi_model(jcfg, seed=2)
    b = post_batch()
    rng = jax.random.PRNGKey(11)
    sched = jgd.create_schedule("", diffusion_steps=100)

    def loss(p, s, bb, r):
        return jmla.mla_train_loss(p, s, jcfg, sched, bb, r, repeated_diffusion_steps=REP, remat=True)

    (total, (ldict, new_state)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, state, jax.tree_util.tree_map(jnp.asarray, b), rng
    )
    return {"params": params, "state": state, "batch": b, "draws": jax_draws(rng, jcfg, B * REP),
            "losses": {k: float(v) for k, v in ldict.items()}, "grads": from_jax(jax.device_get(grads)),
            "new_state": from_jax(jax.device_get(new_state))}


@pytest.mark.parametrize("remat", [False, True], ids=["remat-off", "remat-on"])
def test_phi_post_train_loss_matches_jax(jax_run, remat, record_property):
    _, tcfg = phi_configs(**FLAGS)
    tcfg = no_dropout(tcfg)
    assert tcfg.llm_family == "phi" and tcfg.use_generation and tcfg.use_tactile
    params = trainable(jax_run["params"])
    total, (ldict, new_state) = tmla.mla_train_loss(
        params, from_jax(jax_run["state"]), tcfg, tgd.create_schedule("", diffusion_steps=100),
        as_tensors(jax_run["batch"], "cpu"), repeated_diffusion_steps=REP, remat=remat, **jax_run["draws"],
    )
    total.backward()
    assert sorted(ldict) == sorted(tmla.LOSS_KEYS) == sorted(jax_run["losses"])
    for k in tmla.LOSS_KEYS:
        want = jax_run["losses"][k]
        if want:
            record_property(f"rel_err_{k}", abs(float(ldict[k].detach()) / want - 1))
        np.testing.assert_allclose(float(ldict[k].detach()), want, rtol=1e-5, err_msg=k)
    for k in ("diff_loss", "tactile_contrastive_loss", "image_gen_loss", "point_cloud_gen_loss", "tactile_gen_loss"):
        assert jax_run["losses"][k] != 0.0, k
    want = dict(tree_items(jax_run["grads"]))
    assert sorted(p for p, _ in tree_items(params)) == sorted(want)
    worst, live = 0.0, set()
    for path, leaf in tree_items(params):
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        err, scale = float((g - want[path]).abs().max()), float(want[path].abs().max())
        worst = max(worst, err / (1e-6 + 1e-4 * scale))
        assert err <= 1e-6 + 1e-4 * scale, (path, err, scale)
        if scale > 0:
            live.add("/".join(path.split("/")[:2]))
    assert {"generation_manager/image_gen_module", "generation_manager/pointcloud_gen_module",
            "generation_manager/tactile_gen_module", "contrastive/tactile", "llm_backbone/layers"} <= live, live
    record_property("max_grad_err_share_of_tolerance", worst)
    got_state, want_state = dict(tree_items(new_state)), dict(tree_items(jax_run["new_state"]))
    assert sorted(got_state) == sorted(want_state)
    for path, leaf in want_state.items():
        np.testing.assert_allclose(got_state[path].numpy(), leaf.numpy(), rtol=1e-5, atol=1e-6, err_msg=path)
