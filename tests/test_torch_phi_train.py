"""The diffusion training loss on the phi decoder family against the JAX
package's mla_train_loss, in fp32, on the tiny composed phi model of
tests/test_torch_policy_phi.py: the same weights (from_jax), the same
synthetic batch, and the noise, t and FPS starts the JAX run draws from its
key (tests/torch_train_parity.py). Every loss within rtol 1e-5; every
gradient leaf within 1e-6 + 1e-4 of its own scale, the largest |entry| of
JAX's leaf (tests/test_torch_post_train.py's rule: a bias gradient is a sum
over the batch, and the two frameworks' fp32 orders of summation move a
small entry by more than 1e-4 of itself); the batch-norm state the step
leaves behind; remat on and off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu.models import mla as jmla
from mla_tpu_torch.models import mla as tmla
from mla_tpu_torch.training.strategy import as_tensors
from test_torch_policy_phi import phi_configs, phi_model
from torch_train_parity import batch, from_jax, jax_draws, jgd, tgd, trainable, tree_items

REP, B = 2, 2


@pytest.fixture(scope="module")
def jax_run():
    jcfg, _ = phi_configs()
    params, state = phi_model(jcfg, seed=1)
    b = batch(B)
    rng = jax.random.PRNGKey(7)
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
def test_phi_train_loss_matches_jax(jax_run, remat, record_property):
    _, tcfg = phi_configs()
    params = trainable(jax_run["params"])
    total, (ldict, new_state) = tmla.mla_train_loss(
        params, from_jax(jax_run["state"]), tcfg, tgd.create_schedule("", diffusion_steps=100),
        as_tensors(jax_run["batch"], "cpu"), repeated_diffusion_steps=REP, remat=remat, **jax_run["draws"],
    )
    total.backward()
    for k in ("total_loss", "diff_loss", "img_pc_contrastive_loss"):
        assert jax_run["losses"][k] > 0, k
        record_property(f"rel_err_{k}", abs(float(ldict[k].detach()) / jax_run["losses"][k] - 1))
        np.testing.assert_allclose(float(ldict[k].detach()), jax_run["losses"][k], rtol=1e-5, err_msg=k)
    want = dict(tree_items(jax_run["grads"]))
    assert sorted(p for p, _ in tree_items(params)) == sorted(want)
    worst, live = 0.0, 0
    for path, leaf in tree_items(params):
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        err, scale = float((g - want[path]).abs().max()), float(want[path].abs().max())
        worst = max(worst, err / (1e-6 + 1e-4 * scale))
        assert err <= 1e-6 + 1e-4 * scale, (path, err, scale)
        live += path.startswith("llm_backbone/layers/") and scale > 0
    # every stacked phi leaf (q, k, v, o, fc1, fc2 weights and biases, the
    # LayerNorm) gets a gradient
    assert live == 14, live
    record_property("max_grad_err_share_of_tolerance", worst)
    got_state, want_state = dict(tree_items(new_state)), dict(tree_items(jax_run["new_state"]))
    assert sorted(got_state) == sorted(want_state)
    for path, leaf in want_state.items():
        np.testing.assert_allclose(got_state[path].numpy(), leaf.numpy(), rtol=1e-5, atol=1e-6, err_msg=path)
