"""The port's Adafactor (training/optim.py) against the JAX package's
make_optimizer(optimizer='adafactor'), that is optax's chain
masked(clip_by_global_norm -> adafactor) followed by zeroing the frozen
leaves: five steps on a tree with factored leaves (two dims >= 128, a
stacked [L, ., .] leaf among them) and unfactored ones (a vector, a matrix
with a dim under 128), a frozen module and the always-frozen `uncondition`
vector, under a warmup-cosine schedule, with gradients from a numpy seed
whose scale crosses the clipping norm. Parameters after every step within
rtol 1e-6 (atol 1e-7) in fp32; in bf16 within rtol 1e-2 or 1e-2 of the
leaf's largest |entry|: XLA keeps some bf16 intermediates of the chain in
fp32 (excess precision) where the port rounds them, so an entry near 0
lands one bf16 step of its own away (1.2e-4 on entries of a leaf of scale
0.2). Also the refusal of weight_decay, in both packages."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mla_tpu.training import optim as joptim
from mla_tpu_torch.params import from_jax, tree_items
from mla_tpu_torch.training import optim as toptim

SHAPES = {
    "llm_backbone/layers/attn/q/w": (2, 128, 160),   # factored over its last two dims
    "llm_backbone/lm_head/w": (160, 300),              # frozen (extra_frozen)
    "projector/fc1/w": (300, 144),                     # factored, largest dim first
    "projector/fc1/b": (144,),                         # vector: v kept whole
    "head/w": (200, 40),                               # second dim < 128: kept whole
    "z_embedder/uncondition": (1, 160),                # always frozen
}
STEPS = 5
RTOL = {"float32": 1e-6, "bfloat16": 1e-2}
ATOL_OF_SCALE = {"float32": 0.0, "bfloat16": 1e-2}


def tree(dtype):
    rng = np.random.default_rng(0)
    out = {}
    for path, shape in SHAPES.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(rng.normal(size=shape).astype(np.float32) * 0.05, dtype)
    return out


def grads(step, dtype):
    """Gradients of every leaf; their global norm runs from below the
    clipping norm of 1 (steps 0, 1) to far above it."""
    rng = np.random.default_rng(100 + step)
    scale = 10.0 ** (step - 3)
    return {path: (rng.normal(size=shape) * scale).astype(np.float32) for path, shape in SHAPES.items()}


def nest(flat, dtype):
    out = {}
    for path, v in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v, dtype)
    return out


KW = dict(learning_rate=3e-2, lr_scheduler_type="linear-warmup+cosine-decay", warmup_ratio=0.1,
          num_training_steps=10, extra_frozen=("lm_head",), optimizer="adafactor")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adafactor_matches_optax(dtype):
    jdt = getattr(jnp, dtype)
    jparams = tree(jdt)
    tx, _, _ = joptim.make_optimizer(jparams, **KW)
    jstate = tx.init(jparams)
    tparams = from_jax({k: v for k, v in jparams.items()})
    opt, _, mask = toptim.make_optimizer(tparams, **KW)
    assert sorted(p for p, on in mask.items() if not on) == ["llm_backbone/lm_head/w", "z_embedder/uncondition"]
    factored = {p for p, l in tree_items(tparams) if toptim.factored_dims(tuple(l.shape)) is not None}
    assert factored == {"llm_backbone/layers/attn/q/w", "llm_backbone/lm_head/w", "projector/fc1/w"}
    initial = {p: l.detach().clone() for p, l in tree_items(tparams)}
    norms = []
    for step in range(STEPS):
        g = grads(step, dtype)
        norms.append(float(np.sqrt(sum((v.astype(np.float64) ** 2).sum() for p, v in g.items() if mask[p]))))
        updates, jstate = tx.update(nest(g, jdt), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for path, leaf in tree_items(tparams):
            if mask[path]:
                leaf.grad = torch.from_numpy(g[path]).to(leaf.dtype)
        opt.step()
        opt.zero_grad()
        want = dict(tree_items(from_jax(jparams)))
        for path, leaf in tree_items(tparams):
            assert leaf.dtype == want[path].dtype, path
            w = want[path].float().numpy()
            np.testing.assert_allclose(leaf.detach().float().numpy(), w, rtol=RTOL[dtype],
                                       atol=max(1e-7, ATOL_OF_SCALE[dtype] * float(np.abs(w).max())),
                                       err_msg=f"step {step}: {path}")
    assert min(norms) < 1.0 < max(norms), norms
    for path, leaf in tree_items(tparams):
        moved = not torch.equal(leaf, initial[path])
        assert moved == mask[path], path
    assert opt.count == STEPS


def test_adafactor_refuses_weight_decay():
    params = tree(jnp.float32)
    with pytest.raises(ValueError, match="weight_decay"):
        joptim.make_optimizer(params, weight_decay=0.01, optimizer="adafactor")
    with pytest.raises(ValueError, match="weight_decay"):
        toptim.make_optimizer(from_jax(params), weight_decay=0.01, optimizer="adafactor")
