"""Shared set-up of the slice-level parity tests (tests/test_torch_policy_*):
one mla-tiny model initialized by the JAX package and carried across with
params.from_jax, and one request, all from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np

from mla_tpu.conf.models import get_model_config as jconfig
from mla_tpu.models import mla as jmla
from mla_tpu.models import prismatic as jprismatic
from mla_tpu.ops import quantization as jq
from mla_tpu_torch.conf.models import get_model_config as tconfig
from mla_tpu_torch.models import mla as tmla
from mla_tpu_torch.ops import quantization as tq
from mla_tpu_torch.params import from_jax

STATS = {
    "rlbench": {
        "action": {"q01": [-0.5] * 6 + [-1.0], "q99": [0.5] * 6 + [1.0]},
        "proprio": {"q01": [-1.0] * 7, "q99": [1.0] * 7},
    }
}


def model(seed: int = 0):
    """JAX (params, state) of mla-tiny with a live head: the reference
    zero-inits the final layer's fc2 (which would make eps 0 and every chunk
    independent of the model) and the CFG `uncondition` vector."""
    cfg = jconfig("mla-tiny")
    params, state = jprismatic.mla_model_init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed + 100)
    fc2 = params["final_layer"]["mlp"]["fc2"]
    fc2["w"] = jnp.asarray(rng.normal(size=fc2["w"].shape).astype(np.float32) * 0.05)
    params["z_embedder"]["uncondition"] = jnp.asarray(rng.normal(size=(1, cfg.token_size)).astype(np.float32))
    return params, state


def request(seed: int = 1):
    rng = np.random.default_rng(seed)
    img = np.concatenate([rng.normal(size=(3, 168, 168)).astype(np.float32), np.ones((1, 168, 168), np.float32)])
    pc = rng.uniform(-0.3, 0.7, size=(64, 3)).astype(np.float32)
    ids = np.array([[1, 500, 600, 700, 800, 29871]], np.int32)
    noise = rng.normal(size=(16, 7)).astype(np.float32)
    state = rng.uniform(-0.5, 0.5, size=7).astype(np.float32)
    return img, pc, ids, noise, state


def policies(params, state, quantized: bool):
    """(JAX policy, port policy on the CPU) over the same weights, quantized
    by each package's own quantize_model when asked."""
    tp, ts = from_jax(params), from_jax(state)
    if quantized:
        params, tp = jq.quantize_model(params), tq.quantize_model(tp)
    jpol = jmla.MLAPolicy(params, state, jconfig("mla-tiny"), tokenizer=None, norm_stats=STATS)
    tpol = tmla.MLAPolicy(tp, ts, tconfig("mla-tiny"), norm_stats=STATS, device="cpu")
    return jpol, tpol


def both(jpol, tpol, **kw):
    img, pc, ids, noise, rstate = request()
    args = dict(input_ids=ids, noise=noise, cur_robot_state=rstate, **kw)
    j = np.asarray(jpol.predict_action_diff(img, pc, "", **args))
    t = tpol.predict_action_diff(img, pc, "", **args)
    return j, t
