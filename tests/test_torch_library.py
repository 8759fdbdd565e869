"""The library surface of the port off the model's active path, against the
JAX package on the CPU: the scene-level contrastive loss with its
gradients, the model-zoo registry, the tree utilities' paths, the profiling
helpers and StepTimer, the package's re-exports, the OXE transforms' shim;
and the entry points' model ids (profile_chunk's suffix rule, train_step's
one-card cut of mla-mistral)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mla_tpu
import mla_tpu_torch
from mla_tpu.models import contrastive as jcon
from mla_tpu.models import registry as jreg
from mla_tpu.utils import profiling as jprof
from mla_tpu.utils import tree as jtree
from mla_tpu.vla.rlds import oxe_transforms as joxe
from mla_tpu_torch.models import contrastive as tcon
from mla_tpu_torch.models import registry as treg
from mla_tpu_torch.params import from_jax, tree_items
from mla_tpu_torch.utils import profiling as tprof
from mla_tpu_torch.utils import tree as ttree
from mla_tpu_torch.vla.rlds import oxe_transforms as toxe


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("B,temperature", [(4, 0.07), (1, 0.07), (3, 0.5)])
def test_scene_contrastive_loss_and_grads_match_jax(B, temperature, record_property):
    jp = jcon.scene_contrastive_init(jax.random.PRNGKey(0), 32, 16)
    img, pc = _rand((B, 10, 32), 1), _rand((B, 12, 32), 2)
    loss_fn = lambda p, i, c: jcon.scene_contrastive_loss(p, i, c, temperature)  # noqa: E731
    want, (gp, gi, gc) = jax.value_and_grad(loss_fn, argnums=(0, 1, 2))(jp, jnp.asarray(img), jnp.asarray(pc))
    tp = from_jax(jp)
    for _, leaf in tree_items(tp):
        leaf.requires_grad_(True)
    ti, tc = torch.from_numpy(img).requires_grad_(True), torch.from_numpy(pc).requires_grad_(True)
    got = tcon.scene_contrastive_loss(tp, ti, tc, temperature)
    got.backward()
    record_property("abs_err", abs(float(got) - float(want)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for path, g in tree_items(from_jax(jax.device_get(gp))):
        t = dict(tree_items(tp))[path].grad
        np.testing.assert_allclose(t.numpy(), g.numpy(), atol=1e-6 + 1e-4 * float(g.abs().max()), err_msg=path)
    for t, g in ((ti, gi), (tc, gc)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-6 + 1e-4 * float(np.abs(g).max()))
    shapes = {k: tuple(v.shape) for k, v in tree_items(tcon.scene_contrastive_init(0, 32, 16))}
    assert shapes == {k: tuple(v.shape) for k, v in tree_items(from_jax(jp))}


def test_model_zoo_registry_equals_jax():
    assert treg.MODEL_REGISTRY == jreg.MODEL_REGISTRY
    assert treg.GLOBAL_REGISTRY == jreg.GLOBAL_REGISTRY
    assert treg.LLM_BACKBONE_REGISTRY == jreg.LLM_BACKBONE_REGISTRY
    for name in jreg.GLOBAL_REGISTRY:
        assert treg.get_model_description(name) == jreg.get_model_description(name)
    with pytest.raises(ValueError, match="available"):
        treg.get_model_description("no-such-model")


def _tree():
    return {"a": {"w": np.ones((2, 3), np.float32), "n": np.arange(4, dtype=np.int32)},
            "layers": [{"b": np.zeros(5, np.float32)}, {"b": np.ones(5, np.float32)}], "t": (np.ones(1, np.float32),)}


def test_tree_utilities_match_jax():
    jt, tt = jax.tree_util.tree_map(jnp.asarray, _tree()), from_jax(_tree())
    jpaths = []
    jtree.map_with_path(lambda p, x: jpaths.append(p), jt)
    tpaths = []
    ttree.map_with_path(lambda p, x: tpaths.append(p), tt)
    assert sorted(tpaths) == sorted(jpaths) == ["a/n", "a/w", "layers/0/b", "layers/1/b", "t/0"]
    assert ttree.param_count(tt) == jtree.param_count(jt) == 6 + 4 + 10 + 1
    cast = ttree.cast_floats(tt, torch.bfloat16)
    assert cast["a"]["w"].dtype == torch.bfloat16 and cast["a"]["n"].dtype == torch.int32
    assert isinstance(cast["t"], tuple)
    labels = ttree.label_with_path(lambda p: "decay" if p.endswith("w") else "none", tt)
    want = jtree.label_with_path(lambda p: "decay" if p.endswith("w") else "none", jt)
    assert labels == want
    doubled = ttree.map_with_path(lambda p, x: x * 2 if p.startswith("layers") else x, tt)
    assert float(doubled["layers"][1]["b"].sum()) == 10.0 and float(doubled["a"]["w"].sum()) == 6.0


def test_step_timer_and_profiling(tmp_path):
    for timer in (tprof.StepTimer(window=3), jprof.StepTimer(window=3)):
        assert timer.summary() == {}
        for _ in range(5):
            timer.start()
            timer.stop()
        assert len(timer.times) == 3
        assert set(timer.summary()) == {"step_time_p50", "step_time_p90", "step_time_mean"}
    t = tprof.StepTimer()
    t.times.extend([0.1, 0.2, 0.3, 0.4])
    j = jprof.StepTimer()
    j.times.extend([0.1, 0.2, 0.3, 0.4])
    assert t.summary() == j.summary()
    with pytest.raises(RuntimeError):
        tprof.StepTimer().stop()
    with tprof.trace(str(tmp_path / "trace")):
        with tprof.annotate("my_span"):
            torch.ones(8).sum()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "my_span" for e in events)


def test_package_reexports_and_oxe_shim(monkeypatch):
    assert mla_tpu_torch.available_models() == mla_tpu.available_models()
    assert mla_tpu_torch.__version__ == mla_tpu.__version__
    from mla_tpu_torch.models import load

    monkeypatch.setattr(load, "load_vla", lambda *a, **k: (a, k))
    assert mla_tpu_torch.load_vla("run", device="cpu") == (("run",), {"device": "cpu"})
    assert sorted(toxe.OXE_STANDARDIZATION_TRANSFORMS) == sorted(joxe.OXE_STANDARDIZATION_TRANSFORMS)
    assert sorted(toxe.FRAME_FILTERS) == sorted(joxe.FRAME_FILTERS)
    assert toxe.get_standardization_transform("bridge_orig") is toxe.OXE_STANDARDIZATION_TRANSFORMS["bridge_orig"]
    assert callable(toxe.identity_transform)


@pytest.mark.parametrize("model_id,want", [("mla-7b", ("mla-7b", "int8")), ("mla-7b-int8", ("mla-7b", "int8")),
                                           ("mla-7b-int4", ("mla-7b", "int4")), ("mla-mistral", ("mla-mistral", "int8")),
                                           ("mla-mistral-int4", ("mla-mistral", "int4")), ("mla-phi", ("mla-phi", None))])
def test_profile_chunk_model_ids(model_id, want):
    from mla_tpu_torch import profile_chunk

    assert profile_chunk.parse_model_id(model_id) == want


@pytest.mark.parametrize("model_id", ["mla-phi-int4", "mla-phi-int8", "mla-2b-int4", "mla-13b"])
def test_profile_chunk_refuses_other_ids(model_id):
    from mla_tpu_torch import profile_chunk

    with pytest.raises(ValueError):
        profile_chunk.parse_model_id(model_id)


def test_train_step_cuts_mistral_to_one_card():
    """mla-mistral trains at Mistral-7B's widths with 8 decoder layers, as
    mla-2b cuts mla-7b; the other presets keep their depth."""
    from mla_tpu_torch import train_step
    from mla_tpu_torch.conf.models import get_model_config

    cfg = train_step.model_config("mla-mistral")
    full = get_model_config("mla-mistral").llama
    assert cfg.llama.num_layers == 8 and full.num_layers == 32
    assert (cfg.llama.hidden_size, cfg.llama.intermediate_size, cfg.llama.num_kv_heads) == (4096, 14336, 8)
    assert train_step.model_config("mla-2b").llama.num_layers == 8
    assert train_step.model_config("mla-phi").llama.num_layers == 32
