"""Loading (mla_tpu_torch/models/{convert,load}.py) against the JAX
package: every convert_* and load_reference_checkpoint bitwise on a .pt
that JAX's export writes for mla-tiny; load_vla on that .pt, on a port
trainer run dir (live and EMA weights) and on a JAX orbax run dir (which
raises); the trainer's pretrained_checkpoint."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mla_tpu.conf.models import get_model_config as jconfig
from mla_tpu.models import convert as jconvert
from mla_tpu.models import load as jload
from mla_tpu.models import prismatic as jprismatic
from mla_tpu.training import checkpointing as jckpt
from mla_tpu_torch import params as P
from mla_tpu_torch import train
from mla_tpu_torch.conf.models import get_model_config as tconfig
from mla_tpu_torch.models import convert as tconvert
from mla_tpu_torch.models import load as tload
from mla_tpu_torch.models.mla import MLAPolicy

FLAGS = {"use_tactile": True}  # the tactile embedder and heads, so every exported group is read


def _np(x):
    return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()


def assert_trees_equal(got, want, path=""):
    """Same keys, shapes, dtypes and values, leaf for leaf."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}/{i}")
    else:
        w = np.asarray(want)
        g = _np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
        assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape, w.shape, g.dtype, w.dtype)
        assert np.array_equal(g, w), path


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """(JAX params, state, cfg, path of the .pt JAX's export_reference_pt
    wrote, the state dicts) for mla-tiny with tactile input."""
    cfg = jconfig("mla-tiny", **FLAGS)
    params, state = jax.device_get(jprismatic.mla_model_init(jax.random.PRNGKey(3), cfg))
    path = tmp_path_factory.mktemp("ref") / "ref.pt"
    jckpt.export_reference_pt(path, {"params": params, "model_state": state}, cfg)
    model = torch.load(path, weights_only=True)["model"]
    return params, state, cfg, path, model


def _sd(model, name):
    return {k: v for k, v in model[name].items()}


@pytest.mark.parametrize("name,convert", [
    ("llm_backbone", lambda j, sd, cfg: j.convert_llama(sd, cfg.llama.num_layers)),
    ("llm_backbone", lambda j, sd, cfg: j.convert_contrastive(sd)),
    ("vision_tower_2d", lambda j, sd, cfg: j.convert_vision_tokenizer(sd)),
    ("projector_2d", lambda j, sd, cfg: j.convert_mlp_gelu(sd)),
    ("vision_tower_3d", lambda j, sd, cfg: j.convert_point_tokenizer(sd, cfg.point.num_stages, cfg.point.lga_blocks)),
    ("projector_3d", lambda j, sd, cfg: j.convert_mlp_projector(sd)),
    ("proprio_embedder", lambda j, sd, cfg: j.convert_action_embedder(sd)),
    ("tactile_embedder", lambda j, sd, cfg: j.convert_action_embedder(sd)),
    ("t_embedder", lambda j, sd, cfg: j.convert_timestep_embedder(sd)),
    ("final_layer", lambda j, sd, cfg: j.convert_final_layer(sd)),
], ids=["llama", "contrastive", "vision_tokenizer", "mlp_gelu", "point_tokenizer", "mlp_projector",
        "action_embedder", "tactile_embedder", "timestep_embedder", "final_layer"])
def test_converters_match_jax(jax_export, name, convert):
    _, _, cfg, _, model = jax_export
    assert_trees_equal(convert(tconvert, _sd(model, name), cfg), convert(jconvert, _sd(model, name), cfg))


class _Keys(dict):
    """Records the keys a converter reads (any key is present)."""

    def __init__(self):
        super().__init__()
        self.read = []

    def __contains__(self, key):
        return True

    def __getitem__(self, key):
        self.read.append(key)
        return np.zeros((2, 2), np.float32)


def test_generation_manager_converter_matches_jax():
    """JAX's export does not write the generation heads, so their state dict
    is the keys JAX's converter reads, each a seeded random [3, 5] tensor
    (the converters only transpose, reshape and regroup)."""
    cfg = jconfig("mla-tiny", use_generation=True, use_tactile=True)
    keys = _Keys()
    jconvert.convert_generation_manager(keys, cfg.gen)
    rng = np.random.default_rng(0)
    sd = {k: torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)) for k in dict.fromkeys(keys.read)}
    got = tconvert.convert_generation_manager(sd, tconfig("mla-tiny", use_generation=True, use_tactile=True).gen)
    assert_trees_equal(got, jconvert.convert_generation_manager(sd, cfg.gen))


def test_vocab_padding_matches_jax():
    """convert_llama's target_vocab rows (the HF loaders' resize): fp32
    means, within 1e-6 of JAX's (numpy and torch sum in other orders)."""
    cfg = jconfig("mla-tiny")
    params, _ = jax.device_get(jprismatic.mla_model_init(jax.random.PRNGKey(0), cfg))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in jconvert.export_llama(params["llm_backbone"]).items()}
    sd["llm.model.embed_tokens.weight"] = sd["llm.model.embed_tokens.weight"][:32000]
    sd["llm.lm_head.weight"] = sd["llm.lm_head.weight"][:32000]
    got = tconvert.convert_llama(sd, cfg.llama.num_layers, target_vocab=32064)
    want = jconvert.convert_llama(sd, cfg.llama.num_layers, target_vocab=32064)
    for key in ("embed", "lm_head"):
        g, w = next(iter(got[key].values())), next(iter(want[key].values()))
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)


def test_load_reference_checkpoint_matches_jax(jax_export):
    params, state, cfg, path, _ = jax_export
    base_p, base_s = jax.device_get(jprismatic.mla_model_init(jax.random.PRNGKey(9), cfg))
    want_p, want_s = jconvert.load_reference_checkpoint(path, cfg, base_params=base_p, base_state=base_s)
    got_p, got_s = tconvert.load_reference_checkpoint(path, tconfig("mla-tiny", **FLAGS), base_params=P.from_jax(base_p),
                                                      base_state=P.from_jax(base_s))
    assert_trees_equal(got_p, want_p)
    assert_trees_equal(got_s, want_s)


def test_load_vla_on_a_reference_pt_matches_jax(jax_export, tmp_path):
    """A reference run dir (config.json recording the model, the .pt under
    checkpoints/): the same trees as JAX's load_vla, floating leaves in the
    model's param dtype; the policy serves."""
    import json
    import shutil

    _, _, _, path, _ = jax_export
    run = tmp_path / "run"
    (run / "checkpoints").mkdir(parents=True)
    shutil.copy(path, run / "checkpoints" / "ref.pt")
    (run / "config.json").write_text(json.dumps({"train": {"base_vlm": "mla-tiny", **FLAGS}}))
    stats = {"t": {"action": {"q01": [-1.0] * 7, "q99": [1.0] * 7}}}
    (run / "dataset_statistics.json").write_text(json.dumps(stats))
    want = jload.load_vla(run, load_for_training=True)
    got = tload.load_vla(run, load_for_training=True, device="cpu")
    assert_trees_equal(got[0], jax.device_get(want[0]))
    assert_trees_equal(got[1], jax.device_get(want[1]))
    assert got[3] == want[3] == stats and got[2].use_tactile
    pol = tload.load_vla(run / "checkpoints" / "ref.pt", model_id="mla-tiny", device="cpu", use_tactile=True)
    assert isinstance(pol, MLAPolicy) and pol.norm_stats == stats
    img = np.zeros((3, 168, 168), np.uint8)
    pc = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    out = pol.predict_action_diff(img, pc, "", input_ids=np.array([[1, 5, 6, 29871]], np.int32), sampler="dpm")
    assert out.shape == (16, 7) and np.isfinite(out).all()
    with pytest.raises(ValueError, match="ema_params"):
        tload.load_vla(run, use_ema=True, device="cpu")


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    out = train.main(["--vla.type", "mla-tiny-debug", "--device", "cpu", "--run_root_dir", str(root),
                      "--max_steps", "2", "--save_interval", "2", "--use_ema", "true"])
    return out


@pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema"])
def test_load_vla_on_a_port_run_dir(trained_run, use_ema):
    """The trainer's run dir (config.json with base_vlm mla-tiny, the
    state.pt of step 2): the run's live params (or EMA params) and model
    state, bit for bit."""
    live = trained_run["state"]
    params, state, cfg, stats = tload.load_vla(trained_run["run_dir"], load_for_training=True, use_ema=use_ema,
                                               device="cpu")
    want = live["shards"].host_state(live)["ema_params"] if use_ema else live["params"]
    assert_trees_equal(params, P.tree_map(lambda t: t.detach().numpy(), want))
    assert_trees_equal(state, P.tree_map(lambda t: t.detach().numpy(), live["model_state"]))
    assert cfg.llama.num_layers == tconfig("mla-tiny").llama.num_layers and "dummy" in stats
    step_dir = tload._resolve_checkpoint(Path(trained_run["run_dir"]))
    assert step_dir.name.startswith("step-000002")


def test_load_vla_refuses_a_jax_orbax_run_dir(tmp_path):
    """A real orbax checkpoint written by the JAX package's save_checkpoint:
    the port names export_reference_pt as the way across."""
    cfg = jconfig("mla-tiny")
    params, state = jprismatic.mla_model_init(jax.random.PRNGKey(0), cfg)
    jckpt.save_checkpoint(tmp_path, {"params": params, "model_state": state}, step=1, loss=0.5)
    with pytest.raises(ValueError, match="export_reference_pt"):
        tload.load_vla(tmp_path, model_id="mla-tiny", device="cpu")


def test_load_vla_defaults_to_the_card(jax_export, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tload.load_vla(jax_export[3], model_id="mla-tiny")


def test_trainer_starts_from_a_pretrained_checkpoint(trained_run, tmp_path):
    """--pretrained_checkpoint <run dir>: the new run's first state is the
    old run's params (load_vla(..., load_for_training=True)), and it trains."""
    argv = ["--vla.type", "mla-tiny-debug", "--device", "cpu", "--run_root_dir", str(tmp_path), "--max_steps", "1",
            "--run_id", "ft", "--pretrained_checkpoint", str(trained_run["run_dir"])]
    built = train.build(argv)
    assert_trees_equal(built["state"]["params"],
                       P.tree_map(lambda t: t.detach().numpy(), trained_run["state"]["params"]))
    out = train.main(argv)
    assert np.isfinite(out["metrics"].windows["total_loss"][0])
