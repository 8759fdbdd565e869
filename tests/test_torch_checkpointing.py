"""The port's checkpointing (training/checkpointing.py) against the JAX
package's where both define the same thing, and on its own where the format
is the port's: the checkpoint names and their parsing equal JAX's; garbage
collection and the stale-`latest` fallback leave and find the same
checkpoints as JAX's do on the same run dir; a save and a load into a fresh
state give back every leaf bit for bit (parameters, AdamW and Adafactor
state, batch-norm state, EMA, the step); an async save keeps the values the
state had when it returned, though the parameters change in place right
after; and export_reference_checkpoint gives JAX's arrays, key for key and
bit for bit, on weights carried across by params.from_jax."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mla_tpu.conf.models import get_model_config as jconfig
from mla_tpu.models import convert as jconvert
from mla_tpu.models import prismatic as jprismatic
from mla_tpu.training import checkpointing as jckpt
from mla_tpu_torch import params as P
from mla_tpu_torch.conf.models import get_model_config as tconfig
from mla_tpu_torch.diffusion import gaussian as tgd
from mla_tpu_torch.models import convert as tconvert
from mla_tpu_torch.training import checkpointing as tckpt
from mla_tpu_torch.training import optim, strategy
from mla_tpu_torch.vla.dummy import synthetic_batch


@pytest.mark.parametrize("step,epoch,loss", [(0, 0, None), (2, 0, 1.23456), (123456, 7, 0.0), (5, 12, 10.5)])
def test_names_match_jax(step, epoch, loss):
    name = tckpt._ckpt_name(step, epoch, loss)
    assert name == jckpt._ckpt_name(step, epoch, loss)
    assert tckpt.parse_step_epoch(f"/runs/x/checkpoints/{name}") == jckpt.parse_step_epoch(name) == (step, epoch)
    assert tckpt.parse_step_epoch("no-checkpoint-here") == jckpt.parse_step_epoch("no-checkpoint-here") == (0, 0)


def _fake_run(root: Path, tmp_suffix: str, latest: str):
    ckpt = root / "checkpoints"
    ckpt.mkdir(parents=True)
    for s in (1, 2, 3, 4, 5):
        name = jckpt._ckpt_name(s, 0, 0.5)
        (ckpt / name).mkdir()
        (ckpt / name).with_suffix(".pt").write_bytes(b"x")
    (ckpt / (jckpt._ckpt_name(6, 0, 0.5) + tmp_suffix)).mkdir()
    (ckpt / "latest").write_text(latest)
    return ckpt


@pytest.mark.parametrize("latest", ["step-000004-epoch-00-loss=0.5000", "step-000006-epoch-00-loss=0.5000",
                                    "step-000009-epoch-00-loss=0.5000"],
                         ids=["names-complete", "names-unfinished", "names-missing"])
def test_gc_and_latest_match_jax(tmp_path, latest):
    """The same run dir under each package's unfinished-write suffix: GC
    with keep=3 removes the same checkpoints and their .pt companions, and
    latest_checkpoint names the same one (falling back past a `latest` that
    names an unfinished or missing checkpoint)."""
    jdir = _fake_run(tmp_path / "jax", ".orbax-checkpoint-tmp-1", latest)
    tdir = _fake_run(tmp_path / "port", ".tmp-1", latest)
    assert tckpt.latest_checkpoint(tdir.parent).name == jckpt.latest_checkpoint(jdir.parent).name
    want = "step-000004-epoch-00-loss=0.5000" if latest.startswith("step-000004") else "step-000005-epoch-00-loss=0.5000"
    assert tckpt.latest_checkpoint(tdir.parent).name == want
    jckpt._gc_old_checkpoints(jdir, 3)
    tckpt._gc_old_checkpoints(tdir, 3)

    def listing(d, suffix):
        return sorted(p.name.replace(suffix, "<tmp>") for p in d.iterdir())

    assert listing(tdir, ".tmp-1") == listing(jdir, ".orbax-checkpoint-tmp-1")
    assert not any(p.name.startswith(("step-000001", "step-000002")) for p in tdir.iterdir())
    assert tckpt.latest_checkpoint(tmp_path / "nowhere") is None


def _state(seed: int, optimizer: str = "adamw", steps: int = 1):
    """mla-tiny's train state after `steps` steps (so the optimizer holds
    moments), with EMA."""
    cfg = tconfig("mla-tiny")
    params, mstate = P.init(cfg, seed=seed, device="cpu")
    opt, _, _ = optim.make_optimizer(params, learning_rate=1e-3, num_training_steps=10, optimizer=optimizer,
                                     extra_frozen=("lm_head",))
    state = strategy.init_train_state(params, opt, mstate, use_ema=True)
    step = strategy.make_train_step(cfg, strategy.TrainConfig(repeated_diffusion_steps=1, ema_decay=0.9), opt,
                                    tgd.create_schedule("", diffusion_steps=100))
    for i in range(steps):
        state, _ = step(state, synthetic_batch(cfg, B=2, L=16, seed=i), torch.Generator().manual_seed(i))
    return state


def _leaves(state):
    out = {f"params/{p}": t for p, t in P.tree_items(state["params"])}
    out.update({f"model_state/{p}": t for p, t in P.tree_items(state["model_state"])})
    out.update({f"ema_params/{p}": t for p, t in P.tree_items(state["ema_params"])})
    opt = state["optimizer"].state_dict()
    out.update({f"opt/{p}/{n}": t for p, d in opt["leaves"].items() for n, t in d.items()})
    return out, opt["count"], state["step"]


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_round_trip_is_bitwise(tmp_path, optimizer):
    live = _state(0, optimizer, steps=2)
    path = tckpt.save_checkpoint(tmp_path, live, step=2, loss=1.5)
    assert path.name == "step-000002-epoch-00-loss=1.5000" and (path / tckpt.STATE_FILE).is_file()
    assert tckpt.latest_checkpoint(tmp_path) == path
    blob = torch.load(path / tckpt.STATE_FILE, weights_only=True)
    assert blob["step"] == 2 and all(t.device.type == "cpu" for _, t in P.tree_items(blob["params"]))
    fresh = _state(1, optimizer, steps=0)
    fresh = tckpt.load_checkpoint(path, fresh)
    want, want_count, want_step = _leaves(live)
    got, got_count, got_step = _leaves(fresh)
    assert sorted(got) == sorted(want) and len(want) > 100
    assert (got_count, got_step) == (want_count, want_step) == (2, 2)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    assert any(k.startswith("opt/") and "lm_head" not in k for k in want)
    assert not any("lm_head" in k for k in want if k.startswith("opt/"))


def test_load_refuses_another_tree(tmp_path):
    path = tckpt.save_checkpoint(tmp_path, _state(0, steps=0), step=0)
    other = _state(0, steps=0)
    other["params"]["proprio_embedder"]["fc1"]["w"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="proprio_embedder/fc1/w"):
        tckpt.load_checkpoint(path, other)


def test_async_save_keeps_the_values_at_return(tmp_path):
    live = _state(0, steps=1)
    before, _, _ = _leaves(live)
    before = {k: t.clone() for k, t in before.items()}
    path = tckpt.save_checkpoint(tmp_path, live, step=1, loss=0.25, async_save=True)
    with torch.no_grad():
        for _, t in P.tree_items(live["params"]):
            t.add_(1.0)
    tckpt.wait_for_async_saves()
    assert not any(".tmp-" in p.name for p in path.parent.iterdir())
    fresh = tckpt.load_checkpoint(path, _state(1, steps=0))
    got, _, _ = _leaves(fresh)
    for k, t in before.items():
        assert torch.equal(got[k], t), k


def test_gc_of_real_saves_removes_reference_exports(tmp_path):
    live = _state(0, steps=0)
    cfg = tconfig("mla-tiny")
    for s in range(1, 5):
        tckpt.save_checkpoint(tmp_path, live, step=s, loss=0.5, keep=2, also_reference_format=True, model_cfg=cfg)
    names = sorted(p.name for p in (tmp_path / "checkpoints").iterdir())
    assert names == ["latest", "step-000003-epoch-00-loss=0.5000", "step-000003-epoch-00-loss=0.pt",
                     "step-000004-epoch-00-loss=0.5000", "step-000004-epoch-00-loss=0.pt"]
    blob = torch.load(tmp_path / "checkpoints" / "step-000004-epoch-00-loss=0.pt", weights_only=True)
    assert "llm_backbone" in blob["model"] and "vision_tower_3d" in blob["model"]


def test_export_reference_checkpoint_matches_jax():
    jcfg = jconfig("mla-tiny", use_tactile=True)
    params, state = jprismatic.mla_model_init(jax.random.PRNGKey(0), jcfg)
    params, state = jax.device_get(params), jax.device_get(state)
    want = jconvert.export_reference_checkpoint(params, state, jcfg)["model"]
    got = tconvert.export_reference_checkpoint(P.from_jax(params), P.from_jax(state),
                                               tconfig("mla-tiny", use_tactile=True))["model"]
    assert sorted(got) == sorted(want)
    assert "tactile_embedder" in got and any("tactile_contrastive" in k for k in got["llm_backbone"])
    for mod, sd in want.items():
        assert sorted(got[mod]) == sorted(sd), mod
        for k, v in sd.items():
            assert got[mod][k].dtype == v.dtype and got[mod][k].shape == v.shape, (mod, k)
            assert np.array_equal(got[mod][k], v), (mod, k)
