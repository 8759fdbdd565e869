"""The sampler qualification entry (mla_tpu_torch/qualify_samplers.py)
against scripts/qualify_samplers.py on mla-tiny: the JAX script trains the
model for two steps, its weights go across with params.from_jax, and both
measure the same samplers on the same observations and x_T. The port's
training phase replays the JAX step's draws and matches its losses."""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mla_tpu.models import prismatic as jprismatic
from mla_tpu_torch import qualify_samplers as tqs
from torch_train_parity import from_jax, jax_draws, jconfig, tconfig

ROOT = Path(__file__).resolve().parent.parent
STEPS, SEED = 2, 0
ARGV = ["--model", "mla-tiny", "--train_steps", str(STEPS), "--weight_seeds", str(SEED), "--scenarios", "1",
        "--samplers", "ddim8", "dpm4", "--compare_int8", "--compare_bf16s"]
# the deltas are relative to the DDIM-100 chunk's rms; both packages run
# the same fp32 graphs but for summation order (and the W8A8 rounding of
# an activation that sits on a quantization step)
RTOL, ATOL = 1e-3, 1e-6


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_qualify_samplers", ROOT / "scripts" / "qualify_samplers.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_run():
    """The JAX script's trained weights, its step losses and its printed
    result."""
    from mla_tpu.training import strategy as jstrategy

    mp = pytest.MonkeyPatch()
    # JAX picks 'dequant' off the TPU; the port runs W8A8
    mp.setenv("MLA_INT8_MODE", "w8a8")
    losses = []
    make = jstrategy.make_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch, rng):
            state, metrics = step(state, batch, rng)
            losses.append(float(metrics["total_loss"]))
            return state, metrics

        return run

    mp.setattr(jstrategy, "make_train_step", recording)
    js = _jax_script()
    trained = js.trained_model("mla-tiny", SEED, STEPS)
    mp.setattr(js, "trained_model", lambda *a, **kw: trained)
    out = []
    mp.setattr("builtins.print", lambda *a, **kw: out.append(a[0]) if not kw.get("file") else None)
    try:
        js.main(ARGV)
    finally:
        mp.undo()
    rows = max(len(jax.devices()), 2)
    return {"params": trained[0], "state": trained[1], "losses": losses, "rows": rows,
            "result": json.loads(out[-1])}


def test_qualification_matches_the_jax_script(jax_run):
    args = tqs.parser().parse_args(ARGV + ["--device", "cpu"])
    cfg = tconfig("mla-tiny", use_contrastive=False)
    got = tqs.run(args, models=lambda seed: (from_jax(jax_run["params"]), from_jax(jax_run["state"]), cfg),
                  noise_fn=lambda c, si: np.random.default_rng(9000 + si).normal(
                      size=(c.action_horizon, c.action_dim)).astype(np.float32))
    want = jax_run["result"]
    assert set(got["samplers"]) == set(want["samplers"]) == {"ddim8", "dpm4"}
    for name, metrics in want["samplers"].items():
        for key, value in metrics.items():
            np.testing.assert_allclose(got["samplers"][name][key], value, rtol=RTOL, atol=ATOL, err_msg=f"{name} {key}")
    np.testing.assert_allclose(got["dpm4_vs_ddim8_rms_ratio"], want["dpm4_vs_ddim8_rms_ratio"], rtol=RTOL)
    for key in ("int8_vs_bf16", "bf16_scores_vs_fp32"):
        assert set(got[key]) == set(want[key]) == {"rel_rms", "rel_max", "gripper_agree"}
        for k, value in want[key].items():
            np.testing.assert_allclose(got[key][k], value, rtol=RTOL, atol=ATOL, err_msg=f"{key} {k}")
    assert {k: got[k] for k in ("model", "scenarios", "weight_seeds", "train_steps", "optimizer")} == {
        k: want[k] for k in ("model", "scenarios", "weight_seeds", "train_steps", "optimizer")}


def test_training_phase_matches_the_jax_losses(jax_run):
    """The port's train() from the JAX init, with each JAX step's draws
    (PRNGKey(i)) replayed, gives the JAX step's losses."""
    jcfg = jconfig("mla-tiny", use_contrastive=False)
    params, state = jprismatic.mla_model_init(jax.random.PRNGKey(SEED), jcfg)
    rows = jax_run["rows"]
    _, _, losses = tqs.train(from_jax(params), from_jax(state), tconfig("mla-tiny", use_contrastive=False), STEPS,
                             SEED, rows=rows, draws=lambda i: jax_draws(jax.random.PRNGKey(i), jcfg, rows))
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-4)


def test_noise_is_one_seeded_draw_per_scenario():
    cfg = tconfig("mla-tiny")
    a, b = tqs.scenario_noise(cfg, 0), tqs.scenario_noise(cfg, 1)
    assert a.shape == (cfg.action_horizon, cfg.action_dim) and a.dtype == np.float32
    assert np.array_equal(a, tqs.scenario_noise(cfg, 0)) and not np.array_equal(a, b)


def test_unknown_sampler_and_missing_card_are_refused(monkeypatch):
    with pytest.raises(SystemExit):
        tqs.main(["--samplers", "ddim9"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tqs.run(tqs.parser().parse_args(["--model", "mla-tiny"]))
