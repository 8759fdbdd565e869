"""The port's trackers and VLAMetrics (training/metrics.py) against the JAX
package's: for the same commits (losses as numbers and as 0-d tensors),
run-metrics.jsonl is the same, every line of <run_id>.jsonl has the same
keys and the same values but for the timing fields (step time, tokens/s,
MFU, which read each process's clock), and push() returns the same line
once its step time is masked; W&B without wandb warns and disables itself
in both; and decoder_flops_per_token counts what JAX's counts."""

import json
import logging
import re

import jax
import numpy as np
import pytest
import torch

from mla_tpu.conf.models import get_model_config as jconfig
from mla_tpu.models import prismatic as jprismatic
from mla_tpu.training import metrics as jmetrics
from mla_tpu_torch.params import from_jax
from mla_tpu_torch.training import metrics as tmetrics

TIMING = ("VLA Train/Step Time", "VLA Train/Tokens per Sec", "VLA Train/MFU")
HPARAMS = {"lr": 1e-4, "stage": "pretrain", "nested": {"a": [1, 2]}, "dtype": object()}


def commits(step):
    rng = np.random.default_rng(step)
    # fp32 values, as a train step's losses are, so a 0-d fp32 tensor holds them exactly
    losses = {k: float(np.float32(rng.uniform(0.1, 3.0))) for k in ("total_loss", "diff_loss", "img_pc_contrastive_loss",
                                                          "grad_norm")}
    losses["ar_loss"] = 0.0
    return dict(global_step=step, epoch=step // 4, lr=1e-4 * (1 + step), update_step_time=True, tokens=4096 + step,
                **losses)


def run(mod, tmp, as_tensor: bool):
    m = mod.VLAMetrics(["jsonl"], "run-x", tmp, HPARAMS, window_size=3, resume_step=5,
                       flops_per_token=6e9, peak_flops=989e12)
    lines = []
    for step in range(5, 12):
        c = commits(step)
        if as_tensor:
            c = {k: torch.tensor(v) if k.endswith(("_loss", "_norm")) else v for k, v in c.items()}
        m.commit(**c)
        if step % 3 == 0 or step == 11:
            lines.append(re.sub(r"Step Time :: [0-9.]+s", "Step Time :: <t>s", m.push()))
    m.finalize()
    return lines


def test_jsonl_and_push_match_jax(tmp_path):
    jlines = run(jmetrics, tmp_path / "jax", as_tensor=False)
    tlines = run(tmetrics, tmp_path / "port", as_tensor=True)
    assert tlines == jlines and len(jlines) == 3
    assert (tmp_path / "port" / "run-metrics.jsonl").read_text() == (tmp_path / "jax" / "run-metrics.jsonl").read_text()
    jrec = [json.loads(l) for l in (tmp_path / "jax" / "run-x.jsonl").read_text().splitlines()]
    trec = [json.loads(l) for l in (tmp_path / "port" / "run-x.jsonl").read_text().splitlines()]
    assert len(trec) == len(jrec) == 3
    for t, j in zip(trec, jrec):
        assert list(t) == list(j)
        assert all(k in t for k in TIMING)
        assert {k: v for k, v in t.items() if k not in TIMING} == {k: v for k, v in j.items() if k not in TIMING}


def test_wandb_absent_disables_the_tracker(tmp_path, caplog, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_wandb(name, *a, **kw):
        if name == "wandb":
            raise ImportError("No module named 'wandb'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_wandb)
    for mod in (jmetrics, tmetrics):
        caplog.clear()
        logger = logging.getLogger(mod.overwatch.logger.name)
        logger.addHandler(caplog.handler)
        try:
            m = mod.VLAMetrics(["jsonl", "wandb"], "run-w", tmp_path / mod.__name__, {"a": 1})
            m.commit(global_step=0, total_loss=1.0, update_step_time=True)
            m.push()
            m.finalize()
        finally:
            logger.removeHandler(caplog.handler)
        assert m.trackers[1]._run is None
        assert any("wandb unavailable" in r.getMessage() and "tracker disabled" in r.getMessage()
                   for r in caplog.records), mod.__name__


@pytest.mark.parametrize("use_diff", [True, False])
def test_flops_per_token_matches_jax(use_diff):
    params, _ = jprismatic.mla_model_init(jax.random.PRNGKey(0), jconfig("mla-tiny"))
    bb = jax.device_get(params["llm_backbone"])
    assert tmetrics.decoder_flops_per_token(from_jax(bb), use_diff) == jmetrics.decoder_flops_per_token(bb, use_diff)
    assert tmetrics.bf16_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert tmetrics.bf16_peak_flops("cpu") is None
