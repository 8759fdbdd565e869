"""The port's trainer, `python -m mla_tpu_torch.train`, on the CPU at
mla-tiny-debug (fp32, gradient accumulation 2): two steps write
step-000002 and `latest`; its losses and state equal a loop assembled by
hand from make_train_step on the same DummyDataset batches and
step_generator draws, bit for bit; a resume logs "resuming from", writes
step-000004 and equals a hand replay of steps 2 and 3 from the loaded
checkpoint (the data start again at batch 0, as the JAX loop's do); SIGTERM
to a training subprocess after its first metrics line gives one checkpoint
and exit code 0, and a resume from it (as tests/test_training.py holds the
JAX trainer); the AR loss mode trains lm_head; what is not ported raises."""

import logging
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from mla_tpu_torch import params as P
from mla_tpu_torch import train
from mla_tpu_torch.conf.models import get_model_config
from mla_tpu_torch.diffusion import gaussian as gd
from mla_tpu_torch.training import checkpointing as ckpt
from mla_tpu_torch.training import optim, strategy
from mla_tpu_torch.utils import step_generator
from mla_tpu_torch.vla.dummy import DummyDataset

ROOT = Path(__file__).resolve().parent.parent
SEED = 42  # mla-tiny-debug's


def argv(root, *extra):
    return ["--device", "cpu", "--vla.type", "mla-tiny-debug", "--per_device_batch_size", "2",
            "--global_batch_size", "4", "--run_root_dir", str(root), "--run_id", "cli", *extra]


def hand_run():
    """The trainer's pieces assembled by hand: mla-tiny (fp32) from the
    seed, AdamW with lm_head frozen (diffusion mode), accumulation 2."""
    cfg = get_model_config("mla-tiny")
    params, mstate = P.init(cfg, seed=SEED, device="cpu")
    opt, _, _ = optim.make_optimizer(params, learning_rate=2e-5, num_training_steps=4, extra_frozen=("lm_head",))
    tcfg = strategy.TrainConfig(grad_accumulation_steps=2, repeated_diffusion_steps=4)
    step = strategy.make_train_step(cfg, tcfg, gd.create_schedule("", diffusion_steps=100))
    return strategy.init_train_state(params, opt, mstate), step, iter(DummyDataset(cfg, batch_size=4, seed=SEED))


def leaves(state):
    out = {f"params/{p}": t for p, t in P.tree_items(state["params"])}
    out.update({f"model_state/{p}": t for p, t in P.tree_items(state["model_state"])})
    out.update({f"opt/{p}/{n}": t for p, d in state["optimizer"].state_dict()["leaves"].items() for n, t in d.items()})
    return out


def assert_same_state(got, want):
    g, w = leaves(got), leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert torch.equal(g[k], w[k]), k
    assert got["step"] == want["step"] and got["optimizer"].count == want["optimizer"].count


@pytest.fixture
def log_lines():
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = logging.getLogger("mla_tpu_torch")
    logger.addHandler(handler)
    yield records
    logger.removeHandler(handler)


def test_train_resume_and_hand_replay(tmp_path, log_lines):
    first = train.main(argv(tmp_path, "--max_steps", "2", "--save_interval", "2"))
    ckdir = tmp_path / "cli" / "checkpoints"
    names = sorted(p.name for p in ckdir.iterdir())
    assert names[0] == "latest" and names[1].startswith("step-000002-epoch-00-loss=") and len(names) == 2
    assert {"config.json", "dataset_statistics.json", "run-metrics.jsonl", "cli.jsonl"} <= {
        p.name for p in (tmp_path / "cli").iterdir()}

    # the CLI's steps against make_train_step on the same batches and draws
    state, step, data = hand_run()
    losses, norms = [], []
    for s in range(2):
        state, m = step(state, next(data), step_generator(SEED, s, "cpu"))
        losses.append(float(m["total_loss"]))
        norms.append(float(m["grad_norm"]))
    assert list(first["metrics"].windows["total_loss"]) == losses
    assert list(first["metrics"].windows["grad_norm"]) == norms
    assert_same_state(first["state"], state)

    resumed = train.main(argv(tmp_path, "--max_steps", "4", "--save_interval", "2", "--is_resume", "true"))
    assert any(l.startswith("resuming from ") and l.endswith(names[1]) for l in log_lines), log_lines
    assert any(p.name.startswith("step-000004-") for p in ckdir.iterdir())
    assert ckpt.latest_checkpoint(tmp_path / "cli").name.startswith("step-000004-")

    # hand replay: a fresh state, the step-2 checkpoint, the data from batch 0
    state, step, data = hand_run()
    state = ckpt.load_checkpoint(ckdir / names[1], state)
    for s in (2, 3):
        state, m = step(state, next(data), step_generator(SEED, s, "cpu"))
    assert_same_state(resumed["state"], state)
    assert resumed["load_s"] is not None and [s for s, _ in resumed["saves"]] == [4]


def test_sigterm_saves_one_checkpoint_and_resumes(tmp_path):
    args = [sys.executable, "-m", "mla_tpu_torch.train", *argv(tmp_path, "--max_steps", "500", "--save_interval",
                                                                  "1000", "--use_contrastive", "false")]
    run_dir = tmp_path / "cli"
    log_path = tmp_path / "trainer.log"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    with open(log_path, "w") as log_f:
        proc = subprocess.Popen(args, cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT, env=env)
        try:
            deadline = time.time() + 120
            while time.time() < deadline:
                jsonl = run_dir / "cli.jsonl"
                if jsonl.exists() and jsonl.read_text().strip():
                    break
                if proc.poll() is not None:
                    raise AssertionError(f"trainer died early:\n{log_path.read_text()[-4000:]}")
                time.sleep(0.2)
            else:
                raise AssertionError(f"no training step within 120 s:\n{log_path.read_text()[-4000:]}")
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = log_path.read_text()
    assert proc.returncode == 0, out[-4000:]
    assert "preempted: checkpoint saved" in out, out[-4000:]
    ckpts = sorted((run_dir / "checkpoints").glob("step-*"))
    assert len(ckpts) == 1, ckpts
    saved = ckpt.parse_step_epoch(ckpts[0])[0]
    assert 1 <= saved < 500
    train.main(argv(tmp_path, "--max_steps", str(saved + 1), "--is_resume", "true", "--use_contrastive", "false"))
    assert any(p.name.startswith(f"step-{saved + 1:06d}") for p in (run_dir / "checkpoints").iterdir())


def test_ar_loss_mode_trains_lm_head(tmp_path):
    out = train.main(argv(tmp_path, "--max_steps", "1", "--use_diff", "false"))
    m = out["metrics"].windows
    assert m["ar_loss"][0] > 0 and m["diff_loss"][0] == 0.0 and m["total_loss"][0] > m["ar_loss"][0]
    opt = out["state"]["optimizer"].state_dict()["leaves"]
    assert "llm_backbone/lm_head/w" in opt and "x_embedder/fc1/w" not in opt


@pytest.mark.parametrize("extra,err,match", [
    (["--bogus_flag", "1"], ValueError, "unknown override --bogus_flag"),
    # one process without a launch cannot hold dp 2 or tp 2 (a torchrun
    # launch trains over --dp, tests/test_torch_distributed.py, and over
    # --tp, tests/test_torch_tp_train.py)
    (["--dp", "2"], ValueError, "not divisible by dp"),
    (["--tp", "2"], ValueError, r"not divisible by dp\*tp"),
    # a data root is read now: one without the mix's dataset is refused
    (["--data_root_dir", "{tmp}/no_data"], FileNotFoundError, "no dataset directory"),
    # a JAX orbax run dir: the port cannot read it without JAX
    (["--pretrained_checkpoint", "{tmp}/orbax_run"], ValueError, "export_reference_pt"),
], ids=["unknown-flag", "dp", "tp", "data-root", "pretrained"])
def test_refusals(tmp_path, extra, err, match):
    step = tmp_path / "orbax_run" / "checkpoints" / "step-000001-epoch-00-loss=0.5000"
    step.mkdir(parents=True)
    (step / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(err, match=match):
        train.main(argv(tmp_path, "--max_steps", "1", *(a.format(tmp=tmp_path) for a in extra)))


def test_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--vla.type", "mla-tiny-debug", "--run_root_dir", str(tmp_path), "--max_steps", "1"])
