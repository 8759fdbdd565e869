"""The eval entry of the port (python -m mla_tpu_torch.eval_rlbench) against
scripts/eval_rlbench.py on the CPU, both on one reference-format run dir of
mla-tiny (a .pt that JAX's export writes and both packages load): the
offline replay's predicted_actions.npz with the same x_T injected into both
policies through a wrapped load_policy (DDIM-8; DPM-3 with --voxel_cell on
oversized clouds), the simulator loop over a stub lift3d RLBenchEnv in both
predict modes (episode accounting, the telemetry lines, the success-rate
files, results.json, teardown, the actions executed), the env-recorder
route, the PNG frames against JAX's PIL-written ones, and --device."""

import importlib
import json
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from mla_tpu.conf.models import get_model_config as jconfig
from mla_tpu.models import prismatic as jprismatic
from mla_tpu.training import checkpointing as jckpt
from mla_tpu_torch import eval_rlbench as tev

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
jev = importlib.import_module("eval_rlbench")

STATS = {"rlbench": {"action": {"q01": [-0.5] * 6 + [0.0], "q99": [0.5] * 6 + [1.0]},
                     "proprio": {"q01": [-1.0] * 7, "q99": [1.0] * 7}}}
# fp32 end to end on both sides, the same weights, frames and x_T: the
# tolerance of tests/test_torch_policy_fp32.py's chunks
RTOL = ATOL = 1e-4


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A reference run dir: config.json recording mla-tiny, the dataset
    statistics, checkpoints/mla-tiny.pt from JAX's export; the final layer
    drawn live (the init's zero fc2 would make every chunk the model's
    no-op)."""
    cfg = jconfig("mla-tiny")
    params, state = jax.device_get(jprismatic.mla_model_init(jax.random.PRNGKey(21), cfg))
    fc2 = params["final_layer"]["mlp"]["fc2"]
    fc2["w"] = np.random.default_rng(21).normal(size=fc2["w"].shape).astype(np.float32) * 0.02
    run = tmp_path_factory.mktemp("eval") / "run"
    (run / "checkpoints").mkdir(parents=True)
    jckpt.export_reference_pt(run / "checkpoints" / "mla-tiny.pt", {"params": params, "model_state": state}, cfg)
    (run / "config.json").write_text(json.dumps({"train": {"base_vlm": "mla-tiny"}}))
    (run / "dataset_statistics.json").write_text(json.dumps(STATS))
    return run


def _noise():
    return np.random.default_rng(5).standard_normal((16, 7)).astype(np.float32)


def _inject(monkeypatch, mod, noise):
    """mod.load_policy wrapped: the policy's predict_action_diff gets
    `noise` as its x_T (predict_action_diff_ar reaches it too) and returns
    the chunk before the clip and the unnormalization: a random mla-tiny's
    chunks run far past [-1, 1] (x_T / sqrt(alpha_bar) where eps is off),
    where the clip would hide the model (the unnormalization is held to
    JAX's in tests/test_torch_policy_fp32.py)."""
    real = mod.load_policy

    def load_policy(args):
        pol = real(args)
        diff = pol.predict_action_diff
        pol.predict_action_diff = lambda *a, **k: diff(*a, noise=noise, return_normalized=True, **k)
        return pol

    monkeypatch.setattr(mod, "load_policy", load_policy)


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _trace(path: Path, oversize: int, seed: int = 3, n: int = 3):
    rng = np.random.default_rng(seed)
    np.savez(path, images=rng.integers(0, 256, size=(n, 96, 128, 3), dtype=np.uint8),
             point_clouds=rng.uniform(-0.3, 0.7, size=(n, 64 * oversize, 3)).astype(np.float32),
             instruction="close the box", depths=rng.uniform(0.2, 2.0, size=(n, 96, 128)).astype(np.float32))
    return path


def _assert_video_difference(jout: Path, tout: Path, video: str, log: str):
    """JAX writes the episode's mp4 through OpenCV; the port uses no
    OpenCV, only imageio, which writes mp4 only with a backend (imageio-ffmpeg
    or pyav) installed: the one file in which the layouts may differ, and
    without it the port says why in its log."""
    jfiles, tfiles = _files(jout), _files(tout)
    assert video in jfiles
    if video not in tfiles:
        assert "no video written" in log
        tfiles.append(video)
    jfiles.remove("eval.log")
    tfiles.remove("eval.log")
    assert sorted(tfiles) == sorted(jfiles)


@pytest.mark.parametrize("extra,oversize", [((), 1), (("--sampler", "dpm", "--num_dpm_steps", "3",
                                                        "--voxel_cell", "0.02"), 3)], ids=["ddim8", "dpm3_voxel"])
def test_offline_trace_matches_jax(monkeypatch, tmp_path, run_dir, extra, oversize, record_property):
    trace = _trace(tmp_path / "trace.npz", oversize)
    noise, out = _noise(), {}
    for name, mod, dev in (("jax", jev, ()), ("torch", tev, ("--device", "cpu"))):
        _inject(monkeypatch, mod, noise)
        rc = mod.main(["--run_dir", str(run_dir), "--model", "mla-tiny", "--offline_trace", str(trace),
                       "--output_dir", str(tmp_path / name), "--unnorm_key", "rlbench", *extra, *dev])
        assert rc == 0
        out[name] = np.load(tmp_path / name / "predicted_actions.npz")
    got, want = out["torch"]["actions"], out["jax"]["actions"]
    assert got.shape == (3, 16, 7) and out["torch"]["latencies"].shape == (3,)
    record_property("max_abs_err", float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.abs(got[1] - got[0]).max() > 1e-2  # the frames reach the chunks
    log = (tmp_path / "torch" / "eval.log").read_text()
    assert "offline trace: 3 steps, p50 latency" in log
    _assert_video_difference(tmp_path / "jax", tmp_path / "torch", "offline/videos/episode0_video_steps.mp4", log)
    for j in range(3):
        for sub, ext in (("images", "png"), ("depths", "npy")):
            rel = f"offline/{sub}/episode0/{'frame' if sub == 'images' else 'depth'}_{j:04d}.{ext}"
            if ext == "png":
                a, b = (np.asarray(Image.open(tmp_path / n / rel)) for n in ("torch", "jax"))
            else:
                a, b = (np.load(tmp_path / n / rel) for n in ("torch", "jax"))
            np.testing.assert_array_equal(a, b)


class _Env:
    """A stub of lift3d's RLBenchEnv replaying one observation: task
    close_box ends after 2 steps with success, any other task never ends
    (a failure after max_steps). Every executed action is recorded."""

    calls = []

    def __init__(self, task_name, camera_name):
        self.task, self.t = task_name, 0
        rng = np.random.default_rng(len(task_name))
        self.obs = {"image": rng.integers(0, 256, size=(96, 128, 3), dtype=np.uint8),
                    "point_cloud": rng.uniform(-0.3, 0.7, size=(64, 3)).astype(np.float32),
                    "depth": rng.uniform(0.2, 2.0, size=(96, 128)).astype(np.float32),
                    "instruction": f"do {task_name.replace('_', ' ')}",
                    "robot_state": rng.uniform(-0.5, 0.5, size=7).astype(np.float32)}
        _Env.calls.append(("init", task_name, camera_name))

    def reset(self):
        self.t = 0
        return dict(self.obs)

    def step(self, action):
        _Env.calls.append(("step", self.task, np.asarray(action)))
        self.t += 1
        done = self.task == "close_box" and self.t >= 2
        return dict(self.obs), float(done), done, {"success": done}

    def shutdown(self):
        _Env.calls.append(("shutdown", self.task))


@pytest.fixture
def lift3d(monkeypatch):
    pkg, envs, mod = (types.ModuleType(n) for n in ("lift3d", "lift3d.envs", "lift3d.envs.rlbench_env"))
    mod.RLBenchEnv = _Env
    for name, m in (("lift3d", pkg), ("lift3d.envs", envs), ("lift3d.envs.rlbench_env", mod)):
        monkeypatch.setitem(sys.modules, name, m)
    _Env.calls = []
    return _Env


@pytest.mark.parametrize("mode", ["diff", "diff_ar"])
def test_simulator_loop_matches_jax(monkeypatch, tmp_path, run_dir, lift3d, mode):
    """2 tasks x 2 episodes x at most 3 steps through both entries: the env
    calls (actions within the chunk tolerance), results.json, the success
    rate files, the telemetry lines of each mode, the media layout (the
    video aside) and the frames; each env shut down once."""
    noise, calls, logs = _noise(), {}, {}
    for name, mod, dev in (("jax", jev, ()), ("torch", tev, ("--device", "cpu"))):
        _inject(monkeypatch, mod, noise)
        lift3d.calls = []
        rc = mod.main(["--run_dir", str(run_dir), "--model", "mla-tiny", "--tasks", "close_box", "close_fridge",
                       "--num_episodes", "2", "--max_steps", "3", "--unnorm_key", "rlbench", "--predict_mode", mode,
                       "--sampler", "dpm", "--num_dpm_steps", "3", "--output_dir", str(tmp_path / name), *dev])
        assert rc == 0
        calls[name], logs[name] = list(lift3d.calls), (tmp_path / name / "eval.log").read_text()
    kinds = [c[:2] for c in calls["torch"]]
    assert kinds == [c[:2] for c in calls["jax"]]
    assert kinds == ([("init", "close_box")] + [("step", "close_box")] * 4 + [("shutdown", "close_box"),
                     ("init", "close_fridge")] + [("step", "close_fridge")] * 6 + [("shutdown", "close_fridge")])
    for t, j in zip(calls["torch"], calls["jax"]):
        if t[0] == "step":
            assert t[2].shape == (7,)
            np.testing.assert_allclose(t[2], j[2], rtol=RTOL, atol=ATOL)
    for name in ("jax", "torch"):
        out = tmp_path / name
        assert json.loads((out / "results.json").read_text()) == {"close_box": 1.0, "close_fridge": 0.0}
        assert (out / "close_box_success_rate.txt").read_text() == "1.0000\n"
        assert (out / "close_fridge_success_rate.txt").read_text() == "0.0000\n"
        log = logs[name]
        assert log.count("average diff infer time") == 4
        assert log.count("average ar infer time") == log.count("average ar_sum") == (4 if mode == "diff_ar" else 0)
        assert "[close_box] episode 1: success=True" in log and "[close_fridge] success rate: 0.000" in log
    jfiles = _files(tmp_path / "jax")
    for task, steps in (("close_box", 2), ("close_fridge", 3)):
        for ep in (0, 1):
            video = f"{task}/videos/episode{ep}_video_steps.mp4"
            assert video in jfiles
            assert len(list((tmp_path / "torch" / task / "images" / f"episode{ep}").glob("*.png"))) == steps
            assert len(list((tmp_path / "torch" / task / "depths" / f"episode{ep}").glob("*.npy"))) == steps
    tfiles = _files(tmp_path / "torch")
    assert sorted(set(jfiles) - set(tfiles)) == sorted(f for f in jfiles if f.endswith(".mp4"))
    assert set(tfiles) - set(jfiles) == set()
    frame = "close_fridge/images/episode1/frame_0002.png"
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "torch" / frame)),
                                  np.asarray(Image.open(tmp_path / "jax" / frame)))


def test_simulator_gate_and_task_expansion(monkeypatch, tmp_path, run_dir):
    """Without lift3d both entries log JAX's message and return 1; "all"
    expands wherever it stands, as in JAX."""
    monkeypatch.setitem(sys.modules, "lift3d", None)
    for name, mod, dev in (("jax", jev, ()), ("torch", tev, ("--device", "cpu"))):
        assert mod.main(["--run_dir", str(run_dir), "--output_dir", str(tmp_path / name), *dev]) == 1
        assert "RLBench/lift3d not available on this machine" in (tmp_path / name / "eval.log").read_text()
    seen = {}
    for name, mod, dev in (("jax", jev, ()), ("torch", tev, ("--device", "cpu"))):
        monkeypatch.setattr(mod, "run_simulator_eval", lambda args, logger, name=name: seen.update({name: args}) or 0)
        mod.main(["--run_dir", str(run_dir), "--tasks", "unplug_charger", "all", "close_box",
                  "--output_dir", str(tmp_path / name), *dev])
    assert seen["torch"].tasks == seen["jax"].tasks
    assert seen["torch"].tasks[:2] == ["unplug_charger", "close_box"] and len(seen["torch"].tasks) == 12
    jvars, tvars = vars(seen["jax"]), vars(seen["torch"])
    assert set(tvars) - set(jvars) == {"device"}
    assert {k: tvars[k] for k in jvars if k != "output_dir"} == {k: jvars[k] for k in jvars if k != "output_dir"}


def test_env_recorder_route(tmp_path):
    """A lift3d VideoWrapper env records the media itself (every simulator
    frame); the loop's frames are not written again. A recorder that fails
    mid-episode falls back to the loop's frames, as in JAX."""
    calls = {}

    class Recorder:
        def save_video(self, path):
            calls["video"] = path
            Path(path).write_bytes(b"mp4")

        def save_images(self, d, quiet=False):
            calls["images"] = (d, quiet)

        def save_depths(self, d, quiet=False):
            calls["depths"] = (d, quiet)

    frames = [np.full((8, 8, 3), 7, np.uint8)] * 2
    tev.save_episode_media(tmp_path, "close_box", 3, frames, [np.zeros((8, 8))], env=Recorder())
    assert calls["video"].endswith("close_box/videos/episode3_video_steps.mp4")
    assert calls["images"] == (str(tmp_path / "close_box/images/episode3"), True)
    assert calls["depths"] == (str(tmp_path / "close_box/depths/episode3"), True)
    assert not list((tmp_path / "close_box" / "images" / "episode3").glob("*"))

    class Broken:
        def save_video(self, path):
            raise OSError("the recorder's encoder died")

    warnings = []
    logger = types.SimpleNamespace(warning=warnings.append, info=lambda m: None)
    tev.save_episode_media(tmp_path, "close_box", 4, frames, [np.zeros((8, 8))], env=Broken(), logger=logger)
    assert "env recorder failed" in warnings[0]
    assert len(list((tmp_path / "close_box/images/episode4").glob("*.png"))) == 2
    assert (tmp_path / "close_box/depths/episode4/depth_0000.npy").exists()


def test_png_frames_equal_jax_pil_frames(tmp_path):
    """The port's PNG encoder and JAX's PIL writer: the same pixels,
    decoded, at camera sizes; the video writer leaves no file where it
    cannot encode."""
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, size=s, dtype=np.uint8) for s in ((480, 640, 3), (1, 1, 3), (37, 5, 3))]
    tev._write_frames(frames, tmp_path / "t")
    jev._write_frames(frames, tmp_path / "j")
    for j, f in enumerate(frames):
        a = np.asarray(Image.open(tmp_path / "t" / f"frame_{j:04d}.png"))
        np.testing.assert_array_equal(a, np.asarray(Image.open(tmp_path / "j" / f"frame_{j:04d}.png")))
        np.testing.assert_array_equal(a, f)
    video = tmp_path / "v" / "episode0_video_steps.mp4"
    wrote = tev._write_video(frames[:1] * 3, video)
    assert wrote == video.exists()
    assert tev._write_video([], video) is False


def test_device_refuses_without_a_card(monkeypatch, tmp_path, run_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass --device cpu"):
        tev.main(["--run_dir", str(run_dir), "--offline_trace", "x.npz", "--output_dir", str(tmp_path)])
    assert not (tmp_path / "eval.log").exists()
