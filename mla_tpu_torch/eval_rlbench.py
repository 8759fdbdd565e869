"""RLBench closed-loop evaluation of the policy on the card.

Counterpart of scripts/eval_rlbench.py: load a run dir's policy, roll out
episodes per task in CoppeliaSim through LIFT3D's RLBenchEnv (one diffusion
chunk per step, its first action executed), log success rates and write
each episode's media. The simulator stack (RLBench, CoppeliaSim, lift3d) is
an outside dependency: its import is gated, and without it the entry says
so and exits 1. Without a simulator, --offline_trace <npz> (images [N, H,
W, 3] uint8, point_clouds [N, P, 3], optional instruction and depths)
replays recorded observations through the policy and writes the predicted
actions and each step's latency:

    python -m mla_tpu_torch.eval_rlbench --run_dir runs/<id> --task close_box \\
        --num_episodes 20 --output_dir eval_out
    python -m mla_tpu_torch.eval_rlbench --run_dir runs/<id> --offline_trace trace.npz \\
        [--sampler dpm --num_dpm_steps 4] [--voxel_cell 0.01] [--device cpu]

--device (default cuda) is the port's own: without a card the entry raises
unless given --device cpu. Raw clouds are brought to the model's point count
by native/pointops_host.prepare_pointcloud (C++ built at first use).
Frames are written as PNG by the port's own encoder (vla/rlds/png.py) and
depths as .npy; the episode video goes through imageio where it is
installed and can encode mp4 (JAX tries OpenCV first, which the port does
not use), else it is skipped with a log line.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np

# 12 tasks from the reference sweep (scripts/test_rlbench.sh)
RLBENCH_TASKS = [
    "close_box", "close_laptop_lid", "toilet_seat_down", "sweep_to_dustpan",
    "close_fridge", "phone_on_base", "take_umbrella_out_of_umbrella_stand",
    "frame_off_hanger", "take_frame_off_hanger", "put_books_on_bookshelf",
    "slide_block_to_target", "unplug_charger",
]
LOGGER = "mla_tpu_torch.eval_rlbench"


def setup_logging(output_dir: Path) -> logging.Logger:
    """The entry's logger, to the console and <output_dir>/eval.log. The
    handlers of an earlier call in this process are closed first, so a
    second run does not write into the first one's log."""
    output_dir.mkdir(parents=True, exist_ok=True)
    logger = logging.getLogger(LOGGER)
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    for h in (logging.StreamHandler(), logging.FileHandler(output_dir / "eval.log")):
        h.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(h)
    return logger


def _write_video(frames, path: Path, fps: int = 10) -> bool:
    """An episode's rollout video (the reference's
    episode{i}_video_steps.mp4) through imageio; False, with a log line and
    no file left, when imageio is missing or cannot encode here."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        return False
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        import imageio

        imageio.mimsave(str(path), frames, fps=fps)
        return True
    except Exception as e:  # an optional codec: the eval goes on without the video
        path.unlink(missing_ok=True)
        logging.getLogger(LOGGER).info(f"no video written to {path}: imageio cannot encode it here ({e!r})")
        return False


def _write_frames(frames, frame_dir: Path) -> None:
    """Each step's RGB frame as frame_{j:04d}.png (the port's PNG encoder)."""
    from mla_tpu_torch.vla.rlds import png

    frame_dir.mkdir(parents=True, exist_ok=True)
    for j, f in enumerate(frames):
        (frame_dir / f"frame_{j:04d}.png").write_bytes(png.encode(np.asarray(f)))


def _write_depths(depths, depth_dir: Path) -> None:
    """Each step's depth, lossless, as depth_{j:04d}.npy."""
    depth_dir.mkdir(parents=True, exist_ok=True)
    for j, d in enumerate(depths):
        np.save(depth_dir / f"depth_{j:04d}.npy", np.asarray(d))


def save_episode_media(out_root: Path, task: str, episode: int, frames, depths, env=None, logger=None) -> None:
    """The reference's media layout:

        <out>/<task>/videos/episode{i}_video_steps.mp4
        <out>/<task>/images/episode{i}/frame_{j:04d}.png
        <out>/<task>/depths/episode{i}/depth_{j:04d}.npy

    through the env's own recorder (lift3d's VideoWrapper save_video /
    save_images / save_depths, which records every simulator frame) where it
    has one, else the frames the eval loop collected. A failure is logged and
    the sweep goes on: media are telemetry."""
    base = Path(out_root) / task
    video_path = base / "videos" / f"episode{episode}_video_steps.mp4"
    image_dir = base / "images" / f"episode{episode}"
    depth_dir = base / "depths" / f"episode{episode}"
    if env is not None and hasattr(env, "save_video"):
        try:
            video_path.parent.mkdir(parents=True, exist_ok=True)
            env.save_video(str(video_path))
            if hasattr(env, "save_images"):
                image_dir.mkdir(parents=True, exist_ok=True)
                env.save_images(str(image_dir), quiet=True)
            if hasattr(env, "save_depths"):
                depth_dir.mkdir(parents=True, exist_ok=True)
                env.save_depths(str(depth_dir), quiet=True)
            return
        except Exception as e:  # the recorder broke mid-episode: write the loop's frames
            if logger:
                logger.warning(f"env recorder failed ({e}); writing collected frames")
    try:
        if _write_video(frames, video_path) and logger:
            logger.info(f"video saved to {video_path}")
        _write_frames(frames, image_dir)
        if depths:
            _write_depths(depths, depth_dir)
    except Exception as e:
        if logger:
            logger.warning(f"episode media dump failed ({e}); continuing eval")


def load_policy(args):
    from mla_tpu_torch.models.load import load_vla
    from mla_tpu_torch.vla.tokenizer import SimpleTokenizer, load_llama_tokenizer

    tokenizer = load_llama_tokenizer(args.tokenizer) if args.tokenizer else SimpleTokenizer()
    return load_vla(args.run_dir, model_id=args.model, tokenizer=tokenizer, device=args.device)


def _frame(obs_image, policy) -> np.ndarray:
    """A raw HWC uint8 camera frame through training's preprocessing:
    resize, center crop and CLIP normalization, then the mask channel."""
    from mla_tpu_torch.vla.datasets import add_mask_channel, clip_preprocess

    return add_mask_channel(clip_preprocess(np.asarray(obs_image), policy.cfg.vision.image_size))


def run_simulator_eval(args, logger):
    try:
        from lift3d.envs.rlbench_env import RLBenchEnv  # type: ignore
    except ImportError:
        logger.error(
            "RLBench/lift3d not available on this machine. Run on a simulator "
            "workstation (Xvfb + CoppeliaSim), or use --offline_trace."
        )
        return 1

    policy = load_policy(args)
    results = {}
    for task in args.tasks:
        env = RLBenchEnv(task_name=task, camera_name=args.camera_name)
        try:
            successes = 0
            for ep in range(args.num_episodes):
                obs = env.reset()
                success = False
                ep_frames, ep_depths = [], []
                ar_time_sum = diff_time_sum = ar_conf_sum = 0.0
                n_steps = 0
                for _ in range(args.max_steps):
                    if args.save_media:
                        ep_frames.append(np.asarray(obs["image"]))
                        if "depth" in obs:
                            ep_depths.append(np.asarray(obs["depth"]))
                    pc = _prep_pc(obs["point_cloud"], policy, args)
                    img = _frame(obs["image"], policy)
                    if args.predict_mode == "diff_ar":
                        # both heads: the diffusion chunk is executed, the AR
                        # head runs for its confidences and timings
                        out = policy.predict_action_diff_ar(
                            img, pc, obs["instruction"], cur_robot_state=obs.get("robot_state"),
                            unnorm_key=args.unnorm_key, sampler=args.sampler, num_dpm_steps=args.num_dpm_steps,
                        )
                        action_chunk = out["actions"]
                        ar_time_sum += out["timings"][0]
                        diff_time_sum += out["timings"][1]
                        ar_conf_sum += float(np.mean(out["ar_max_probs"]))
                    else:
                        t0 = time.perf_counter()
                        action_chunk = policy.predict_action_diff(
                            image=img, pointcloud=pc, instruction=obs["instruction"],
                            cur_robot_state=obs.get("robot_state"), unnorm_key=args.unnorm_key,
                            sampler=args.sampler, num_dpm_steps=args.num_dpm_steps,
                        )
                        diff_time_sum += time.perf_counter() - t0
                    n_steps += 1
                    # closed loop: the chunk's first action is executed
                    obs, reward, done, info = env.step(action_chunk[0])
                    if done:
                        success = bool(info.get("success", reward > 0))
                        break
                successes += int(success)
                if n_steps:
                    if args.predict_mode == "diff_ar":
                        logger.info(f"average ar_sum = {ar_conf_sum / n_steps:.6f}")
                        logger.info(f"average ar infer time = {ar_time_sum / n_steps:.6f}")
                    logger.info(f"average diff infer time = {diff_time_sum / n_steps:.6f}")
                if args.save_media:
                    save_episode_media(Path(args.output_dir), task, ep, ep_frames, ep_depths, env=env, logger=logger)
                logger.info(f"[{task}] episode {ep}: success={success}")
            rate = successes / args.num_episodes
            results[task] = rate
            logger.info(f"[{task}] success rate: {rate:.3f}")
        finally:
            # PyRep/CoppeliaSim needs an explicit teardown before the next
            # task's env starts (a leaked simulator breaks a sweep)
            for closer in ("shutdown", "close"):
                if hasattr(env, closer):
                    try:
                        getattr(env, closer)()
                    except Exception:
                        pass
                    break
        (Path(args.output_dir) / f"{task}_success_rate.txt").write_text(f"{rate:.4f}\n")
    (Path(args.output_dir) / "results.json").write_text(json.dumps(results, indent=2))
    return 0


def _prep_pc(pc, policy, args):
    """A raw sensor cloud -> exactly cfg.point.input_points points (the voxel
    pass with --voxel_cell, then the exact count); a cloud of the right size
    without --voxel_cell is passed as it is."""
    pc = np.asarray(pc, np.float32)
    target = policy.cfg.point.input_points
    if pc.ndim == 2 and (pc.shape[0] != target or args.voxel_cell is not None):
        from mla_tpu_torch.native.pointops_host import prepare_pointcloud

        pc = prepare_pointcloud(pc, target, cell=args.voxel_cell)
    return pc


def run_offline_trace(args, logger):
    policy = load_policy(args)
    trace = np.load(args.offline_trace, allow_pickle=True)
    images = trace["images"]  # [N, H, W, 3] uint8
    pointclouds = trace["point_clouds"]  # [N, P, 3]
    instruction = str(trace["instruction"]) if "instruction" in trace else "close the box"

    latencies, actions = [], []
    for i in range(len(images)):
        img = _frame(images[i], policy)
        t0 = time.perf_counter()
        act = policy.predict_action_diff(img, _prep_pc(pointclouds[i], policy, args), instruction,
                                         unnorm_key=args.unnorm_key, sampler=args.sampler,
                                         num_dpm_steps=args.num_dpm_steps)
        latencies.append(time.perf_counter() - t0)
        actions.append(act)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "predicted_actions.npz", actions=np.stack(actions), latencies=np.asarray(latencies))
    if args.save_media:
        # the trace's frames as episode 0 of task "offline" (depths where recorded)
        depths = list(trace["depths"]) if "depths" in trace.files else []
        save_episode_media(out, "offline", 0, list(images), depths, logger=logger)
    warm = latencies[1:] if len(latencies) > 1 else latencies  # without the first call's builds
    logger.info(f"offline trace: {len(images)} steps, p50 latency {np.percentile(warm, 50) * 1e3:.1f} ms")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description="RLBench evaluation of an MLA policy (PyTorch/CUDA).")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--model", default="mla-7b")
    p.add_argument("--tokenizer", default=None, help="HF tokenizer path")
    p.add_argument("--tasks", nargs="+", default=["close_box"], choices=RLBENCH_TASKS + ["all"])
    p.add_argument("--num_episodes", type=int, default=20)
    p.add_argument("--max_steps", type=int, default=200)
    p.add_argument("--camera_name", default="rlbench_front")
    p.add_argument("--unnorm_key", default=None)
    p.add_argument("--output_dir", default="eval_out")
    p.add_argument("--offline_trace", default=None)
    p.add_argument("--sampler", default="ddim", choices=["ddim", "dpm"],
                   help="dpm = DPM-Solver++(2M), half the denoise cost of DDIM-8")
    p.add_argument("--num_dpm_steps", type=int, default=4)
    p.add_argument("--predict_mode", default="diff", choices=["diff", "diff_ar"],
                   help="diff = the diffusion chunk alone; diff_ar = both heads, with the AR head's confidence "
                        "and each head's time logged per episode")
    p.add_argument("--save_media", action=argparse.BooleanOptionalAction, default=True,
                   help="per-episode video, frames and depths under <output_dir>/<task>/")
    p.add_argument("--voxel_cell", type=float, default=None,
                   help="voxel-grid cell (m) for raw clouds, which are then sampled to the model's input_points")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to evaluate on the CPU")
    if "all" in args.tasks:
        # expanded wherever it appears, or "all" would reach RLBenchEnv as a task name
        expanded = [t for t in args.tasks if t != "all"]
        args.tasks = expanded + [t for t in RLBENCH_TASKS if t not in expanded]

    logger = setup_logging(Path(args.output_dir))
    if args.offline_trace:
        return run_offline_trace(args, logger)
    return run_simulator_eval(args, logger)


if __name__ == "__main__":
    sys.exit(main())
