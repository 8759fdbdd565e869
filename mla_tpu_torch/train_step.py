"""Diffusion training steps of MLA on one NVIDIA GPU: step time, tokens/s,
MFU and peak memory.

    python -m mla_tpu_torch.train_step --model mla-2b --batch 8 [--steps 5]
        [--text_len 32] [--profile] [--device cuda] [--post_franka] [--optimizer adamw|adafactor]
        [--stage S] [--use_tactile] [--num_extra_views N] [--use_generation]
        [--gen_image] [--use_roi] [--gen_pointcloud] [--gen_tactile] [--grad_accumulation_steps A]

Counterpart of scripts/tpu_smoke.py. --model is any preset of
conf/models.py (mla-2b, the llama rung; mla-phi, Phi-2 at full width;
mla-mistral, Mistral-7B's widths with its decoder cut to ONE_CARD_LAYERS'
8 layers, as mla-2b cuts mla-7b: its 7.2 B decoder with AdamW does not fit
one card).
Builds the model from the seeded random init on the device (`params.init`),
then runs `--steps` steps
of `make_train_step` on `synthetic_batch` (repeated_diffusion_steps 1, remat
on, learning rate 1e-5; AdamW, or Adafactor with --optimizer adafactor, as
scripts/tpu_smoke.py takes it; the --batch rows cut into
--grad_accumulation_steps micro-batches), printing each step's loss,
grad_norm and wall ms.
Then: step ms (median of the steps after the first), tokens/s (B x S per
step, S = text + fused + diffusion tokens), MFU (6N decoder FLOPs per token,
training/metrics.py, over the card's dense bf16 peak: the front-ends and the
generation heads are not counted) and peak GiB.

The stage flags are those of scripts/train.py: --use_tactile (tactile input
and the tactile contrastive loss), --num_extra_views (seeded wrist views),
--use_generation with --gen_image / --gen_pointcloud / --gen_tactile (the
heads) and --use_roi, --stage (which modules freeze). --post_franka sets
the Franka post-training stage of scripts/post_franka.sh: all of them on,
one wrist view, stage post-training.

--profile adds the device-time split of one step from torch.profiler: the
front-end forward alone (vision and point tokenizers, projectors), the
whole loss forward (the decoder forward, with the generation heads' forward
when they are on, is the difference), and the whole
step (backward + optimizer is the difference from the forward), with the
device's idle share of that profiled step (1 - busy / its wall time) and
its top kernels. With the generation heads on, their forward and backward
on the step's hidden states are profiled alone too, and their device time
is a class of its own, taken out of the classes of the step's kernels.

Over N processes, one per card:

    torchrun --nproc_per_node N -m mla_tpu_torch.train_step --model mla-7b
        --fp32_masters --batch 2

shards the state over all of them (fsdp = N / tp; training/strategy.py;
--batch rows a data rank): a rank holds its part of every trainable leaf
and gathers the decoder layer by layer (parallel/fsdp.py), with
--fp32_masters as the trainer holds it (fp32 masters, the decoder's layer
matrices gathered in bf16); --tp T splits the decoder over tp groups of T
ranks (JAX's _TP_RULES), which hold the same rows; rank 0 prints the
global batch's numbers and each rank's build peak, step peak, optimizer
GiB, layer-stack GiB and the most whole layers alive at once.

Runs on the card unless given --device cpu. Results go to
chiprun_out/train_step_<model>.json (with _post_franka, _adafactor,
_fp32_masters, _w<N> and _tp<T> for those options).
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace
from pathlib import Path
from typing import Any, Callable, Dict

import numpy as np
import torch

from mla_tpu_torch import params as P
from mla_tpu_torch.conf.models import get_model_config
from mla_tpu_torch.diffusion import gaussian as gd
from mla_tpu_torch.models import mla as mla_mod
from mla_tpu_torch.models import prismatic
from mla_tpu_torch.parallel import fsdp
from mla_tpu_torch.parallel.mesh import distinct_cards, initialize_distributed, make_mesh
from mla_tpu_torch.parallel.sharding import shard_batch
from mla_tpu_torch.training import metrics, optim, strategy
from mla_tpu_torch.vla.dummy import add_extra_views, synthetic_batch

LEARNING_RATE = 1e-5
# device-time classes of the profile, by kernel-name fragment (first match)
KERNEL_CLASSES = (
    ("flash attention (port kernels)", ("flash_fwd_kernel", "flash_bwd_")),
    ("FPS (port kernel)", ("fps_kernel",)),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
)


# presets whose whole decoder with AdamW does not fit one card: the depth
# they train at here, widths kept (mla-2b's cut of mla-7b)
ONE_CARD_LAYERS = {"mla-mistral": 8}

# the stage of scripts/post_franka.sh
POST_FRANKA = dict(stage="post-training", use_tactile=True, num_extra_views=1, use_generation=True, gen_image=True,
                   use_roi=True, gen_pointcloud=True, gen_tactile=True)
HEADS_CLASS = "generation heads (fwd + bwd, profiled alone)"


def model_config(model: str, *, use_tactile: bool = False, num_extra_views: int = 0, use_generation: bool = False,
                 gen_image: bool = False, use_roi: bool = False, gen_pointcloud: bool = False,
                 gen_tactile: bool = False) -> prismatic.MLAModelConfig:
    """The preset with the stage flags, mapped onto the gen config as
    scripts/train.py maps them, its decoder cut to ONE_CARD_LAYERS."""
    cfg = get_model_config(model, use_tactile=use_tactile, use_generation=use_generation, use_roi=use_roi,
                           num_extra_views=num_extra_views)
    if model in ONE_CARD_LAYERS:
        cfg = replace(cfg, llama=replace(cfg.llama, num_layers=ONE_CARD_LAYERS[model]))
    if use_generation:
        cfg = replace(cfg, gen=replace(cfg.gen, use_image=gen_image, use_pointcloud=gen_pointcloud,
                                       use_tactile=gen_tactile))
    return cfg


def build(model: str, batch: int, text_len: int, device, seed: int = 0, stage: str = "pretrain",
          optimizer: str = "adamw", mesh: Any = None, fp32_masters: bool = False, accum: int = 1,
          **flags) -> Dict[str, Any]:
    """Model, optimizer, train state, step function and batch, as
    scripts/tpu_smoke.py sets them up; `flags` are model_config's. With
    fp32_masters, the trainer's mixed precision: fp32 masters, the
    decoder's layer matrices gathered in bf16. Over `mesh` the state
    is sharded and `batch` rows a data rank (its rows of the global batch;
    the ranks of a tp group hold the same), cut into `accum`
    micro-batches."""
    cfg = model_config(model, **flags)
    if fp32_masters:
        cfg = replace(cfg, llama=replace(cfg.llama, param_dtype=torch.float32))
    strategy.check_tp(cfg, mesh.tp if mesh is not None else 1)
    world, rank = (mesh.data_world, mesh.data_rank) if mesh is not None else (1, 0)
    params, mstate = P.init(cfg, seed=seed, device=device)
    tcfg = strategy.TrainConfig(repeated_diffusion_steps=1, enable_gradient_checkpointing=True,
                                grad_accumulation_steps=accum)
    opt, _, _ = optim.make_optimizer(params, learning_rate=LEARNING_RATE, num_training_steps=10, stage=stage,
                                     optimizer=optimizer)
    sched = gd.create_schedule("", diffusion_steps=100)
    return {
        "cfg": cfg, "tcfg": tcfg, "sched": sched,
        "state": strategy.init_train_state(params, opt, mstate, mesh=mesh,
                                           compute_dtype=cfg.llama.compute_dtype if fp32_masters else None),
        "step": strategy.make_train_step(cfg, tcfg, sched),
        "batch": strategy.as_tensors(shard_batch(add_extra_views(synthetic_batch(cfg, B=batch * world, L=text_len), cfg),
                                                 rank, world), device),
        "flops_per_token": metrics.decoder_flops_per_token(params["llm_backbone"], cfg.use_diff),
        "tokens_per_step": batch * world * (text_len + cfg.fused_len + cfg.diff_block_len)
        * tcfg.repeated_diffusion_steps,
        "generator": torch.Generator(device=device).manual_seed(seed + 1),
    }


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_time(fn: Callable[[], Any]) -> Dict[str, Any]:
    """Run fn() once under torch.profiler: device busy ms (device-side
    events only, so no kernel counts twice, and no annotated spans such as
    Optimizer.step, which cover kernels already counted), wall ms, top
    kernels. Raises if busy exceeds wall: on one stream that is a miscount."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [
        {"name": e.key[:90], "device_ms": e.self_device_time_total / 1e3, "count": e.count}
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    ]
    rows.sort(key=lambda r: -r["device_ms"])
    classes: Dict[str, float] = {}
    for r in rows:
        cls = next((c for c, frags in KERNEL_CLASSES if any(f in r["name"] for f in frags)),
                   "other (elementwise, reductions, copies)")
        classes[cls] = classes.get(cls, 0.0) + r["device_ms"]
    busy = sum(r["device_ms"] for r in rows)
    if busy > wall:
        raise RuntimeError(f"profiled device busy time {busy:.3f} ms exceeds the wall time {wall:.3f} ms of the "
                           "same run: some device time is counted twice")
    return {"device_ms": busy, "wall_ms": wall, "classes": classes, "kernels": rows[:25]}


def profile_step(run: Dict[str, Any]) -> Dict[str, Any]:
    """Device-time split of one step (see the module docstring)."""
    cfg, st, b = run["cfg"], run["state"], run["batch"]
    gen = run["generator"]
    gatherer = st["shards"].gatherer

    def frontend():  # the weights as the step gathers them (in their compute dtype)
        with fsdp.gathering(gatherer):
            prismatic.get_fused_tokens(gatherer.tree(st["params"]), st["model_state"], cfg, b["images"],
                                       b.get("point_cloud"), b.get("tactile"), b.get("gripper_xyz"), training=True)

    def forward():
        with fsdp.gathering(gatherer):
            mla_mod.mla_train_loss(gatherer.tree(st["params"]), st["model_state"], cfg, run["sched"], b, gen,
                                   repeated_diffusion_steps=run["tcfg"].repeated_diffusion_steps,
                                   remat=run["tcfg"].enable_gradient_checkpointing)

    def step():
        run["state"], _ = run["step"](run["state"], b, gen)

    fe, fwd, full = device_time(frontend), device_time(forward), device_time(step)
    out = {
        "frontend_fwd_device_ms": fe["device_ms"],
        "decoder_fwd_device_ms": fwd["device_ms"] - fe["device_ms"],
        "bwd_and_optimizer_device_ms": full["device_ms"] - fwd["device_ms"],
        "step_device_ms": full["device_ms"], "profiled_step_wall_ms": full["wall_ms"],
        "step_classes": full["classes"], "step_kernels": full["kernels"],
    }
    if cfg.use_generation:
        heads = device_time(heads_step(run))
        for c, ms in heads["classes"].items():
            out["step_classes"][c] = out["step_classes"].get(c, 0.0) - ms
        out["step_classes"][HEADS_CLASS] = heads["device_ms"]
        out["heads_kernels"] = heads["kernels"]
    return out


def heads_step(run: Dict[str, Any]) -> Callable[[], None]:
    """The generation heads' forward, losses and backward alone, on the
    hidden states and image tokens of the step's batch (computed once,
    outside what the returned function runs). One process (--profile):
    the heads are the state's own fp32 leaves, as the step's gather hands
    them out."""
    cfg, st = run["cfg"], run["state"]
    b = mla_mod._tile_batch(run["batch"], run["tcfg"].repeated_diffusion_steps)
    future = b["actions"][:, -cfg.action_horizon :].float()
    b = {**b, "x": future, "t": torch.zeros(future.shape[0], dtype=torch.long, device=future.device)}
    with torch.no_grad():
        fused = prismatic.get_fused_tokens(st["params"], st["model_state"], cfg, b["images"], b.get("point_cloud"))
        hidden = prismatic.vlm_forward(st["params"], st["model_state"], cfg, b, use_diff=True)[0]["last_hidden"]

    def fn():
        h = hidden.detach().requires_grad_(True)
        _, losses, _ = prismatic.generation_block(st["params"], st["model_state"], cfg, b, h, fused["img_tokens"],
                                                  fused["patch_indices"], generator=run["generator"])
        losses["total_generation_loss"].backward()
        run["state"]["optimizer"].zero_grad()

    return fn


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="mla-2b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--text_len", type=int, default=32)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--post_franka", action="store_true", help="the stage flags of scripts/post_franka.sh")
    ap.add_argument("--stage", default="pretrain", choices=sorted(optim.STAGE_FROZEN_MODULES))
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--fp32_masters", action="store_true", help="the trainer's fp32 masters, bf16 layer matrices")
    ap.add_argument("--num_extra_views", type=int, default=0)
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel mesh axis under torchrun")
    ap.add_argument("--grad_accumulation_steps", type=int, default=1, help="micro-batches of the --batch rows")
    for flag in ("use_tactile", "use_generation", "gen_image", "use_roi", "gen_pointcloud", "gen_tactile"):
        ap.add_argument(f"--{flag}", action="store_true")
    args = ap.parse_args()
    flags = {k: getattr(args, k) for k in POST_FRANKA}
    if args.post_franka:
        flags.update(POST_FRANKA)
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("train_step: no CUDA device is available; pass --device cpu to run on the CPU")
    if args.profile and not on_card:
        raise SystemExit("train_step: --profile measures device time and needs the card")
    launch = initialize_distributed(args.device)
    mesh = make_mesh(tp=args.tp) if launch is not None else None
    if launch is None and args.tp != 1:
        make_mesh(tp=args.tp)  # raises: one process holds no tp > 1
    if launch is not None:
        device = launch["device"]
        if args.profile:
            raise SystemExit("train_step: --profile runs in one process")
    world, rank = (mesh.world, mesh.rank) if mesh is not None else (1, 0)
    cards = distinct_cards(device) if mesh is not None else 1
    say = print if rank == 0 else (lambda *a, **k: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    run = build(args.model, args.batch, args.text_len, device, optimizer=args.optimizer, mesh=mesh,
                fp32_masters=args.fp32_masters, accum=args.grad_accumulation_steps, **flags)
    _sync(device)
    build_peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    layers = run["cfg"].llama.num_layers
    say(f"{args.model}: built on {device} in {time.perf_counter() - t0:.1f} s"
        + (f" (decoder cut to {layers} layers)" if args.model in ONE_CARD_LAYERS else "")
        + (f" over {world} processes, mesh dp {mesh.dp} x fsdp {mesh.fsdp} x tp {mesh.tp}" if mesh is not None
           else ""))
    times = []
    fsdp.reset_counts()
    for i in range(args.steps):
        _sync(device)
        t = time.perf_counter()
        run["state"], m = run["step"](run["state"], run["batch"], run["generator"])
        loss, gnorm = float(m["total_loss"]), float(m["grad_norm"])
        _sync(device)
        times.append((time.perf_counter() - t) * 1e3)
        parts = ", ".join(f"{k.replace('_loss', '')} {float(m[k]):.5f}" for k in mla_mod.LOSS_KEYS[1:] if float(m[k]))
        say(f"step {i}: loss {loss:.5f} ({parts}), grad_norm {gnorm:.5f}, {times[-1]:.1f} ms")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise SystemExit(f"step {i}: non-finite loss {loss} or grad_norm {gnorm}")

    step_ms = float(np.median(times[1:] if len(times) > 1 else times))
    tok_s = run["tokens_per_step"] / (step_ms / 1e3)
    result: Dict[str, Any] = {
        "model": args.model, "num_layers": layers, "batch": args.batch, "text_len": args.text_len, "flags": flags,
        "optimizer": args.optimizer, "fp32_masters": args.fp32_masters, "world": world,
        "grad_accumulation_steps": args.grad_accumulation_steps,
        "mesh": ({"dp": mesh.dp, "fsdp": mesh.fsdp, **({"tp": mesh.tp} if mesh.tp > 1 else {})}
                 if mesh is not None else None), "cards": cards,
        "tokens_per_step": run["tokens_per_step"], "step_ms": times, "step_ms_median": step_ms,
        "tokens_per_s": tok_s, "flops_per_token": run["flops_per_token"],
    }
    if on_card:
        name = torch.cuda.get_device_name(0)
        peak = metrics.bf16_peak_flops(name)
        result.update({
            "device": name, "bf16_peak_flops": peak,
            "mfu": tok_s * run["flops_per_token"] / (peak * cards) if peak else None,
            "peak_gib": max(build_peak, torch.cuda.max_memory_allocated() / 2**30),
        })
    # per rank: the build's and the steps' peaks and the optimizer's bytes
    # (master parts and moments)
    held = run["state"]["shards"].optimizer_bytes()["held"] / 2**30
    stack = run["state"]["shards"].layer_bytes(run["state"]["params"])
    per_rank = {"build_peak_gib": build_peak, "step_peak_gib": torch.cuda.max_memory_allocated() / 2**30
                if on_card else None, "optimizer_gib": held, "layer_stack_gib": stack["held"] / 2**30,
                "whole_stack_gib": stack["stack"] / 2**30, "max_live_layers": fsdp.counts["max_live_layers"]}
    if mesh is not None:
        import torch.distributed as dist

        ranks = [None] * world
        dist.all_gather_object(ranks, per_rank)
        result["ranks"] = ranks
        dist.destroy_process_group()
        if rank != 0:
            return
    else:
        result["ranks"] = [per_rank]
        if args.profile:
            result["profile"] = prof = profile_step(run)
            prof["device_idle_share"] = 1.0 - prof["step_device_ms"] / prof["profiled_step_wall_ms"]
    print(json.dumps({k: v for k, v in result.items() if k != "profile"}))
    if "profile" in result:
        p = result["profile"]
        print(f"device time per step: front-end fwd {p['frontend_fwd_device_ms']:.3f} ms, decoder fwd "
              f"{p['decoder_fwd_device_ms']:.3f} ms, backward + optimizer {p['bwd_and_optimizer_device_ms']:.3f} ms, "
              f"total {p['step_device_ms']:.3f} ms; idle share of the step {p['device_idle_share']:.3f}")
        for c, ms in sorted(p["step_classes"].items(), key=lambda kv: -kv[1]):
            print(f"  {ms:9.3f} ms  {c}")
        for r in p["step_kernels"][:15]:
            print(f"  {r['device_ms']:9.3f} ms  x{r['count']:5d}  {r['name']}")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    tag = ("_post_franka" if args.post_franka else "") + ("_adafactor" if args.optimizer == "adafactor" else "")
    tag += ("_fp32_masters" if args.fp32_masters else "") + (f"_w{world}" if mesh is not None else "")
    tag += f"_tp{mesh.tp}" if mesh is not None and mesh.tp > 1 else ""
    tag += f"_acc{args.grad_accumulation_steps}" if args.grad_accumulation_steps > 1 else ""
    (out / f"train_step_{args.model}{tag}.json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
