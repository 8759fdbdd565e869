"""Training entry point: the VLA training loop on one NVIDIA GPU.

    python -m mla_tpu_torch.train --vla.type prism-dinosiglip-224px+oxe+diffusion \\
        --model mla-2b --vla.per_device_batch_size 2 --global_batch_size 4 \\
        [--max_steps N] [--save_interval N] [--run_root_dir DIR] [--is_resume true] [--device cuda]

Counterpart of the VLA loop of scripts/train.py, with its flags: --vla.type
picks an experiment of conf/vla.py, --model a preset of conf/models.py
(default: the experiment's base_vlm), and every other `--key value` or
`--vla.key value` is coerced onto VLATrainConfig (an unknown key raises
ValueError listing the valid ones). --device (default cuda) is the port's
own; without a card the run raises unless given --device cpu.

The loop, in scripts/train.py's order: the run id and run dir; the model
from a seeded init on the device, with fp32 master weights when
enable_mixed_precision_training (the decoder computes in bf16); the stage
from the freeze flags and lm_head frozen in diffusion mode; gradient
accumulation global_batch_size / per_device_batch_size; resume from the
run dir's latest checkpoint with --is_resume true; each step's randomness
from step_generator(seed, step) (JAX's fold_in(rng, step)); VLAMetrics
committed every step and pushed every 10; a checkpoint every save_interval
steps and at the last; SIGTERM or SIGUSR1 sets a flag that the loop drains
at the next step boundary with one synchronous checkpoint, then exits 0;
generation panels every visualize_interval steps in the post-training
stage. A resumed run starts the synthetic data again at batch 0, as the JAX
loop does (it makes a new iterator). --pretrained_checkpoint starts from
load_vla(..., load_for_training=True) of a run dir or a .pt, whose model
config then replaces the run's, as scripts/train.py does. --data_root_dir
trains on an RLDS data root through the port's pipeline (vla/rlds/), with
the experiment's shuffle_buffer_size and action_tokenizer_exist, each step
collating per-device batch x accumulation frames. --hf_llama_dir loads an
HF Llama base into the seeded init (models/load.load_base_llm), not over
--pretrained_checkpoint, as scripts/train.py does.

--vlm_stage align|finetune runs the VLM pretraining loop instead
(`train_vlm`, scripts/train.py's): the LLaVA-era data of --vlm_dataset
(conf/datasets.py; synthetic examples without --data_root_dir) through
SplitModalitySampler and the LM collator (--vlm_max_length), tokenized by
--tokenizer (default SimpleTokenizer), into the same train step with the
AR loss at stage vlm-align (projectors only) or vlm-finetune (the decoder
too).

Over N processes, one per card: `torchrun --nproc_per_node N -m
mla_tpu_torch.train ... [--dp D] [--tp T]` (or the JAX package's
MLA_COORDINATOR_ADDRESS / MLA_NUM_PROCESSES / MLA_PROCESS_ID). The world
splits as JAX's mesh, fsdp = world / (dp * tp), rank (d * fsdp + f) * tp +
t: each rank computes with its tp-local part of the decoder (JAX's
_TP_RULES, the llama family); every trainable leaf (its master weight,
gradient and optimizer state) is sharded over fsdp, and the step gathers
the decoder layer by layer (parallel/fsdp.py, as JAX's GSPMD shardings
do); the global batch splits over the dp * fsdp data ranks
(training/strategy.py; the ranks of a tp group hold the same rows). As in
scripts/train.py a step's micro-batch is per_device_batch_size x world
rows, so a data rank collates per_device_batch_size x tp x accumulation
rows; each data rank reads its own shard of the RLDS episodes and the
sampler's rows; logs, trackers and checkpoints are written on rank 0, and
a checkpoint (the whole tree) resumes at any (dp, fsdp, tp). tokens/s
count each row once, MFU the distinct cards' peak. A phi decoder, or head
counts that T does not divide, raise under tp (ROADMAP item 16 (c), (e)).
"""

from __future__ import annotations

import argparse
import dataclasses
import signal
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from mla_tpu_torch.utils.overwatch import initialize_overwatch

overwatch = initialize_overwatch("train")


def parse_args(argv: Optional[List[str]] = None) -> Tuple[argparse.Namespace, Dict[str, str]]:
    p = argparse.ArgumentParser(description="MLA trainer (PyTorch port)")
    p.add_argument("--vla.type", dest="vla_type", default="prism-dinosiglip-224px+oxe+diffusion")
    p.add_argument("--model", default=None, help="model registry id (default: config.base_vlm)")
    p.add_argument("--data_root_dir", default=None, help="RLDS/TFDS data root (dummy data if unset)")
    p.add_argument("--dp", type=int, default=1, help="data-parallel mesh axis (fsdp = world / (dp * tp))")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel mesh axis (a llama decoder's tp group)")
    p.add_argument("--hf_llama_dir", default=None, help="HF Llama base weights to initialize from")
    p.add_argument("--vlm_stage", default=None, choices=["align", "finetune"],
                   help="run the VLM-pretraining loop instead of the VLA loop: align = projector warm-up, "
                        "finetune = instruct tuning")
    p.add_argument("--vlm_dataset", default="llava-v15", help="conf/datasets.py dataset id for --vlm_stage")
    p.add_argument("--vlm_max_length", type=int, default=512,
                   help="pad/truncate length for the LM collator (--vlm_stage)")
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer path/id for --vlm_stage (default: the deterministic SimpleTokenizer)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, unknown = p.parse_known_args(argv)

    # --vla.foo bar / --foo bar overrides onto VLATrainConfig
    overrides = {}
    i = 0
    while i < len(unknown):
        key = unknown[i]
        if not key.startswith("--"):
            raise ValueError(f"unexpected arg {key}")
        key = key[2:]
        if key.startswith("vla."):
            key = key[4:]
        if i + 1 < len(unknown) and not unknown[i + 1].startswith("--"):
            val = unknown[i + 1]
            i += 2
        else:
            val = "true"
            i += 1
        overrides[key] = val
    return args, overrides


def _coerce(cfg_cls, overrides: Dict[str, Any]) -> Dict[str, Any]:
    fields = {f.name: f for f in dataclasses.fields(cfg_cls)}
    out = {}
    for k, v in overrides.items():
        if k not in fields:
            raise ValueError(f"unknown override --{k} (valid: {sorted(fields)})")
        t = fields[k].type
        if isinstance(v, str):
            tl = str(t)
            if "bool" in tl:
                v = v.lower() in ("1", "true", "yes")
            elif "int" in tl:
                v = int(v) if v.lower() != "none" else None
            elif "float" in tl:
                v = float(v)
        out[k] = v
    return out


def build(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Everything the loop needs, from the command line, before any step or
    resume: {'tc' (VLATrainConfig), 'cfg', 'device', 'seed', 'run_id',
    'run_dir', 'state' (a fresh train state), 'step_fn', 'schedule',
    'sched', 'dataset', 'collator', 'per_host_batch', 'grad_accum',
    'steps_per_epoch', 'num_steps', 'world', 'data_world' (the ranks the
    batch splits over), 'mesh' (None for one process), 'flops_per_token'
    (6N of the whole decoder), 'hf_load' (load_base_llm's report with
    --hf_llama_dir, else empty)}. Writes the run metadata."""
    args, overrides = parse_args(argv)

    from mla_tpu_torch import params as P
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.conf.vla import get_vla_config
    from mla_tpu_torch.diffusion import gaussian as gd
    from mla_tpu_torch.training import checkpointing as ckpt_mod
    from mla_tpu_torch.training import metrics as metrics_mod
    from mla_tpu_torch.training import optim, strategy
    from mla_tpu_torch.utils import set_global_seed
    from mla_tpu_torch.utils.overwatch import process_count
    from mla_tpu_torch.vla.materialize import get_vla_dataset_and_collator

    tc0 = get_vla_config(args.vla_type)
    tc = get_vla_config(args.vla_type, **_coerce(type(tc0), overrides))
    device, mesh = _device(args)
    model_id = args.model or tc.base_vlm
    stage = tc.stage
    overwatch.info(f"MLA :: vla={tc.vla_id} model={model_id} stage={stage} device={device}")
    if tc.unfreeze_last_llm_layer:
        overwatch.warning(
            "unfreeze_last_llm_layer is inert (as in the reference, whose freeze logic never reads it); with "
            "freeze_llm_backbone=true the WHOLE decoder stays frozen")

    # --- run dir -------------------------------------------------------------
    world = process_count()
    tp = mesh.tp if mesh is not None else 1
    data_rank, data_world = (mesh.data_rank, mesh.data_world) if mesh is not None else (0, 1)
    run_id = tc.run_id or f"{tc.vla_id}+n{world}+b{tc.per_device_batch_size}+x{tc.seed}"
    run_dir = Path(tc.run_root_dir) / run_id
    # the host generators take the rank-folded seed; the model's init and
    # the per-step draws take the run's seed on every rank (rank 0's fold)
    set_global_seed(tc.seed, data_rank)
    seed = tc.seed

    # --- model ---------------------------------------------------------------
    cfg = get_model_config(
        model_id, use_diff=tc.use_diff, use_pointcloud=tc.use_pointcloud, use_tactile=tc.use_tactile,
        use_contrastive=tc.use_contrastive, use_generation=tc.use_generation, use_roi=tc.use_roi,
        camera_name=tc.camera_name, action_dim=tc.action_dim, future_action_window_size=tc.future_action_window_size,
        class_dropout_prob=tc.class_dropout_prob, num_extra_views=tc.num_extra_views,
    )
    if tc.use_generation:
        cfg = dataclasses.replace(cfg, gen=dataclasses.replace(
            cfg.gen, use_image=tc.gen_image, use_pointcloud=tc.gen_pointcloud, use_tactile=tc.gen_tactile))
    # fp32 master weights (the reference's FSDP MixedPrecision steps fp32
    # originals); the decoder still computes in cfg.llama.compute_dtype
    if tc.enable_mixed_precision_training and cfg.llama.param_dtype != torch.float32:
        cfg = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama, param_dtype=torch.float32))
    hf_load: Dict[str, Any] = {}
    if tc.pretrained_checkpoint:
        from mla_tpu_torch.models.load import load_vla

        params, mstate, cfg, _ = load_vla(tc.pretrained_checkpoint, model_id=model_id, load_for_training=True,
                                          device=device)
    else:
        params, mstate = P.init(cfg, seed=seed, device=device)
        if args.hf_llama_dir:
            from mla_tpu_torch.models.load import load_base_llm

            params = load_base_llm(args.hf_llama_dir, cfg, params, device=device, report=hf_load)

    strategy.check_tp(cfg, tp)

    # --- strategy sizing (scripts/train.py's: a micro-batch of per-device x
    # every card's rows, split over the data ranks) ---------------------------
    global_bsz_per_step = tc.per_device_batch_size * world
    grad_accum = max(tc.global_batch_size // global_bsz_per_step, 1)
    per_host_batch = tc.per_device_batch_size * tp * grad_accum

    # --- data ----------------------------------------------------------------
    dataset, collator, dataset_statistics, dataset_len = get_vla_dataset_and_collator(
        data_root_dir=args.data_root_dir, data_mix=tc.data_mix, model_cfg=cfg, per_host_batch_size=per_host_batch,
        shuffle_buffer_size=tc.shuffle_buffer_size, action_tokenizer_exist=tc.action_tokenizer_exist, seed=tc.seed,
        data_shard=(data_rank, data_world),
    )
    steps_per_epoch = max((dataset_len or tc.shuffle_buffer_size) // tc.global_batch_size, 1)
    num_steps = tc.max_steps or (tc.epochs * steps_per_epoch)
    ckpt_mod.write_run_metadata(run_dir, tc, cfg, dataset_statistics)

    train_cfg = strategy.TrainConfig(
        learning_rate=tc.learning_rate, weight_decay=tc.weight_decay, max_grad_norm=tc.max_grad_norm,
        lr_scheduler_type=tc.lr_scheduler_type, warmup_ratio=tc.warmup_ratio, num_training_steps=num_steps,
        grad_accumulation_steps=grad_accum, repeated_diffusion_steps=tc.repeated_diffusion_steps, stage=stage,
        use_ema=tc.use_ema, enable_gradient_checkpointing=tc.enable_gradient_checkpointing,
    )
    extra_frozen: Tuple[str, ...] = ("llm_backbone",) if tc.freeze_llm_backbone else ()
    if cfg.use_diff:
        # diffusion mode leaves the LM loss out of the total, so lm_head gets
        # no gradient: freeze it (no moments, no decay)
        extra_frozen = extra_frozen + ("lm_head",)
    opt, schedule, _ = optim.make_optimizer(params, **train_cfg.optimizer_settings(), extra_frozen=extra_frozen)
    sched = gd.create_schedule("", diffusion_steps=100)
    flops_per_token = metrics_mod.decoder_flops_per_token(params["llm_backbone"], tc.use_diff)
    state = strategy.init_train_state(params, opt, mstate, use_ema=train_cfg.use_ema, mesh=mesh,
                                      compute_dtype=cfg.llama.compute_dtype)
    del params, opt
    return {
        "tc": tc, "cfg": cfg, "device": device, "seed": seed, "run_id": run_id, "run_dir": run_dir, "world": world,
        "data_world": data_world, "flops_per_token": flops_per_token,
        "state": state, "step_fn": strategy.make_train_step(cfg, train_cfg, sched),
        "schedule": schedule, "sched": sched, "dataset": dataset, "collator": collator,
        "per_host_batch": per_host_batch, "grad_accum": grad_accum, "steps_per_epoch": steps_per_epoch,
        "num_steps": num_steps, "hf_load": hf_load, "mesh": mesh,
    }


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the loop; returns {'state', 'run_dir', 'metrics' (VLAMetrics),
    'saves' [(step, seconds)], 'load_s' (None without a resume), 'cfg',
    'data_wait_s' (per step, the seconds the loop blocked for its host
    batch), 'hf_load'}; with --vlm_stage, train_vlm's result."""
    from mla_tpu_torch.training import checkpointing as ckpt_mod
    from mla_tpu_torch.training import metrics as metrics_mod
    from mla_tpu_torch.training import strategy
    from mla_tpu_torch.utils import step_generator

    args, overrides = parse_args(argv)
    if args.vlm_stage:
        return train_vlm(args, overrides)
    run = build(argv)
    tc, cfg, device, seed, run_dir = run["tc"], run["cfg"], run["device"], run["seed"], run["run_dir"]
    state, step_fn, schedule = run["state"], run["step_fn"], run["schedule"]
    num_steps, steps_per_epoch = run["num_steps"], run["steps_per_epoch"]
    collator, per_host_batch, data_world = run["collator"], run["per_host_batch"], run["data_world"]
    viz_fn = None  # built at the first visualize_interval hit

    start_step, load_s = 0, None
    if tc.is_resume and (latest := ckpt_mod.latest_checkpoint(run_dir)) is not None:
        overwatch.info(f"resuming from {latest}")
        t0 = time.perf_counter()
        state = ckpt_mod.load_checkpoint(latest, state)
        _sync(device)
        load_s = time.perf_counter() - t0
        start_step = int(state["step"])
        overwatch.info(f"checkpoint loaded in {load_s:.1f} s")

    overwatch.info(_strategy_line(run["mesh"], device, tc.global_batch_size, tc.per_device_batch_size,
                                  run["grad_accum"], num_steps))

    # throughput: 6N model FLOPs per decoder token (the whole decoder's N)
    # against the bf16 peak of every distinct card of the world
    from mla_tpu_torch.parallel.mesh import distinct_cards

    peak_flops = _peak_flops(device, distinct_cards(device))
    metrics = metrics_mod.VLAMetrics(
        tc.trackers.split(","), run["run_id"], run_dir, hparams=dataclasses.asdict(tc), resume_step=start_step or None,
        flops_per_token=run["flops_per_token"], peak_flops=peak_flops,
    )

    # preemption: the handler only sets a flag (saving inside a signal frame
    # would catch a step half done); the loop drains it at the next step
    # boundary with one synchronous checkpoint and exits cleanly
    preempt = {"hit": False}

    def _on_preempt(signum, frame):
        preempt["hit"] = True

    prev_handlers = {s: signal.signal(s, _on_preempt) for s in (signal.SIGTERM, signal.SIGUSR1)}
    saves: List[Tuple[int, float]] = []
    data_wait_s: List[float] = []

    def save(step_done: int, loss: float, async_save: bool) -> None:
        t0 = time.perf_counter()
        path = ckpt_mod.save_checkpoint(run_dir, state, step=step_done, epoch=0, loss=loss, model_cfg=cfg,
                                        async_save=async_save)
        saves.append((step_done, time.perf_counter() - t0))
        overwatch.info(f"checkpoint {path.name} {'handed to the writer' if async_save else 'saved'} in "
                       f"{saves[-1][1]:.1f} s")

    # --- loop ----------------------------------------------------------------
    try:
        data_iter = iter(run["dataset"])
        for step in range(start_step, num_steps):
            t_wait = time.perf_counter()
            if collator is not None:
                host_batch = collator([next(data_iter) for _ in range(per_host_batch)])
            else:
                host_batch = next(data_iter)
            data_wait_s.append(time.perf_counter() - t_wait)
            gen = step_generator(seed, step, device)
            state, step_metrics = step_fn(state, host_batch, gen)
            # decoder tokens run this step: prompt + fused block (+ the
            # diffusion block [proprio, t, x_0..15], repeated
            # repeated_diffusion_steps times), each data rank's rows once
            bsz, ids_len = host_batch["input_ids"].shape[:2]
            seq_len, reps = ids_len + cfg.fused_len, 1
            if tc.use_diff:
                seq_len += 2 + cfg.action_horizon
                reps = tc.repeated_diffusion_steps
            metrics.commit(global_step=step, epoch=step // steps_per_epoch, lr=float(schedule(step)),
                           update_step_time=True, tokens=bsz * data_world * reps * seq_len, **step_metrics)
            if step % 10 == 0 or step == num_steps - 1:
                overwatch.info(metrics.push())
            saved_this_step = (step + 1) % tc.save_interval == 0 or step == num_steps - 1
            if saved_this_step:
                save(step + 1, float(step_metrics["total_loss"]), tc.async_checkpoints)
            if preempt["hit"]:
                if not saved_this_step:
                    save(step + 1, float(step_metrics["total_loss"]), False)
                overwatch.info(f"preempted: checkpoint saved at step {step + 1}, exiting")
                break
            if tc.visualize_interval and cfg.use_generation and (step + 1) % tc.visualize_interval == 0:
                from mla_tpu_torch.utils.visualize import save_generation_visualization

                if viz_fn is None:
                    viz_fn = strategy.make_visualize_step(cfg, run["sched"])
                save_generation_visualization(
                    viz_fn(state, host_batch, step_generator(seed, step, device)), host_batch.get("next_images"),
                    host_batch.get("next_point_cloud"), run_dir / "visualizations", step=step + 1,
                    image_patch_size=cfg.gen.image.image_patch_size,
                )
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
    ckpt_mod.wait_for_async_saves()
    metrics.finalize()
    overwatch.info("done")
    return {"state": state, "run_dir": run_dir, "metrics": metrics, "saves": saves, "load_s": load_s, "cfg": cfg,
            "data_wait_s": data_wait_s, "hf_load": run["hf_load"]}


def _device(args: argparse.Namespace) -> Tuple[torch.device, Any]:
    """(device, mesh): the launch's process group joined
    (parallel/mesh.initialize_distributed: cuda:LOCAL_RANK and NCCL, or
    gloo with --device cpu) and its mesh (dp x fsdp x tp), or the one
    device and None without a launch. A dp * tp that does not divide the
    world, a partial launch environment and a card-less cuda raise."""
    from mla_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    launch = initialize_distributed(args.device)
    if launch is None:
        if args.dp != 1 or args.tp != 1:
            make_mesh(dp=args.dp, tp=args.tp)  # raises: one process holds no dp or tp > 1
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to train on the CPU")
        return device, None
    return launch["device"], make_mesh(dp=args.dp, tp=args.tp)


def _strategy_line(mesh: Any, device: torch.device, global_bsz: int, per_device: int, grad_accum: int,
                   steps: int) -> str:
    """The strategy log line (scripts/train.py's 'GSPMD strategy ::')."""
    if mesh is None:
        return (f"single-device strategy :: device={device} global_bsz={global_bsz} per-device={per_device} "
                f"grad_accum={grad_accum} steps={steps}")
    shape = {"dp": mesh.dp, "fsdp": mesh.fsdp, "tp": mesh.tp}
    return (f"distributed strategy :: mesh={shape} global_bsz={global_bsz} per-device={per_device} "
            f"grad_accum={grad_accum} steps={steps}")


def _peak_flops(device: torch.device, cards: int) -> Optional[float]:
    """The bf16 peak of `cards` cards like `device` (None off the card)."""
    from mla_tpu_torch.training import metrics as metrics_mod

    if device.type != "cuda":
        return None
    peak = metrics_mod.bf16_peak_flops(torch.cuda.get_device_name(device))
    return peak * cards if peak is not None else None


def vlm_model_batch(cb: Dict[str, Any]) -> Dict[str, Any]:
    """The LM collator's output as a vlm_forward batch. The sampler's
    batches are of one modality: all multimodal (the image block spliced
    right after BOS, splice_idx 1, no diffusion block) or all
    language-only (no images)."""
    import numpy as np

    n_mm, B = len(cb["multimodal_indices"]), cb["input_ids"].shape[0]
    assert n_mm in (0, B), f"mixed-modality batch ({n_mm}/{B} multimodal)"
    out = {"input_ids": cb["input_ids"], "attention_mask": cb["attention_mask"], "labels": cb["labels"]}
    if n_mm:
        out["images"] = {"front_image": cb["pixel_values"]}
        out["splice_idx"] = np.ones((B,), np.int32)
    return out


def train_vlm(args: argparse.Namespace, overrides: Dict[str, str]) -> Dict[str, Any]:
    """The VLM pretraining loop, scripts/train.py's train_vlm in its order:
    the vision-language config (no diffusion, point cloud, tactile,
    contrastive or generation heads) of --model (default mla-7b); the
    seeded init, then --hf_llama_dir; the --vlm_dataset stage data through
    SplitModalitySampler (drop_last off) and the LM collator; AdamW at
    stage vlm-align (lr 1e-3) or vlm-finetune (2e-5) and the shared train
    step with the AR loss, on vlm_model_batch's batches; VLAMetrics every
    step; one checkpoint at the end. Overrides read: seed, epochs, max_steps, global_batch_size, learning_rate,
    run_root_dir, run_id, trackers, enable_gradient_checkpointing. Returns
    {'state', 'run_dir', 'metrics', 'cfg', 'hf_load', 'multimodal' (per
    step, whether its batch had images), 'num_steps'}."""
    from mla_tpu_torch import params as P
    from mla_tpu_torch.conf.datasets import get_dataset_config
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.diffusion import gaussian as gd
    from mla_tpu_torch.parallel.mesh import distinct_cards
    from mla_tpu_torch.training import checkpointing as ckpt_mod
    from mla_tpu_torch.training import metrics as metrics_mod
    from mla_tpu_torch.training import optim, strategy
    from mla_tpu_torch.utils import set_global_seed, step_generator
    from mla_tpu_torch.vla.sampler import SplitModalitySampler
    from mla_tpu_torch.vla.tokenizer import SimpleTokenizer, load_llama_tokenizer
    from mla_tpu_torch.vla.vlm_datasets import get_vlm_dataset_and_collator

    stage = f"vlm-{args.vlm_stage}"
    model_id = args.model or "mla-7b"
    device, mesh = _device(args)
    data_world, data_rank = (mesh.data_world, mesh.data_rank) if mesh is not None else (1, 0)

    def g(k, d):
        if k not in overrides:
            return d
        v = overrides[k]
        if isinstance(d, bool):
            return str(v).lower() in ("1", "true", "yes")
        return type(d)(v)

    seed = g("seed", 7)
    epochs = g("epochs", 1)
    max_steps = g("max_steps", 0) or None
    global_batch_size = g("global_batch_size", 4)
    learning_rate = g("learning_rate", 1e-3 if args.vlm_stage == "align" else 2e-5)
    run_root_dir = g("run_root_dir", "runs")

    cfg = get_model_config(model_id, use_diff=False, use_pointcloud=False, use_tactile=False,
                           use_contrastive=False, use_generation=False)
    strategy.check_tp(cfg, mesh.tp if mesh is not None else 1)
    set_global_seed(seed, data_rank)  # the host's, rank-folded; the init and the draws take `seed`
    params, mstate = P.init(cfg, seed=seed, device=device)
    hf_load: Dict[str, Any] = {}
    if args.hf_llama_dir:
        from mla_tpu_torch.models.load import load_base_llm

        params = load_base_llm(args.hf_llama_dir, cfg, params, device=device, report=hf_load)

    tokenizer = load_llama_tokenizer(args.tokenizer) if args.tokenizer else SimpleTokenizer()
    ds, collator = get_vlm_dataset_and_collator(
        stage=args.vlm_stage, dataset_cfg=get_dataset_config(args.vlm_dataset), data_root_dir=args.data_root_dir,
        tokenizer=tokenizer, image_size=cfg.vision.image_size, max_length=args.vlm_max_length,
    )
    lengths = (ds.get_modality_lengths(n_image_patches=cfg.fused_len) if args.vlm_stage == "align"
               else ds.get_modality_lengths())
    sampler = SplitModalitySampler(lengths, global_batch_size=global_batch_size, num_replicas=data_world,
                                   rank=data_rank, seed=seed, drop_last=False)
    per_host = global_batch_size // data_world
    steps_per_epoch = max(len(sampler) // per_host, 1)
    num_steps = max_steps or epochs * steps_per_epoch
    overwatch.info(f"VLM {stage} :: model={model_id} dataset={args.vlm_dataset} examples={len(ds)} "
                   f"gbs={global_batch_size} steps={num_steps} device={device}")

    tcfg = strategy.TrainConfig(
        learning_rate=learning_rate, grad_accumulation_steps=1, repeated_diffusion_steps=1, stage=stage,
        num_training_steps=num_steps, enable_gradient_checkpointing=g("enable_gradient_checkpointing", True),
    )
    opt, schedule, _ = optim.make_optimizer(params, learning_rate=learning_rate, num_training_steps=num_steps,
                                            stage=stage)
    flops_per_token = metrics_mod.decoder_flops_per_token(params["llm_backbone"], use_diff=False)
    state = strategy.init_train_state(params, opt, mstate, mesh=mesh, compute_dtype=cfg.llama.compute_dtype)
    del params, mstate, opt
    step_fn = strategy.make_train_step(cfg, tcfg, gd.create_schedule("", diffusion_steps=100))
    overwatch.info(_strategy_line(mesh, device, global_batch_size, per_host, 1, num_steps))

    run_id = g("run_id", f"vlm-{args.vlm_stage}+{args.vlm_dataset}+x{seed}")
    run_dir = Path(run_root_dir) / run_id
    metrics = metrics_mod.VLAMetrics(
        g("trackers", "jsonl").split(","), run_id, run_dir,
        hparams={"stage": stage, "dataset": args.vlm_dataset, "global_batch_size": global_batch_size,
                 "lr": learning_rate},
        flops_per_token=flops_per_token, peak_flops=_peak_flops(device, distinct_cards(device)),
    )

    step, epoch, step_metrics, multimodal = 0, 0, None, []
    for epoch in range(epochs if max_steps is None else 10**6):
        sampler.set_epoch(epoch)
        idx = list(iter(sampler))
        for bstart in range(0, len(idx) - per_host + 1, per_host):
            host_batch = vlm_model_batch(collator([ds[i] for i in idx[bstart : bstart + per_host]]))
            state, step_metrics = step_fn(state, host_batch, step_generator(seed, step, device))
            multimodal.append("images" in host_batch)
            B, L = host_batch["input_ids"].shape
            metrics.commit(global_step=step, epoch=epoch, lr=float(schedule(step)), update_step_time=True,
                           tokens=B * data_world * L, **step_metrics)
            if step % 10 == 0 or step == num_steps - 1:
                overwatch.info(metrics.push())
            step += 1
            if step >= num_steps:
                break
        if step >= num_steps:
            break
    ckpt_mod.save_checkpoint(run_dir, state, step=step, epoch=epoch, loss=float(step_metrics["total_loss"]),
                             model_cfg=cfg, async_save=False)
    metrics.finalize()
    overwatch.info("done")
    return {"state": state, "run_dir": run_dir, "metrics": metrics, "cfg": cfg, "hf_load": hf_load,
            "multimodal": multimodal, "num_steps": num_steps}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    main()
