"""Sampler qualification on the card: is DPM-Solver++(2M) with 4
evaluations as faithful as DDIM-8?

    python -m mla_tpu_torch.qualify_samplers [--model mla-small] [--scenarios 6]
        [--weight_seeds 0 1] [--trace obs.npz] [--train_steps 120]
        [--optimizer adamw|adafactor] [--compare_int8] [--compare_bf16s]
        [--samplers ddim8 dpm4 ...] [--out result.json] [--device cuda|cpu]

Counterpart of scripts/qualify_samplers.py, with its flags, defaults,
candidates and metrics. Each weight seed's model is first trained on the
diffusion objective with the production step (`training/strategy`,
`training/optim`) on `vla/dummy.synthetic_batch`, so that the eps head
predicts a consistent noise field: a fresh head is zero and every sampler
agrees on it; a random one gives a chaotic field in which sampler deltas are
noise. Each candidate (DDIM-8, DDIM-4, DPM-2/3/4/6) is then measured against
DDIM-100 on the same weights, observations and x_T, on the normalized chunk
before the clip: the rms and max of |delta| over the continuous dims, each
relative to the DDIM-100 chunk's rms, and the gripper agreement of the
binarized last dim. --compare_int8 adds W8A8 against bf16 and
--compare_bf16s bf16 prefill scores against fp32, both with DDIM-8.

The prefill-scores dtype is pinned (fp32 unless --compare_bf16s asks for the
bf16 side), not read from MLA_PREFILL_SCORES. x_T comes from a CPU
`torch.Generator` seeded 9000 + the scenario's index, one per scenario,
shared by every sampler. The entry runs on the card (`--device cuda`, the
default) and raises when there is none; --device cpu runs it on the CPU.
It prints one JSON line, the counterpart of the JAX script's.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mla_tpu_torch import params as P
from mla_tpu_torch.conf.models import get_model_config
from mla_tpu_torch.diffusion import gaussian as gd
from mla_tpu_torch.models.mla import MLAPolicy, unnormalize_actions
from mla_tpu_torch.ops.quantization import quantize_llama
from mla_tpu_torch.training import optim, strategy
from mla_tpu_torch.vla.datasets import add_mask_channel, clip_preprocess
from mla_tpu_torch.vla.dummy import synthetic_batch
from mla_tpu_torch.vla.tokenizer import SimpleTokenizer

CANDIDATES: List[Tuple[str, Dict[str, Any]]] = [
    ("ddim8", dict(num_ddim_steps=8)),
    ("ddim4", dict(num_ddim_steps=4)),  # DDIM at DPM-4's cost
    ("dpm2", dict(sampler="dpm", num_dpm_steps=2)),
    ("dpm3", dict(sampler="dpm", num_dpm_steps=3)),
    ("dpm4", dict(sampler="dpm", num_dpm_steps=4)),
    ("dpm6", dict(sampler="dpm", num_dpm_steps=6)),
]
REFERENCE_STEPS = 100
LEARNING_RATE = 1e-3
TEXT_LEN = 16
INSTRUCTION = "close the jar"


def train(params, mstate, cfg, steps: int, seed: int, optimizer: str = "adamw", rows: int = 2,
          draws: Optional[Callable[[int], Dict[str, Any]]] = None, log=None):
    """`steps` production train steps on synthetic batches (seed * 10000 +
    i, `rows` rows), learning rate 1e-3, one diffusion step a row, no remat,
    as the JAX script's _train runs them. The step draws its noise, t and
    FPS starts from a generator seeded `seed`, or takes `draws(i)`
    (mla_train_loss's overrides). Returns (params, model_state, losses)."""
    dev = next(iter(P.tree_leaves(params))).device
    sched = gd.create_schedule("", diffusion_steps=100)
    tcfg = strategy.TrainConfig(learning_rate=LEARNING_RATE, grad_accumulation_steps=1, repeated_diffusion_steps=1,
                                enable_gradient_checkpointing=False, num_training_steps=steps)
    tx, _, _ = optim.make_optimizer(params, learning_rate=LEARNING_RATE, num_training_steps=steps,
                                    optimizer=optimizer)
    state = strategy.init_train_state(params, tx, mstate)
    step_fn = strategy.make_train_step(cfg, tcfg, sched)
    gen = torch.Generator(device=dev).manual_seed(seed)
    losses = []
    for i in range(steps):
        batch = synthetic_batch(cfg, B=rows, L=TEXT_LEN, seed=seed * 10_000 + i, training=True)
        if draws is not None:
            state, metrics = step_fn(state, batch, draws=[draws(i)])
        else:
            state, metrics = step_fn(state, batch, generator=gen)
        losses.append(float(metrics["total_loss"]))
        if log is not None and (i % 25 == 0 or i == steps - 1):
            print(f"  train[{i}] loss {losses[-1]:.4f}", file=log)
    # one process: the masters are the tree's own leaves, what the step's gather hands out
    trained = P.tree_map(lambda t: t.detach(), state["params"])
    return trained, state["model_state"], losses


def trained_model(model_id: str, weight_seed: int, train_steps: int = 0, optimizer: str = "adamw",
                  device="cuda", log=None):
    """(params, model_state, cfg): the preset's seeded random init on
    `device`, trained for `train_steps` steps."""
    cfg = get_model_config(model_id.removesuffix("-int8"), use_contrastive=False)
    params, mstate = P.init(cfg, seed=weight_seed, device=device)
    if train_steps:
        params, mstate, _ = train(params, mstate, cfg, train_steps, weight_seed, optimizer=optimizer, log=log)
    return params, mstate, cfg


def make_policy(params, mstate, cfg, quantize: bool = False, scores_dtype: Optional[torch.dtype] = None,
                device="cuda") -> MLAPolicy:
    """The policy the measurements run, its prefill-scores dtype pinned to
    `scores_dtype` (fp32 when None) rather than read from the environment,
    its decoder quantized (W8A8) when `quantize`."""
    if quantize:
        params = {**params, "llm_backbone": quantize_llama(params["llm_backbone"])}
    stats = {"qualify": {
        "action": {"q01": [-1.0] * cfg.action_dim, "q99": [1.0] * cfg.action_dim},
        "proprio": {"q01": [-1.0] * cfg.action_dim, "q99": [1.0] * cfg.action_dim},
    }}
    return MLAPolicy(params, mstate, cfg, tokenizer=SimpleTokenizer(), norm_stats=stats, device=device,
                     prefill_scores_dtype=scores_dtype or torch.float32)


def make_scenarios(cfg, n: int, trace_path: Optional[str]) -> List[Tuple[np.ndarray, np.ndarray, Any]]:
    """(image, pointcloud, proprio) observations: seeded synthetic draws
    (numpy generator 7000 + i), or recorded ones from an npz of the eval
    schema (images [N, H, W, 3] uint8, point_clouds [N, P, 3])."""
    out = []
    if trace_path:
        trace = np.load(trace_path, allow_pickle=True)
        for i in range(min(n, len(trace["images"]))):
            img = add_mask_channel(clip_preprocess(trace["images"][i], cfg.vision.image_size))
            out.append((img, np.asarray(trace["point_clouds"][i], np.float32), None))
        return out
    for i in range(n):
        rng = np.random.default_rng(7000 + i)
        raw = rng.integers(0, 255, (cfg.vision.image_size, cfg.vision.image_size, 3), np.uint8)
        img = add_mask_channel(clip_preprocess(raw, cfg.vision.image_size))
        pc = rng.normal(size=(cfg.point.input_points, 3)).astype(np.float32)
        proprio = rng.uniform(-0.8, 0.8, cfg.action_dim).astype(np.float32)
        out.append((img, pc, proprio))
    return out


def scenario_noise(cfg, index: int) -> np.ndarray:
    """Scenario `index`'s x_T [horizon, action_dim], from a CPU generator
    seeded 9000 + index."""
    gen = torch.Generator(device="cpu").manual_seed(9000 + index)
    return torch.randn((cfg.action_horizon, cfg.action_dim), generator=gen).numpy()


def _pair_delta(a: np.ndarray, ref: np.ndarray, stats) -> Tuple[np.ndarray, float]:
    """|a - ref| over the continuous dims relative to ref's rms, and the
    agreement of the binarized gripper."""
    scale = max(float(np.sqrt(np.mean(ref[:, :-1] ** 2))), 1e-9)
    agree = float(np.mean(unnormalize_actions(a, stats)[:, -1] == unnormalize_actions(ref, stats)[:, -1]))
    return np.abs(a[:, :-1] - ref[:, :-1]) / scale, agree


def _summary(deltas: Sequence[np.ndarray], agrees: Sequence[float], prefix: str = "rel") -> Dict[str, float]:
    d = np.stack(deltas)
    return {f"{prefix}_rms": float(np.sqrt(np.mean(d ** 2))), f"{prefix}_max": float(d.max()),
            "gripper_agree": float(np.mean(agrees))}


class Tally:
    """The per-scenario deltas and agreements of every comparison."""

    def __init__(self, names: Sequence[str]) -> None:
        self.names = list(names)
        self.deltas: Dict[str, list] = {n: [] for n in self.names}
        self.grip: Dict[str, list] = {n: [] for n in self.names}
        self.extra: Dict[str, Tuple[list, list]] = {}

    def add(self, name: str, delta: np.ndarray, agree: float) -> None:
        self.deltas[name].append(delta)
        self.grip[name].append(agree)

    def add_extra(self, name: str, delta: np.ndarray, agree: float) -> None:
        d, g = self.extra.setdefault(name, ([], []))
        d.append(delta)
        g.append(agree)

    def result(self) -> Dict[str, Any]:
        samplers = {}
        for n in self.names:
            s = _summary(self.deltas[n], self.grip[n])
            samplers[n] = {"rel_rms_vs_ddim100": s["rel_rms"], "rel_max_vs_ddim100": s["rel_max"],
                           "gripper_agree": s["gripper_agree"]}
        out: Dict[str, Any] = {"samplers": samplers}
        if "dpm4" in samplers and "ddim8" in samplers:
            out["dpm4_vs_ddim8_rms_ratio"] = samplers["dpm4"]["rel_rms_vs_ddim100"] / max(
                samplers["ddim8"]["rel_rms_vs_ddim100"], 1e-12)
        for name, (d, g) in self.extra.items():
            out[name] = _summary(d, g)
        return out


def measure(policy: MLAPolicy, scenarios, candidates, tally: Tally, noise_fn: Callable[[int], np.ndarray],
            int8_policy: Optional[MLAPolicy] = None, bf16s_policy: Optional[MLAPolicy] = None) -> None:
    """Every candidate against DDIM-100 on each scenario, with the
    scenario's x_T; the W8A8 and bf16-scores comparisons with DDIM-8."""
    stats = policy.get_action_stats("qualify")
    for si, (img, pc, proprio) in enumerate(scenarios):
        common = dict(cur_robot_state=proprio, unnorm_key="qualify", noise=noise_fn(si), instruction=INSTRUCTION,
                      return_normalized=True)
        ref = policy.predict_action_diff(img, pc, num_ddim_steps=REFERENCE_STEPS, **common)
        for name, kw in candidates:
            tally.add(name, *_pair_delta(policy.predict_action_diff(img, pc, **common, **kw), ref, stats))
        for key, other in (("int8_vs_bf16", int8_policy), ("bf16_scores_vs_fp32", bf16s_policy)):
            if other is not None:
                base = policy.predict_action_diff(img, pc, num_ddim_steps=8, **common)
                tally.add_extra(key, *_pair_delta(other.predict_action_diff(img, pc, num_ddim_steps=8, **common),
                                                  base, stats))


def select(samplers: Optional[Sequence[str]]) -> List[Tuple[str, Dict[str, Any]]]:
    if not samplers:
        return list(CANDIDATES)
    unknown = set(samplers) - {n for n, _ in CANDIDATES}
    if unknown:
        raise ValueError(f"unknown samplers: {sorted(unknown)}")
    return [(n, kw) for n, kw in CANDIDATES if n in samplers]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="mla-small")
    p.add_argument("--scenarios", type=int, default=6)
    p.add_argument("--weight_seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--trace", default=None, help="npz with images / point_clouds")
    p.add_argument("--train_steps", type=int, default=120, help="diffusion-objective train steps before measuring")
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    p.add_argument("--compare_int8", action="store_true", help="also measure W8A8 against bf16 (DDIM-8)")
    p.add_argument("--compare_bf16s", action="store_true",
                   help="also measure bf16 prefill scores against fp32 (DDIM-8)")
    p.add_argument("--out", default=None, help="write the full JSON here")
    p.add_argument("--samplers", nargs="+", default=None, help="a subset of " + " ".join(n for n, _ in CANDIDATES))
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    return p


def run(args, models: Optional[Callable[[int], Tuple[Any, Any, Any]]] = None,
        noise_fn: Optional[Callable[[Any, int], np.ndarray]] = None) -> Dict[str, Any]:
    """The qualification of `args` (parser()'s namespace). `models(seed)`
    and `noise_fn(cfg, index)` replace the trained model and the x_T draw
    (the parity tests pass the JAX script's)."""
    candidates = select(args.samplers)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("qualify_samplers: no CUDA device is available; pass --device cpu to run on the CPU")
    quantized = args.model.endswith("-int8")
    tally = Tally([n for n, _ in candidates])
    for wseed in args.weight_seeds:
        if models is not None:
            tparams, tstate, tcfg = models(wseed)
        else:
            tparams, tstate, tcfg = trained_model(args.model, wseed, args.train_steps, optimizer=args.optimizer,
                                                  device=args.device, log=sys.stderr)
        policy = make_policy(tparams, tstate, tcfg, quantize=quantized, device=args.device)
        int8_policy = (make_policy(tparams, tstate, tcfg, quantize=True, device=args.device)
                       if args.compare_int8 and not quantized else None)
        bf16s_policy = (make_policy(tparams, tstate, tcfg, quantize=quantized, scores_dtype=torch.bfloat16,
                                    device=args.device) if args.compare_bf16s else None)
        scenarios = make_scenarios(tcfg, args.scenarios, args.trace)
        measure(policy, scenarios, candidates, tally, lambda si: (noise_fn or scenario_noise)(tcfg, si),
                int8_policy, bf16s_policy)
        del policy, int8_policy, bf16s_policy, tparams, tstate
        if args.device.startswith("cuda"):
            torch.cuda.empty_cache()
    return {"model": args.model, "scenarios": args.scenarios, "weight_seeds": args.weight_seeds,
            "trace": bool(args.trace), "train_steps": args.train_steps, "optimizer": args.optimizer,
            **tally.result()}


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    try:
        select(args.samplers)
    except ValueError as e:
        p.error(str(e))
    result = run(args)
    print(json.dumps(result))
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
