"""Where the time of one request goes, on one NVIDIA GPU.

    python3 -m mla_tpu_torch.profile_chunk [--model MODEL] [--sampler ddim|dpm|ar]

Builds the model from a seeded random init on the card (as chip_smoke.py
does). MODEL is mla-7b, mla-mistral or mla-phi, with bench.py's suffix
rule for the llama family: a bare llama id is its int8 tree, as
`--model mla-7b` has always measured (so earlier figures stay
comparable), `-int8` names the same, and `-int4` serves the int4 tree
(group 128: ops/quantization.quantize_model_int4, int4 products in plain
PyTorch, no kernel). mla-phi is the bf16 Phi-2 (the JAX package quantizes
llama trees only). It serves a few warm-up requests, then reports:
  * host wall time per stage, each ending in a synchronize: for a
    diffusion chunk (ddim, dpm; mla-7b's linears W8A8) front-end + prefix
    embeds, prefill, one suffix evaluation and the whole chunk; for an AR
    action (ar: predict_action_ar, mla-7b's linears weight-only int8)
    front-end + prefix embeds, prefill with the last position's logits, one
    decode step, the lm_head alone and the whole request, beside the decode
    step's weight-read bound (the bytes of the decoder layers' weights, and
    with the lm_head's, over 3.35 TB/s; int4 trees count their packed
    bytes and run int4_linear in every mode);
  * a torch.profiler trace of one request: device time by kernel, the sum
    of device time, the device time and launches of the int8_mm and w8a8
    kernels, and the device's idle share of the unprofiled request's wall
    time (1 - busy / request ms).
Results print as text and go to chiprun_out/profile_chunk_<model>_<sampler>.json.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from mla_tpu_torch import params as P
from mla_tpu_torch.conf.models import get_model_config
from mla_tpu_torch.models import mla, prismatic
from mla_tpu_torch.ops.quantization import quantize_model, quantize_model_int4

PEAK_BYTES = 3.35e12  # H100 SXM HBM bytes/s (data sheet)
MODELS = ("mla-7b", "mla-mistral", "mla-phi")
QUANTIZE = {"int8": quantize_model, "int4": quantize_model_int4}


def parse_model_id(model_id: str):
    """(preset, quantization) of a model id after bench.py's suffix rule:
    '-int8' / '-int4' name the llama tree's quantization, a bare llama id is
    int8, and mla-phi serves its bf16 tree (None)."""
    base, quant = model_id, None
    for suffix in ("-int8", "-int4"):
        if model_id.endswith(suffix):
            base, quant = model_id[: -len(suffix)], suffix[1:]
    if base not in MODELS:
        raise ValueError(f"unknown model {model_id!r}: one of {MODELS}, a llama id may end in -int8 or -int4")
    if base == "mla-phi":
        if quant:
            raise ValueError("mla-phi serves its bf16 tree: the JAX package quantizes llama trees only")
        return base, None
    return base, quant or "int8"


def _timed(fn, reps: int = 5):
    """Median host wall ms of fn() ending in a synchronize."""
    out, times = None, []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times)), out


def _diffusion_stages(policy, cfg, prefix_ids, images, pc_t, noise):
    stages = {}
    with torch.inference_mode():
        stages["prefix_embeds_ms"], prefix = _timed(
            lambda: mla.build_prefix_embeds(policy.params, policy.state, cfg, prefix_ids, images, pc_t))
        cache_max = prefix.shape[1] + 2 + cfg.action_horizon + 1 + mla.CACHE_MARGIN
        stages["prefill_ms"], (kv, _) = _timed(lambda: mla.prefill(policy.params, cfg, prefix, cache_max,
                                                                     compute_logits=False))
        fn = mla.make_suffix_denoise_fn(policy.params, cfg, kv, prefix.shape[1],
                                        torch.zeros((1, 1, cfg.action_dim), device="cuda"))
        x = torch.as_tensor(noise, device="cuda")[None]
        t = torch.full((1,), 50, dtype=torch.int32, device="cuda")
        stages["suffix_eval_ms"], _ = _timed(lambda: fn(x, t))
    return stages


def _ar_stages(policy, cfg, ids, images, pc_t):
    """Stages of predict_action_ar; the decode step is timed at one cache
    position (each repetition rewrites the same slot)."""
    stages = {}
    mode = policy.int8_mode
    bb = policy.params["llm_backbone"]
    with torch.inference_mode():
        stages["prefix_embeds_ms"], prefix = _timed(
            lambda: mla.build_prefix_embeds(policy.params, policy.state, cfg, ids, images, pc_t))
        n = prefix.shape[1]
        cache_max = n + cfg.action_dim + mla.CACHE_MARGIN
        stages["prefill_ms"], (kv, last) = _timed(lambda: mla.prefill(policy.params, cfg, prefix, cache_max,
                                                                        int8_mode=mode))
        tok = last.argmax(-1)
        stages["decode_step_ms"], _ = _timed(lambda: mla.decode_step(policy.params, cfg, kv, n, tok, int8_mode=mode))
        h = torch.zeros((1, cfg.llama.hidden_size), dtype=cfg.llama.compute_dtype, device="cuda")
        stages["lm_head_ms"], _ = _timed(lambda: prismatic.get_decoder(cfg).lm_head_logits(bb, h))
    weight_bytes = sum(_bytes(leaf[next(k for k in ("w_q4", "w_q", "w") if k in leaf)])
                       for group in ("attn", "mlp") for leaf in bb["layers"][group].values())
    head_bytes = sum(_bytes(t) for t in P.tree_leaves(bb["lm_head"]))
    stages["decode_weight_read_bound_ms"] = weight_bytes / PEAK_BYTES * 1e3
    stages["decode_weight_and_lm_head_read_bound_ms"] = (weight_bytes + head_bytes) / PEAK_BYTES * 1e3
    return stages


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="mla-7b",
                    help="mla-7b, mla-mistral or mla-phi; a llama id is int8 (its -int8 id too) or, as "
                         "mla-7b-int4 / mla-mistral-int4, the int4 tree")
    ap.add_argument("--sampler", default="ddim", choices=("ddim", "dpm", "ar"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_chunk: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    base, quant = parse_model_id(args.model)
    cfg = get_model_config(base)
    params, state = P.init(cfg, seed=0, device="cuda")
    fc2 = params["final_layer"]["mlp"]["fc2"]
    fc2["w"] = torch.randn(fc2["w"].shape, generator=torch.Generator("cuda").manual_seed(1), device="cuda") * 0.02
    ar = args.sampler == "ar"
    stats = {"rlbench": {"action": {"q01": [-1.0] * 6 + [0.0], "q99": [1.0] * 7}}}
    if quant:
        params = QUANTIZE[quant](params)
    policy = mla.MLAPolicy(params, state, cfg, norm_stats=stats, int8_mode="weight_only" if ar else "w8a8")
    del params
    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    img = rng.integers(0, 256, size=(3, size, size), dtype=np.uint8)
    pc = rng.uniform([-0.3, -0.45, 0.75], [0.7, 0.45, 1.6], size=(cfg.point.input_points, 3)).astype(np.float32)
    ids = np.concatenate([[1], rng.integers(100, 20000, 20), [29871]]).astype(np.int32)[None, :]
    noise = rng.standard_normal((cfg.action_horizon, cfg.action_dim)).astype(np.float32)

    def chunk():
        if ar:
            return policy.predict_action_ar(img, pc, "", input_ids=ids)
        return policy.predict_action_diff(img, pc, "", input_ids=ids, noise=noise, sampler=args.sampler,
                                          return_normalized=True)

    for _ in range(3):
        chunk()
    stages = {}
    stages["chunk_ms"], _ = _timed(chunk)
    images = {"front_image": torch.as_tensor(img, device="cuda")[None]}
    pc_t = torch.as_tensor(pc, device="cuda")[None]
    ids_t = torch.as_tensor(ids, device="cuda").long()
    if ar:
        stages.update(_ar_stages(policy, cfg, ids_t, images, pc_t))
    else:
        stages.update(_diffusion_stages(policy, cfg, ids_t[:, :-1], images, pc_t, noise))

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, memcpy, memset): the CPU-side aten
    # ops carry their kernels' time too and would count it twice
    rows = [
        {"name": e.key[:90], "device_ms": e.self_device_time_total / 1e3, "count": e.count}
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r["device_ms"])
    device_ms = sum(r["device_ms"] for r in rows)
    # the hand-written products by kernel file: int8_mm (weight-only) and w8a8
    products = {name: {"device_ms": sum(r["device_ms"] for r in rows if name in r["name"]),
                       "launches": sum(r["count"] for r in rows if name in r["name"])}
                for name in ("int8_mm", "w8a8")}
    result = {"gpu": torch.cuda.get_device_name(0), "model": args.model, "sampler": args.sampler,
              "stages": stages, "profiled_chunk_wall_ms": wall_ms, "device_busy_ms": device_ms,
              "device_idle_share": max(0.0, 1.0 - device_ms / stages["chunk_ms"]), "products": products,
              "kernels": rows[:40]}
    for k, v in stages.items():
        print(f"{k}: {v:.3f}")
    print(f"profiled chunk: wall {wall_ms:.3f} ms (under the profiler), device busy {device_ms:.3f} ms, "
          f"idle share of the unprofiled chunk {result['device_idle_share']:.3f}")
    for name, v in products.items():
        print(f"{name} kernels: {v['device_ms']:.3f} ms device time, {v['launches']} launches")
    for r in rows[:20]:
        print(f"  {r['device_ms']:9.3f} ms  x{r['count']:5d}  {r['name']}")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"profile_chunk_{args.model}_{args.sampler}.json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
