#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`mla_tpu_torch`) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:
  1. build    compile every CUDA kernel of the serving path from
              mla_tpu_torch/csrc with nvcc (sm_90a), in parallel.
  2. kernels  hold each kernel against its plain PyTorch version at the
              shapes of the int8 mla-7b serving path and time kernel, plain
              version, a PyTorch library call (yardstick only) and the
              roofline bound.
  3. agree    serve one DDIM-8 request of an int8 `mla-small` (4 decoder
              layers, full-width front-ends) on the card and on the CPU
              (plain versions) from the same weights and noise; the
              normalized chunks must agree.
  4. serve    build the int8 `mla-7b` at full width from a seeded random
              init on the card, serve DDIM-8 and DPM-4 requests through
              MLAPolicy.predict_action_diff, check finite [16, 7] chunks and
              the kernel launch counts of every request.

The second-to-last line of output is a JSON object with each kernel's
numbers; the last is {"ok": true, "device": {...}}. Detailed results go to
chiprun_out/chip_smoke.json. Without a CUDA device, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM data-sheet peaks (dense): HBM bytes/s, int8 ops/s, bf16 and fp32 flop/s
PEAK_BYTES = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12}

# serving shapes of the int8 mla-7b: prefix P = 21 text + 513 fused tokens,
# suffix 18 tokens; (K, N) of the fused qkv, o, fused gate-up and down linears
PREFIX_LEN, SUFFIX_LEN = 534, 18
LINEARS = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)]


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_w8a8(torch, report):
    from mla_tpu_torch.ops import quantization as q

    gen = torch.Generator(device="cuda").manual_seed(1)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "err": 0.0, "b_bytes": 0.0, "b_ops": 0.0}
    for M in (PREFIX_LEN, SUFFIX_LEN):
        for K, N in LINEARS:
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            w_q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
            ws = torch.rand((N,), generator=gen, device="cuda") * 1e-3 + 1e-4
            y, acc = q.w8a8_matmul(x, w_q, ws, return_acc=True)
            yp, accp = q.w8a8_matmul_plain(x, w_q, ws, return_acc=True)
            torch.cuda.synchronize()
            if not torch.equal(acc, accp):
                raise AssertionError(f"w8a8 M={M} K={K} N={N}: int32 accumulators differ "
                                     f"({int((acc != accp).sum())} entries)")
            err = float((y.float() - yp.float()).abs().max())
            if err != 0.0:
                raise AssertionError(f"w8a8 M={M} K={K} N={N}: outputs differ by {err} with equal accumulators")

            def library():
                xq, sx = q.quantize_rows(x)
                return (torch._int_mm(xq, w_q).float() * sx * ws).to(torch.bfloat16)

            ms = cuda_ms(torch, lambda: q.w8a8_matmul(x, w_q, ws), 20)
            plain_ms = cuda_ms(torch, lambda: q.w8a8_matmul_plain(x, w_q, ws), 3, 1)
            lib_ms = cuda_ms(torch, library, 20)
            nbytes, ops = M * K * 2 + K * N + N * 4 + M * N * 2, 2.0 * M * K * N
            b, by = bound_ms(nbytes, ops, "int8")
            log(f"w8a8 M={M:4d} K={K:5d} N={N:5d}: acc identical, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"_int_mm {lib_ms:.4f} ms, bound {b:.4f} ms ({by})")
            report["shapes"].append({"kernel": "w8a8_matmul", "M": M, "K": K, "N": N, "ms": ms, "plain_ms": plain_ms,
                                     "library_ms": lib_ms, "bound_ms": b, "bound_by": by, "max_abs_err": err})
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["library_ms"] += lib_ms
            tot["bound_ms"] += b
            tot["b_bytes"] += nbytes / PEAK_BYTES * 1e3
            tot["b_ops"] += ops / PEAK_OPS["int8"] * 1e3
            tot["err"] = max(tot["err"], err)
    return {
        "name": "w8a8_matmul", "route": "cuda", "source": "mla_tpu_torch/csrc/w8a8.cu",
        "replaces": "mla_tpu/ops/quantization.py:347", "max_abs_err": tot["err"],
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if tot["b_bytes"] >= tot["b_ops"] else "operations",
        "library_ms": tot["library_ms"],
    }


def check_fps(torch, report):
    from mla_tpu_torch.ops import pointops

    gen = torch.Generator(device="cuda").manual_seed(2)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "b_bytes": 0.0, "b_ops": 0.0}
    for N, npoint in ((1024, 512), (512, 256)):
        xyz = torch.rand((1, N, 3), generator=gen, device="cuda")
        for start in (0, 7):
            s = torch.full((1,), start, dtype=torch.int32, device="cuda")
            got = pointops.furthest_point_sample(xyz, npoint, s)
            want = pointops.furthest_point_sample_plain(xyz, npoint, s)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"fps N={N} npoint={npoint} start={start}: indices differ "
                                     f"(first at {int((got != want).nonzero()[0, 1])})")
        ms = cuda_ms(torch, lambda: pointops.furthest_point_sample(xyz, npoint), 20)
        zero = torch.zeros((1,), dtype=torch.int32, device="cuda")
        plain_ms = cuda_ms(torch, lambda: pointops.furthest_point_sample_plain(xyz, npoint, zero), 2, 1)
        nbytes, ops = N * 12 + npoint * 4, 9.0 * N * npoint
        b, by = bound_ms(nbytes, ops, "fp32")
        log(f"fps N={N} npoint={npoint}: indices identical, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b:.6f} ms ({by})")
        report["shapes"].append({"kernel": "furthest_point_sample", "N": N, "npoint": npoint, "ms": ms,
                                 "plain_ms": plain_ms, "library_ms": None, "bound_ms": b, "bound_by": by,
                                 "max_abs_err": 0.0})
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += b
        tot["b_bytes"] += nbytes / PEAK_BYTES * 1e3
        tot["b_ops"] += ops / PEAK_OPS["fp32"] * 1e3
    return {
        "name": "furthest_point_sample", "route": "cuda", "source": "mla_tpu_torch/csrc/fps.cu",
        "replaces": "mla_tpu/ops/pointops_pallas.py:28", "max_abs_err": 0.0,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if tot["b_bytes"] >= tot["b_ops"] else "operations", "library_ms": None,
    }


# kernel vs plain version, both bf16 out: P is rounded to bf16 in both, but
# the tiles (64 vs 128) and so the online-softmax rescale order differ, which
# moves an output by about one bf16 ulp (2^-8 relative)
FLASH_ATOL = 2e-2


def check_flash(torch, report):
    import torch.nn.functional as F

    from mla_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    BH, S, hd = 32, PREFIX_LEN, 128
    q, k, v = (torch.randn((BH, S, hd), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    mask = torch.ones((BH, S), dtype=torch.int32, device="cuda")
    mask_pad = mask.clone()
    mask_pad[:, S - 40:] = 0
    err = 0.0
    for m in (mask, mask_pad):
        o, lse = fa.flash_fwd(q, k, v, m)
        op, lsep = fa.flash_fwd_plain(q, k, v, m)
        torch.cuda.synchronize()
        valid = m[0] > 0
        e = float((o.float() - op.float())[:, valid].abs().max())
        e_lse = float((lse - lsep)[:, valid].abs().max())
        if not (e <= FLASH_ATOL and e_lse <= 1e-3):
            raise AssertionError(f"flash: max |o - plain| {e} (tol {FLASH_ATOL}), max |lse - plain| {e_lse} (tol 1e-3)")
        err = max(err, e)
    q4, k4, v4 = (t[None] for t in (q, k, v))
    lib_err = float((fa.flash_fwd(q, k, v, mask)[0].float()
                     - F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)[0].float()).abs().max())
    ms = cuda_ms(torch, lambda: fa.flash_fwd(q, k, v, mask), 20)
    plain_ms = cuda_ms(torch, lambda: fa.flash_fwd_plain(q, k, v, mask), 5)
    lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), 20)
    nbytes = 4 * BH * S * hd * 2 + BH * S * 4 * 2
    ops = 4.0 * BH * hd * S * (S + 1) / 2
    b, by = bound_ms(nbytes, ops, "bf16")
    log(f"flash BH={BH} S={S} hd={hd}: max |o - plain| {err:.3e} (tol {FLASH_ATOL}), |o - sdpa| {lib_err:.3e}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b:.4f} ms ({by})")
    report["shapes"].append({"kernel": "flash_attention", "BH": BH, "S": S, "hd": hd, "ms": ms, "plain_ms": plain_ms,
                             "library_ms": lib_ms, "bound_ms": b, "bound_by": by, "max_abs_err": err,
                             "max_abs_err_vs_sdpa": lib_err})
    return {
        "name": "flash_attention", "route": "cuda", "source": "mla_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "mla_tpu/ops/flash_attention.py:39", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
    }


def request_inputs(cfg, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    img = rng.integers(0, 256, size=(3, size, size), dtype=np.uint8)
    pc = rng.uniform([-0.3, -0.45, 0.75], [0.7, 0.45, 1.6], size=(cfg.point.input_points, 3)).astype(np.float32)
    # a 22-id prompt (BOS, 20 words, the trailing 29871): prefix = 21 text ids
    ids = np.concatenate([[1], rng.integers(100, 20000, 20), [29871]]).astype(np.int32)[None, :]
    noise = rng.standard_normal((cfg.action_horizon, cfg.action_dim)).astype(np.float32)
    return img, pc, ids, noise


def live_head(torch, params, seed: int):
    """The reference zero-inits the final layer's fc2, which would make every
    chunk independent of the decoder; draw it instead."""
    fc2 = params["final_layer"]["mlp"]["fc2"]
    g = torch.Generator(device=fc2["w"].device).manual_seed(seed)
    fc2["w"] = torch.randn(fc2["w"].shape, generator=g, device=fc2["w"].device) * 0.02


# GPU (bf16 tensor-core products, flash prefill) vs CPU (plain versions,
# reference attention) on the same int8 weights: bf16 rounding differs in
# every product, and a W8A8 activation can round to the next int8 step, so
# the normalized chunks agree to a few bf16 ulps of their scale
AGREE_RTOL = 5e-2


def check_agreement(torch, report):
    from mla_tpu_torch import params as P
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.models.mla import MLAPolicy
    from mla_tpu_torch.ops.quantization import quantize_model

    cfg = get_model_config("mla-small")
    params, state = P.init(cfg, seed=5, device="cpu")
    live_head(torch, params, 6)
    params = quantize_model(params)
    img, pc, ids, noise = request_inputs(cfg, 7)
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        pol = MLAPolicy(params, state, cfg, device=dev)
        out[dev] = pol.predict_action_diff(img, pc, "", input_ids=ids, noise=noise, return_normalized=True)
        log(f"agree mla-small int8 DDIM-8 on {dev}: {time.perf_counter() - t0:.2f} s")
    scale = float(abs(out["cpu"]).max())
    err = float(abs(out["cuda"] - out["cpu"]).max())
    log(f"agree: max |gpu - cpu| {err:.4e}, max |cpu| {scale:.4e}, rel {err / scale:.4e} (tol {AGREE_RTOL})")
    report["agree"] = {"max_abs_err": err, "scale": scale, "rtol": AGREE_RTOL}
    if not (out["cuda"].shape == (cfg.action_horizon, cfg.action_dim) and err <= AGREE_RTOL * scale):
        raise AssertionError(f"GPU and CPU chunks disagree: max abs err {err} vs scale {scale}")


REQUESTS = 3  # requests per sampler in the serve phase


def serve(torch, report):
    import numpy as np

    from mla_tpu_torch import params as P
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.models.mla import MLAPolicy
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.ops.quantization import quantize_model

    cfg = get_model_config("mla-7b")
    t0 = time.perf_counter()
    params, state = P.init(cfg, seed=0, device="cuda")
    live_head(torch, params, 1)
    params = quantize_model(params)
    torch.cuda.empty_cache()
    stats = {"rlbench": {"action": {"q01": [-1.0] * 6 + [0.0], "q99": [1.0] * 7}}}
    policy = MLAPolicy(params, state, cfg, norm_stats=stats)
    del params
    torch.cuda.synchronize()
    log(f"serve: int8 mla-7b built on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    L = cfg.llama.num_layers
    expected = {"ddim": {"w8a8_matmul": L * 4 * (1 + 8)}, "dpm": {"w8a8_matmul": L * 4 * (1 + 4)}}
    for e in expected.values():
        e.update({"flash_attention": L, "furthest_point_sample": cfg.point.num_stages})
    # one warm-up request per sampler (first-call allocations), not counted
    img, pc, ids, noise = request_inputs(cfg, 100)
    for sampler in ("ddim", "dpm"):
        policy.predict_action_diff(img, pc, "", input_ids=ids, noise=noise, sampler=sampler)
    torch.cuda.synchronize()
    cuda.launches.clear()
    totals = {}
    lat = {"ddim": [], "dpm": []}
    for i in range(REQUESTS):
        for sampler in ("ddim", "dpm"):
            img, pc, ids, noise = request_inputs(cfg, i)
            before = dict(cuda.launches)
            torch.cuda.synchronize()
            t = time.perf_counter()
            chunk = policy.predict_action_diff(img, pc, "", input_ids=ids, noise=noise, sampler=sampler)
            ms = (time.perf_counter() - t) * 1e3
            counts = {k: cuda.launches[k] - before.get(k, 0) for k in expected[sampler]}
            if chunk.shape != (cfg.action_horizon, cfg.action_dim) or not np.isfinite(chunk).all():
                raise AssertionError(f"serve {sampler} request {i}: bad chunk shape {chunk.shape} or non-finite values")
            if counts != expected[sampler]:
                raise AssertionError(f"serve {sampler} request {i}: launches {counts}, expected {expected[sampler]}")
            lat[sampler].append(ms)
            log(f"serve {sampler} request {i}: {ms:.2f} ms per chunk, launches {counts}, "
                f"chunk |max| {float(np.abs(chunk).max()):.3f}")
    totals = dict(cuda.launches)
    report["serve"] = {"latency_ms": lat, "launches": totals, "expected_per_chunk": expected,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    return totals


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from mla_tpu_torch.ops import cuda
    except ImportError as e:
        print(f"chip_smoke: the mla_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_all = time.perf_counter()
    line = gpu_line()
    log(line)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    report = {"gpu": line, "shapes": []}
    t = time.perf_counter()
    for name, text in cuda.build().items():
        log(f"built {name}.cu\n" + "\n".join("  " + l for l in text.strip().splitlines() if "registers" in l or "spill" in l))
    log(f"build: {time.perf_counter() - t:.1f} s")
    kernels = [check_w8a8(torch, report), check_fps(torch, report), check_flash(torch, report)]
    check_agreement(torch, report)
    totals = serve(torch, report)
    for k in kernels:
        k["launches"] = totals[k["name"]]
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in order} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
