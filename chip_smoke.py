#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`mla_tpu_torch`) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:
  1. build        compile every CUDA kernel from mla_tpu_torch/csrc with
                  nvcc (sm_90a), one process per source, in parallel, and
                  beside them a control: a copy of flash_bwd.cu in a
                  temporary directory with the last, partial tile of each
                  backward loop dropped.
  2. kernels      hold each kernel against its plain PyTorch version and
                  time kernel, plain version, a PyTorch library call
                  (yardstick only) and the roofline bound: W8A8, FPS and
                  the flash forward at the shapes of the int8 mla-7b
                  serving path; the flash backward (dQ, dK/dV) at the
                  mla-2b training shape (BH 256, S 563, hd 128), with and
                  without a padded key tail, each gradient row within a
                  bf16 tolerance of its own norm, bit-identical over two
                  launches; the same check must reject the control.
  3. agree        serve one DDIM-8 request of an int8 `mla-small` (4
                  decoder layers, full-width front-ends) on the card and on
                  the CPU (plain versions) from the same weights and noise;
                  the normalized chunks must agree.
  4. serve        build the int8 `mla-7b` at full width from a seeded
                  random init on the card, serve DDIM-8 and DPM-4 requests
                  through MLAPolicy.predict_action_diff, check finite
                  [16, 7] chunks and the kernel launch counts of every
                  request.
  5. train-agree  one AdamW training step of the bf16 `mla-small` (B = 2)
                  on the card and on the CPU from the same weights, batch,
                  noise, t and FPS starts; loss and grad_norm must agree,
                  and the card's step through the control must not.
  6. train        build `mla-2b` (Llama-2-7B widths, 8 layers, full
                  front-ends) on the card from a seeded random init and run
                  TRAIN_STEPS AdamW steps at B = 8, S = 563, remat on,
                  through mla_tpu_torch.train_step; check finite loss and
                  grad_norm and the exact kernel launch counts of every
                  step.

The second-to-last line of output is a JSON object with each kernel's
numbers (launches counted on the serving path for the kernels of slice 1,
on the training path for the flash backward); the last is
{"ok": true, "device": {...}}. Detailed results go to
chiprun_out/chip_smoke.json. Without a CUDA device, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
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


# training shape of mla-2b at B = 8: 32 text + 513 fused + 18 diffusion
# tokens, 32 heads of 128
TRAIN_BH, TRAIN_S, TRAIN_HD = 8 * 32, 563, 128
# kernels vs plain version, bf16 gradients: P and dS are rounded to bf16 at
# the same places in both, but the kernels' tiles (32/64) differ from the
# plain version's (128), so fp32 sums run in another order and an entry can
# land a bf16 step (2^-8 relative) away. Each row of a gradient (one query
# of dQ, one key of dK and dV) is held to its own norm, so the small rows
# count as much as the few large ones: max over rows of
# ||kernel - plain|| / ||plain|| must stay within FLASH_BWD_ROW_RTOL
FLASH_BWD_ROW_RTOL = 1e-2
ROW_FLOOR = 1e-2

# the control: flash_bwd.cu with the last, partial tile of each loop dropped
# (at S = 563, keys 544..562 for dQ and queries 544..562 for dK/dV), the
# ragged-S fault the checks above must catch
FLASH_BWD_MUTATIONS = (
    ("const int nk = min((S + BKQ - 1) / BKQ,", "const int nk = min(S / BKQ,"),
    ("const int nq = (S + BQKV - 1) / BQKV;", "const int nq = S / BQKV;"),
)


def start_control_build(cuda, tmp: Path):
    """Write the control's source into `tmp` and start its nvcc."""
    src = (cuda.CSRC / "flash_bwd.cu").read_text()
    for old, new in FLASH_BWD_MUTATIONS:
        if old not in src:
            raise AssertionError(f"flash_bwd.cu no longer holds {old!r}: the control must follow the source")
        src = src.replace(old, new)
    cu, lib = tmp / "flash_bwd_control.cu", tmp / "libflash_bwd_control.so"
    cu.write_text(src)
    cmd = cuda.compile_cmd("flash_bwd", cu, lib)
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_control_build(cuda, lib: Path, proc):
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"the control build of flash_bwd.cu failed:\n{out}")
    return cuda.load("flash_bwd", lib)


@contextlib.contextmanager
def flash_bwd_from(cuda, lib):
    """Within the block, the flash-backward launches go to `lib`."""
    real = cuda.library
    cuda.library = lambda name: lib if name == "flash_bwd" else real(name)
    try:
        yield
    finally:
        cuda.library = real


def row_rel_err(torch, a, w):
    """(max over rows of ||a - w|| / max(||w||, ROW_FLOOR x the median row
    norm), that row's index, its norm). The floor holds rows whose true
    gradient is zero, such as query 0 of dQ (its one key has dS = P (dP -
    delta) = 0), where only rounding is left."""
    a, w = a.float().flatten(0, -2), w.float().flatten(0, -2)
    n = w.norm(dim=-1)
    rel = (a - w).norm(dim=-1) / n.clamp_min(ROW_FLOOR * float(n.median()))
    i = int(rel.argmax())
    return float(rel[i]), i, float(n[i])


def check_flash_bwd(torch, report, control):
    """dQ and dK/dV kernels at the training shape, with and without a
    padded key tail: every gradient row within FLASH_BWD_ROW_RTOL of the
    plain version's, bit-identical over two launches; the control
    library must exceed the tolerance in each gradient. Also times the
    forward kernel there."""
    import torch.nn.functional as F

    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(4)
    BH, S, hd = TRAIN_BH, TRAIN_S, TRAIN_HD
    q, k, v, do = (torch.randn((BH, S, hd), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(4))
    mask = torch.ones((BH, S), dtype=torch.int32, device="cuda")
    mask_pad = mask.clone()
    mask_pad[:, S - 40:] = 0
    errs = {"dq": 0.0, "dkv": 0.0}
    readings = {"row_rtol": FLASH_BWD_ROW_RTOL, "kernel": {}, "control": {}}
    for m, case in ((mask, "no padding"), (mask_pad, "padded tail")):
        o, lse = fa.flash_fwd(q, k, v, m)
        got = fa.flash_bwd(q, k, v, m, o, lse, do)
        again = fa.flash_bwd(q, k, v, m, o, lse, do)
        want = fa.flash_bwd_plain(q, k, v, m, o, lse, do)
        with flash_bwd_from(cuda, control):
            bad = fa.flash_bwd(q, k, v, m, o, lse, do)
        torch.cuda.synchronize()
        valid = m[0] > 0
        for a, b, c, w, name in zip(got, again, bad, want, ("dq", "dk", "dv")):
            if not torch.equal(a, b):
                raise AssertionError(f"flash bwd {name}: two launches differ in {int((a != b).sum())} entries")
            a, c, w = a[:, valid], c[:, valid], w[:, valid]
            (rel, row, norm), (rel_c, row_c, _) = row_rel_err(torch, a, w), row_rel_err(torch, c, w)
            e = float((a.float() - w.float()).abs().max())
            log(f"flash bwd {name} ({case}): bit-identical repeats, max row |kernel - plain| / |plain| {rel:.3e} "
                f"(tol {FLASH_BWD_ROW_RTOL}; row {row % int(valid.sum())} of head {row // int(valid.sum())}, "
                f"norm {norm:.3e}), max |kernel - plain| {e:.3e}; control {rel_c:.3e} "
                f"(row {row_c % int(valid.sum())})")
            if not rel <= FLASH_BWD_ROW_RTOL:
                raise AssertionError(f"flash bwd {name} ({case}): a row is {rel} of its norm from the plain version "
                                     f"(tol {FLASH_BWD_ROW_RTOL})")
            key = "dq" if name == "dq" else "dkv"
            errs[key] = max(errs[key], e)
            readings["kernel"][f"{name}, {case}"] = rel
            readings["control"][f"{name}, {case}"] = rel_c
    for name in ("dq", "dk", "dv"):
        worst = max(readings["control"][f"{name}, {case}"] for case in ("no padding", "padded tail"))
        if not worst > FLASH_BWD_ROW_RTOL:
            raise AssertionError(f"flash bwd {name}: the check passes the control ({worst} <= {FLASH_BWD_ROW_RTOL})")
    report["flash_bwd_rows"] = readings

    o, lse = fa.flash_fwd(q, k, v, mask)
    delta = (do.float() * o.float()).sum(-1)
    scale = 1.0 / hd**0.5
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ms = {
        "dq": cuda_ms(torch, lambda: cuda.call("flash_bwd", *ptrs, dq.data_ptr(), BH, S, hd, scale,
                                               symbol="flash_bwd_dq"), 20),
        "dkv": cuda_ms(torch, lambda: cuda.call("flash_bwd", *ptrs, dk.data_ptr(), dv.data_ptr(), BH, S, hd, scale,
                                                symbol="flash_bwd_dkv"), 20),
    }
    plain_ms = {
        "dq": cuda_ms(torch, lambda: fa.flash_bwd_dq_plain(q, k, v, mask, o, lse, do), 3, 1),
        "dkv": cuda_ms(torch, lambda: fa.flash_bwd_dkv_plain(q, k, v, mask, o, lse, do), 3, 1),
    }
    # yardstick only: the backward of torch's fused causal attention, which
    # computes dQ, dK and dV in one call
    q4, k4, v4 = (t[None].detach().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(out, (q4, k4, v4), do[None], retain_graph=True), 10)
    fwd_ms = cuda_ms(torch, lambda: fa.flash_fwd(q, k, v, mask), 20)
    fwd_lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), 20)
    tile = BH * S * hd * 2
    causal = 2.0 * BH * hd * S * (S + 1) / 2  # one causal [S, S] x [S, hd] product
    small = BH * S * 4 * 3  # lse, delta and the mask
    work = {"dq": (5 * tile + small, 3 * causal), "dkv": (6 * tile + small, 4 * causal)}
    out_rows = []
    for key, name, src_line in (("dq", "flash_attention_bwd_dq", 92), ("dkv", "flash_attention_bwd_dkv", 127)):
        b, by = bound_ms(*work[key], "bf16")
        log(f"flash bwd {key} BH={BH} S={S} hd={hd}: kernel {ms[key]:.4f} ms, plain {plain_ms[key]:.4f} ms, "
            f"sdpa backward (dq+dk+dv) {lib_ms:.4f} ms, bound {b:.4f} ms ({by})")
        report["shapes"].append({"kernel": name, "BH": BH, "S": S, "hd": hd, "ms": ms[key], "plain_ms": plain_ms[key],
                                 "library_ms": lib_ms, "bound_ms": b, "bound_by": by, "max_abs_err": errs[key]})
        out_rows.append({
            "name": name, "route": "cuda", "source": "mla_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"mla_tpu/ops/flash_attention.py:{src_line}", "max_abs_err": errs[key], "ms": ms[key],
            "plain_ms": plain_ms[key], "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
        })
    fb, fby = bound_ms(4 * tile + BH * S * 8, 2 * causal, "bf16")
    log(f"flash fwd at the training shape BH={BH} S={S} hd={hd}: kernel {fwd_ms:.4f} ms, sdpa {fwd_lib_ms:.4f} ms, "
        f"bound {fb:.4f} ms ({fby})")
    report["shapes"].append({"kernel": "flash_attention", "BH": BH, "S": S, "hd": hd, "ms": fwd_ms,
                             "library_ms": fwd_lib_ms, "bound_ms": fb, "bound_by": fby})
    return out_rows


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


# bf16 training step, card (flash kernels, bf16 tensor-core products) vs CPU
# (reference attention, CPU bf16 products) from the same weights and draws:
# every product rounds differently, but the differences average out over
# the loss and the gradient norm, which agree to about 1e-4 relative; the
# step through the control (flash_bwd.cu with its last tiles dropped) must
# miss the CPU's gradient norm by more than this
TRAIN_AGREE_RTOL = 2e-3
TRAIN_STEPS = 5


def _draws(cfg, rows: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return {
        "override_noise": rng.standard_normal((rows, cfg.action_horizon, cfg.action_dim)).astype(np.float32),
        "override_t": rng.integers(0, 100, rows),
        "fps_start": [rng.integers(0, cfg.point.input_points >> s, rows).astype(np.int32)
                      for s in range(cfg.point.num_stages)],
    }


def check_train_agreement(torch, report, control):
    from mla_tpu_torch import params as P
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.diffusion import gaussian as gd
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.training import optim, strategy
    from mla_tpu_torch.vla.dummy import synthetic_batch

    cfg = get_model_config("mla-small")
    params, state = P.init(cfg, seed=8, device="cpu")
    live_head(torch, params, 9)
    batch = synthetic_batch(cfg, B=2, L=32, seed=10)
    draws = [_draws(cfg, 2, 11)]
    sched = gd.create_schedule("", diffusion_steps=100)

    def one_step(dev):
        t0 = time.perf_counter()
        p = P.tree_map(lambda t: t.detach().to(dev, copy=True), params)
        opt, _, _ = optim.make_optimizer(p, learning_rate=1e-5, num_training_steps=10)
        tcfg = strategy.TrainConfig(repeated_diffusion_steps=1)
        step = strategy.make_train_step(cfg, tcfg, opt, sched)
        _, m = step(strategy.init_train_state(p, opt, P.tree_to(state, dev)), batch, draws=draws)
        out = {k: float(m[k]) for k in ("total_loss", "diff_loss", "img_pc_contrastive_loss", "grad_norm")}
        log(f"train-agree mla-small bf16 B=2 on {dev}: {time.perf_counter() - t0:.2f} s, {out}")
        return out

    out = {"cuda": one_step("cuda"), "cpu": one_step("cpu")}
    with flash_bwd_from(cuda, control):
        out["control"] = one_step("cuda")

    def rel(dev):
        return {k: abs(out[dev][k] - out["cpu"][k]) / abs(out["cpu"][k]) for k in ("total_loss", "grad_norm")}

    sound, ctrl = rel("cuda"), rel("control")
    log(f"train-agree: relative |gpu - cpu| loss {sound['total_loss']:.4e}, grad_norm {sound['grad_norm']:.4e} "
        f"(tol {TRAIN_AGREE_RTOL}); control: loss {ctrl['total_loss']:.4e}, grad_norm {ctrl['grad_norm']:.4e}")
    report["train_agree"] = {**out, "rel_err": sound, "control_rel_err": ctrl, "rtol": TRAIN_AGREE_RTOL}
    if not all(v <= TRAIN_AGREE_RTOL for v in sound.values()):
        raise AssertionError(f"GPU and CPU training steps disagree: {sound}")
    if not ctrl["grad_norm"] > TRAIN_AGREE_RTOL:
        raise AssertionError(f"train-agree passes the control: grad_norm off by {ctrl['grad_norm']}")


def train(torch, report):
    import numpy as np

    from mla_tpu_torch import train_step
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.training import metrics

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    run = train_step.build("mla-2b", 8, 32, "cuda", seed=0)
    cfg = run["cfg"]
    torch.cuda.synchronize()
    log(f"train: mla-2b built on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    L = cfg.llama.num_layers
    expected = {"flash_attention": 2 * L, "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
                "furthest_point_sample": cfg.point.num_stages, "w8a8_matmul": 0}
    cuda.launches.clear()
    times, steps = [], []
    for i in range(TRAIN_STEPS):
        before = dict(cuda.launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run["state"], m = run["step"](run["state"], run["batch"], run["generator"])
        loss, gnorm = float(m["total_loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        counts = {k: cuda.launches[k] - before.get(k, 0) for k in expected}
        log(f"train step {i}: loss {loss:.5f}, grad_norm {gnorm:.5f}, {times[-1]:.1f} ms, launches {counts}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"train step {i}: non-finite loss {loss} or grad_norm {gnorm}")
        if counts != expected:
            raise AssertionError(f"train step {i}: launches {counts}, expected {expected}")
        steps.append({"loss": loss, "grad_norm": gnorm, "ms": times[-1]})
    step_ms = float(np.median(times[1:]))
    tok_s = run["tokens_per_step"] / (step_ms / 1e3)
    peak = metrics.bf16_peak_flops(torch.cuda.get_device_name(0))
    mfu = tok_s * run["flops_per_token"] / peak if peak else None
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"train mla-2b B=8 S=563: step {step_ms:.1f} ms (median of steps 1..{TRAIN_STEPS - 1}), "
        f"{tok_s:.0f} tokens/s, MFU {mfu if mfu is None else round(mfu, 4)}, peak {peak_gib:.2f} GiB")
    report["train"] = {"steps": steps, "step_ms_median": step_ms, "tokens_per_s": tok_s, "mfu": mfu,
                       "peak_gib": peak_gib, "launches": dict(cuda.launches), "expected_per_step": expected}
    return dict(cuda.launches)


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
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    control_lib, control_proc = start_control_build(cuda, Path(tmp.name))
    try:
        built = cuda.build()
    except BaseException:
        control_proc.kill()
        control_proc.wait()
        raise
    for name, text in built.items():
        log(f"built {name}.cu\n" + "\n".join("  " + l for l in text.strip().splitlines() if "registers" in l or "spill" in l))
    control = finish_control_build(cuda, control_lib, control_proc)
    log(f"build: {time.perf_counter() - t:.1f} s (with the control copy of flash_bwd.cu)")
    kernels = [check_w8a8(torch, report), check_fps(torch, report), check_flash(torch, report)]
    train_kernels = check_flash_bwd(torch, report, control)
    check_agreement(torch, report)
    totals = serve(torch, report)
    torch.cuda.empty_cache()
    check_train_agreement(torch, report, control)
    train_totals = train(torch, report)
    for k in kernels:
        k["launches"] = totals[k["name"]]
    for k in train_kernels:
        k["launches"] = train_totals[k["name"]]
    kernels += train_kernels
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
