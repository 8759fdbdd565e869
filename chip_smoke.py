#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`mla_tpu_torch`) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

or, to time this tree's flash forward, dQ, dK/dV, W8A8, weight-only int8
and FPS kernels against another version of them (such as the parent
commit's, written out with `git show HEAD~1:mla_tpu_torch/csrc/flash_fwd.cu`,
the same for flash_bwd.cu, w8a8.cu, int8_mm.cu, fps.cu and hopper.cuh), add
`--parent DIR`.

Phases, each of which fails the run if it fails:
  1. build        compile every CUDA kernel from mla_tpu_torch/csrc with
                  nvcc (sm_90a), one process per source, in parallel, and
                  beside them five controls, each in a temporary directory:
                  a copy of flash_fwd.cu with its last, ragged key tile
                  dropped, a copy of flash_bwd.cu with the last, partial
                  tile of each backward loop dropped, a copy of int8_mm.cu
                  and one of w8a8.cu with the last K tile dropped, and a
                  copy of fps.cu that leaves the last point out of the
                  distance field (and, with --parent, the other version's
                  kernels).
  2. kernels      hold each kernel against its plain PyTorch version and
                  time kernel, plain version, a PyTorch library call
                  (yardstick only) and the roofline bound: W8A8 (int32
                  accumulators and outputs identical) at the shapes of the
                  int8 mla-7b serving host (prefill M = B x 534 and suffix
                  B x 18 for buckets B = 1, 2, 4) and at ragged and
                  boundary row counts on both sides of its narrow/wide
                  line, the check
                  rejecting the control at every shape, kernel and
                  torch._int_mm timed as CUDA graphs with the weights cycled
                  past L2; FPS at both point-tokenizer stages, B = 1, 2
                  (the trainer's AR loss mode; serving bucket 2), 4 and 8,
                  starts 0 and 7, indices identical, the control rejected
                  at each stage; the flash forward at the serving prefill
                  (BH 32, 64 and 128 at S 534: buckets 1, 2 and 4),
                  the mla-2b training shapes (BH 256, S 563, and S 819 of
                  the post-training step, a ragged last tile of 51 rows)
                  and the trainer's (BH 256, S 547, a 35-key tail; BH 64,
                  S 529 of its AR loss mode, a 17-key tail), with and
                  without a padded key tail, o and lse at every valid row,
                  the check rejecting the forward control without padding;
                  the flash backward (dQ, dK/dV) at the four training
                  shapes, with and without a padded key tail, each
                  gradient row within a bf16 tolerance of its own norm,
                  bit-identical over two launches; the same check must
                  reject the control; SDPA's backward, the yardstick, the
                  median of 5 graph replays.
                  The weight-only int8 product at M = 1, 4 and 535 rows by
                  the four mla-7b linears, at edge row counts on both sides
                  of its narrow/wide line, and in fp32 at the lm_head's
                  shape (M = 1 and 4, K 4096, N 32064), each output column
                  within one bf16 step of its own norm, bit-identical over
                  two launches; the check must reject the int8_mm control
                  at every shape; one layer timed on both paths at row
                  counts around the line (INT8_LINE_M). The kernels are timed as CUDA graphs (the
                  flash kernels of 20 launches; device time, no host launch
                  cost). With --parent, the other version's flash forward,
                  dQ, dK/dV, one layer's four W8A8 linears (M = 534 and 18;
                  an earlier W8A8 ABI gets [K, N] weights), one layer's four
                  weight-only int8 linears (M = 1, 4, 535) and FPS, and the
                  parent tree's lm_head (the widened head and an fp32
                  matmul), in turns with this tree's (parent, this, this,
                  parent).
  3. agree        serve one DDIM-8 request of an int8 `mla-small` (4
                  decoder layers, full-width front-ends) on the card and on
                  the CPU (plain versions) from the same weights and noise;
                  the normalized chunks must agree.
     ar-agree     the weight-only int8 `mla-small` on the card and on the
                  CPU: prefill and 7 cached decode steps fed the CPU's
                  greedy ids; the card's fp32 logits must agree with the
                  CPU's at every step, and the card's run through the
                  int8_mm control must not; predict_action_ar on the card
                  must give the CPU's ids wherever the CPU's top-1 margin
                  exceeds twice the logits' error.
  4. serve        build the int8 `mla-7b` at full width from a seeded
                  random init on the card, serve DDIM-8 and DPM-4 requests
                  through MLAPolicy.predict_action_diff, check finite
                  [16, 7] chunks and the kernel launch counts of every
                  request.
     ar-serve     a second policy over the same int8 weights with
                  int8_mode="weight_only": predict_action_ar x 3, greedy
                  and 4-beam generate_text of 16 tokens,
                  predict_action_diff_ar (DDIM-8) and predict_action_batch
                  (B = 2, a seeded DiT-B head), each with its exact kernel
                  launch counts (int8_matmul counts the int8 lm_head of
                  every forward that yields logits); then prefill and
                  decode-step times beside the decode step's weight-read
                  bound, and the lm_head through int8_mm (one launch) beside
                  the widened head it replaced.
     serve-host   mla_tpu_torch.serving.BatchingServer over serve's W8A8
                  policy, DPM-4, buckets (1, 2, 4), a 20 ms window: 1, 2
                  and 4 closed-loop clients of 30 requests each, a distinct
                  frame per request; every chunk finite [16, 7], every
                  device call's launches W8A8 4L(1 + 4), flash L and FPS 2
                  whatever its bucket; 3 requests padded into one bucket-4
                  call get their own normalized rows exactly; a bucket-4
                  call's rows within AGREE_RTOL of B = 1 calls fed those
                  rows' x_T (rotated rows must miss) on the int8 mla-7b cut
                  to 4 layers, and within FULL_DEPTH_RTOL at 32 random
                  layers, where a one-ulp batch-dependent rounding of the
                  front-end grows layer by layer (the relative RMS
                  difference of the hidden states is read after the first,
                  middle and last layer); one dispatch under
                  torch.cuda.set_sync_debug_mode("error") makes no host
                  sync. Chunks/s per client count, call ms per bucket, e2e
                  and queue-wait percentiles, the worker's
                  assemble+dispatch and finalize-block ms, the bucket
                  histogram.
     serve-http   a run dir of a seeded bf16 mla-7b (32 layers; config.json
                  with base_vlm, dataset statistics, a reference-format .pt
                  under checkpoints/) served by `python -m
                  mla_tpu_torch.serve` in a subprocess on a free port while
                  this process loads it with load_vla: 4 concurrent clients
                  posting raw 672 x 672 frames, a 640 x 480 frame through
                  the resize, /stats and /metrics parsed, the server warmed
                  at the prompt length its requests have (22 ids: the
                  prefill's S = 534, held by the flash checks), one
                  sequential answer within AGREE_RTOL of the in-process
                  predict_action_diff_batched (B = 1, seed 0, DPM-4, flash
                  L and FPS 2 launches), the next frame's answer outside it;
                  SIGINT must end the server with
                  exit 0 and no traceback. load_vla seconds and GiB, HTTP
                  round trip against the in-process call. Then serve-host's
                  bucket-4 row check on this bf16 policy (no W8A8), the
                  hidden states' growth layer by layer beside the W8A8
                  policy's (a reading, not a pass/fail check).
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
  7. post-train-agree  one AdamW step of the bf16 `mla-small` in the Franka
                  post-training stage (the image, point-cloud and tactile
                  generation heads, tactile input and loss, one wrist view;
                  the heads' dropout 0) on the card and on the CPU from the
                  same weights, batch and draws: the loss, grad_norm and
                  each head's loss must agree, and the card's step through
                  the flash_bwd control must miss grad_norm.
  8. post-train   the same stage on `mla-2b` through
                  mla_tpu_torch.train_step (POST_FRANKA): TRAIN_STEPS AdamW
                  steps at B = 8, S = 819, remat on; finite losses, every
                  head's loss and the tactile contrastive loss non-zero, the
                  frozen vision towers without gradients and unchanged, the
                  exact kernel launch counts of every step; step ms,
                  tokens/s, MFU and peak GiB beside the card's name and
                  power limit.
  9. phi-agree    the bf16 `mla-phi` (Phi-2 widths, head_dim 80) cut to 4
                  layers on the card and on the CPU from the same weights:
                  one DDIM-8 chunk (same noise) within AGREE_RTOL, the
                  prefill and 7 decode steps fed the CPU's greedy ids with
                  fp32 logits within AR_AGREE_RTOL; the card's run with
                  layer 0's attention-output bias shifted must miss both.
 10. phi-serve    the full `mla-phi` (32 layers) from a seeded init on the
                  card: predict_action_diff DDIM-8 and DPM-4,
                  predict_action_ar x 3, greedy and 4-beam generate_text of
                  16 tokens, predict_action_diff_ar and predict_action_batch
                  (B = 2, DiT-B), finite outputs and exact launches (FPS 2
                  per front-end pass; flash, W8A8 and int8_matmul 0: at
                  head_dim 80 the attention is plain, by JAX's rule); chunk
                  wall, prefill, suffix-evaluation and decode ms beside the
                  decode step's weight-read bound.
 11. phi-train-agree  one AdamW step of a small bf16 phi model (hidden
                  1280, 4 layers, head_dim 80, full-width front-ends; B = 2)
                  on the card and on the CPU; loss and grad_norm within
                  TRAIN_AGREE_RTOL, the shifted-bias control must miss both.
 12. phi-train    the full `mla-phi` through mla_tpu_torch.train_step:
                  TRAIN_STEPS AdamW steps at B = 8, S = 563, remat on,
                  finite loss and grad_norm, exact launches of every step
                  (FPS 2, nothing else); step ms, tokens/s, MFU and peak
                  GiB beside the card's name and power limit.
 13. trainer-agree  the trainer's two new step kinds on `mla-small` with
                  fp32 master weights (bf16 compute), card vs CPU from the
                  same weights, batch and draws: one step of the AR loss
                  mode and two Adafactor steps (the second's loss follows
                  the first's update); loss and grad_norm within
                  TRAIN_AGREE_RTOL, the flash_bwd control must miss
                  grad_norm in each.
 14. trainer      mla_tpu_torch.train.main at full width: `mla-2b`, fp32
                  master weights, AdamW, lm_head frozen, per-device batch 2
                  and global batch 4 (accumulation 2), 2 steps and a
                  checkpoint under build/chip_smoke_trainer (removed when
                  the phase ends); the step-2 checkpoint loaded into a fresh
                  state equals the run's live state bit for bit; a resume
                  (--is_resume true, async save) to step 3; exact launches
                  of every run (flash forward 2L, dQ L, dK/dV L, FPS 2 per
                  micro-batch); step ms, tokens/s, MFU, peak GiB,
                  checkpoint GiB, save and load seconds. Then 2 steps of the
                  AR loss mode through the CLI (lm_head trained) and 3
                  Adafactor steps of train_step's path (bf16 mla-2b, B = 8),
                  with step ms and peak GiB.
 15. trainer-viz  mla-small post-training through the CLI with the image and
                  point-cloud heads and --visualize_interval 1, one step:
                  the two PNG panels (prediction beside target) and the
                  point-cloud NPZ are written.
 16. data         the RLDS pipeline (mla_tpu_torch/vla/rlds/, no
                  TensorFlow) and the trainer on real frames: a franka
                  fixture written by the port's own writer under
                  build/chip_smoke_data (6 episodes x 40 steps in 2 shards,
                  third-person and wrist views as 640 x 480 PNG, the
                  fixture's choice of camera; 8192-point clouds, tactile
                  pads, gripper xyz) and a 672 x 672 episode whose frames
                  must come back exactly through the writer, the reader,
                  PNG, Lanczos and the CLIP transform, its normalized
                  action chunks and proprio equal to a numpy recomputation
                  from the written values; a record with a flipped byte must
                  fail its CRC; the pipeline alone at the trainer's 4 rows a
                  step (frames/s, host batch ms p50 and p95, time to the
                  first batch, the shuffle buffer's host RAM); then
                  train.main with scripts/sft_franka.sh's flags on mla-2b
                  (fp32 masters, per-device 2, global 4, buffer 256), 3
                  steps: S = DATA_S (979), exact launches, finite losses,
                  step ms, tokens/s, MFU, peak GiB and the loop's data wait
                  per step. The flash forward, dQ and dK/dV are held at its
                  BH 256 / S 979 in the kernels phase.

The second-to-last line of output is a JSON object with each kernel's
numbers, each row naming its path and, for the flash kernels, its shape
(launches counted on the serving host's client runs for W8A8, the
flash forward and FPS, timed at its bucket-4 shapes: one layer's W8A8 at
M = 2136 and 72, flash at BH 128 / S 534, FPS at B = 4; on the trainer's
first run for dQ and dK/dV, timed at its diffusion micro-batch, BH 256 at
S 547; on the AR serving path for the weight-only int8 product, timed at
its serving shapes; and on the data phase's trainer run for the flash
forward, dQ and dK/dV, timed at BH 256 / S 979; the other paths' counts
are in the log and in chip_smoke.json); an earlier line says whether
tensorflow, tensorflow_datasets, protobuf and Pillow are installed; the
last is
{"ok": true, "device": {...}}. Detailed results go to
chiprun_out/chip_smoke.json. Without a CUDA device, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import mmap
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

# H100 SXM data-sheet peaks (dense): HBM bytes/s, int8 ops/s, bf16 and fp32 flop/s
PEAK_BYTES = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12}

# serving shapes of the int8 mla-7b: prefix P = 21 text + 513 fused tokens,
# suffix 18 tokens; (K, N) of the fused qkv, o, fused gate-up and down linears
PREFIX_LEN, SUFFIX_LEN = 534, 18
LINEARS = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)]
L2_BYTES = 50e6  # H100 L2: weight copies are cycled past it, as a layer's products find them cold


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


# W8A8 beyond the serving shapes: ragged and boundary row counts (one row,
# an odd count under 32, just past the narrow tile's 32, both sides of the
# narrow/wide line, a ragged wide tile), at the o and down linears, whose
# N = 4096 splits K on both paths
W8A8_EDGE_M = (1, 17, 33, 63, 64, 65, PREFIX_LEN + 1)
W8A8_EDGE_LINEARS = ((4096, 4096), (11008, 4096))


def weight_copies(torch, gen, K, N):
    """int8 [K, N] weights, enough distinct copies that cycling through them
    reads each from memory, not L2, as a layer's products find them."""
    return [torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
            for _ in range(max(2, int(4 * L2_BYTES // (K * N)) + 1))]


# the serving host's rows: a bucket of B requests runs the prefill at M =
# B x 534 and each suffix evaluation at B x 18 (B = 1, 2, 4); the kernels
# line sums one layer's linears at the largest bucket's two shapes
SERVE_BUCKETS = (1, 2, 4)
W8A8_LAYER_M = tuple(b * m for b in SERVE_BUCKETS for m in (PREFIX_LEN, SUFFIX_LEN))
W8A8_ROW_M = (SERVE_BUCKETS[-1] * PREFIX_LEN, SERVE_BUCKETS[-1] * SUFFIX_LEN)


def check_w8a8(torch, report, control):
    """W8A8 against its plain version: the int32 accumulators and outputs
    identical at the serving host's shapes (M = B x 534 and B x 18 for B =
    1, 2, 4, by the four mla-7b linears) and at W8A8_EDGE_M; the control (its
    last K tile dropped) must miss at every shape. Times kernel (CUDA graph,
    weights K-major and cycled past L2), plain version, torch._int_mm with
    the quantization and rescale around it (the yardstick, timed the same
    way) and the bound; the row sums W8A8_ROW_M."""
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.ops import quantization as q

    gen = torch.Generator(device="cuda").manual_seed(1)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "err": 0.0, "b_bytes": 0.0, "b_ops": 0.0}
    readings = {"per_layer_ms": {}, "checked": [], "control_missed": []}

    def check(x, w_q, w_qt, ws, where):
        y, acc = q.w8a8_matmul(x, w_qt, ws, return_acc=True)
        yp, accp = q.w8a8_matmul_plain(x, w_q.t(), ws, return_acc=True)
        with kernel_from(cuda, "w8a8", control):
            _, acc_c = q.w8a8_matmul(x, w_qt, ws, return_acc=True)
        torch.cuda.synchronize()
        if not torch.equal(acc, accp):
            raise AssertionError(f"w8a8 {where}: int32 accumulators differ ({int((acc != accp).sum())} entries)")
        err = float((y.float() - yp.float()).abs().max())
        if err != 0.0:
            raise AssertionError(f"w8a8 {where}: outputs differ by {err} with equal accumulators")
        if torch.equal(acc_c, accp):
            raise AssertionError(f"w8a8 {where}: the check passes the control")
        readings["checked"].append(where)
        readings["control_missed"].append(int((acc_c != accp).sum()))
        return err

    for K, N in W8A8_EDGE_LINEARS:
        w_q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
        w_qt = w_q.t().contiguous()
        ws = torch.rand((N,), generator=gen, device="cuda") * 1e-3 + 1e-4
        for M in W8A8_EDGE_M:
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            check(x, w_q, w_qt, ws, f"M={M} K={K} N={N}")
        log(f"w8a8 K={K} N={N}: acc and output identical at M = {W8A8_EDGE_M}, the control missed")
        del w_q, w_qt

    for M in W8A8_LAYER_M:
        layer = {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
        for K, N in LINEARS:
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            copies = weight_copies(torch, gen, K, N)
            kmajor = [c.t().contiguous() for c in copies]
            ws = torch.rand((N,), generator=gen, device="cuda") * 1e-3 + 1e-4
            err = check(x, copies[0], kmajor[0], ws, f"M={M} K={K} N={N}")

            def library(w):
                xq, sx = q.quantize_rows(x)
                return (torch._int_mm(xq, w).float() * sx * ws).to(torch.bfloat16)

            cyc, cyc_lib = itertools.cycle(kmajor), itertools.cycle(copies)
            ms = graph_ms(torch, lambda: q.w8a8_matmul(x, next(cyc), ws))
            plain_ms = cuda_ms(torch, lambda: q.w8a8_matmul_plain(x, kmajor[0], ws), 3, 1)
            lib_ms = graph_ms(torch, lambda: library(next(cyc_lib)))
            nbytes, ops = M * K * 2 + K * N + N * 4 + M * N * 2, 2.0 * M * K * N
            b, by = bound_ms(nbytes, ops, "int8")
            plan = q.w8a8_plan(M, K, N, torch.cuda.get_device_properties(0).multi_processor_count)
            log(f"w8a8 M={M:4d} K={K:5d} N={N:5d}: acc identical, kernel {ms:.4f} ms "
                f"({'narrow' if plan.narrow else 'wide'}, {plan.tiles} tiles x {plan.splits} splits, "
                f"{len(copies)} weight copies), plain {plain_ms:.4f} ms, _int_mm {lib_ms:.4f} ms, "
                f"bound {b:.4f} ms ({by})")
            report["shapes"].append({"kernel": "w8a8_matmul", "M": M, "K": K, "N": N, "ms": ms, "plain_ms": plain_ms,
                                     "library_ms": lib_ms, "bound_ms": b, "bound_by": by, "max_abs_err": err,
                                     "splits": plan.splits, "narrow": plan.narrow})
            for k, v in (("ms", ms), ("bound_ms", b), ("library_ms", lib_ms)):
                layer[k] += v
            tot["err"] = max(tot["err"], err)
            if M in W8A8_ROW_M:
                for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b), ("library_ms", lib_ms)):
                    tot[k] += v
                tot["b_bytes"] += nbytes / PEAK_BYTES * 1e3
                tot["b_ops"] += ops / PEAK_OPS["int8"] * 1e3
            del copies, kmajor
        readings["per_layer_ms"][M] = layer
        log(f"w8a8 M={M}: one layer's 4 linears {layer['ms']:.4f} ms, _int_mm {layer['library_ms']:.4f} ms, "
            f"bound {layer['bound_ms']:.4f} ms")
    # the wrapper's host time per call (checks, plan, scratch, two launches),
    # at a shape whose device time is far shorter, so the host sets the pace
    x = torch.randn((1, 128), generator=gen, device="cuda").to(torch.bfloat16)
    w_qt = torch.randint(-127, 128, (64, 128), generator=gen, device="cuda", dtype=torch.int8)
    ws = torch.rand((64,), generator=gen, device="cuda")
    q.w8a8_matmul(x, w_qt, ws)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(200):
        q.w8a8_matmul(x, w_qt, ws)
    readings["host_us_per_call"] = (time.perf_counter() - t) / 200 * 1e6
    torch.cuda.synchronize()
    log(f"w8a8 host time per call (M=1 K=128 N=64, 200 calls): {readings['host_us_per_call']:.1f} us")
    report["w8a8"] = readings
    return {
        "name": "w8a8_matmul", "route": "cuda", "source": "mla_tpu_torch/csrc/w8a8.cu",
        "replaces": "mla_tpu/ops/quantization.py:347", "max_abs_err": tot["err"],
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if tot["b_bytes"] >= tot["b_ops"] else "operations",
        "library_ms": tot["library_ms"],
    }


# FPS: the point tokenizer's two stages, at the serving host's buckets (1,
# 2, 4; bucket 4 the row's shape), at the trainer's AR loss mode (2 rows)
# and at mla-2b training's (B = 8: the trainer's diffusion micro-batch, 2
# rows x 4 repeats), each from start indices 0 and 7
FPS_STAGES = ((1024, 512), (512, 256))
FPS_BATCHES = (1, 2, 4, 8)
FPS_ROW_B = 4


def check_fps(torch, report, control):
    """FPS at both stages, FPS_BATCHES, starts 0 and 7: indices identical to
    the plain version's; the control (the last point left out of the
    distance field, so it is never sampled) must differ at every stage. The
    last cloud of each batch holds its last point far outside the unit
    cube, so the sound kernel samples it second and the control cannot.
    Times kernel (CUDA graph), plain version and the bound; the row sums the
    stages at FPS_ROW_B, the serving host's largest bucket."""
    from mla_tpu_torch.ops import cuda, pointops

    gen = torch.Generator(device="cuda").manual_seed(2)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "b_bytes": 0.0, "b_ops": 0.0}
    readings = {"control_differs": {}, "ms": {}}
    for N, npoint in FPS_STAGES:
        differs = 0
        for B in FPS_BATCHES:
            xyz = torch.rand((B, N, 3), generator=gen, device="cuda")
            if B > 1:
                xyz[-1, -1] = 2.0
            for start in (0, 7):
                s = torch.full((B,), start, dtype=torch.int32, device="cuda")
                got = pointops.furthest_point_sample(xyz, npoint, s)
                want = pointops.furthest_point_sample_plain(xyz, npoint, s)
                with kernel_from(cuda, "fps", control):
                    bad = pointops.furthest_point_sample(xyz, npoint, s)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    first = (got != want).nonzero()[0]
                    raise AssertionError(f"fps B={B} N={N} npoint={npoint} start={start}: indices differ "
                                         f"(first at cloud {int(first[0])}, step {int(first[1])})")
                differs += int((bad != want).sum())
            out = torch.empty((B, npoint), dtype=torch.int32, device="cuda")
            zero = torch.zeros((B,), dtype=torch.int32, device="cuda")
            ms = graph_ms(torch, lambda: cuda.call("fps", xyz.data_ptr(), zero.data_ptr(), out.data_ptr(), B, N,
                                                   npoint), 10)
            nbytes, ops = B * (N * 12 + npoint * 4), 9.0 * B * N * npoint
            b, by = bound_ms(nbytes, ops, "fp32")
            readings["ms"][f"B={B} N={N} npoint={npoint}"] = ms
            plain_ms = None
            if B == FPS_ROW_B:
                plain_ms = cuda_ms(torch, lambda: pointops.furthest_point_sample_plain(xyz, npoint, zero), 2, 1)
                tot["ms"] += ms
                tot["plain_ms"] += plain_ms
                tot["bound_ms"] += b
                tot["b_bytes"] += nbytes / PEAK_BYTES * 1e3
                tot["b_ops"] += ops / PEAK_OPS["fp32"] * 1e3
            log(f"fps B={B} N={N} npoint={npoint}: indices identical at starts 0 and 7, kernel {ms:.4f} ms"
                + (f", plain {plain_ms:.4f} ms" if plain_ms is not None else "")
                + f", roofline bound {b:.6f} ms ({by}; the floor is the chain of {npoint} dependent steps)")
            report["shapes"].append({"kernel": "furthest_point_sample", "B": B, "N": N, "npoint": npoint, "ms": ms,
                                     "plain_ms": plain_ms, "library_ms": None, "bound_ms": b, "bound_by": by,
                                     "max_abs_err": 0.0})
        readings["control_differs"][f"N={N} npoint={npoint}"] = differs
        if differs == 0:
            raise AssertionError(f"fps N={N} npoint={npoint}: the check passes the control")
        log(f"fps N={N} npoint={npoint}: the control differs in {differs} indices")
    report["fps"] = readings
    return {
        "name": "furthest_point_sample", "route": "cuda", "source": "mla_tpu_torch/csrc/fps.cu",
        "replaces": "mla_tpu/ops/pointops_pallas.py:28", "max_abs_err": 0.0,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if tot["b_bytes"] >= tot["b_ops"] else "operations", "library_ms": None,
    }


# kernel vs plain version, both bf16 out: P is rounded to bf16 in both, but
# the tiles (64 vs 128) and so the online-softmax rescale order differ,
# which moves an output by about one bf16 ulp (2^-8 relative)
FLASH_ATOL = 2e-2
FLASH_LSE_ATOL = 1e-3
# the forward's shapes: the int8 mla-7b serving prefill and the serving
# host's buckets 2 and 4, the mla-2b training step (B = 8: 32 text + 513
# fused + 18 diffusion tokens, 32 heads), its post-training step (769 fused
# tokens), and the trainer's micro-batches (its DummyDataset has 16 text
# tokens): diffusion, 2 rows x 4 repeats at 16 + 513 + 18, and the AR loss
# mode, 2 rows at 16 + 513
TRAINER_S, TRAINER_AR_S = 547, 529
# the data phase's trainer on real frames: the collated prompt of 192 ids,
# the fused block of 256 point, 256 front, 256 wrist and 1 tactile tokens,
# the 18-token diffusion block; 2 rows x 4 repeats x 32 heads
DATA_S, DATA_BH = 192 + 769 + 18, 2 * 4 * 32
FLASH_SHAPES = ((32, PREFIX_LEN, "serving prefill"), (2 * 32, PREFIX_LEN, "serving host bucket 2"),
                (4 * 32, PREFIX_LEN, "serving host bucket 4"), (8 * 32, 563, "training"),
                (8 * 32, 819, "post-training"), (8 * 32, TRAINER_S, "trainer"),
                (2 * 32, TRAINER_AR_S, "trainer AR mode"), (DATA_BH, DATA_S, "data trainer"))
# the shapes the kernels line times: the serving host's, and the data phase's
FLASH_ROW_SHAPES = {"serving host bucket 4": "serve-host", "data trainer": "data"}


def graph_ms(torch, fn, reps: int = 20, windows: int = 3, stream=None) -> float:
    """Device time of one fn() call: `reps` calls captured in one CUDA graph
    and replayed back to back, so the host's launch cost between calls is
    not counted; the median of `windows` replays. `stream`, if given, is
    the capture stream (an autograd backward runs on its forward's)."""
    side = stream or torch.cuda.Stream()  # warm-up off the default stream, as capture wants
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del g
    return sorted(times)[len(times) // 2]


def fwd_call(cuda, q, k, v, mask, o, lse):
    """A bare launch of flash_fwd into preallocated o and lse."""
    BH, S, hd = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), o.data_ptr(), lse.data_ptr(), BH, S, hd,
            1.0 / hd**0.5)
    return lambda: cuda.call("flash_fwd", *args)


def check_flash(torch, report, control):
    """The flash forward at FLASH_SHAPES, with and without a padded 40-key
    tail: o within FLASH_ATOL and lse within
    FLASH_LSE_ATOL of the plain version at valid rows; the control (its
    last, ragged key tile dropped) must miss that check without padding.
    Times kernel (CUDA graph), plain version, SDPA and the bound. Returns
    the kernels-line rows of FLASH_ROW_SHAPES."""
    import torch.nn.functional as F

    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.ops import flash_attention as fa

    readings, rows, worst = {}, [], 0.0
    for BH, S, what in FLASH_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(3)
        hd = 128
        q, k, v = (torch.randn((BH, S, hd), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        mask = torch.ones((BH, S), dtype=torch.int32, device="cuda")
        mask_pad = mask.clone()
        mask_pad[:, S - 40:] = 0
        err = 0.0
        for m, case in ((mask, "no padding"), (mask_pad, "padded tail")):
            o, lse = fa.flash_fwd(q, k, v, m)
            op, lsep = fa.flash_fwd_plain(q, k, v, m)
            with kernel_from(cuda, "flash_fwd", control):
                oc, lsec = fa.flash_fwd(q, k, v, m)
            torch.cuda.synchronize()
            valid = m[0] > 0
            e = float((o.float() - op.float())[:, valid].abs().max())
            e_lse = float((lse - lsep)[:, valid].abs().max())
            ec = float((oc.float() - op.float())[:, valid].abs().max())
            ec_lse = float((lsec - lsep)[:, valid].abs().max())
            log(f"flash fwd BH={BH} S={S} ({what}, {case}): max |o - plain| {e:.3e} (tol {FLASH_ATOL}), "
                f"max |lse - plain| {e_lse:.3e} (tol {FLASH_LSE_ATOL}); control {ec:.3e}, lse {ec_lse:.3e}")
            if not (e <= FLASH_ATOL and e_lse <= FLASH_LSE_ATOL):
                raise AssertionError(f"flash fwd BH={BH} S={S} ({case}): max |o - plain| {e} (tol {FLASH_ATOL}), "
                                     f"max |lse - plain| {e_lse} (tol {FLASH_LSE_ATOL})")
            if case == "no padding" and ec <= FLASH_ATOL and ec_lse <= FLASH_LSE_ATOL:
                raise AssertionError(f"flash fwd BH={BH} S={S}: the check passes the control ({ec}, lse {ec_lse})")
            err = max(err, e)
            readings[f"BH={BH} S={S}, {case}"] = {"o": e, "lse": e_lse, "control_o": ec, "control_lse": ec_lse}
        q4, k4, v4 = (t[None] for t in (q, k, v))
        lib_err = float((fa.flash_fwd(q, k, v, mask)[0].float()
                         - F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)[0].float()).abs().max())
        o, lse = torch.empty_like(q), torch.empty((BH, S), dtype=torch.float32, device="cuda")
        ms = graph_ms(torch, fwd_call(cuda, q, k, v, mask, o, lse))
        plain_ms = cuda_ms(torch, lambda: fa.flash_fwd_plain(q, k, v, mask), 3, 1)
        lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
        nbytes = 4 * BH * S * hd * 2 + BH * S * 4 * 2
        ops = 4.0 * BH * hd * S * (S + 1) / 2
        b, by = bound_ms(nbytes, ops, "bf16")
        log(f"flash fwd BH={BH} S={S} hd={hd} ({what}): |o - sdpa| {lib_err:.3e}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, kernel / sdpa {ms / lib_ms:.3f}, bound {b:.4f} ms ({by})")
        report["shapes"].append({"kernel": "flash_attention", "BH": BH, "S": S, "hd": hd, "ms": ms,
                                 "plain_ms": plain_ms, "library_ms": lib_ms, "kernel_over_library": ms / lib_ms,
                                 "bound_ms": b, "bound_by": by, "max_abs_err": err, "max_abs_err_vs_sdpa": lib_err})
        if what in FLASH_ROW_SHAPES:
            rows.append({"name": "flash_attention", "route": "cuda", "source": "mla_tpu_torch/csrc/flash_fwd.cu",
                         "replaces": "mla_tpu/ops/flash_attention.py:39", "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b, "bound_by": by, "library_ms": lib_ms, "path": FLASH_ROW_SHAPES[what],
                         "shape": f"BH {BH}, S {S}"})
        worst = max(worst, err)
    for row in rows:
        row["max_abs_err"] = worst
    report["flash_fwd"] = readings
    return rows


# training shape of mla-2b at B = 8: 32 text + 513 fused + 18 diffusion
# tokens, 32 heads of 128; the post-training step's fused block is 769
# tokens (256 point, 256 front, 256 wrist, 1 tactile), so S = 819 = 6 x 128
# + 51, a ragged last tile
TRAIN_BH, TRAIN_S, TRAIN_HD = 8 * 32, 563, 128
POST_S = 819
# kernels vs plain version, bf16 gradients: P and dS are rounded to bf16 at
# the same places in both, but the kernels' tiles (32/64) differ from the
# plain version's (128), so fp32 sums run in another order and an entry can
# land a bf16 step (2^-8 relative) away. Each row of a gradient (one query
# of dQ, one key of dK and dV) is held to its own norm, so the small rows
# count as much as the few large ones: max over rows of
# ||kernel - plain|| / ||plain|| must stay within FLASH_BWD_ROW_RTOL
FLASH_BWD_ROW_RTOL = 1e-2
ROW_FLOOR = 1e-2

# the controls: copies of a kernel's source with a fault the checks must
# catch, each built in a temporary directory beside the kernels.
# flash_fwd.cu with its last, ragged key tile dropped (at S = 529 to 563,
# keys 512.. of its 64-key tiles, at S = 819 keys 768..): the rows past them
# lose keys, which only the unpadded case shows
FLASH_FWD_MUTATIONS = (("const int nk_all = (S + BN - 1) / BN;", "const int nk_all = S / BN;"),)
# flash_bwd.cu with the last, partial tile of each loop dropped (at S = 529
# to 563, keys 512.. for dQ and queries 512.. for dK/dV; at S = 819, 768..),
# the ragged-S fault
FLASH_BWD_MUTATIONS = (
    ("const int nk_all = (S + DQ_BN - 1) / DQ_BN;", "const int nk_all = S / DQ_BN;"),
    ("const int nq = (S + KV_QS - 1) / KV_QS;", "const int nq = S / KV_QS;"),
)
# int8_mm.cu with its last K tile dropped (every split range of both paths,
# bf16 and fp32, ends one tile short), the fault the column check must
# catch
INT8_MM_MUTATIONS = (("const int kt = (K + BK - 1) / BK;", "const int kt = (K + BK - 1) / BK - 1;"),)
# w8a8.cu with its last K tile dropped (every split range of both paths
# ends one tile short), the fault the exact check must catch
W8A8_MUTATIONS = (("const int kt = (K + BK - 1) / BK;", "const int kt = (K + BK - 1) / BK - 1;"),)
# fps.cu with the last point left out of the distance field (it is then
# never sampled), the fault the exact check must catch
FPS_MUTATIONS = (("const bool real = p < N;", "const bool real = p < N - 1;"),)
CONTROLS = {"flash_fwd": FLASH_FWD_MUTATIONS, "flash_bwd": FLASH_BWD_MUTATIONS, "int8_mm": INT8_MM_MUTATIONS,
            "w8a8": W8A8_MUTATIONS, "fps": FPS_MUTATIONS}


def control_source(cuda, name: str) -> str:
    """The control copy of `name`.cu; raises unless each mutation matches
    exactly once, so a control cannot silently stop following its source."""
    src = (cuda.CSRC / f"{name}.cu").read_text()
    for old, new in CONTROLS[name]:
        if src.count(old) != 1:
            raise AssertionError(f"{name}.cu holds {old!r} {src.count(old)} times, not once: "
                                 "the control must follow the source")
        src = src.replace(old, new)
    return src


def start_build(cuda, tmp: Path, name: str, src: str, tag: str, headers: Path = None):
    """Write `src`, a version of `name`.cu, into a directory of `tmp` beside
    a copy of the kernels' headers (those of `headers`, where it has them)
    and start its nvcc."""
    out = tmp / tag
    out.mkdir(exist_ok=True)
    for d in (cuda.CSRC, headers):
        for header in (d.glob("*.cuh") if d else ()):
            shutil.copy(header, out / header.name)
    cu, lib = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(src)
    cmd = cuda.compile_cmd(name, cu, lib)
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(cuda, name: str, lib: Path, proc):
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"the build of {lib.name} failed:\n{out}")
    return cuda.load(name, lib)


@contextlib.contextmanager
def kernel_from(cuda, name: str, lib):
    """Within the block, the launches of library `name` go to `lib`."""
    real = cuda.library
    cuda.library = lambda n: lib if n == name else real(n)
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


def bwd_calls(cuda, ptrs, dq, dk, dv, BH, S, hd):
    """Bare launches of the two backward kernels into preallocated outputs."""
    scale = 1.0 / hd**0.5
    return {
        "dq": lambda: cuda.call("flash_bwd", *ptrs, dq.data_ptr(), BH, S, hd, scale, symbol="flash_bwd_dq"),
        "dkv": lambda: cuda.call("flash_bwd", *ptrs, dk.data_ptr(), dv.data_ptr(), BH, S, hd, scale,
                                 symbol="flash_bwd_dkv"),
    }


def check_flash_bwd(torch, report, control):
    """The flash backward at the training shapes of every training path
    (flash_bwd_at); returns the kernel-table rows of the trainer's
    diffusion micro-batch, BH 256 at S = 547, and of the data phase's, BH
    256 at DATA_S."""
    flash_bwd_at(torch, report, control, TRAIN_BH, TRAIN_S, "training")
    flash_bwd_at(torch, report, control, TRAIN_BH, POST_S, "post-training")
    rows = flash_bwd_at(torch, report, control, TRAIN_BH, TRAINER_S, "trainer")
    flash_bwd_at(torch, report, control, 2 * 32, TRAINER_AR_S, "trainer AR mode")
    data_rows = flash_bwd_at(torch, report, control, DATA_BH, DATA_S, "data trainer")
    for row in data_rows:
        row["path"] = "data"
    return rows + data_rows


def flash_bwd_at(torch, report, control, BH, S, what):
    """dQ and dK/dV kernels at BH heads of sequence S, with and without a
    padded key tail: every gradient row within FLASH_BWD_ROW_RTOL of the
    plain version's, bit-identical over two launches; the control
    library must exceed the tolerance in each gradient. Times the kernels
    (CUDA graph), the plain versions, SDPA's backward and the bound."""
    import torch.nn.functional as F

    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(4)
    hd = TRAIN_HD
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
        with kernel_from(cuda, "flash_bwd", control):
            bad = fa.flash_bwd(q, k, v, m, o, lse, do)
        torch.cuda.synchronize()
        valid = m[0] > 0
        for a, b, c, w, name in zip(got, again, bad, want, ("dq", "dk", "dv")):
            if not torch.equal(a, b):
                raise AssertionError(f"flash bwd {name}: two launches differ in {int((a != b).sum())} entries")
            a, c, w = a[:, valid], c[:, valid], w[:, valid]
            (rel, row, norm), (rel_c, row_c, _) = row_rel_err(torch, a, w), row_rel_err(torch, c, w)
            e = float((a.float() - w.float()).abs().max())
            log(f"flash bwd {name} BH={BH} S={S} ({case}): bit-identical repeats, max row |kernel - plain| / |plain| {rel:.3e} "
                f"(tol {FLASH_BWD_ROW_RTOL}; row {row % int(valid.sum())} of head {row // int(valid.sum())}, "
                f"norm {norm:.3e}), max |kernel - plain| {e:.3e}; control {rel_c:.3e} "
                f"(row {row_c % int(valid.sum())})")
            if not rel <= FLASH_BWD_ROW_RTOL:
                raise AssertionError(f"flash bwd {name} BH={BH} S={S} ({case}): a row is {rel} of its norm from the plain version "
                                     f"(tol {FLASH_BWD_ROW_RTOL})")
            key = "dq" if name == "dq" else "dkv"
            errs[key] = max(errs[key], e)
            readings["kernel"][f"{name}, {case}"] = rel
            readings["control"][f"{name}, {case}"] = rel_c
    for name in ("dq", "dk", "dv"):
        worst = max(readings["control"][f"{name}, {case}"] for case in ("no padding", "padded tail"))
        if not worst > FLASH_BWD_ROW_RTOL:
            raise AssertionError(f"flash bwd {name} BH={BH} S={S}: the check passes the control ({worst} <= "
                                 f"{FLASH_BWD_ROW_RTOL})")
    report.setdefault("flash_bwd_rows", {})[f"BH={BH} S={S}"] = readings

    o, lse = fa.flash_fwd(q, k, v, mask)
    delta = (do.float() * o.float()).sum(-1)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    calls = bwd_calls(cuda, ptrs, dq, dk, dv, BH, S, hd)
    ms = {key: graph_ms(torch, fn) for key, fn in calls.items()}
    plain_ms = {
        "dq": cuda_ms(torch, lambda: fa.flash_bwd_dq_plain(q, k, v, mask, o, lse, do), 3, 1),
        "dkv": cuda_ms(torch, lambda: fa.flash_bwd_dkv_plain(q, k, v, mask, o, lse, do), 3, 1),
    }
    # yardstick only: the backward of torch's fused causal attention, which
    # computes dQ, dK and dV in one call. Eager windows of it read 0.32 to
    # 1.5 ms, paced by the host; so it is captured in a CUDA graph like the
    # kernels, and the median of 5 timed replays is taken
    q4, k4, v4 = (t[None].detach().requires_grad_(True) for t in (q, k, v))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    lib_ms = graph_ms(torch, lambda: torch.autograd.grad(out, (q4, k4, v4), do[None], retain_graph=True), 10, 5,
                      stream)
    windows = [cuda_ms(torch, lambda: torch.autograd.grad(out, (q4, k4, v4), do[None], retain_graph=True), 10)
               for _ in range(5)]
    log(f"sdpa backward: {lib_ms:.4f} ms (CUDA graph, median of 5 replays); eager windows (ms), host-paced: "
        f"{[round(w, 4) for w in windows]}")
    tile = BH * S * hd * 2
    causal = 2.0 * BH * hd * S * (S + 1) / 2  # one causal [S, S] x [S, hd] product
    small = BH * S * 4 * 3  # lse, delta and the mask
    work = {"dq": (5 * tile + small, 3 * causal), "dkv": (6 * tile + small, 4 * causal)}
    out_rows = []
    for key, name, src_line in (("dq", "flash_attention_bwd_dq", 92), ("dkv", "flash_attention_bwd_dkv", 127)):
        b, by = bound_ms(*work[key], "bf16")
        log(f"flash bwd {key} BH={BH} S={S} hd={hd} ({what}): kernel {ms[key]:.4f} ms, plain {plain_ms[key]:.4f} ms, "
            f"sdpa backward (dq+dk+dv) {lib_ms:.4f} ms, kernel / sdpa backward {ms[key] / lib_ms:.3f}, "
            f"bound {b:.4f} ms ({by})")
        report["shapes"].append({"kernel": name, "BH": BH, "S": S, "hd": hd, "ms": ms[key], "plain_ms": plain_ms[key],
                                 "library_ms": lib_ms, "library_windows_ms": windows,
                                 "kernel_over_library": ms[key] / lib_ms, "bound_ms": b, "bound_by": by,
                                 "max_abs_err": errs[key]})
        out_rows.append({
            "name": name, "route": "cuda", "source": "mla_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"mla_tpu/ops/flash_attention.py:{src_line}", "max_abs_err": errs[key], "ms": ms[key],
            "plain_ms": plain_ms[key], "bound_ms": b, "bound_by": by, "library_ms": lib_ms, "path": "trainer",
            "shape": f"BH {BH}, S {S}",
        })
    return out_rows


PARENT_KERNELS = ("flash_fwd", "flash_bwd", "w8a8", "int8_mm", "fps")


def w8a8_abi(src: str) -> str:
    """'k_major' for a w8a8.cu whose entry point takes the weight K-major
    with split-K scratch (this tree's), 'kn' for the earlier one ([K, N]
    weights, 11 arguments and the stream)."""
    decl = src[src.index('extern "C" int w8a8_matmul('):]
    return "k_major" if decl[:decl.index(")")].count(",") > 11 else "kn"


def int8_mm_abi(src: str) -> str:
    """'split' for an int8_mm.cu whose entry point takes a path and split-K
    scratch (this tree's), 'plain' for the earlier one (8 arguments and the
    stream)."""
    decl = src[src.index('extern "C" int int8_mm('):]
    return "split" if decl[:decl.index(")")].count(",") > 8 else "plain"


def load_parent_int8_mm(lib: Path, abi: str):
    """The other version's int8_mm library, with its own C signature."""
    import ctypes

    from mla_tpu_torch.ops import cuda

    if abi == "split":
        return cuda.load("int8_mm", lib)
    handle = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    handle.int8_mm.argtypes = [P, I, P, P, P, I, I, I, P]
    handle.int8_mm.restype = ctypes.c_int
    return handle


def load_parent_w8a8(lib: Path, abi: str):
    """The other version's W8A8 library, with its own C signature."""
    import ctypes

    from mla_tpu_torch.ops import cuda

    if abi == "k_major":
        return cuda.load("w8a8", lib)
    handle = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    handle.w8a8_matmul.argtypes = [P, I, P, P, P, P, P, P, I, I, I, P]
    handle.w8a8_matmul.restype = ctypes.c_int
    return handle


def compare_parent(torch, report, parent, w8a8_layout, int8_layout):
    """The flash forward (both shapes), dQ and dK/dV (training shape), one
    layer's four W8A8 linears (M = 534 and 18) and four weight-only int8
    linears (M = 1, 4 and 535; weights cycled past L2), the int8 lm_head
    (fp32, M = 1 and 4; the parent tree widened the head and ran an fp32
    matmul) and FPS (both stages, B = 1 and 8) of this tree against
    `parent`'s on the same card and inputs, in turns: parent, this tree,
    this tree, parent (CUDA graph device times). A W8A8 or int8_mm of an
    earlier ABI gets its own arguments."""
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.ops import flash_attention as fa
    from mla_tpu_torch.ops import quantization as q

    out = {}

    def turns(name, key, fn, fn_parent=None):
        def theirs():
            with kernel_from(cuda, name, parent[name]):
                return graph_ms(torch, fn_parent or fn)

        t = [theirs(), graph_ms(torch, fn), graph_ms(torch, fn), theirs()]
        out[key] = {"parent_ms": [t[0], t[3]], "ms": [t[1], t[2]]}
        log(f"parent vs this tree, {key}: parent {t[0]:.4f}, this {t[1]:.4f}, this {t[2]:.4f}, parent {t[3]:.4f} ms")

    gen = torch.Generator(device="cuda").manual_seed(17)
    for BH, S, what in FLASH_SHAPES:
        q_, k, v, do = (torch.randn((BH, S, 128), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(4))
        mask = torch.ones((BH, S), dtype=torch.int32, device="cuda")
        o, lse = torch.empty_like(q_), torch.empty((BH, S), dtype=torch.float32, device="cuda")
        turns("flash_fwd", f"flash fwd BH={BH} S={S} ({what})", fwd_call(cuda, q_, k, v, mask, o, lse))
    o, lse = fa.flash_fwd(q_, k, v, mask)
    delta = (do.float() * o.float()).sum(-1)
    ptrs = (q_.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr())
    calls = bwd_calls(cuda, ptrs, torch.empty_like(q_), torch.empty_like(k), torch.empty_like(v), BH, S, 128)
    turns("flash_bwd", f"flash dQ BH={BH} S={S} ({what})", calls["dq"])
    turns("flash_bwd", f"flash dK/dV BH={BH} S={S} ({what})", calls["dkv"])
    del q_, k, v, do, o, lse, delta

    for M in (PREFIX_LEN, SUFFIX_LEN):
        linears = []
        for K, N in LINEARS:
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            ws = torch.rand((N,), generator=gen, device="cuda") * 1e-3 + 1e-4
            copies = weight_copies(torch, gen, K, N)
            kmajor = [c.t().contiguous() for c in copies]
            linears.append((x, ws, itertools.cycle(kmajor),
                            itertools.cycle(kmajor if w8a8_layout == "k_major" else copies)))
            del copies

        def layer():
            for x, ws, cyc, _ in linears:
                q.w8a8_matmul(x, next(cyc), ws)

        def layer_parent():
            for x, ws, _, cyc in linears:
                if w8a8_layout == "k_major":
                    q.w8a8_matmul(x, next(cyc), ws)
                    continue
                K, N = x.shape[1], ws.shape[0]
                y = torch.empty((M, N), dtype=x.dtype, device="cuda")
                xq = torch.empty((M, K), dtype=torch.int8, device="cuda")
                sx = torch.empty((M,), dtype=torch.float32, device="cuda")
                cuda.call("w8a8", x.data_ptr(), 1, next(cyc).data_ptr(), ws.data_ptr(), y.data_ptr(), xq.data_ptr(),
                          sx.data_ptr(), None, M, K, N)

        turns("w8a8", f"w8a8 one layer's 4 linears, M={M}", layer, layer_parent)
        del linears

    for M in INT8_M:
        linears = []
        for K, N in LINEARS:
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            ws = torch.rand((N,), generator=gen, device="cuda") * 1e-3 + 1e-4
            linears.append((x, ws, itertools.cycle(weight_copies(torch, gen, K, N))))

        def int8_layer():
            for x, ws, cyc in linears:
                q.int8_matmul(x, next(cyc), ws)

        def int8_layer_parent():
            for x, ws, cyc in linears:
                if int8_layout == "split":
                    q.int8_matmul(x, next(cyc), ws)
                    continue
                K, N = x.shape[1], ws.shape[0]
                y = torch.empty((M, N), dtype=x.dtype, device="cuda")
                cuda.call("int8_mm", x.data_ptr(), 1, next(cyc).data_ptr(), ws.data_ptr(), y.data_ptr(), M, K, N)

        turns("int8_mm", f"int8_mm one layer's 4 linears, M={M}", int8_layer, int8_layer_parent)
        del linears
    K, N = LM_HEAD
    head = itertools.cycle(weight_copies(torch, gen, K, N))
    ws = torch.rand((N,), generator=gen, device="cuda") * 1e-3 + 1e-4
    for M in LM_HEAD_M:
        x = torch.randn((M, K), generator=gen, device="cuda")
        turns("int8_mm", f"int8 lm_head fp32, M={M} (parent: widened head + fp32 matmul)",
              lambda: q.int8_matmul(x, next(head), ws), lambda: (x @ next(head).float()) * ws)
    del head

    for N, npoint in FPS_STAGES:
        for B in FPS_BATCHES:
            xyz = torch.rand((B, N, 3), generator=gen, device="cuda")
            start = torch.zeros((B,), dtype=torch.int32, device="cuda")
            idx = torch.empty((B, npoint), dtype=torch.int32, device="cuda")
            turns("fps", f"fps B={B} N={N} npoint={npoint}",
                  lambda: cuda.call("fps", xyz.data_ptr(), start.data_ptr(), idx.data_ptr(), B, N, npoint))
    report["parent"] = out


# the weight-only int8 product at a decode step (1 row), a 4-beam step and
# the AR prefill (22 prompt ids + 513 fused tokens)
INT8_M = (1, 4, PREFIX_LEN + 1)
# beyond those: ragged and boundary row counts on both sides of the
# narrow/wide line (quantization.INT8_NARROW_MAX_M), past a wide tile and at
# predict_action_batch's prefill (B = 2), at the o and down linears, whose
# N = 4096 splits K
INT8_EDGE_LINEARS = ((4096, 4096), (11008, 4096))
# the narrow/wide line: one layer's four bf16 linears timed on each path at
# row counts around it
INT8_LINE_M = (2, 4, 5, 8, 16)
# the int8 lm_head in fp32 (mla-7b: hidden 4096, vocab 32064; 32064 is not a
# multiple of a tile's columns), greedy and 4 beams
LM_HEAD, LM_HEAD_M = (4096, 32064), (1, 4)
# kernel vs plain version, bf16 out: the products are exact in both and the
# sums fp32, only their order differs, so an output lands at most one bf16
# step away: 2^-7 = 7.8e-3 of its value when it sits just above a power of
# two, which a one-row column (M = 1) reads in full. Each column is held to
# its own norm, norms floored at ROW_FLOOR of the median (a one-row column
# can cancel to ~0, where only the fp32 sum order is left, ~1e-3 of the
# floor); the tolerance is one bf16 step plus that term. fp32 out (the
# lm_head) stays far inside it: its sums differ in order only
INT8_COL_RTOL = 1e-2


def col_rel_err(a, w):
    """max over columns of ||a - w|| / max(||w||, ROW_FLOOR x the median)."""
    a, w = a.float(), w.float()
    n = w.norm(dim=0)
    return float(((a - w).norm(dim=0) / n.clamp_min(ROW_FLOOR * float(n.median()))).max())


def check_int8_mm(torch, report, control):
    """int8_mm against its plain version: bf16 at the mla-7b AR shapes and at
    edge row counts on both paths, fp32 at the lm_head's shape; every column
    within INT8_COL_RTOL, bit-identical over two launches; the control
    library (its last K tile dropped) must exceed the tolerance at every
    shape. Times kernel, plain version, _weight_int8pack_mm (the yardstick;
    its scales are bf16) and the bound as CUDA graphs, weights cycled past
    L2; the lm_head beside the parent's way of computing it (the head
    widened to fp32, then an fp32 matmul)."""
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.ops import quantization as q

    gen = torch.Generator(device="cuda").manual_seed(12)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "err": 0.0, "b_bytes": 0.0, "b_ops": 0.0}
    readings = {"col_rtol": INT8_COL_RTOL, "narrow_max_m": q.INT8_NARROW_MAX_M, "kernel": {}, "control": {},
                "per_layer_ms": {}, "lm_head": {}}

    def check(x, w_q, ws):
        M, K = x.shape
        N = w_q.shape[1]
        key = f"M={M} K={K} N={N} {str(x.dtype).replace('torch.', '')}"
        y, again, want = q.int8_matmul(x, w_q, ws), q.int8_matmul(x, w_q, ws), q.int8_matmul_plain(x, w_q, ws)
        with kernel_from(cuda, "int8_mm", control):
            bad = q.int8_matmul(x, w_q, ws)
        torch.cuda.synchronize()
        if not torch.equal(y, again):
            raise AssertionError(f"int8_mm {key}: two launches differ in {int((y != again).sum())} entries")
        rel, rel_c = col_rel_err(y, want), col_rel_err(bad, want)
        readings["kernel"][key], readings["control"][key] = rel, rel_c
        if not rel <= INT8_COL_RTOL:
            raise AssertionError(f"int8_mm {key}: a column is {rel} of its norm from the plain version "
                                 f"(tol {INT8_COL_RTOL})")
        if not rel_c > INT8_COL_RTOL:
            raise AssertionError(f"int8_mm {key}: the check passes the control ({rel_c} <= {INT8_COL_RTOL})")
        return key, rel, rel_c, float((y.float() - want.float()).abs().max())

    line = q.INT8_NARROW_MAX_M
    edge_m = (2, 3, line, line + 1, 17, 65, 193, 2 * (PREFIX_LEN + 1))
    for K, N in INT8_EDGE_LINEARS:
        w_q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
        ws = torch.rand((N,), generator=gen, device="cuda") * 1e-3 + 1e-4
        worst = max(check(torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16), w_q, ws)[1]
                    for M in edge_m)
        log(f"int8_mm K={K} N={N}: identical repeats, columns within {worst:.3e} (tol {INT8_COL_RTOL}) at "
            f"M = {edge_m} (narrow up to {line} rows), the control missed at each")
        del w_q

    readings["line"] = {}
    for M in INT8_LINE_M:
        linears = []
        for K, N in LINEARS:
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            ws = torch.rand((N,), generator=gen, device="cuda") * 1e-3 + 1e-4
            y = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
            linears.append((x, ws, y, itertools.cycle(weight_copies(torch, gen, K, N)), K, N))
        ms = {}
        for path, narrow in (("narrow", True), ("wide", False)):
            plans = [q.int8_mm_plan(M, K, N, sms, False, narrow) for *_, K, N in linears]
            ms[path] = graph_ms(torch, lambda: [q.int8_mm_launch(x, next(c), ws, y, plan)
                                                for (x, ws, y, c, _, _), plan in zip(linears, plans)])
        readings["line"][M] = ms
        log(f"int8_mm line, M={M}: one layer's 4 linears {ms['narrow']:.4f} ms on the weight stream, "
            f"{ms['wide']:.4f} ms on wgmma (the plan takes {'narrow' if M <= line else 'wide'})")
        del linears

    K, N = LM_HEAD
    copies = weight_copies(torch, gen, K, N)
    ws = torch.rand((N,), generator=gen, device="cuda") * 1e-3 + 1e-4
    for M in LM_HEAD_M:
        x = torch.randn((M, K), generator=gen, device="cuda")
        key, rel, rel_c, err = check(x, copies[0], ws)
        cyc, cyc_w = itertools.cycle(copies), itertools.cycle(copies)
        ms = graph_ms(torch, lambda: q.int8_matmul(x, next(cyc), ws))
        widen_ms = graph_ms(torch, lambda: (x @ next(cyc_w).float()) * ws)
        b, by = bound_ms(M * K * 4 + K * N + N * 4 + M * N * 4, 2.0 * M * K * N, "fp32")
        plan = q.int8_mm_plan(M, K, N, sms, True)
        log(f"int8_mm lm_head {key}: identical repeats, max column error {rel:.3e} (tol {INT8_COL_RTOL}), "
            f"control {rel_c:.3e}; kernel {ms:.4f} ms ({plan.tiles} tiles x {plan.splits} splits), widened head "
            f"+ fp32 matmul {widen_ms:.4f} ms, bound {b:.4f} ms ({by})")
        readings["lm_head"][M] = {"ms": ms, "widen_matmul_ms": widen_ms, "bound_ms": b, "col_rel_err": rel}
        report["shapes"].append({"kernel": "int8_matmul (lm_head)", "M": M, "K": K, "N": N, "ms": ms,
                                 "library_ms": None, "widen_matmul_ms": widen_ms, "bound_ms": b, "bound_by": by,
                                 "max_abs_err": err, "col_rel_err": rel, "control_col_rel_err": rel_c})
    del copies

    library_ok = True
    for M in INT8_M:
        layer = {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
        for K, N in LINEARS:
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            ws = torch.rand((N,), generator=gen, device="cuda") * 1e-3 + 1e-4
            copies = weight_copies(torch, gen, K, N)
            w_q = copies[0]
            key, rel, rel_c, err = check(x, w_q, ws)
            cyc = itertools.cycle(copies)
            ms = graph_ms(torch, lambda: q.int8_matmul(x, next(cyc), ws))
            plain_ms = cuda_ms(torch, lambda: q.int8_matmul_plain(x, w_q, ws), 3, 1)
            lib_ms = None
            if library_ok:
                w_t = [c.t().contiguous() for c in copies]
                s_b = ws.to(torch.bfloat16)
                cyc_t = itertools.cycle(w_t)
                try:
                    lib_ms = graph_ms(torch, lambda: torch._weight_int8pack_mm(x, next(cyc_t), s_b))
                except RuntimeError as e:
                    library_ok = False
                    log(f"int8_mm yardstick: torch._weight_int8pack_mm is not available here ({str(e)[:120]})")
                del w_t
            nbytes, ops = M * K * 2 + K * N + N * 4 + M * N * 2, 2.0 * M * K * N
            b, by = bound_ms(nbytes, ops, "bf16")
            plan = q.int8_mm_plan(M, K, N, sms, False)
            lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else "n/a"
            log(f"int8_mm {key:28s}: identical repeats, max column |kernel - plain| / |plain| {rel:.3e} "
                f"(tol {INT8_COL_RTOL:.3e}), control {rel_c:.3e}; kernel {ms:.4f} ms "
                f"({'narrow' if plan.narrow else 'wide'}, {plan.tiles} tiles x {plan.splits} splits), plain "
                f"{plain_ms:.4f} ms, _weight_int8pack_mm {lib_txt}, bound {b:.4f} ms ({by})")
            report["shapes"].append({"kernel": "int8_matmul", "M": M, "K": K, "N": N, "ms": ms, "plain_ms": plain_ms,
                                     "library_ms": lib_ms, "bound_ms": b, "bound_by": by, "max_abs_err": err,
                                     "col_rel_err": rel, "control_col_rel_err": rel_c, "narrow": plan.narrow,
                                     "splits": plan.splits})
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b)):
                tot[k] += v
            layer["ms"] += ms
            layer["bound_ms"] += b
            if lib_ms is not None:
                tot["library_ms"] += lib_ms
                layer["library_ms"] += lib_ms
            tot["b_bytes"] += nbytes / PEAK_BYTES * 1e3
            tot["b_ops"] += ops / PEAK_OPS["bf16"] * 1e3
            tot["err"] = max(tot["err"], err)
            del copies
        readings["per_layer_ms"][M] = layer
        log(f"int8_mm M={M}: one layer's 4 linears {layer['ms']:.4f} ms against a bound of {layer['bound_ms']:.4f} ms"
            f", _weight_int8pack_mm {layer['library_ms']:.4f} ms")
    report["int8_mm"] = readings
    return {
        "name": "int8_matmul", "route": "cuda", "source": "mla_tpu_torch/csrc/int8_mm.cu",
        "replaces": "mla_tpu/ops/quantization.py:264", "max_abs_err": tot["err"],
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if tot["b_bytes"] >= tot["b_ops"] else "operations",
        "library_ms": tot["library_ms"] if library_ok else None,
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


class WordTokenizer:
    """A word-level stand-in for the Llama tokenizer (no vocabulary files
    here): BOS, then one id in [100, 20100) per word."""

    def __call__(self, text, add_special_tokens=True):
        return {"input_ids": [1] + [100 + zlib.crc32(w.encode()) % 20000 for w in text.split()]}

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


STATS = {"rlbench": {"action": {"q01": [-1.0] * 6 + [0.0], "q99": [1.0] * 7}}}

# weight-only int8 mla-small, card (bf16 products through int8_mm, the flash
# prefill) vs CPU (plain versions, reference attention) on the same weights
# and ids: bf16 rounds at other places in the attention and at a different
# fp32 sum order in every product, so the fp32 logits agree to a small share
# of their scale (the largest |logit| of the CPU's run); the card's run
# through the int8_mm control (its last K tile dropped) must miss it
AR_AGREE_RTOL = 2e-2


def drive_ar(torch, pol, img, pc, ids, T: int, feed=None):
    """A policy's prefill and T cached decode steps: (fp32 logits [T + 1,
    V] on the CPU, the ids fed, seconds), each step fed feed[i] (None: the
    run's own greedy id), through the policy's int8 product."""
    from mla_tpu_torch.models import mla

    dev, cfg = pol.device, pol.cfg
    t0 = time.perf_counter()
    with torch.inference_mode():
        prefix = mla.build_prefix_embeds(
            pol.params, pol.state, cfg, torch.as_tensor(ids, device=dev).long(),
            {"front_image": torch.as_tensor(img, device=dev)[None]}, torch.as_tensor(pc, device=dev)[None])
        n = prefix.shape[1]
        kv, logits = mla.prefill(pol.params, cfg, prefix, n + T + mla.CACHE_MARGIN, int8_mode=pol.int8_mode)
        out, toks = [logits[0].float().cpu()], []
        for i in range(T):
            toks.append(int(logits[0].argmax()) if feed is None else feed[i])
            logits = mla.decode_step(pol.params, cfg, kv, n + i, torch.tensor([toks[-1]], device=dev),
                                     int8_mode=pol.int8_mode)
            out.append(logits[0].float().cpu())
    return torch.stack(out), toks, time.perf_counter() - t0


def check_ar_agreement(torch, report, control):
    from mla_tpu_torch import params as P
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.models import mla
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.ops.quantization import quantize_model

    cfg = get_model_config("mla-small")
    params, state = P.init(cfg, seed=13, device="cpu")
    params = quantize_model(params)
    img, pc, ids, _ = request_inputs(cfg, 14)
    T = cfg.action_dim
    pols = {dev: mla.MLAPolicy(params, state, cfg, norm_stats=STATS, device=dev, int8_mode="weight_only")
            for dev in ("cuda", "cpu")}

    def drive(pol, feed=None):
        out = drive_ar(torch, pol, img, pc, ids, T, feed)
        log(f"ar-agree mla-small weight-only int8, prefill + {T} decode steps on {pol.device}: {out[2]:.2f} s")
        return out[:2]

    cpu, cpu_ids = drive(pols["cpu"])
    gpu, _ = drive(pols["cuda"], cpu_ids)
    with kernel_from(cuda, "int8_mm", control):
        ctrl, _ = drive(pols["cuda"], cpu_ids)
    scale = float(cpu.abs().max())
    step_err = (gpu - cpu).abs().amax(dim=1)
    err, err_c = float(step_err.max()), float((ctrl - cpu).abs().max())
    log(f"ar-agree: max |gpu - cpu| logit {err:.4e} per step {[round(float(e), 5) for e in step_err]}, "
        f"scale {scale:.4e}, rel {err / scale:.4e} (tol {AR_AGREE_RTOL}); control rel {err_c / scale:.4e}")
    if not err <= AR_AGREE_RTOL * scale:
        raise AssertionError(f"ar-agree: GPU and CPU logits disagree: {err} vs scale {scale}")
    if not err_c > AR_AGREE_RTOL * scale:
        raise AssertionError(f"ar-agree passes the control: {err_c} vs scale {scale}")

    # the card's own greedy run: the CPU's id at every step whose top-1
    # margin exceeds twice the logits' error; a closer call may go either
    # way, and past a differing id the two contexts part, so the comparison
    # stops at the first difference
    top2 = cpu[:T].topk(2, dim=-1).values
    margins = [float(m) for m in top2[:, 0] - top2[:, 1]]
    gpu_ids = [int(t) for t in pols["cuda"].generate_ids(img, pc, ids, T)[0][0]]
    compared = T
    for i in range(T):
        if gpu_ids[i] != cpu_ids[i]:
            if margins[i] > 2 * err:
                raise AssertionError(f"ar-agree: predict_action_ar on the card chose {gpu_ids[i]} at step {i}, the "
                                     f"CPU {cpu_ids[i]}, with a margin {margins[i]} > 2 x {err}")
            compared = i
            break
    held = sum(m > 2 * err for m in margins[:compared])
    log(f"ar-agree: card ids {gpu_ids}, CPU ids {cpu_ids}, CPU margins {[round(m, 5) for m in margins]}; "
        f"{compared} step(s) in one context, {held} of them with a margin above 2 x {err:.4e}")
    report["ar_agree"] = {"max_abs_err": err, "step_err": [float(e) for e in step_err], "scale": scale,
                          "rtol": AR_AGREE_RTOL, "control_max_abs_err": err_c, "cpu_ids": cpu_ids,
                          "gpu_ids": gpu_ids, "margins": margins, "steps_compared": compared,
                          "steps_above_margin": held}


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
    policy = MLAPolicy(params, state, cfg, norm_stats=STATS)
    # the AR policy over the same int8 leaves (its own fused q|k|v, gate|up)
    ar_policy = MLAPolicy(params, state, cfg, tokenizer=WordTokenizer(), norm_stats=STATS, int8_mode="weight_only")
    del params
    torch.cuda.synchronize()
    log(f"serve: int8 mla-7b built on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated (two policies)")
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
    return totals, policy, ar_policy


AR_TEXT_TOKENS = 16
INSTRUCTIONS = ("pick up the red block and place it on the green plate next to the cup",
                "open the top drawer of the cabinet")


def ar_serve(torch, report, policy):
    """The weight-only int8 mla-7b through its AR entry points, each call
    with its exact kernel launch counts; then the decode step's parts."""
    import numpy as np

    from mla_tpu_torch.models import action_model as am
    from mla_tpu_torch.models import llama as llama_mod
    from mla_tpu_torch.models import mla
    from mla_tpu_torch.ops import cuda

    cfg, dev = policy.cfg, policy.device
    L, S, A, T = cfg.llama.num_layers, cfg.point.num_stages, cfg.action_dim, AR_TEXT_TOKENS
    dit_cfg = am.dit_config("DiT-B", token_size=cfg.token_size, in_channels=A,
                            future_action_window_size=cfg.future_action_window_size)
    dit = am.dit_init(dit_cfg, seed=15, device=dev)
    fc2 = dit["final_layer"]["mlp"]["fc2"]  # zero in the reference init; drawn so the head is live
    fc2["w"] = torch.randn(fc2["w"].shape, generator=torch.Generator(dev).manual_seed(16), device=dev) * 0.02
    reqs = [request_inputs(cfg, 200 + i) for i in range(3)]
    img, pc, ids, _ = reqs[0]

    def counts(int8, passes=1):
        return {"int8_matmul": int8, "flash_attention": passes * L, "furthest_point_sample": passes * S,
                "w8a8_matmul": 0}

    def check_ar(out):
        actions, probs = out
        return actions.shape == (A,) and np.isfinite(actions).all() and len(probs) == A and \
            all(0.0 < p <= 1.0 for p in probs)

    def check_text(out):
        return isinstance(out, str) and len(out.split()) <= T

    def check_both(out):
        return out["actions"].shape == (cfg.action_horizon, A) and np.isfinite(out["actions"]).all() and \
            check_ar((out["ar_actions"], out["ar_max_probs"]))

    # int8_matmul launches: 4 decoder linears a layer in each forward, and
    # the int8 lm_head (fp32) once in each forward that yields logits (the
    # AR prefill and every decode step; not the diffusion prefill or suffix
    # steps, nor predict_action_batch's cognition feature)
    calls = [(f"predict_action_ar {i}", counts((4 * L + 1) * (1 + A)), check_ar,
              lambda r=r: policy.predict_action_ar(r[0], r[1], "", input_ids=r[2], return_probs=True))
             for i, r in enumerate(reqs)]
    calls += [
        (f"generate_text greedy {T}", counts((4 * L + 1) * (1 + T)), check_text,
         lambda: policy.generate_text(img, pc, "", max_new_tokens=T, input_ids=ids)),
        (f"generate_text 4 beams {T}", counts((4 * L + 1) * T), check_text,
         lambda: policy.generate_text(img, pc, "", max_new_tokens=T, input_ids=ids, num_beams=4)),
        ("predict_action_diff_ar DDIM-8", counts((4 * L + 1) * (1 + A) + 4 * L * (1 + 8), passes=2), check_both,
         lambda: policy.predict_action_diff_ar(img, pc, INSTRUCTIONS[0], seed=3)),
        ("predict_action_batch B=2 DiT-B", counts(4 * L), lambda out: out.shape == (2, cfg.action_horizon, A)
         and np.isfinite(out).all(),
         lambda: policy.predict_action_batch([reqs[1][0], reqs[2][0]], [reqs[1][1], reqs[2][1]], list(INSTRUCTIONS),
                                             action_model_params=dit, action_model_cfg=dit_cfg)),
    ]
    policy.predict_action_ar(img, pc, "", input_ids=ids)  # warm-up (first-call allocations), not counted
    torch.cuda.synchronize()
    cuda.launches.clear()
    lat = {}
    for name, expected, ok, fn in calls:
        before = dict(cuda.launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        lat[name] = (time.perf_counter() - t) * 1e3
        got = {k: cuda.launches[k] - before.get(k, 0) for k in expected}
        log(f"ar-serve {name}: {lat[name]:.2f} ms, launches {got}")
        if not ok(out):
            raise AssertionError(f"ar-serve {name}: bad output {out!r:.200}")
        if got != expected:
            raise AssertionError(f"ar-serve {name}: launches {got}, expected {expected}")
    totals = dict(cuda.launches)

    # the parts of a request, outside the counted run
    bb = policy.params["llm_backbone"]
    with torch.inference_mode():
        prefix = mla.build_prefix_embeds(policy.params, policy.state, cfg, torch.as_tensor(ids, device=dev).long(),
                                         {"front_image": torch.as_tensor(img, device=dev)[None]},
                                         torch.as_tensor(pc, device=dev)[None])
        n = prefix.shape[1]
        torch.cuda.synchronize()
        t = time.perf_counter()
        kv, last = mla.prefill(policy.params, cfg, prefix, n + T + mla.CACHE_MARGIN, int8_mode="weight_only")
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        mla.greedy_decode_actions(policy.params, cfg, kv, n, last, T, int8_mode="weight_only")
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t) * 1e3 / T
        h = torch.randn((1, cfg.llama.hidden_size), device=dev).to(cfg.llama.compute_dtype)
        before = cuda.launches["int8_matmul"]
        llama_mod.lm_head_logits(bb, h)
        head_launches = cuda.launches["int8_matmul"] - before
        if head_launches != 1:
            raise AssertionError(f"ar-serve: the int8 lm_head launched int8_matmul {head_launches} times, not once")
        head = bb["lm_head"]
        lm_head_ms = graph_ms(torch, lambda: llama_mod.lm_head_logits(bb, h))
        widen_ms = graph_ms(torch, lambda: (h.float() @ head["w_q"].float()) * head["w_scale"][0])
    weight_bytes = sum(leaf["w_q"].numel() for group in ("attn", "mlp") for leaf in bb["layers"][group].values())
    bound = weight_bytes / PEAK_BYTES * 1e3
    log(f"ar-serve parts: prefill of {n} positions {prefill_ms:.2f} ms; decode {decode_ms:.3f} ms per token "
        f"(host wall, {T} tokens) against a weight-read bound of {bound:.3f} ms ({weight_bytes / 1e9:.2f} GB of int8 "
        f"weights); lm_head through int8_mm {lm_head_ms:.4f} ms device time (CUDA graph; the widened head + fp32 "
        f"matmul it replaces {widen_ms:.4f} ms), {lm_head_ms / decode_ms:.4f} of a decode step")
    report["ar_serve"] = {"latency_ms": lat, "launches": totals, "prefill_ms": prefill_ms,
                          "decode_ms_per_token": decode_ms, "decode_bound_ms": bound, "lm_head_ms": lm_head_ms,
                          "lm_head_widen_matmul_ms": widen_ms, "prefix_len": n}
    return totals


# bf16 training step, card (flash kernels, bf16 tensor-core products) vs CPU
# (reference attention, CPU bf16 products) from the same weights and draws:
# every product rounds differently, but the differences average out over
# the loss and the gradient norm, which agree to about 1e-4 relative; the
# step through the control (flash_bwd.cu with its last tiles dropped) must
# miss the CPU's gradient norm by more than this
# --------------------------------------------------------------------------- #
# the serving host: BatchingServer over the int8 mla-7b, and the HTTP entry
# --------------------------------------------------------------------------- #

SERVE_WAIT_MS = 20.0  # the batching window (scripts/bench_serve_host.py's)
SERVE_ROUNDS = 30     # requests per closed-loop client: enough for a p95
SERVE_CLIENTS = (1, 2, 4)
SERVE_KERNELS = ("w8a8_matmul", "flash_attention", "furthest_point_sample")
SERVE_STATS = {"rlbench": {"action": {"q01": [-1.0] * 6 + [0.0], "q99": [1.0] * 7},
                           "proprio": {"q01": [-1.0] * 7, "q99": [1.0] * 7}}}


class CountingPolicy:
    """The policy behind the server, with each dispatch's kernel launches,
    batch and host milliseconds recorded. Only the server's worker thread
    launches kernels while a client run lasts, so the counts between the
    two reads are that dispatch's. With `normalized` set, each call returns
    the normalized rows (a random head drives nearly every action past the
    q01/q99 clip, so only these tell rows apart)."""

    def __init__(self, policy):
        self.policy, self.cfg, self.tokenizer = policy, policy.cfg, policy.tokenizer
        self.calls = []
        self.normalized = False

    def dispatch_action_diff_batched(self, images, *args, **kw):
        from mla_tpu_torch.ops import cuda

        before, t0 = dict(cuda.launches), time.perf_counter()
        finalize = self.policy.dispatch_action_diff_batched(images, *args, return_normalized=self.normalized, **kw)
        rec = {"B": int(images.shape[0]), "dispatch_ms": (time.perf_counter() - t0) * 1e3,
               "launches": {k: cuda.launches[k] - before.get(k, 0) for k in SERVE_KERNELS}}
        self.calls.append(rec)

        def timed_finalize():
            t1 = time.perf_counter()
            out = finalize()
            rec["finalize_ms"] = (time.perf_counter() - t1) * 1e3
            return out

        return timed_finalize


def serve_frames(cfg, n: int, seed: int):
    """n distinct raw uint8 [3, S, S] frames and [P, 3] clouds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    lo, hi = [-0.3, -0.45, 0.75], [0.7, 0.45, 1.6]
    return ([rng.integers(0, 256, size=(3, size, size), dtype=np.uint8) for _ in range(n)],
            [rng.uniform(lo, hi, size=(cfg.point.input_points, 3)).astype(np.float32) for _ in range(n)])


BUCKET_ROWS_LAYERS = 4
# a bucket-4 row against its B = 1 call at 32 random layers: the front-end's
# one-ulp batch-dependent roundings grow layer by layer to ~8e-2 of the
# chunk; a row mix-up gives ~1
FULL_DEPTH_RTOL = 0.3


def cut_policy(torch, cfg, num_layers: int):
    """The int8 W8A8 mla-7b policy (widths and front-ends of `cfg`) with its
    decoder cut to num_layers, from a seeded init with a live head."""
    from dataclasses import replace

    from mla_tpu_torch import params as P
    from mla_tpu_torch.models.mla import MLAPolicy
    from mla_tpu_torch.ops.quantization import quantize_model

    cut = replace(cfg, llama=replace(cfg.llama, num_layers=num_layers))
    params, state = P.init(cut, seed=45, device="cuda")
    live_head(torch, params, 46)
    return MLAPolicy(quantize_model(params), state, cut, norm_stats=SERVE_STATS)


def bucket_rows(torch, policy, frames, clouds, ids) -> dict:
    """A bucket-4 DPM-4 call's normalized rows against B = 1 calls fed each
    row's x_T (the call's generator, seed 3): rel = max error / max |B = 1|,
    per row, against rotated rows (the control), and the relative RMS
    difference of the prefix embeds, where the batch first enters, and of
    the decoder's hidden states after its first, middle and last layer
    (an uncached forward of each prefix)."""
    from dataclasses import replace

    import numpy as np

    from mla_tpu_torch.models import mla, prismatic

    dev = policy.device
    dpm = dict(input_ids=ids, sampler="dpm", num_dpm_steps=mla.DPM_STEPS, return_normalized=True)
    rows = policy.predict_action_diff_batched(np.stack(frames), np.stack(clouds), seed=3, **dpm)
    x_t = torch.randn((len(frames),) + rows.shape[1:], generator=torch.Generator(device=dev).manual_seed(3),
                      device=dev).cpu().numpy()
    single = np.stack([policy.predict_action_diff(f, c, "", noise=x, **dpm) for f, c, x in zip(frames, clouds, x_t)])
    scale = float(np.abs(single).max())
    with torch.inference_mode():
        pid = torch.as_tensor(np.repeat(ids[:, :-1], len(frames), 0), device=dev).long()
        img, pc = torch.as_tensor(np.stack(frames), device=dev), torch.as_tensor(np.stack(clouds), device=dev)
        pre = mla.build_prefix_embeds(policy.params, policy.state, policy.cfg, pid, {"front_image": img}, pc).float()
        pre1 = torch.cat([mla.build_prefix_embeds(policy.params, policy.state, policy.cfg, pid[b:b + 1],
                                                  {"front_image": img[b:b + 1]}, pc[b:b + 1])
                          for b in range(len(frames))]).float()
        growth = {"prefix": float((pre - pre1).norm() / pre1.norm())}
        decoder, lcfg = prismatic.get_decoder(policy.cfg), policy.cfg.llama
        for k in (1, lcfg.num_layers // 2, lcfg.num_layers):
            # hidden_mid is h before layer contrastive_layer (the last h at num_layers)
            cut = replace(lcfg, contrastive_layer=k)
            h = [decoder.forward(policy.params["llm_backbone"], cut, x, compute_logits=False,
                                 int8_mode=policy.int8_mode)["hidden_mid"].float()
                 for x in [pre.to(lcfg.compute_dtype)] + [pre1[b:b + 1].to(lcfg.compute_dtype)
                                                          for b in range(len(frames))]]
            growth[f"after layer {k - 1}"] = float((h[0] - torch.cat(h[1:])).norm() / torch.cat(h[1:]).norm())
    return {"max_abs_err": float(np.abs(rows - single).max()), "scale": scale,
            "rel": float(np.abs(rows - single).max()) / scale,
            "row_rel": [float(np.abs(rows[b] - single[b]).max() / np.abs(single[b]).max()) for b in range(len(rows))],
            "rotated_rel": float(np.abs(rows - np.roll(single, 1, axis=0)).max()) / scale,
            "rel_rms_by_layer": growth}


def serve_host(torch, report, policy):
    """BatchingServer over the W8A8 int8 mla-7b with DPM-4, buckets (1, 2,
    4) and a 20 ms window: 1, 2 and 4 closed-loop clients of SERVE_ROUNDS
    requests each, a distinct frame per request; every chunk finite [16, 7]
    and every device call's launches W8A8 4L(1 + 4), flash L, FPS 2,
    whatever the bucket; three requests padded to bucket 4 get their own
    normalized rows exactly; a bucket-4 call's rows agree with B = 1 calls
    fed those rows' x_T (a row mix-up must not) within AGREE_RTOL on the
    int8 mla-7b cut to BUCKET_ROWS_LAYERS layers and within FULL_DEPTH_RTOL
    at full depth; one dispatch under sync debug mode
    'error' makes no host sync. Returns the launches of the client runs."""
    import threading

    import numpy as np

    from mla_tpu_torch.models.mla import DPM_STEPS
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.serve import warm_buckets
    from mla_tpu_torch.serving import BatchingServer

    cfg = policy.cfg
    L = cfg.llama.num_layers
    want = {"w8a8_matmul": L * 4 * (1 + DPM_STEPS), "flash_attention": L,
            "furthest_point_sample": cfg.point.num_stages}
    policy.norm_stats = SERVE_STATS
    _, _, ids, _ = request_inputs(cfg, 100)
    dpm = dict(input_ids=ids, sampler="dpm", num_dpm_steps=DPM_STEPS)
    counting = CountingPolicy(policy)
    server = BatchingServer(counting, buckets=SERVE_BUCKETS, max_wait_ms=SERVE_WAIT_MS, sampler="dpm",
                            num_dpm_steps=DPM_STEPS)
    readings = {"expected_per_call": want, "runs": {}}
    try:
        t0 = time.perf_counter()
        warm_buckets(server, [ids.shape[1]], log=False)
        log(f"serve-host: buckets {SERVE_BUCKETS} warmed in {time.perf_counter() - t0:.1f} s")
        frames, clouds = serve_frames(cfg, max(SERVE_CLIENTS) * SERVE_ROUNDS, 41)
        torch.cuda.synchronize()
        cuda.launches.clear()
        counting.calls.clear()
        for n in SERVE_CLIENTS:
            server.reset_latency_stats()
            hist0 = dict(server.stats()["batch_size_hist"])
            calls0 = len(counting.calls)
            results, errors = [], []

            def client(c):
                try:
                    for r in range(SERVE_ROUNDS):
                        k = c * SERVE_ROUNDS + r
                        results.append(server.submit(frames[k], clouds[k], input_ids=ids).result(timeout=600))
                except BaseException as e:  # re-raised below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(c,)) for c in range(n)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = time.perf_counter() - t
            if errors:
                raise errors[0]
            for chunk in results:
                if chunk.shape != (cfg.action_horizon, cfg.action_dim) or not np.isfinite(chunk).all():
                    raise AssertionError(f"serve-host {n} clients: a bad chunk {chunk.shape}")
            s = server.stats()
            calls = counting.calls[calls0:]
            hist = {b: c - hist0.get(b, 0) for b, c in s["batch_size_hist"].items() if c - hist0.get(b, 0)}
            run = {"chunks": len(results), "wall_s": wall, "chunks_per_s": len(results) / wall, "device_calls": len(calls),
                   "batch_hist": hist, **{k: s[k] for k in ("queue_wait_ms", "e2e_ms", "assemble_dispatch_ms",
                                                            "finalize_block_ms")},
                   "dispatch_ms_by_bucket": {b: float(np.mean([c["dispatch_ms"] for c in calls if c["B"] == b]))
                                             for b in sorted({c["B"] for c in calls})},
                   "finalize_ms_by_bucket": {b: float(np.mean([c["finalize_ms"] for c in calls if c["B"] == b]))
                                             for b in sorted({c["B"] for c in calls})}}
            readings["runs"][n] = run
            log(f"serve-host {n} client(s) x {SERVE_ROUNDS}: {run['chunks_per_s']:.2f} chunks/s ({len(results)} in "
                f"{wall:.2f} s, {len(calls)} device calls, buckets {hist}); e2e p50 {s['e2e_ms']['p50']} p95 "
                f"{s['e2e_ms']['p95']} ms, queue wait p50 {s['queue_wait_ms']['p50']} p95 {s['queue_wait_ms']['p95']} "
                f"ms, assemble+dispatch p50 {s['assemble_dispatch_ms']['p50']} ms, finalize block p50 "
                f"{s['finalize_block_ms']['p50']} ms; host dispatch ms by bucket "
                f"{ {b: round(v, 2) for b, v in run['dispatch_ms_by_bucket'].items()} }")
        totals = {k: cuda.launches[k] for k in SERVE_KERNELS}
        for c in counting.calls:
            if c["launches"] != want:
                raise AssertionError(f"serve-host: a bucket-{c['B']} call launched {c['launches']}, expected {want}")
        if totals != {k: v * len(counting.calls) for k, v in want.items()}:
            raise AssertionError(f"serve-host: launches {totals} over {len(counting.calls)} calls")
        log(f"serve-host: every one of {len(counting.calls)} device calls launched {want}; totals {totals}")
        readings["launches"] = totals

        # three requests at once coalesce into one call padded to bucket 4;
        # each gets its own normalized row of the padded batch's direct call
        f3, c3 = serve_frames(cfg, 3, 43)
        n0 = len(counting.calls)
        counting.normalized = True
        futs = [server.submit(f3[i], c3[i], input_ids=ids, seed=9) for i in range(3)]
        got = np.stack([f.result(timeout=600) for f in futs])
        counting.normalized = False
        if [c["B"] for c in counting.calls[n0:]] != [4]:
            raise AssertionError(f"serve-host: 3 requests gave calls {[c['B'] for c in counting.calls[n0:]]}, not [4]")
    finally:
        server.close()
    direct = policy.predict_action_diff_batched(np.stack(f3 + f3[-1:]), np.stack(c3 + c3[-1:]), seed=9,
                                                return_normalized=True, **dpm)[:3]
    pad_err = float(np.abs(got - direct).max())
    swap_err = float(np.abs(got - direct[[1, 2, 0]]).max())
    inside = float((np.abs(direct) <= 1).mean())
    log(f"serve-host padding: 3 requests in one bucket-4 call, normalized rows: max |row - own row| {pad_err:.3e} "
        f"(must be 0), against a rotated row {swap_err:.3e}, scale {np.abs(direct).max():.4e}; {inside:.3f} of "
        f"the entries inside the [-1, 1] clip")
    if not (pad_err == 0 and swap_err > AGREE_RTOL * float(np.abs(direct).max())):
        raise AssertionError(f"serve-host padding: rows {pad_err} from their own, {swap_err} from others")
    readings["padding"] = {"max_abs_err": pad_err, "rotated_max_abs_err": swap_err,
                           "scale": float(np.abs(direct).max()), "share_inside_clip": inside}

    # a bucket-4 call's rows against B = 1 calls fed each row's x_T. The
    # front-end's cuBLAS products round a row by one bf16 step or not
    # depending on the batch, and 32 random decoder layers amplify that
    # (held to FULL_DEPTH_RTOL, the growth read layer by layer); AGREE_RTOL
    # holds on the same int8 mla-7b cut to BUCKET_ROWS_LAYERS layers, as
    # agree and phi-agree cut depth
    f4, c4 = serve_frames(cfg, 4, 44)
    readings["rows_full_depth"] = bucket_rows(torch, policy, f4, c4, ids)
    r = readings["rows_full_depth"]
    log(f"serve-host rows at {L} layers: bucket-4 rows vs B = 1 calls with their x_T rel {r['rel']:.4e} "
        f"(per row {[round(x, 4) for x in r['row_rel']]}; tol {FULL_DEPTH_RTOL}), against rotated rows "
        f"{r['rotated_rel']:.4e}; rel rms by layer { {k: float(f'{v:.3e}') for k, v in r['rel_rms_by_layer'].items()} }")
    if not (r["rel"] <= FULL_DEPTH_RTOL and r["rotated_rel"] > FULL_DEPTH_RTOL):
        raise AssertionError(f"serve-host rows at {L} layers: rel {r['rel']} (rotated {r['rotated_rel']}), "
                             f"tol {FULL_DEPTH_RTOL}")
    cut = cut_policy(torch, cfg, BUCKET_ROWS_LAYERS)
    r = readings["rows"] = bucket_rows(torch, cut, f4, c4, ids)
    del cut
    log(f"serve-host rows at {BUCKET_ROWS_LAYERS} layers: bucket-4 rows vs B = 1 calls with their x_T, max err "
        f"{r['max_abs_err']:.4e}, scale {r['scale']:.4e}, rel {r['rel']:.4e} (tol {AGREE_RTOL}); against rotated "
        f"rows {r['rotated_rel']:.4e}; rel rms by layer "
        f"{ {k: float(f'{v:.3e}') for k, v in r['rel_rms_by_layer'].items()} }")
    if not (r["rel"] <= AGREE_RTOL and r["rotated_rel"] > AGREE_RTOL):
        raise AssertionError(f"serve-host rows: rel {r['rel']} (rotated {r['rotated_rel']}), tol {AGREE_RTOL}")

    # the blocking call's wall per bucket, and one dispatch that must not sync
    call_ms = {}
    for b in SERVE_BUCKETS:
        times = []
        for r in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            policy.predict_action_diff_batched(np.stack(f4[:b]), np.stack(c4[:b]), seed=r, **dpm)
            times.append((time.perf_counter() - t) * 1e3)
        call_ms[b] = times
    log(f"serve-host: predict_action_diff_batched wall ms per bucket {call_ms}")
    readings["call_ms"] = call_ms
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = time.perf_counter()
        finalize = policy.dispatch_action_diff_batched(np.stack(f4), np.stack(c4), seed=5, **dpm)
        dispatch_ms = (time.perf_counter() - t) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    t = time.perf_counter()
    out = finalize()
    block_ms = (time.perf_counter() - t) * 1e3
    if out.shape != (4, cfg.action_horizon, cfg.action_dim) or not np.isfinite(out).all():
        raise AssertionError("serve-host: the no-sync dispatch gave a bad result")
    log(f"serve-host: one bucket-4 dispatch under sync debug mode 'error': no sync, {dispatch_ms:.1f} ms to "
        f"enqueue, then {block_ms:.1f} ms blocked in finalize")
    readings["no_sync_dispatch"] = {"dispatch_ms": dispatch_ms, "finalize_ms": block_ms}
    report["serve_host"] = readings
    return totals


SERVE_HTTP_ROOT = Path("build") / "chip_smoke_serve"
HTTP_CLIENTS, HTTP_ROUNDS, HTTP_SEQUENTIAL = 4, 2, 3
# 22 ids through SimpleTokenizer (BOS, 20 pieces, the trailing 29871), as
# request_inputs' prompt: the prefill is S = PREFIX_LEN, which FLASH_SHAPES holds
HTTP_INSTRUCTION = "put the red block on the green plate"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post_npz(base: str, timeout: float = 600, **arrays):
    import io
    import urllib.request

    import numpy as np

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"{base}/predict", data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return np.asarray(json.load(r)["actions"])


def serve_http(torch, report):
    """A run dir of a seeded bf16 mla-7b (full width; config.json with
    base_vlm mla-7b, dataset statistics, a reference-format .pt with bf16
    decoder leaves) served by `python -m mla_tpu_torch.serve` in a
    subprocess on a free port, while this process loads the same dir with
    load_vla: 4 concurrent clients posting raw 672 x 672 frames, a 640 x 480
    frame through the resize, /stats and /metrics parsed, one sequential
    answer against the in-process predict_action_diff_batched (B = 1, seed
    0, DPM-4) within AGREE_RTOL, the next frame's answer outside it (the
    control); SIGINT must stop it with exit 0 and no
    traceback. Returns the in-process launches of the agreement call."""
    import threading
    import urllib.request

    import numpy as np

    from mla_tpu_torch import params as P
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.models.load import load_vla
    from mla_tpu_torch.models.mla import DPM_STEPS, build_prompt_ids
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.serve import _prep_image
    from mla_tpu_torch.training.checkpointing import export_reference_pt, write_run_metadata
    from mla_tpu_torch.vla.tokenizer import SimpleTokenizer

    readings = {}
    shutil.rmtree(SERVE_HTTP_ROOT, ignore_errors=True)
    run = SERVE_HTTP_ROOT / "mla-7b"
    cfg = get_model_config("mla-7b")
    warm_len = build_prompt_ids(SimpleTokenizer(), HTTP_INSTRUCTION).shape[1]
    if warm_len - 1 + cfg.fused_len != PREFIX_LEN:
        raise AssertionError(f"serve-http: a {warm_len}-id prompt gives a prefill of "
                             f"{warm_len - 1 + cfg.fused_len}, not the checked {PREFIX_LEN}")
    t = time.perf_counter()
    params, state = P.init(cfg, seed=31, device="cuda")
    live_head(torch, params, 32)
    write_run_metadata(run, {"base_vlm": "mla-7b"}, cfg, SERVE_STATS)
    (run / "checkpoints").mkdir()
    pt = run / "checkpoints" / "mla-7b.pt"
    export_reference_pt(pt, {"params": params, "model_state": state}, cfg, llm_dtype=torch.bfloat16)
    readings["write_s"], readings["pt_gib"] = time.perf_counter() - t, pt.stat().st_size / 2**30
    log(f"serve-http: bf16 mla-7b run dir written in {readings['write_s']:.1f} s ({readings['pt_gib']:.2f} GiB .pt)")
    del params, state
    gc.collect()
    torch.cuda.empty_cache()

    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    server_log = SERVE_HTTP_ROOT / "serve.log"
    t_start = time.perf_counter()
    with open(server_log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mla_tpu_torch.serve", "--checkpoint", str(run), "--port", str(port),
             "--warm_len", str(warm_len), "--max_wait_ms", str(SERVE_WAIT_MS)],
            cwd=Path(__file__).resolve().parent, stdout=out, stderr=subprocess.STDOUT)
    try:
        before = torch.cuda.memory_allocated()
        t = time.perf_counter()
        policy = load_vla(run, tokenizer=SimpleTokenizer())
        torch.cuda.synchronize()
        readings["load_vla_s"] = time.perf_counter() - t
        readings["load_vla_gib"] = (torch.cuda.memory_allocated() - before) / 2**30
        log(f"serve-http: in-process load_vla {readings['load_vla_s']:.1f} s, {readings['load_vla_gib']:.2f} GiB "
            f"on the card (the fused serving tree)")
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"serve-http: the server exited {proc.returncode}:\n{server_log.read_text()}")
            try:
                with urllib.request.urlopen(f"{base}/healthz", timeout=5) as r:
                    if json.load(r) == {"ok": True}:
                        break
            except OSError:
                if time.perf_counter() - t_start > 600:
                    raise AssertionError(f"serve-http: no /healthz in 600 s:\n{server_log.read_text()}")
                time.sleep(0.5)
        readings["ready_s"] = time.perf_counter() - t_start
        log(f"serve-http: the server answered /healthz {readings['ready_s']:.1f} s after its start (load and "
            f"warm-up of 3 buckets)")

        size = cfg.vision.image_size
        rng = np.random.default_rng(51)
        pc = rng.uniform([-0.3, -0.45, 0.75], [0.7, 0.45, 1.6], size=(cfg.point.input_points, 3)).astype(np.float32)
        frames = [rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
                  for _ in range(HTTP_CLIENTS * HTTP_ROUNDS + HTTP_SEQUENTIAL)]
        chunks, errors, rtt = [], [], []

        def client(c):
            try:
                for r in range(HTTP_ROUNDS):
                    t0 = time.perf_counter()
                    chunks.append(_post_npz(base, image=frames[c * HTTP_ROUNDS + r], pointcloud=pc,
                                            instruction=np.asarray(HTTP_INSTRUCTION)))
                    rtt.append((time.perf_counter() - t0) * 1e3)
            except BaseException as e:  # re-raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(HTTP_CLIENTS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t
        if errors:
            raise errors[0]
        odd = rng.integers(0, 256, size=(480, 640, 3), dtype=np.uint8)
        chunks.append(_post_npz(base, image=odd, pointcloud=pc, instruction=np.asarray(HTTP_INSTRUCTION)))
        for a in chunks:
            if a.shape != (cfg.action_horizon, cfg.action_dim) or not np.isfinite(a).all():
                raise AssertionError(f"serve-http: a bad answer {a.shape}")
        readings["concurrent"] = {"clients": HTTP_CLIENTS, "requests": HTTP_CLIENTS * HTTP_ROUNDS, "wall_s": wall,
                                  "chunks_per_s": HTTP_CLIENTS * HTTP_ROUNDS / wall,
                                  "rtt_ms_p50": float(np.percentile(rtt, 50)), "rtt_ms_max": float(max(rtt))}
        log(f"serve-http: {HTTP_CLIENTS} clients x {HTTP_ROUNDS} raw 672 px frames in {wall:.2f} s "
            f"({readings['concurrent']['chunks_per_s']:.2f} chunks/s, round trip p50 "
            f"{readings['concurrent']['rtt_ms_p50']:.1f} ms), and a 640 x 480 frame through the resize")

        seq, seq_ms = [], []
        for k in range(HTTP_SEQUENTIAL):
            t0 = time.perf_counter()
            seq.append(_post_npz(base, image=frames[-1 - k], pointcloud=pc, instruction=np.asarray(HTTP_INSTRUCTION)))
            seq_ms.append((time.perf_counter() - t0) * 1e3)
        with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
            stats = json.load(r)
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            metrics = r.read().decode()
        samples = {}
        for line in metrics.splitlines():
            if line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                samples[name] = float(value)
        n_req = HTTP_CLIENTS * HTTP_ROUNDS + 1 + HTTP_SEQUENTIAL
        if stats["requests"] != n_req + 7 or samples["mla_serve_requests"] != stats["requests"] or stats["errors"]:
            raise AssertionError(f"serve-http: /stats {stats}, /metrics {samples}")
        readings["stats"] = stats

        # the sequential answer against this process's load_vla of the dir
        ids = build_prompt_ids(policy.tokenizer, HTTP_INSTRUCTION)
        img = _prep_image(frames[-1], size)[None]
        cuda.launches.clear()
        want = policy.predict_action_diff_batched(img, pc[None], input_ids=ids, seed=0, sampler="dpm",
                                                  num_dpm_steps=DPM_STEPS)[0]
        launches = dict(cuda.launches)
        local_ms = []
        for _ in range(HTTP_SEQUENTIAL):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            policy.predict_action_diff_batched(img, pc[None], input_ids=ids, seed=0, sampler="dpm",
                                               num_dpm_steps=DPM_STEPS)
            local_ms.append((time.perf_counter() - t0) * 1e3)
        scale = float(np.abs(want).max())
        err = float(np.abs(seq[0] - want).max())
        # the control: the answer to the next sequential frame must miss it
        err_c = float(np.abs(seq[1] - want).max())
        readings["agreement"] = {"max_abs_err": err, "scale": scale, "rtol": AGREE_RTOL, "launches": launches,
                                 "control_max_abs_err": err_c}
        readings["http_ms"], readings["in_process_ms"] = seq_ms, local_ms
        log(f"serve-http: the HTTP answer vs in-process load_vla + predict_action_diff_batched: max err {err:.4e}, "
            f"scale {scale:.4e} (tol {AGREE_RTOL}), control (another frame's answer) {err_c:.4e}; HTTP round trip "
            f"ms {[round(x, 1) for x in seq_ms]} vs "
            f"in-process call ms {[round(x, 1) for x in local_ms]}; in-process launches {launches}")
        if not (err <= AGREE_RTOL * scale and err_c > AGREE_RTOL * scale):
            raise AssertionError(f"serve-http: the HTTP answer vs the in-process call {err}, another frame's "
                                 f"answer {err_c}, scale {scale}")
        L = cfg.llama.num_layers
        if launches != {"flash_attention": L, "furthest_point_sample": cfg.point.num_stages}:
            raise AssertionError(f"serve-http: in-process launches {launches}")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise
    text = server_log.read_text()
    log("serve-http: the server's log:\n" + "\n".join("  " + line for line in text.strip().splitlines()))
    if rc != 0 or "Traceback" in text:
        raise AssertionError(f"serve-http: the server ended with exit {rc}")
    readings["server_log"] = text

    # the bucket-4 row fault (ROADMAP.md section 3): serve-host's check of a
    # bucket-4 call's rows against B = 1 calls, the same frames, prompt and
    # x_T, on this bf16 policy, which has no W8A8. If the jump after layer 0
    # goes, W8A8's per-row requantization is its cause
    f4, c4 = serve_frames(cfg, 4, 44)
    _, _, rows_ids, _ = request_inputs(cfg, 100)
    r = readings["rows_bf16"] = bucket_rows(torch, policy, f4, c4, rows_ids)
    w8a8 = report.get("serve_host", {}).get("rows_full_depth", {}).get("rel_rms_by_layer", {})
    jump, jump_w8a8 = r["rel_rms_by_layer"]["after layer 0"], w8a8.get("after layer 0")
    readings["bucket_rows_fault"] = "confirmed" if jump_w8a8 and jump < 0.1 * jump_w8a8 else "open"
    log(f"serve-http rows at 32 layers, bf16 (no W8A8): bucket-4 rows vs B = 1 calls with their x_T rel "
        f"{r['rel']:.4e}, rotated {r['rotated_rel']:.4e}; rel rms by layer "
        f"{ {k: float(f'{v:.3e}') for k, v in r['rel_rms_by_layer'].items()} } against the W8A8 policy's "
        f"{ {k: float(f'{v:.3e}') for k, v in w8a8.items()} }: the layer-0 jump's cause (W8A8) is "
        f"{readings['bucket_rows_fault']} (confirmed when the bf16 jump is under a tenth of the W8A8 one)")
    report["serve_http"] = readings
    del policy
    shutil.rmtree(SERVE_HTTP_ROOT, ignore_errors=True)
    return launches



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


def agreement_steps(torch, control, cfg, batch, keys, what: str, stage: str = "pretrain", perturb=None,
                    optimizer: str = "adamw", learning_rate: float = 1e-5, steps: int = 1):
    """`steps` steps (AdamW, or `optimizer`) of `cfg` from the same seeded
    weights (a live diffusion head), batch, noise, t and FPS starts on the
    card, on the CPU and on the card through the flash_bwd `control` (or,
    given `perturb`, on the card from perturb(weights)): {'cuda', 'cpu',
    'control'}, each the last step's metrics named in `keys` (with more than
    one step, they depend on the optimizer's updates)."""
    from mla_tpu_torch import params as P
    from mla_tpu_torch.diffusion import gaussian as gd
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.training import optim, strategy

    params, state = P.init(cfg, seed=8, device="cpu")
    if "final_layer" in params:
        live_head(torch, params, 9)
    draws = [_draws(cfg, 2, 11)]
    sched = gd.create_schedule("", diffusion_steps=100)

    def one_step(dev, weights=params):
        t0 = time.perf_counter()
        p = P.tree_map(lambda t: t.detach().to(dev, copy=True), weights)
        opt, _, _ = optim.make_optimizer(p, learning_rate=learning_rate, num_training_steps=10, stage=stage,
                                         optimizer=optimizer)
        tcfg = strategy.TrainConfig(repeated_diffusion_steps=1)
        step = strategy.make_train_step(cfg, tcfg, opt, sched)
        st = strategy.init_train_state(p, opt, P.tree_to(state, dev))
        for _ in range(steps):
            st, m = step(st, batch, draws=draws)
        out = {k: float(m[k]) for k in keys}
        log(f"{what} on {dev}: {time.perf_counter() - t0:.2f} s, {out}")
        return out

    out = {"cuda": one_step("cuda"), "cpu": one_step("cpu")}
    if perturb is not None:
        out["control"] = one_step("cuda", perturb(params))
        return out
    with kernel_from(cuda, "flash_bwd", control):
        out["control"] = one_step("cuda")
    return out


def check_train_agreement(torch, report, control):
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.vla.dummy import synthetic_batch

    cfg = get_model_config("mla-small")
    out = agreement_steps(torch, control, cfg, synthetic_batch(cfg, B=2, L=32, seed=10),
                          ("total_loss", "diff_loss", "img_pc_contrastive_loss", "grad_norm"),
                          "train-agree mla-small bf16 B=2")

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


# the post-training losses compared card vs CPU within TRAIN_AGREE_RTOL of
# themselves; image_gen_loss within it of |total_loss|, since its
# delta-reward term is negative and the image loss can sit near 0
POST_AGREE_KEYS = ("total_loss", "tactile_contrastive_loss", "point_cloud_gen_loss", "tactile_gen_loss", "grad_norm")


def check_post_train_agreement(torch, report, control):
    """One AdamW step of the bf16 `mla-small` in the Franka post-training
    stage (every head, tactile, one wrist view; the heads' dropout 0, since
    the card's and the CPU's generators differ) on the card and on the CPU
    from the same weights, batch, wrist view, noise, t and FPS starts; the
    card's step through the flash_bwd control must miss grad_norm."""
    from dataclasses import replace

    from mla_tpu_torch import train_step as ts
    from mla_tpu_torch.models.mla import LOSS_KEYS
    from mla_tpu_torch.vla.dummy import add_extra_views, synthetic_batch

    flags = {k: v for k, v in ts.POST_FRANKA.items() if k != "stage"}
    cfg = ts.model_config("mla-small", **flags)
    g = cfg.gen
    cfg = replace(cfg, gen=replace(g, image=replace(g.image, dropout=0.0), point=replace(g.point, dropout=0.0),
                                   tactile=replace(g.tactile, dropout=0.0)))
    batch = add_extra_views(synthetic_batch(cfg, B=2, L=32, seed=10), cfg, seed=12)
    out = agreement_steps(torch, control, cfg, batch, LOSS_KEYS + ("grad_norm",),
                          f"post-train-agree mla-small bf16 B=2 S={32 + cfg.fused_len + cfg.diff_block_len}",
                          stage=ts.POST_FRANKA["stage"])

    def rel(dev):
        r = {k: abs(out[dev][k] - out["cpu"][k]) / abs(out["cpu"][k]) for k in POST_AGREE_KEYS}
        r["image_gen_loss (of |total_loss|)"] = (abs(out[dev]["image_gen_loss"] - out["cpu"]["image_gen_loss"])
                                                 / abs(out["cpu"]["total_loss"]))
        return r

    sound, ctrl = rel("cuda"), rel("control")
    log(f"post-train-agree: relative |gpu - cpu| {({k: float(f'{v:.4e}') for k, v in sound.items()})} "
        f"(tol {TRAIN_AGREE_RTOL}); control grad_norm {ctrl['grad_norm']:.4e}")
    report["post_train_agree"] = {**out, "rel_err": sound, "control_rel_err": ctrl, "rtol": TRAIN_AGREE_RTOL}
    for k in ("tactile_contrastive_loss", "image_gen_loss", "point_cloud_gen_loss", "tactile_gen_loss"):
        if out["cpu"][k] == 0.0:
            raise AssertionError(f"post-train-agree: {k} is 0 on the CPU, the head did not run")
    if not all(v <= TRAIN_AGREE_RTOL for v in sound.values()):
        raise AssertionError(f"GPU and CPU post-training steps disagree: {sound}")
    if not ctrl["grad_norm"] > TRAIN_AGREE_RTOL:
        raise AssertionError(f"post-train-agree passes the control: grad_norm off by {ctrl['grad_norm']}")


def post_train(torch, report):
    """mla-2b in the Franka post-training stage (train_step --post_franka):
    TRAIN_STEPS AdamW steps at B = 8, S = 819, remat on; finite losses, the
    three generation losses and the tactile contrastive loss non-zero, the
    frozen vision towers without gradients and unchanged, the exact kernel
    launches of every step."""
    import numpy as np

    from mla_tpu_torch import params as P
    from mla_tpu_torch import train_step as ts
    from mla_tpu_torch.models.mla import LOSS_KEYS
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.training import metrics

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    run = ts.build("mla-2b", 8, 32, "cuda", seed=0, **ts.POST_FRANKA)
    cfg, params = run["cfg"], run["state"]["params"]
    S = 32 + cfg.fused_len + cfg.diff_block_len
    heads_n = sum(t.numel() for t in P.tree_leaves(params["generation_manager"]))
    towers = {p: t.detach().clone() for p, t in P.tree_items(params)
              if p.startswith(("vision_tower_2d/", "vision_tower_3d/"))}
    torch.cuda.synchronize()
    log(f"post-train: mla-2b built on the card in {time.perf_counter() - t0:.1f} s, S = {S}, generation heads "
        f"{heads_n / 1e9:.3f} B parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    L = cfg.llama.num_layers
    expected = {"flash_attention": 2 * L, "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
                "furthest_point_sample": cfg.point.num_stages, "w8a8_matmul": 0, "int8_matmul": 0}
    cuda.launches.clear()
    times, steps = [], []
    for i in range(TRAIN_STEPS):
        before = dict(cuda.launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run["state"], m = run["step"](run["state"], run["batch"], run["generator"])
        losses = {k: float(m[k]) for k in LOSS_KEYS}
        gnorm = float(m["grad_norm"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        counts = {k: cuda.launches[k] - before.get(k, 0) for k in expected}
        log(f"post-train step {i}: {losses}, grad_norm {gnorm:.5f}, {times[-1]:.1f} ms, launches {counts}")
        if not all(np.isfinite(v) for v in (*losses.values(), gnorm)):
            raise AssertionError(f"post-train step {i}: non-finite loss or grad_norm: {losses}, {gnorm}")
        for k in ("tactile_contrastive_loss", "image_gen_loss", "point_cloud_gen_loss", "tactile_gen_loss"):
            if losses[k] == 0.0:
                raise AssertionError(f"post-train step {i}: {k} is 0")
        if counts != expected:
            raise AssertionError(f"post-train step {i}: launches {counts}, expected {expected}")
        steps.append({**losses, "grad_norm": gnorm, "ms": times[-1]})
    for p, t in P.tree_items(params):
        if p in towers and (t.requires_grad or t.grad is not None or not torch.equal(t, towers[p])):
            raise AssertionError(f"post-train: the frozen leaf {p} got a gradient or moved")
    step_ms = float(np.median(times[1:]))
    tok_s = run["tokens_per_step"] / (step_ms / 1e3)
    peak = metrics.bf16_peak_flops(torch.cuda.get_device_name(0))
    mfu = tok_s * run["flops_per_token"] / peak if peak else None
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"post-train mla-2b B=8 S={S} ({gpu_line()}): step {step_ms:.1f} ms (median of steps 1..{TRAIN_STEPS - 1}), "
        f"{tok_s:.0f} tokens/s, MFU {mfu if mfu is None else round(mfu, 4)} (decoder 6N only: the front-ends and "
        f"the {heads_n / 1e9:.3f} B generation-head parameters not counted), peak {peak_gib:.2f} GiB")
    report["post_train"] = {"steps": steps, "S": S, "step_ms_median": step_ms, "tokens_per_s": tok_s, "mfu": mfu,
                            "peak_gib": peak_gib, "generation_head_params": heads_n,
                            "frozen_leaves_checked": len(towers), "launches": dict(cuda.launches),
                            "expected_per_step": expected}
    return dict(cuda.launches)


# --------------------------------------------------------------------------- #
# The phi decoder family (mla-phi, Phi-2): head_dim 80, so its attention is
# plain PyTorch on the card, as JAX leaves it to XLA; FPS is its one kernel
# --------------------------------------------------------------------------- #

PHI_AGREE_LAYERS = 4
# the phi counts of every call and step: FPS per front-end pass, nothing else
PHI_KERNELS = ("furthest_point_sample", "flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
               "w8a8_matmul", "int8_matmul")


def phi_counts(passes: int = 1):
    return {k: 2 * passes if k == "furthest_point_sample" else 0 for k in PHI_KERNELS}


def phi_config(num_layers: int = None, **narrow):
    """mla-phi (bf16, Phi-2 widths, full-width front-ends), its decoder cut
    to num_layers or narrowed by `narrow` (PhiConfig fields)."""
    from dataclasses import replace

    from mla_tpu_torch.conf.models import get_model_config

    cfg = get_model_config("mla-phi")
    if num_layers is not None:
        narrow["num_layers"] = num_layers
    return replace(cfg, llama=replace(cfg.llama, **narrow))


def shifted_o_bias(torch, params, seed: int):
    """The control of the phi checks: the same weights with layer 0's
    attention-output bias shifted by a seeded normal vector (std 1), a
    change only the phi decoder's own forward can see."""
    bb = params["llm_backbone"]
    o = bb["layers"]["attn"]["o"]
    b = o["b"].clone()
    g = torch.Generator(device=b.device).manual_seed(seed)
    b[0] += torch.randn(b.shape[1:], generator=g, device=b.device).to(b.dtype)
    attn = {**bb["layers"]["attn"], "o": {**o, "b": b}}
    return {**params, "llm_backbone": {**bb, "layers": {**bb["layers"], "attn": attn}}}


def check_phi_agreement(torch, report):
    """bf16 mla-phi cut to PHI_AGREE_LAYERS layers on the card and on the CPU
    from the same weights: one DDIM-8 chunk (same noise) within AGREE_RTOL,
    and the prefill and 7 decode steps fed the CPU's greedy ids with fp32
    logits within AR_AGREE_RTOL; the card's run from the shifted-o-bias
    control must miss both."""
    from mla_tpu_torch import params as P
    from mla_tpu_torch.models.mla import MLAPolicy

    cfg = phi_config(PHI_AGREE_LAYERS)
    params, state = P.init(cfg, seed=21, device="cpu")
    live_head(torch, params, 22)
    img, pc, ids, noise = request_inputs(cfg, 23)
    T = cfg.action_dim
    runs = {"cpu": ("cpu", params), "card": ("cuda", params), "control": ("cuda", shifted_o_bias(torch, params, 24))}
    chunk, logits = {}, {}
    cpu_ids = None
    for name, (dev, p) in runs.items():
        pol = MLAPolicy(p, state, cfg, norm_stats=STATS, device=dev)
        t0 = time.perf_counter()
        chunk[name] = pol.predict_action_diff(img, pc, "", input_ids=ids, noise=noise, return_normalized=True)
        t1 = time.perf_counter()
        logits[name], fed, ar_s = drive_ar(torch, pol, img, pc, ids, T, cpu_ids)
        cpu_ids = cpu_ids or fed
        log(f"phi-agree mla-phi {PHI_AGREE_LAYERS} layers bf16 ({name}, on {dev}): DDIM-8 chunk {t1 - t0:.2f} s, "
            f"prefill + {T} decode steps {ar_s:.2f} s")
        del pol
    scale, lscale = float(abs(chunk["cpu"]).max()), float(logits["cpu"].abs().max())
    err = {k: float(abs(chunk[k] - chunk["cpu"]).max()) for k in ("card", "control")}
    lerr = {k: float((logits[k] - logits["cpu"]).abs().max()) for k in ("card", "control")}
    log(f"phi-agree: chunk max |gpu - cpu| {err['card']:.4e} of scale {scale:.4e}, rel {err['card'] / scale:.4e} "
        f"(tol {AGREE_RTOL}), control rel {err['control'] / scale:.4e}; AR logits max |gpu - cpu| "
        f"{lerr['card']:.4e} of scale {lscale:.4e}, rel {lerr['card'] / lscale:.4e} (tol {AR_AGREE_RTOL}), control "
        f"rel {lerr['control'] / lscale:.4e}; CPU ids {cpu_ids}")
    report["phi_agree"] = {"layers": PHI_AGREE_LAYERS, "chunk_max_abs_err": err, "chunk_scale": scale,
                           "rtol": AGREE_RTOL, "logits_max_abs_err": lerr, "logits_scale": lscale,
                           "ar_rtol": AR_AGREE_RTOL, "cpu_ids": cpu_ids}
    if not (chunk["card"].shape == (cfg.action_horizon, cfg.action_dim) and err["card"] <= AGREE_RTOL * scale):
        raise AssertionError(f"phi-agree: GPU and CPU chunks disagree: {err['card']} vs scale {scale}")
    if not lerr["card"] <= AR_AGREE_RTOL * lscale:
        raise AssertionError(f"phi-agree: GPU and CPU logits disagree: {lerr['card']} vs scale {lscale}")
    if not (err["control"] > AGREE_RTOL * scale and lerr["control"] > AR_AGREE_RTOL * lscale):
        raise AssertionError(f"phi-agree passes the control: chunk {err['control']}, logits {lerr['control']}")


def phi_serve(torch, report):
    """The full mla-phi (Phi-2, 32 layers, bf16) from a seeded init on the
    card through every serving entry point, each call with its exact
    launches (FPS 2 per front-end pass, flash, W8A8 and int8_matmul 0);
    then the chunk, prefill, suffix-evaluation and decode-step times, the
    decode step beside its weight-read bound."""
    import numpy as np

    from mla_tpu_torch import params as P
    from mla_tpu_torch.models import action_model as am
    from mla_tpu_torch.models import mla
    from mla_tpu_torch.ops import cuda

    cfg = phi_config()
    t0 = time.perf_counter()
    params, state = P.init(cfg, seed=30, device="cuda")
    live_head(torch, params, 31)
    policy = mla.MLAPolicy(params, state, cfg, tokenizer=WordTokenizer(), norm_stats=STATS)
    del params
    torch.cuda.synchronize()
    log(f"phi-serve: mla-phi built on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    A, T, dev = cfg.action_dim, AR_TEXT_TOKENS, policy.device
    dit_cfg = am.dit_config("DiT-B", token_size=cfg.token_size, in_channels=A,
                            future_action_window_size=cfg.future_action_window_size)
    dit = am.dit_init(dit_cfg, seed=32, device=dev)
    fc2 = dit["final_layer"]["mlp"]["fc2"]  # zero in the reference init; drawn so the head is live
    fc2["w"] = torch.randn(fc2["w"].shape, generator=torch.Generator(dev).manual_seed(33), device=dev) * 0.02
    reqs = [request_inputs(cfg, 300 + i) for i in range(REQUESTS)]
    img, pc, ids, noise = reqs[0]

    def chunk_ok(out):
        return out.shape == (cfg.action_horizon, A) and np.isfinite(out).all()

    def ar_ok(out):
        actions, probs = out
        return actions.shape == (A,) and np.isfinite(actions).all() and len(probs) == A and \
            all(0.0 < p <= 1.0 for p in probs)

    calls = [(f"predict_action_diff {s} {i}", phi_counts(), chunk_ok,
              lambda r=r, s=s: policy.predict_action_diff(r[0], r[1], "", input_ids=r[2], noise=r[3], sampler=s))
             for s in ("ddim", "dpm") for i, r in enumerate(reqs)]
    calls += [(f"predict_action_ar {i}", phi_counts(), ar_ok,
               lambda r=r: policy.predict_action_ar(r[0], r[1], "", input_ids=r[2], return_probs=True))
              for i, r in enumerate(reqs)]
    calls += [
        (f"generate_text greedy {T}", phi_counts(), lambda out: isinstance(out, str) and len(out.split()) <= T,
         lambda: policy.generate_text(img, pc, "", max_new_tokens=T, input_ids=ids)),
        (f"generate_text 4 beams {T}", phi_counts(), lambda out: isinstance(out, str) and len(out.split()) <= T,
         lambda: policy.generate_text(img, pc, "", max_new_tokens=T, input_ids=ids, num_beams=4)),
        ("predict_action_diff_ar DDIM-8", phi_counts(passes=2),
         lambda out: chunk_ok(out["actions"]) and ar_ok((out["ar_actions"], out["ar_max_probs"])),
         lambda: policy.predict_action_diff_ar(img, pc, INSTRUCTIONS[0], seed=3)),
        ("predict_action_batch B=2 DiT-B", phi_counts(),
         lambda out: out.shape == (2, cfg.action_horizon, A) and np.isfinite(out).all(),
         lambda: policy.predict_action_batch([reqs[1][0], reqs[2][0]], [reqs[1][1], reqs[2][1]], list(INSTRUCTIONS),
                                             action_model_params=dit, action_model_cfg=dit_cfg)),
    ]
    # warm-up (first-call allocations), not counted
    for sampler in ("ddim", "dpm"):
        policy.predict_action_diff(img, pc, "", input_ids=ids, noise=noise, sampler=sampler)
    policy.predict_action_ar(img, pc, "", input_ids=ids)
    torch.cuda.synchronize()
    cuda.launches.clear()
    lat = {}
    for name, expected, ok, fn in calls:
        before = dict(cuda.launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        lat[name] = (time.perf_counter() - t) * 1e3
        got = {k: cuda.launches[k] - before.get(k, 0) for k in expected}
        log(f"phi-serve {name}: {lat[name]:.2f} ms, launches {got}")
        if not ok(out):
            raise AssertionError(f"phi-serve {name}: bad output {out!r:.200}")
        if got != expected:
            raise AssertionError(f"phi-serve {name}: launches {got}, expected {expected}")
    totals = dict(cuda.launches)

    # the parts of a request, outside the counted run
    bb = policy.params["llm_backbone"]
    with torch.inference_mode():
        prefix = mla.build_prefix_embeds(policy.params, policy.state, cfg,
                                         torch.as_tensor(ids[:, :-1], device=dev).long(),
                                         {"front_image": torch.as_tensor(img, device=dev)[None]},
                                         torch.as_tensor(pc, device=dev)[None])
        n = prefix.shape[1]
        parts = {}

        def timed(name, fn, reps=5):
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            parts[name] = float(np.median(times))
            return out

        kv, _ = timed("prefill_ms", lambda: mla.prefill(policy.params, cfg, prefix, n + 2 + cfg.action_horizon + 1
                                                         + mla.CACHE_MARGIN, compute_logits=False))
        fn = mla.make_suffix_denoise_fn(policy.params, cfg, kv, n, torch.zeros((1, 1, A), device=dev))
        x = torch.as_tensor(noise, device=dev)[None]
        timed("suffix_eval_ms", lambda: fn(x, torch.full((1,), 50, dtype=torch.int32, device=dev)))
        ar_prefix = mla.build_prefix_embeds(policy.params, policy.state, cfg, torch.as_tensor(ids, device=dev).long(),
                                            {"front_image": torch.as_tensor(img, device=dev)[None]},
                                            torch.as_tensor(pc, device=dev)[None])
        m = ar_prefix.shape[1]
        kv, last = timed("ar_prefill_ms", lambda: mla.prefill(policy.params, cfg, ar_prefix, m + T + mla.CACHE_MARGIN))
        torch.cuda.synchronize()
        t = time.perf_counter()
        mla.greedy_decode_actions(policy.params, cfg, kv, m, last, T)
        torch.cuda.synchronize()
        parts["decode_ms_per_token"] = (time.perf_counter() - t) * 1e3 / T
    layer_bytes = sum(t.numel() * t.element_size() for t in P.tree_leaves(bb["layers"]))
    head_bytes = sum(t.numel() * t.element_size() for t in P.tree_leaves(bb["lm_head"]))
    bound = (layer_bytes + head_bytes) / PEAK_BYTES * 1e3
    chunk_ms = {s: [lat[f"predict_action_diff {s} {i}"] for i in range(REQUESTS)] for s in ("ddim", "dpm")}
    log(f"phi-serve mla-phi ({gpu_line()}): DDIM-8 chunk {[round(v, 2) for v in chunk_ms['ddim']]} ms, DPM-4 "
        f"{[round(v, 2) for v in chunk_ms['dpm']]} ms; prefill of {n} positions {parts['prefill_ms']:.2f} ms, one "
        f"suffix evaluation {parts['suffix_eval_ms']:.2f} ms; AR prefill of {m} positions {parts['ar_prefill_ms']:.2f} "
        f"ms, decode {parts['decode_ms_per_token']:.3f} ms per token (host wall, {T} tokens) against a weight-read "
        f"bound of {bound:.3f} ms ({layer_bytes / 1e9:.3f} GB of bf16 decoder layers + {head_bytes / 1e9:.3f} GB of "
        f"lm_head); launches {totals}")
    report["phi_serve"] = {"latency_ms": lat, "launches": totals, "parts_ms": parts, "decode_bound_ms": bound,
                           "layer_bytes": layer_bytes, "lm_head_bytes": head_bytes, "prefix_len": n,
                           "ar_prefix_len": m}
    return totals


def check_phi_train_agreement(torch, report):
    """One AdamW step of a small bf16 phi model (Phi-2's head_dim 80 and
    rotary_dim 32 at hidden 1280, 4 layers, full-width front-ends; B = 2)
    on the card and on the CPU from the same weights, batch and draws: loss
    and grad_norm within TRAIN_AGREE_RTOL; the card's step from the
    shifted-o-bias control must miss both."""
    from mla_tpu_torch.vla.dummy import synthetic_batch

    cfg = phi_config(4, hidden_size=1280, intermediate_size=5120, num_heads=16, contrastive_layer=2)
    out = agreement_steps(torch, None, cfg, synthetic_batch(cfg, B=2, L=32, seed=10),
                          ("total_loss", "diff_loss", "img_pc_contrastive_loss", "grad_norm"),
                          "phi-train-agree small phi bf16 B=2", perturb=lambda p: shifted_o_bias(torch, p, 25))

    def rel(dev):
        return {k: abs(out[dev][k] - out["cpu"][k]) / abs(out["cpu"][k]) for k in ("total_loss", "grad_norm")}

    sound, ctrl = rel("cuda"), rel("control")
    log(f"phi-train-agree: relative |gpu - cpu| loss {sound['total_loss']:.4e}, grad_norm {sound['grad_norm']:.4e} "
        f"(tol {TRAIN_AGREE_RTOL}); control: loss {ctrl['total_loss']:.4e}, grad_norm {ctrl['grad_norm']:.4e}")
    report["phi_train_agree"] = {**out, "rel_err": sound, "control_rel_err": ctrl, "rtol": TRAIN_AGREE_RTOL}
    if not all(v <= TRAIN_AGREE_RTOL for v in sound.values()):
        raise AssertionError(f"GPU and CPU phi training steps disagree: {sound}")
    if not all(v > TRAIN_AGREE_RTOL for v in ctrl.values()):
        raise AssertionError(f"phi-train-agree passes the control: {ctrl}")


def phi_train(torch, report):
    """The full mla-phi through mla_tpu_torch.train_step: TRAIN_STEPS AdamW
    steps at B = 8, S = 563, remat on; finite loss and grad_norm and the
    exact launches of every step (FPS 2, no flash, W8A8 or int8_matmul)."""
    import numpy as np

    from mla_tpu_torch import train_step
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.training import metrics

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    run = train_step.build("mla-phi", 8, 32, "cuda", seed=0)
    cfg = run["cfg"]
    S = 32 + cfg.fused_len + cfg.diff_block_len
    torch.cuda.synchronize()
    log(f"phi-train: mla-phi built on the card in {time.perf_counter() - t0:.1f} s, S = {S}, decoder N = "
        f"{run['flops_per_token'] / 6e9:.4f} B, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    expected = phi_counts()
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
        log(f"phi-train step {i}: loss {loss:.5f}, grad_norm {gnorm:.5f}, {times[-1]:.1f} ms, launches {counts}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"phi-train step {i}: non-finite loss {loss} or grad_norm {gnorm}")
        if counts != expected:
            raise AssertionError(f"phi-train step {i}: launches {counts}, expected {expected}")
        steps.append({"loss": loss, "grad_norm": gnorm, "ms": times[-1]})
    step_ms = float(np.median(times[1:]))
    tok_s = run["tokens_per_step"] / (step_ms / 1e3)
    peak = metrics.bf16_peak_flops(torch.cuda.get_device_name(0))
    mfu = tok_s * run["flops_per_token"] / peak if peak else None
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"phi-train mla-phi B=8 S={S} ({gpu_line()}): step {step_ms:.1f} ms (median of steps 1..{TRAIN_STEPS - 1}), "
        f"{tok_s:.0f} tokens/s ({run['tokens_per_step']} a step), MFU {mfu if mfu is None else round(mfu, 4)}, peak "
        f"{peak_gib:.2f} GiB; launches {dict(cuda.launches)}")
    report["phi_train"] = {"steps": steps, "S": S, "step_ms_median": step_ms, "tokens_per_s": tok_s, "mfu": mfu,
                           "peak_gib": peak_gib, "decoder_params": run["flops_per_token"] / 6,
                           "launches": dict(cuda.launches), "expected_per_step": expected}
    return dict(cuda.launches)


# --------------------------------------------------------------------------- #
# The trainer entry point (python -m mla_tpu_torch.train): fp32 master
# weights, gradient accumulation, checkpoint save and resume, the AR loss
# mode, Adafactor and the visualization cadence
# --------------------------------------------------------------------------- #

# the kernels the trainer's diffusion and AR steps launch, per micro-batch of
# an L-layer llama decoder with remat: the flash forward twice a layer (the
# forward and its recompute), each backward kernel once a layer, FPS once a
# point-tokenizer stage; no int8 product
TRAINER_KERNELS = ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "furthest_point_sample",
                   "w8a8_matmul", "int8_matmul")
TRAINER_ROOT = Path("build") / "chip_smoke_trainer"
TRAINER_ARGS = ("--vla.type", "prism-dinosiglip-224px+oxe+diffusion", "--model", "mla-2b",
                "--per_device_batch_size", "2", "--global_batch_size", "4", "--save_interval", "2")


def trainer_counts(cfg, micro_batches: int):
    L = cfg.llama.num_layers
    per = {"flash_attention": 2 * L, "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
           "furthest_point_sample": cfg.point.num_stages, "w8a8_matmul": 0, "int8_matmul": 0}
    return {k: v * micro_batches for k, v in per.items()}


def check_trainer_agreement(torch, report, control):
    """The trainer's two new step kinds on the bf16-compute `mla-small` with
    fp32 master weights, card vs CPU from the same weights, batch and
    draws: one step of the AR loss mode (use_diff off, lm_head trained) and
    two Adafactor steps (the second step's loss and grad_norm follow the
    first step's Adafactor update). Loss and grad_norm within
    TRAIN_AGREE_RTOL; the flash_bwd control must miss grad_norm in each."""
    from dataclasses import replace

    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.vla.dummy import synthetic_batch

    def fp32_masters(cfg):
        return replace(cfg, llama=replace(cfg.llama, param_dtype=torch.float32))

    cases = {
        "ar_loss_mode": dict(cfg=fp32_masters(get_model_config("mla-small", use_diff=False)), keys=("ar_loss",)),
        "adafactor": dict(cfg=fp32_masters(get_model_config("mla-small")), keys=("diff_loss",),
                          optimizer="adafactor", learning_rate=1e-3, steps=2),
    }
    report["trainer_agree"] = {}
    for name, c in cases.items():
        cfg = c.pop("cfg")
        keys = ("total_loss", "img_pc_contrastive_loss", "grad_norm") + c.pop("keys")
        out = agreement_steps(torch, control, cfg, synthetic_batch(cfg, B=2, L=32, seed=10), keys,
                              f"trainer-agree {name} mla-small fp32 masters B=2", **c)

        def rel(dev):
            return {k: abs(out[dev][k] - out["cpu"][k]) / abs(out["cpu"][k]) for k in ("total_loss", "grad_norm")}

        sound, ctrl = rel("cuda"), rel("control")
        log(f"trainer-agree {name}: relative |gpu - cpu| loss {sound['total_loss']:.4e}, grad_norm "
            f"{sound['grad_norm']:.4e} (tol {TRAIN_AGREE_RTOL}); control grad_norm {ctrl['grad_norm']:.4e}")
        report["trainer_agree"][name] = {**out, "rel_err": sound, "control_rel_err": ctrl, "rtol": TRAIN_AGREE_RTOL}
        if not all(v <= TRAIN_AGREE_RTOL for v in sound.values()):
            raise AssertionError(f"trainer-agree {name}: GPU and CPU steps disagree: {sound}")
        if not ctrl["grad_norm"] > TRAIN_AGREE_RTOL:
            raise AssertionError(f"trainer-agree {name} passes the control: grad_norm off by {ctrl['grad_norm']}")


def _timed_write(path: Path, block, blocks: int, flags: int):
    """(seconds to write, seconds to write and fsync)."""
    fd = os.open(path, flags, 0o600)
    try:
        t0 = time.perf_counter()
        for _ in range(blocks):
            view = memoryview(block)
            while len(view):
                view = view[os.write(fd, view):]
        written = time.perf_counter() - t0
        os.fsync(fd)
        return written, time.perf_counter() - t0
    finally:
        os.close(fd)


def disk_write_gbs(directory: Path, gib: int = 4):
    """The disk's own sequential write rate under `directory`, the
    yardstick of the checkpoint writer (which fsyncs): `gib` GiB written in
    64 MiB blocks past the page cache (O_DIRECT, where the file system
    takes it), then fsync'd and removed. -> (GB/s of the writes alone, GB/s
    with the fsync, whether O_DIRECT was used)."""
    block = mmap.mmap(-1, 64 << 20)  # page-aligned, as O_DIRECT wants
    block.write(bytes(range(256)) * (len(block) // 256))
    path = directory / "disk_rate.bin"
    flags = os.O_WRONLY | os.O_CREAT | os.O_TRUNC
    try:
        try:
            (written, synced), direct = _timed_write(path, block, gib * 16, flags | os.O_DIRECT), True
        except (AttributeError, OSError):  # no direct I/O on this system or file system
            (written, synced), direct = _timed_write(path, block, gib * 16, flags), False
    finally:
        path.unlink(missing_ok=True)
        block.close()
    return gib * 2**30 / written / 1e9, gib * 2**30 / synced / 1e9, direct


def _trainer_step_line(out, tokens_per_step: int, flops_per_token: float, peak):
    """(step ms, tokens/s, MFU) of a run's last step, by the trainer's own
    clock (VLAMetrics' step time: the wall between two commits)."""
    ms = out["metrics"].windows["step_time"][-1] * 1e3
    tok_s = tokens_per_step / (ms / 1e3)
    return ms, tok_s, (tok_s * flops_per_token / peak if peak else None)


def trainer(torch, report):
    """mla-2b through mla_tpu_torch.train.main at full width with fp32
    master weights and AdamW: 2 steps of gradient accumulation 2 and a
    checkpoint at step 2; the step-2 checkpoint loaded into a fresh state
    equals the run's live state bit for bit; a resume to step 3 (async
    save); the launches of every run; then 2 steps of the AR loss mode
    through the CLI and 3 Adafactor steps of train_step's path."""
    import numpy as np

    from mla_tpu_torch import train, train_step
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.params import tree_items
    from mla_tpu_torch.training import checkpointing as ckpt
    from mla_tpu_torch.training import metrics

    shutil.rmtree(TRAINER_ROOT, ignore_errors=True)
    peak_flops = metrics.bf16_peak_flops(torch.cuda.get_device_name(0))
    args = list(TRAINER_ARGS) + ["--run_root_dir", str(TRAINER_ROOT)]
    rep = {}
    try:
        # -- 2 steps, a save, the totals of the main path -------------------
        torch.cuda.reset_peak_memory_stats()
        cuda.launches.clear()
        t0 = time.perf_counter()
        first = train.main(args + ["--run_id", "smoke", "--max_steps", "2"])
        torch.cuda.synchronize()
        totals = {k: cuda.launches[k] for k in TRAINER_KERNELS}
        run_s = time.perf_counter() - t0
        cfg = first["cfg"]
        params = first["state"]["params"]
        n_params = sum(t.numel() for _, t in tree_items(params))
        n_train = sum(t.numel() for t in first["state"]["optimizer"].trainable)
        if {t.dtype for path, t in tree_items(params["llm_backbone"])} != {torch.float32}:
            raise AssertionError("trainer: the decoder's master weights are not fp32")
        if any("lm_head" in p for p in first["state"]["optimizer"].paths):
            raise AssertionError("trainer: lm_head is trained in diffusion mode")
        expected = trainer_counts(cfg, micro_batches=2 * 2)
        if totals != expected:
            raise AssertionError(f"trainer: launches {totals} in 2 steps of accumulation 2, expected {expected}")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        S = 16 + cfg.fused_len + cfg.diff_block_len
        if S != TRAINER_S:
            raise AssertionError(f"trainer: S = {S}, but the kernels were checked at TRAINER_S = {TRAINER_S}")
        tokens = 4 * 4 * S  # per-step rows (2 x accumulation 2) x repeated_diffusion_steps 4 x S
        fpt = first["metrics"].flops_per_token
        ms, tok_s, mfu = _trainer_step_line(first, tokens, fpt, peak_flops)
        run_dir = first["run_dir"]
        step2 = ckpt.latest_checkpoint(run_dir)
        ckpt_gib = (step2 / ckpt.STATE_FILE).stat().st_size / 2**30
        losses = list(first["metrics"].windows["total_loss"])
        if not (step2.name.startswith("step-000002-") and all(np.isfinite(losses))):
            raise AssertionError(f"trainer: checkpoint {step2}, losses {losses}")
        log(f"trainer mla-2b fp32 masters ({n_params / 1e9:.3f} B parameters, {n_train / 1e9:.3f} B trained), "
            f"accumulation 2 x 2 rows x 4 repeats, S = {S} ({gpu_line()}): run {run_s:.1f} s, losses {losses}, "
            f"step 1 {ms:.1f} ms, {tok_s:.0f} tokens/s, MFU {mfu if mfu is None else round(mfu, 4)}, peak "
            f"{peak_gib:.2f} GiB, checkpoint {ckpt_gib:.2f} GiB saved in {first['saves'][0][1]:.1f} s, launches "
            f"{totals}")
        # the host's share of the trainer's step clock: one synthetic batch
        from mla_tpu_torch.vla.dummy import DummyDataset

        batches = iter(DummyDataset(cfg, batch_size=4, seed=0))
        host_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            next(batches)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"trainer: one synthetic batch of 4 rows built on the host in {np.median(host_ms):.1f} ms (median of 3)")
        disk_gbs, disk_synced_gbs, direct = disk_write_gbs(TRAINER_ROOT)
        save_gbs = ckpt_gib * 2**30 / first["saves"][0][1] / 1e9
        log(f"trainer: the disk takes 4 GiB at {disk_gbs:.2f} GB/s "
            f"({'O_DIRECT' if direct else 'through the page cache'}), {disk_synced_gbs:.2f} GB/s fsync'd; the "
            f"checkpoint's save (host copy, torch.save, fsync) {save_gbs:.2f} GB/s")
        rep.update(params=n_params, trained=n_train, S=S, tokens_per_step=tokens, losses=losses, step_ms=ms,
                   host_batch_ms=float(np.median(host_ms)), disk_gbs=disk_gbs, disk_synced_gbs=disk_synced_gbs,
                   disk_direct=direct, save_gbs=save_gbs,
                   tokens_per_s=tok_s, mfu=mfu, peak_gib=peak_gib, checkpoint_gib=ckpt_gib,
                   save_s=first["saves"][0][1], launches=totals, expected=expected,
                   step_times_s=list(first["metrics"].windows["step_time"]))

        # -- the step-2 checkpoint loaded into a fresh state ----------------
        live = first["state"]
        gc.collect()
        torch.cuda.empty_cache()
        fresh = train.build(args + ["--run_id", "smoke-fresh", "--max_steps", "2"])["state"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh = ckpt.load_checkpoint(step2, fresh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        pairs = [(f"params/{p}", a, b) for (p, a), (_, b) in zip(tree_items(live["params"]),
                                                                tree_items(fresh["params"]))]
        pairs += [(f"model_state/{p}", a, b) for (p, a), (_, b) in zip(tree_items(live["model_state"]),
                                                                      tree_items(fresh["model_state"]))]
        lo, fo = live["optimizer"].state_dict(), fresh["optimizer"].state_dict()
        pairs += [(f"opt/{p}/{n}", t, fo["leaves"][p][n]) for p, d in lo["leaves"].items() for n, t in d.items()]
        bad = [k for k, a, b in pairs if a.dtype != b.dtype or not torch.equal(a, b)]
        if bad or lo["count"] != fo["count"] or not live["step"] == fresh["step"] == 2:
            raise AssertionError(f"trainer: the loaded checkpoint differs from the live state in {bad[:5]} "
                                 f"({len(bad)} of {len(pairs)} leaves), count {lo['count']} vs {fo['count']}")
        log(f"trainer: step-2 checkpoint loaded into a fresh state in {load_s:.1f} s, {len(pairs)} leaves "
            "bit-identical to the live state")
        rep.update(load_s=load_s, leaves_compared=len(pairs))
        del first, live, fresh, params, pairs, lo, fo
        gc.collect()
        torch.cuda.empty_cache()

        # -- resume to step 3 ------------------------------------------------
        cuda.launches.clear()
        resumed = train.main(args + ["--run_id", "smoke", "--max_steps", "3", "--is_resume", "true",
                                     "--async_checkpoints", "true"])
        counts = {k: cuda.launches[k] for k in TRAINER_KERNELS}
        names = sorted(p.name for p in (run_dir / "checkpoints").iterdir())
        latest = ckpt.latest_checkpoint(run_dir)
        if not (resumed["load_s"] is not None and any(n.startswith("step-000002-") for n in names)
                and latest.name.startswith("step-000003-") and "latest" in names):
            raise AssertionError(f"trainer: after the resume {names}, latest {latest}")
        if counts != trainer_counts(cfg, micro_batches=2):
            raise AssertionError(f"trainer: resumed step launches {counts}")
        ms3, tok_s3, mfu3 = _trainer_step_line(resumed, tokens, fpt, peak_flops)
        log(f"trainer: resumed from step 2 (loaded in {resumed['load_s']:.1f} s), step 3 {ms3:.1f} ms "
            f"({tok_s3:.0f} tokens/s, MFU {mfu3 if mfu3 is None else round(mfu3, 4)}), async save handed over in "
            f"{resumed['saves'][0][1]:.1f} s; checkpoints {names}")
        rep["resume"] = {"load_s": resumed["load_s"], "step_ms": ms3, "tokens_per_s": tok_s3, "mfu": mfu3,
                         "async_save_s": resumed["saves"][0][1], "checkpoints": names, "launches": counts}
        del resumed
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(TRAINER_ROOT, ignore_errors=True)

        # -- the AR loss mode at full width: lm_head trained ------------------
        torch.cuda.reset_peak_memory_stats()
        cuda.launches.clear()
        ar = train.main(args + ["--run_id", "smoke-ar", "--max_steps", "2", "--use_diff", "false"])
        counts = {k: cuda.launches[k] for k in TRAINER_KERNELS}
        ar_losses = list(ar["metrics"].windows["ar_loss"])
        if not ("llm_backbone/lm_head/w" in ar["state"]["optimizer"].paths and all(np.isfinite(ar_losses))
                and min(ar_losses) > 0):
            raise AssertionError(f"trainer AR mode: ar_loss {ar_losses}")
        if counts != trainer_counts(ar["cfg"], micro_batches=2 * 2):
            raise AssertionError(f"trainer AR mode: launches {counts}")
        S_ar = 16 + ar["cfg"].fused_len
        if S_ar != TRAINER_AR_S:
            raise AssertionError(f"trainer AR mode: S = {S_ar}, but the kernels were checked at {TRAINER_AR_S}")
        ms_ar, tok_ar, mfu_ar = _trainer_step_line(ar, 4 * S_ar, ar["metrics"].flops_per_token, peak_flops)
        peak_ar = torch.cuda.max_memory_allocated() / 2**30
        log(f"trainer AR loss mode mla-2b (lm_head trained), 4 rows, S = {S_ar}: ar_loss {ar_losses}, step 1 "
            f"{ms_ar:.1f} ms, {tok_ar:.0f} tokens/s, MFU {mfu_ar if mfu_ar is None else round(mfu_ar, 4)}, peak "
            f"{peak_ar:.2f} GiB, launches {counts}")
        rep["ar_mode"] = {"ar_losses": ar_losses, "S": S_ar, "step_ms": ms_ar, "tokens_per_s": tok_ar, "mfu": mfu_ar,
                          "peak_gib": peak_ar, "launches": counts}
        del ar
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(TRAINER_ROOT, ignore_errors=True)

        # -- Adafactor through train_step's path (bf16 mla-2b, B = 8) ---------
        torch.cuda.reset_peak_memory_stats()
        run = train_step.build("mla-2b", 8, 32, "cuda", seed=0, optimizer="adafactor")
        times = []
        for i in range(3):
            before = dict(cuda.launches)
            torch.cuda.synchronize()
            t = time.perf_counter()
            run["state"], m = run["step"](run["state"], run["batch"], run["generator"])
            loss, gnorm = float(m["total_loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            counts = {k: cuda.launches[k] - before.get(k, 0) for k in TRAINER_KERNELS}
            if not (np.isfinite(loss) and np.isfinite(gnorm)) or counts != trainer_counts(run["cfg"], 1):
                raise AssertionError(f"adafactor step {i}: loss {loss}, grad_norm {gnorm}, launches {counts}")
            log(f"adafactor mla-2b step {i}: loss {loss:.5f}, grad_norm {gnorm:.5f}, {times[-1]:.1f} ms")
        peak_af = torch.cuda.max_memory_allocated() / 2**30
        step_af = float(np.median(times[1:]))
        log(f"adafactor mla-2b bf16 B=8 S=563: step {step_af:.1f} ms (median of steps 1..2), peak {peak_af:.2f} GiB")
        rep["adafactor"] = {"step_ms": times, "step_ms_median": step_af, "peak_gib": peak_af}
        del run
    finally:
        shutil.rmtree(TRAINER_ROOT, ignore_errors=True)
    report["trainer"] = rep
    return totals


def _png_size(path: Path):
    """(width, height) from a PNG's IHDR, after checking its signature."""
    head = path.read_bytes()[:24]
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")


def trainer_viz(torch, report):
    """mla-small post-training through the CLI with the image and point-cloud
    heads and --visualize_interval 1, one step: the panels are written."""
    from mla_tpu_torch import train

    shutil.rmtree(TRAINER_ROOT, ignore_errors=True)
    try:
        out = train.main(["--vla.type", "prism-dinosiglip-224px+oxe+diffusion", "--model", "mla-small",
                          "--per_device_batch_size", "2", "--global_batch_size", "2", "--max_steps", "1",
                          "--use_generation", "true", "--gen_image", "true", "--gen_pointcloud", "true",
                          "--visualize_interval", "1", "--run_root_dir", str(TRAINER_ROOT), "--run_id", "viz"])
        viz = out["run_dir"] / "visualizations"
        names = sorted(p.name for p in viz.iterdir()) if viz.is_dir() else []
        size = out["cfg"].vision.image_size
        want = ["step000001_img0.png", "step000001_img1.png", "step000001_pc.npz"]
        if names != want or any(_png_size(viz / n) != (2 * size, size) for n in want[:2]):
            raise AssertionError(f"trainer-viz: {names}, expected {want} of {2 * size} x {size} panels")
        losses = {k: float(out["metrics"].windows[k][-1]) for k in ("image_gen_loss", "point_cloud_gen_loss")}
        log(f"trainer-viz: mla-small post-training, 1 step, losses {losses}, panels {names}")
        report["trainer_viz"] = {"files": names, "losses": losses}
    finally:
        shutil.rmtree(TRAINER_ROOT, ignore_errors=True)


# the data phase: scripts/sft_franka.sh's trainer on the port's RLDS
# pipeline, from a franka fixture the port's own writer puts under build/
DATA_ROOT = Path("build") / "chip_smoke_data"
DATA_RUNS = Path("build") / "chip_smoke_data_runs"
# the fixture's choice: the repo names no camera size
DATA_CAMERA = (480, 640)
DATA_EPISODES, DATA_STEPS, DATA_SHARDS, DATA_POINTS = 6, 40, 2, 8192
DATA_EXACT_SIZE, DATA_EXACT_STEPS = 672, 4
DATA_BUFFER = 256  # frames in the shuffle buffer: 240 distinct ones and the first of the next pass
DATA_TIMED_BATCHES = 20
DATA_RUN_STEPS = 3
DATA_ARGS = ("--vla.type", "prism-dinosiglip-224px+oxe+diffusion", "--model", "mla-2b",
             "--data_mix", "franka", "--camera_name", "franka_front", "--freeze_vision_tower", "true",
             "--use_diff", "true", "--use_pointcloud", "true", "--use_contrastive", "true", "--use_tactile", "true",
             "--num_extra_views", "1", "--per_device_batch_size", "2", "--global_batch_size", "4")
DATA_MODULES = ("tensorflow", "tensorflow_datasets", "google.protobuf", "PIL")


def installed(name: str) -> bool:
    """Whether `name` can be imported here (without importing it)."""
    import importlib.util

    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:  # its parent package is missing
        return False


def _camera_frame(seed, size, t: int):
    """A smooth gradient that moves with t, plus noise: real work for zlib
    and for Paeth."""
    import numpy as np

    h, w = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    base = np.stack([(xx + 5 * t) * 255 / w, (yy + 3 * t) * 255 / h, (xx + yy + 7 * t) * 127 / (h + w)], -1)
    return np.clip(base % 256 + rng.normal(0, 3, (h, w, 3)), 0, 255).astype(np.uint8)


def data_fixture(root: Path, name: str, episodes: int, steps: int, size, points: int, shards: int, seed: int,
                 keep_images: bool = False):
    """Franka-schema episodes (third-person and wrist views as PNG, point
    clouds, proprio, gripper xyz, tactile pads with some 65535 sentinels,
    7-DoF actions, an instruction) written by the port's writer; the PNGs
    encoded in a pool of threads. Returns the raw episodes (images as PNG
    bytes, and as arrays under 'pixels' with keep_images)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from mla_tpu_torch.vla.rlds import png
    from mla_tpu_torch.vla.rlds.tfds_compat import write_rlds_dataset

    def encoded(key):
        e, t, view = key
        img = _camera_frame((seed, e, t, view), size, t + 17 * view)
        return img, png.encode(img)

    keys = [(e, t, v) for e in range(episodes) for t in range(steps) for v in range(2)]
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        images = dict(zip(keys, pool.map(encoded, keys)))
    rng = np.random.default_rng(seed)
    out = []
    for e in range(episodes):
        # right and left pads, 6 readings each: the model's tactile_dim of 12
        tactile = rng.uniform(0, 200, (2, steps, 6)).astype(np.float32)
        tactile[rng.random(tactile.shape) < 0.05] = 65535
        walk = np.cumsum(rng.normal(0, 0.1, (steps, 7)), axis=0)
        obs = {
            "image_third": np.asarray([images[e, t, 0][1] for t in range(steps)], object),
            "image_wrist": np.asarray([images[e, t, 1][1] for t in range(steps)], object),
            "point_cloud": rng.uniform([-0.3, -0.45, 0.75], [0.7, 0.45, 1.6], (steps, points, 3)).astype(np.float32),
            "proprio": rng.normal(size=(steps, 7)).astype(np.float32),
            "gripper_xyz": rng.uniform([0.0, -0.2, 0.9], [0.4, 0.2, 1.3], (steps, 3)).astype(np.float32),
            "tactile_right": tactile[0],
            "tactile_left": tactile[1],
        }
        ep = {"steps": {"observation": obs, "action": np.tanh(walk).astype(np.float32),
                        "language_instruction": np.asarray([b"wipe the table"] * steps, object)}}
        out.append(ep)
    write_rlds_dataset(root, name, out, num_shards=shards)
    if keep_images:
        for e, ep in enumerate(out):
            ep["pixels"] = {v: np.stack([images[e, t, i][0] for t in range(steps)])
                            for i, v in enumerate(("image_third", "image_wrist"))}
    return out


def held_bytes(frames) -> int:
    """The bytes a list of frames keeps alive: each encoded image once, and
    each numpy buffer a leaf views (a frame's leaves view its trajectory's
    arrays) once."""
    import numpy as np

    seen, total = set(), 0

    def visit(x):
        nonlocal total
        if isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, bytes):
            if id(x) not in seen:
                seen.add(id(x))
                total += len(x)
        elif isinstance(x, np.ndarray):
            root = x
            while isinstance(root.base, np.ndarray):
                root = root.base
            if id(root) not in seen:
                seen.add(id(root))
                total += root.nbytes
            if x.dtype == object:
                for v in x.reshape(-1):
                    visit(v)

    for f in frames:
        visit(f)
    return total


def data_exact(root: Path, written) -> dict:
    """The 672 x 672 episode through the writer, the reader, PNG, Lanczos
    (672 -> 672) and the CLIP transform: every decoded frame equals the
    written pixels, every CLIP image equals numpy's CLIP normalization of
    them, and the normalized action chunks and proprio equal a numpy
    recomputation from the written values and the statistics' q01/q99, in
    float32 as TensorFlow computes them."""
    import numpy as np

    from mla_tpu_torch.vla.datasets import CLIP_MEAN, CLIP_STD, RLDSBatchTransform
    from mla_tpu_torch.vla.rlds.dataset import make_interleaved_dataset
    from mla_tpu_torch.vla.tokenizer import SimpleTokenizer

    ds, n, stats = make_interleaved_dataset("franka", str(root), shuffle_buffer_size=1, load_pointcloud=True,
                                            load_tactile=True, image_size=DATA_EXACT_SIZE,
                                            stats_cache_dir=str(root / "cache"))
    T = DATA_EXACT_STEPS
    frames = list(ds.take(n))
    if n != T:
        raise AssertionError(f"data exact: {n} transitions, wrote {T}")
    st, ep = stats["franka"], written[0]

    def norm(x, s):
        lo, hi = np.asarray(s["q01"]), np.asarray(s["q99"])
        y = np.clip(np.float32(2) * (x - lo.astype(np.float32)) / (hi - lo + 1e-8).astype(np.float32)
                    - np.float32(1), np.float32(-1), np.float32(1))
        return np.where(np.asarray(s["min"]) == np.asarray(s["max"]), np.float32(0), y)

    act = norm(ep["steps"]["action"], st["action"])
    prop = norm(ep["steps"]["observation"]["proprio"], st["proprio"])
    lo, hi = np.asarray(st["action"]["q01"]), np.asarray(st["action"]["q99"])
    zero = (2 * (0 - lo) / (hi - lo + 1e-8) - 1).astype(np.float32)
    transform = RLDSBatchTransform(None, SimpleTokenizer(), image_size=DATA_EXACT_SIZE, use_pointcloud=True,
                                   use_tactile=True, num_points=1024)
    third, wrist = ep["pixels"]["image_third"], ep["pixels"]["image_wrist"]

    def clip(img):
        return ((img.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD).transpose(2, 0, 1)

    bad = {}
    for t, f in enumerate(frames):
        obs = f["observation"]
        chunk = np.stack([act[t + k] if t + k < T else zero for k in range(16)])
        batch = transform(f)
        checks = {
            "image_primary": (obs["image_primary"][0], third[t]),
            "image_next_primary": (obs["image_next_primary"][0], third[min(t + 1, T - 1)]),
            "image_wrist_right": (obs["image_wrist_right"][0], wrist[t]),
            "clip front_image": (batch["images"]["front_image"][:3], clip(third[t])),
            "clip wrist_right_image": (batch["images"]["wrist_right_image"][:3], clip(wrist[t])),
            "clip next_images": (batch["next_images"], clip(third[min(t + 1, T - 1)])),
            "action chunk": (f["action"], chunk),
            "proprio": (obs["proprio"][0], prop[t]),
        }
        for k, (got, want) in checks.items():
            if got.shape != want.shape or got.dtype != want.dtype or not np.array_equal(got, want):
                bad[f"step {t} {k}"] = (str(got.dtype), list(got.shape), int(np.sum(got != want)) if
                                        got.shape == want.shape else -1)
    return {"frames": len(frames), "checks": 8 * len(frames), "mismatches": bad}


def data_crc_control(root: Path, tmp: Path) -> str:
    """A copy of one shard with one byte of its first record's data flipped
    must be refused by the CRC check (the unflipped copy reads)."""
    from mla_tpu_torch.vla.rlds.tfds_compat import DataLossError, read_records

    shard = sorted((root / "franka" / "1.0.0").glob("franka-train.tfrecord-*"))[0]
    raw = bytearray(shard.read_bytes())
    good, bad = tmp / "good.tfrecord", tmp / "bad.tfrecord"
    good.write_bytes(bytes(raw))
    raw[len(raw) // 3] ^= 0x01
    bad.write_bytes(bytes(raw))
    n = sum(1 for _ in read_records(good))
    try:
        for _ in read_records(bad):
            pass
    except DataLossError as e:
        return f"refused: {e} (the unflipped copy reads {n} records)"
    raise AssertionError("data: a record with a flipped byte passed the CRC check")


def data(torch, report):
    """The RLDS pipeline on the card's host and the trainer on real frames:
    the fixtures (a franka data root of DATA_EPISODES x DATA_STEPS steps in
    DATA_SHARDS shards, 640 x 480 PNG views, 8192-point clouds; a 672 x 672
    episode held exactly through PNG, Lanczos and the CLIP transform); the
    CRC control; the pipeline alone at the trainer's 4 rows a step (frames/s,
    host batch ms, time to the first batch, the buffer's host RAM); then
    train.main with scripts/sft_franka.sh's flags on the data root: exact
    launches, finite losses, S = DATA_S, step ms, tokens/s, MFU, peak GiB
    and the loop's data wait. Returns the trainer run's launches."""
    import numpy as np

    from mla_tpu_torch import train
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.training import metrics
    from mla_tpu_torch.vla import datasets as vdata
    from mla_tpu_torch.vla.materialize import get_vla_dataset_and_collator
    from mla_tpu_torch.vla.rlds import dataset as rds

    rep = {"modules_installed": {m: installed(m) for m in DATA_MODULES}, "camera": DATA_CAMERA}
    home = os.environ.get("HOME")
    for d in (DATA_ROOT, DATA_RUNS):
        shutil.rmtree(d, ignore_errors=True)
    # the statistics cache (~/.cache/mla_tpu_torch) stays inside the checkout
    os.environ["HOME"] = str((DATA_ROOT / "home").resolve())
    try:
        t = time.perf_counter()
        data_fixture(DATA_ROOT, "franka", DATA_EPISODES, DATA_STEPS, DATA_CAMERA, DATA_POINTS, DATA_SHARDS, 61)
        exact = data_fixture(DATA_ROOT / "exact", "franka", 1, DATA_EXACT_STEPS,
                             (DATA_EXACT_SIZE, DATA_EXACT_SIZE), DATA_POINTS, 1, 62, keep_images=True)
        shard_mb = sum(p.stat().st_size for p in (DATA_ROOT / "franka" / "1.0.0").glob("*.tfrecord-*")) / 1e6
        rep["fixture"] = {"write_s": time.perf_counter() - t, "steps": DATA_EPISODES * DATA_STEPS,
                          "episodes": DATA_EPISODES, "shards": DATA_SHARDS, "shard_mb": shard_mb}
        log(f"data: franka fixture of {DATA_EPISODES} x {DATA_STEPS} steps ({DATA_CAMERA[1]} x {DATA_CAMERA[0]} PNG "
            f"views, {DATA_POINTS}-point clouds) in {DATA_SHARDS} shards, {shard_mb:.1f} MB, and a "
            f"{DATA_EXACT_SIZE} px episode, written in {rep['fixture']['write_s']:.1f} s")

        t = time.perf_counter()
        rep["exact"] = data_exact(DATA_ROOT / "exact", exact)
        log(f"data: the {DATA_EXACT_SIZE} px episode through writer, reader, PNG, Lanczos and CLIP: "
            f"{rep['exact']['checks']} checks over {rep['exact']['frames']} frames, mismatches "
            f"{rep['exact']['mismatches'] or 'none'} ({time.perf_counter() - t:.1f} s)")
        if rep["exact"]["mismatches"]:
            raise AssertionError(f"data: the exact round trip failed: {rep['exact']['mismatches']}")
        with tempfile.TemporaryDirectory(dir=DATA_ROOT) as tmp:
            rep["crc_control"] = data_crc_control(DATA_ROOT, Path(tmp))
        log(f"data: CRC control {rep['crc_control']}")

        # -- the pipeline alone, at the trainer's rows a step -----------------
        cfg = get_model_config("mla-2b", use_pointcloud=True, use_tactile=True, use_contrastive=True,
                               camera_name="franka_front", num_extra_views=1)
        rows = 4
        t = time.perf_counter()
        ds, collator, stats, n = get_vla_dataset_and_collator(
            data_root_dir=str(DATA_ROOT), data_mix="franka", model_cfg=cfg, per_host_batch_size=rows,
            shuffle_buffer_size=DATA_BUFFER, seed=0)
        stats_s = time.perf_counter() - t
        it = iter(ds)
        t = time.perf_counter()
        first = collator([next(it) for _ in range(rows)])
        first_s = time.perf_counter() - t
        batch_ms = []
        for _ in range(DATA_TIMED_BATCHES):
            t = time.perf_counter()
            collator([next(it) for _ in range(rows)])
            batch_ms.append((time.perf_counter() - t) * 1e3)
        it.close()
        frames_s = rows * DATA_TIMED_BATCHES / (sum(batch_ms) / 1e3)
        shapes = {k: list(v.shape) for k, v in first.items() if hasattr(v, "shape")}
        shapes.update({f"images/{k}": list(v.shape) for k, v in first["images"].items()})
        trajs, st = rds.make_dataset_from_rlds("franka", str(DATA_ROOT), load_pointcloud=True, load_tactile=True,
                                               dataset_statistics=stats["franka"])
        buffered = list(rds.flatten_to_frames(rds.apply_trajectory_transforms(
            trajs.repeat(), dataset_statistics=st)).take(DATA_BUFFER))
        buf_bytes = held_bytes(buffered)
        del buffered
        decoded = sum(v.nbytes for k, v in first["images"].items()) / rows + first["next_images"][0].nbytes
        rep["pipeline"] = {
            "rows_per_batch": rows, "transitions": n, "stats_pass_s": stats_s, "first_batch_s": first_s,
            "host_batch_ms": batch_ms, "host_batch_ms_p50": float(np.percentile(batch_ms, 50)),
            "host_batch_ms_p95": float(np.percentile(batch_ms, 95)), "frames_per_s": frames_s,
            "buffer_frames": DATA_BUFFER, "buffer_bytes": buf_bytes, "buffer_bytes_per_frame": buf_bytes / DATA_BUFFER,
            "decoded_bytes_per_frame": decoded, "batch_shapes": shapes, "threads": os.cpu_count()}
        log(f"data pipeline (franka, {rows} rows a batch, buffer {DATA_BUFFER}, {os.cpu_count()} host threads): "
            f"statistics pass {stats_s:.2f} s, first batch {first_s:.2f} s, host batch p50 "
            f"{rep['pipeline']['host_batch_ms_p50']:.1f} ms p95 {rep['pipeline']['host_batch_ms_p95']:.1f} ms over "
            f"{DATA_TIMED_BATCHES}, {frames_s:.1f} frames/s; the buffer's frames hold {buf_bytes / 2**20:.1f} MiB "
            f"({buf_bytes / DATA_BUFFER / 2**20:.3f} MiB a frame, images encoded; decoded, a frame's CLIP views "
            f"are {decoded / 2**20:.1f} MiB); batch {shapes}")

        # -- the trainer on the data root -------------------------------------
        args = list(DATA_ARGS) + ["--data_root_dir", str(DATA_ROOT), "--shuffle_buffer_size", str(DATA_BUFFER),
                                  "--max_steps", str(DATA_RUN_STEPS), "--save_interval", str(DATA_RUN_STEPS),
                                  "--run_root_dir", str(DATA_RUNS), "--run_id", "data"]
        torch.cuda.reset_peak_memory_stats()
        cuda.launches.clear()
        t = time.perf_counter()
        out = train.main(args)
        torch.cuda.synchronize()
        totals = {k: cuda.launches[k] for k in TRAINER_KERNELS}
        run_s = time.perf_counter() - t
        cfg = out["cfg"]
        S = vdata.PaddedCollatorForActionPrediction().max_prompt_len + cfg.fused_len + cfg.diff_block_len
        if S != DATA_S:
            raise AssertionError(f"data: S = {S}, but the kernels were checked at DATA_S = {DATA_S}")
        expected = trainer_counts(cfg, micro_batches=DATA_RUN_STEPS * 2)
        if totals != expected:
            raise AssertionError(f"data: launches {totals} in {DATA_RUN_STEPS} steps of accumulation 2, "
                                 f"expected {expected}")
        losses = {k: list(out["metrics"].windows[k]) for k in ("total_loss", "diff_loss", "img_pc_contrastive_loss",
                                                               "tactile_contrastive_loss")}
        if not all(np.isfinite(v).all() and len(v) == DATA_RUN_STEPS for v in losses.values()):
            raise AssertionError(f"data: losses {losses}")
        tokens = rows * 4 * S
        peak_flops = metrics.bf16_peak_flops(torch.cuda.get_device_name(0))
        ms, tok_s, mfu = _trainer_step_line(out, tokens, out["metrics"].flops_per_token, peak_flops)
        wait_ms = [w * 1e3 for w in out["data_wait_s"]]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        rep["trainer"] = {"S": S, "BH": DATA_BH, "tokens_per_step": tokens, "losses": losses, "step_ms": ms,
                          "step_times_s": list(out["metrics"].windows["step_time"]), "tokens_per_s": tok_s,
                          "mfu": mfu, "peak_gib": peak_gib, "data_wait_ms": wait_ms,
                          "data_wait_ms_p50": float(np.percentile(wait_ms, 50)), "data_wait_ms_max": max(wait_ms),
                          "launches": totals, "launches_per_step": {k: v // DATA_RUN_STEPS for k, v in totals.items()},
                          "run_s": run_s, "save_s": out["saves"][-1][1]}
        log(f"data trainer mla-2b ({' '.join(DATA_ARGS[4:])}), fp32 masters, buffer {DATA_BUFFER}, S = {S} "
            f"({gpu_line()}): run {run_s:.1f} s, total losses {losses['total_loss']}, step {ms:.1f} ms (the last), "
            f"{tok_s:.0f} tokens/s, MFU {mfu if mfu is None else round(mfu, 4)}, peak {peak_gib:.2f} GiB, data wait "
            f"ms {[round(w, 1) for w in wait_ms]} (p50 {rep['trainer']['data_wait_ms_p50']:.1f}, max "
            f"{rep['trainer']['data_wait_ms_max']:.1f}), launches a step {rep['trainer']['launches_per_step']}, "
            f"save {rep['trainer']['save_s']:.1f} s")
        del out
    finally:
        if home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = home
        gc.collect()
        for d in (DATA_ROOT, DATA_RUNS):
            shutil.rmtree(d, ignore_errors=True)
    report["data"] = rep
    return totals


def main() -> int:
    parser = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.")
    parser.add_argument("--parent", help="a directory holding another version of flash_fwd.cu, flash_bwd.cu, "
                        "w8a8.cu, int8_mm.cu and fps.cu (such as the parent commit's, with its hopper.cuh) to time "
                        "against this tree's kernels")
    args = parser.parse_args()
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
    log("installed (the data path needs none of them): "
        + ", ".join(f"{m} {'yes' if installed(m) else 'no'}" for m in DATA_MODULES))
    report = {"gpu": line, "shapes": []}
    t = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    started = {name: start_build(cuda, Path(tmp.name), name, control_source(cuda, name), "control")
               for name in CONTROLS}
    if args.parent:
        started.update({("parent", name): start_build(cuda, Path(tmp.name), name,
                                                      (Path(args.parent) / f"{name}.cu").read_text(), "parent",
                                                      Path(args.parent))
                        for name in PARENT_KERNELS})
    try:
        built = cuda.build()
    except BaseException:
        for _, proc in started.values():
            proc.kill()
            proc.wait()
        raise
    for name, text in built.items():
        log(f"built {name}.cu\n" + "\n".join("  " + l for l in text.strip().splitlines() if "registers" in l or "spill" in l))
    from mla_tpu_torch.native import rlds_host

    rlds_host.load()
    log(f"built {rlds_host.SRC.name} (the data pipeline's host helper, g++)")
    w8a8_layout = w8a8_abi((Path(args.parent) / "w8a8.cu").read_text()) if args.parent else None
    int8_layout = int8_mm_abi((Path(args.parent) / "int8_mm.cu").read_text()) if args.parent else None
    libs = {}
    for key, (lib, proc) in started.items():
        if key == ("parent", "w8a8"):
            finish_build(cuda, "w8a8", lib, proc)
            libs[key] = load_parent_w8a8(lib, w8a8_layout)
        elif key == ("parent", "int8_mm"):
            finish_build(cuda, "int8_mm", lib, proc)
            libs[key] = load_parent_int8_mm(lib, int8_layout)
        else:
            libs[key] = finish_build(cuda, key[1] if isinstance(key, tuple) else key, lib, proc)
    log(f"build: {time.perf_counter() - t:.1f} s (with the control copies of {', '.join(CONTROLS)}"
        f"{' and the parent kernels' if args.parent else ''})")
    kernels = ([check_w8a8(torch, report, libs["w8a8"]), check_fps(torch, report, libs["fps"])]
               + check_flash(torch, report, libs["flash_fwd"]) + [check_int8_mm(torch, report, libs["int8_mm"])])
    train_kernels = check_flash_bwd(torch, report, libs["flash_bwd"])
    if args.parent:
        compare_parent(torch, report, {name: libs[("parent", name)] for name in PARENT_KERNELS}, w8a8_layout,
                       int8_layout)
    check_agreement(torch, report)
    check_ar_agreement(torch, report, libs["int8_mm"])
    totals, policy, ar_policy = serve(torch, report)
    ar_totals = ar_serve(torch, report, ar_policy)
    del ar_policy
    torch.cuda.empty_cache()
    host_totals = serve_host(torch, report, policy)
    del policy
    gc.collect()
    torch.cuda.empty_cache()
    report["serve_http_launches"] = serve_http(torch, report)
    gc.collect()
    torch.cuda.empty_cache()
    check_train_agreement(torch, report, libs["flash_bwd"])
    train_totals = train(torch, report)
    gc.collect()
    torch.cuda.empty_cache()
    check_post_train_agreement(torch, report, libs["flash_bwd"])
    report["post_train_launches"] = post_train(torch, report)
    gc.collect()
    torch.cuda.empty_cache()
    check_phi_agreement(torch, report)
    report["phi_serve_launches"] = phi_serve(torch, report)
    gc.collect()
    torch.cuda.empty_cache()
    check_phi_train_agreement(torch, report)
    report["phi_train_launches"] = phi_train(torch, report)
    gc.collect()
    torch.cuda.empty_cache()
    check_trainer_agreement(torch, report, libs["flash_bwd"])
    trainer_totals = trainer(torch, report)
    gc.collect()
    torch.cuda.empty_cache()
    trainer_viz(torch, report)
    gc.collect()
    torch.cuda.empty_cache()
    data_totals = data(torch, report)
    report["serve_launches"], report["ar_serve_launches"], report["train_launches"] = totals, ar_totals, train_totals
    report["serve_host_launches"], report["data_launches"] = host_totals, data_totals
    # launches, by each row's path: the serving host's client runs for the
    # kernels it runs (W8A8, flash forward, FPS); the trainer's run for the
    # backward kernels; the AR serving path for int8_matmul; the data
    # phase's trainer run for the flash kernels at its shape
    kernels += train_kernels
    by_path = {"serve-host": host_totals, "ar-serve": ar_totals, "trainer": trainer_totals, "data": data_totals}
    for k in kernels:
        k.setdefault("path", "serve-host" if k["name"] in host_totals else
                     "ar-serve" if k["name"] == "int8_matmul" else "trainer")
        k["launches"] = by_path[k["path"]][k["name"]]
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "path", "shape")
    print(json.dumps({"kernels": [{key: k[key] for key in order if key in k} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
