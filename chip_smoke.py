#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`mla_tpu_torch`) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

(`--only PHASES` runs the build, the kernels phase and only the named
phases among mistral-agree ... augment, qualify, tp, tp-train, fsdp-train
and formats,
the oxe phase's format checks alone, and prints no result line; `--tp_world
2,4,2x2 --tp_backend nccl` runs the tp phase over those meshes (T, or T x
F with fsdp F), a rank a card, on a machine with that many cards,
`--tp_train_world 4` the tp-train phase at tp 2 x fsdp 2), or, to
time this tree's flash forward, dQ, dK/dV, W8A8, weight-only int8
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
                  S 529 of its AR loss mode, a 17-key tail; BH 128, S 547
                  of a tp-train rank), the data
                  phase's (BH 256, S 979) and the VLM stage's (BH 512, S
                  1025, one key in the last tile; S 512, no ragged tile),
                  with and without a padded key tail, o and lse at every
                  valid row, the check rejecting the forward control
                  without padding wherever S has a ragged tile;
                  the flash backward (dQ, dK/dV) at the training shapes
                  (a tp-train rank's too), with and without a padded key tail, each
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
     eval         `python -m mla_tpu_torch.eval_rlbench` through its main()
                  on serve-http's bf16 mla-7b run dir (kept until this phase
                  ends): the offline replay of a trace of 8 distinct 640 x
                  480 frames with raw clouds of 16 384 points (--voxel_cell
                  0.01 brings them to 1024 through the C++ host ops), DDIM-8
                  then DPM-4; then the simulator loop over a stub lift3d
                  RLBenchEnv replaying the trace, 2 tasks x 1 episode x 3
                  steps in --predict_mode diff_ar. Exact launches (flash L
                  and FPS 2 a chunk, twice that a diff_ar step, no W8A8 or
                  int8_matmul), chunks [8, 16, 7], finite, the gripper
                  binarized; the reference's output layout (the mp4 only
                  where imageio can write it), a written PNG frame decoded
                  equal to the trace's, results.json and the success-rate
                  files; step latency p50 / p95 per sampler and each head's
                  of diff_ar, prepare_pointcloud's host ms; one DDIM-8 step
                  profiled (host preprocessing, wall, device busy, idle
                  share; on the float frame and on the uint8 frame). Then a
                  bf16 mla-small run dir through the same entry on the card
                  and on the CPU, the same x_T injected through a wrapped
                  load_policy: the normalized chunks within AGREE_RTOL.
     diffusion    CogACT's DiT-B action head (token_size 4096) at B = 64,
                  fp32, TF32 off: dit_loss forward and backward,
                  training_losses (MSE, KL, RESCALED_KL) and the 100-step
                  calc_bpd_loop on the card and on the CPU from the same
                  weights, inputs and replayed draws; the loss, each
                  gradient leaf (of its scale) and each row's terms within
                  DIFF_RTOL (the decoder's ill-conditioned elements at t = 0
                  allowed their gap, ILL_MASS); the seconds of each.
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
 12a. mistral-agree  a narrow GQA `mla-mistral` (hidden 1024, 8 query heads
                  over 2 KV heads, intermediate 3584, 4 layers) in int8 on
                  the card and on the CPU: a W8A8 DDIM-8 chunk within
                  AGREE_RTOL; the weight-only prefill and 7 decode steps fed
                  the CPU's ids, fp32 logits within AR_AGREE_RTOL, the
                  int8_mm control outside it.
     mistral-serve  the int8 `mla-mistral` at full width and depth (GQA
                  32:8, intermediate 14336): DDIM-8 and DPM-4 chunks through
                  W8A8 (launches W8A8 1152 / 640, flash 32, FPS 2), then
                  predict_action_ar through a weight-only policy (1032
                  int8_matmul, flash 32, FPS 2); p50 ms, the trees' GiB.
     mistral-train-agree  one AdamW step of the narrow GQA mistral card vs
                  CPU within TRAIN_AGREE_RTOL; the flash_bwd control must
                  miss grad_norm. Then one forward and backward of it (no
                  optimizer) with GQA (8:2 heads) and without (8:8), card
                  vs CPU: each attention leaf's gradient (q, k, v, o) and
                  the worst leaf, ||g_card - g_cpu|| / ||g_cpu||, and the
                  global norm each way (the fp32 sum of squares the step
                  takes, torch.linalg.vector_norm in fp32, float64).
     mistral-train  `mla-mistral` at full width, its decoder cut to 8 layers
                  (train_step.ONE_CARD_LAYERS): TRAIN_STEPS AdamW steps at B
                  = 8, S = 563, launches 16 / 8 / 8 / 2 a step; step ms, MFU
                  by 6N (N = 1.745 B), peak GiB.
     int4-agree   int4_linear's integer partial sums (group 128) identical
                  card vs CPU at mla-7b's four linears, M = 534 and 18, TF32
                  off and on; an int4 mla-7b cut to 4 layers, one DDIM-8
                  chunk card vs CPU within AGREE_RTOL.
     int4-serve   mla-7b-int4 at full depth: DDIM-8, DPM-4 and
                  predict_action_ar with exact launches (flash 32, FPS 2; no
                  W8A8, no int8_matmul: int4 is plain PyTorch, as in JAX);
                  p50 ms, the decoder tree's GiB against the int8 trees'.
     phi-post-agree  a hidden-1280 phi (4 layers, head_dim 80) with the
                  generation heads at its width, one post-training AdamW
                  step card vs CPU (the heads' dropout 0): the losses within
                  TRAIN_AGREE_RTOL, the shifted-o-bias control must miss
                  grad_norm.
     phi-post-train  `train_step --model mla-phi --post_franka` at full
                  width and depth: TRAIN_STEPS AdamW steps at B = 8, S =
                  819, FPS 2 and no other launch a step; step ms, MFU, peak
                  GiB.
     pointlib     models/pointlib on 8 clouds of 8192 points card vs CPU:
                  KMeansEmbed into 256 groups (one FPS launch, counted; FPS
                  8192 -> 256 is also held and timed in the kernels phase,
                  as are W8A8 and int8_mm at mla-mistral's shapes), dilated
                  kNN, the graph convolutions, PCViews' depth images.
     dp-agree     training over a process group (parallel/, the sharded
                  train step): NCCL at world size 1 in this process, 2
                  steps of mla-small (fp32 masters, bf16 compute,
                  accumulation 2) over the NCCL world-1 mesh and over the
                  one-process mesh without a group (twice) from the same
                  weights, batches
                  and per-step generators, deterministic algorithms on: the
                  same losses and launches, grad_norm and every updated
                  master within 1e-6.
     dp           2 steps of mla_tpu_torch.train --model mla-2b --dp 1 in
                  this process at world size 1 over NCCL (the save
                  skipped): exact launches, step ms, tokens/s, MFU, peak
                  GiB and the rank's optimizer GiB beside the one-device
                  trainer's (the trainer under torchrun runs in tp-train).
     augment      the RLDS frame stage on a franka root (640 x 480 PNG
                  views) with augment=True and without: frames/s of each,
                  and augment_image's host ms per frame (both views, the
                  default kwargs) on one thread.
     qualify      the sampler qualification entry
                  (mla_tpu_torch.qualify_samplers) at mla-small, full width,
                  QUALIFY_ARGS: QUALIFY_TRAIN_STEPS production train steps,
                  then DDIM-8 and DPM-4 against DDIM-100 and W8A8 against
                  bf16 on 2 scenarios, one weight seed: finite metrics,
                  W8A8 within QUALIFY_INT8_RMS of the chunk's rms, exact
                  launches of the flash forward and backward, FPS and W8A8
                  (qualify_counts).
     tp           tensor-parallel serving: the int8 mla-7b at full width
                  and depth (seeded) through the one-process W8A8 and
                  weight-only policies, then the ranks of this script
                  (--tp-child) over each mesh of TP_MESHES: 2 ranks of one
                  tp group, then 4 at tp 2 x fsdp 2 (each rank keeps its
                  fsdp part of every leaf and gathers it per use), sharing
                  the card over gloo (which the script names; NCCL refuses
                  two ranks on a device), each building the whole tree
                  (one rank at a time where ranks share the card) and
                  keeping its part: DDIM-8 and DPM-4 chunks bit for bit the one-process
                  ones (else within TP_CHUNK_RTOL of their scale, logged),
                  predict_action_ar's ids equal, the AR logits of a prefill
                  and 7 decode steps fed the one-process ids within
                  AR_AGREE_RTOL on the decoder cut to 4 layers and within
                  TP_AR_FULL_DEPTH_RTOL at 32 (a control with the
                  row-parallel sums skipped must miss it), the ranks'
                  results equal, exact
                  launches of every call (tp_expected: W8A8 2L, its
                  row-parallel steps 2L each, a forward; int8_matmul 2L +
                  1 and its fp32 output 2L an AR forward; flash L, FPS 2),
                  at fsdp 2 exactly L layer gathers a forward and at most
                  2 whole layers alive, each rank's decoder GiB and ms (not
                  tensor-parallel speed on a shared card). Also, on each
                  mesh, a bucket-4 batched DPM-4 call, 4-beam
                  search (weight-only and W8A8), sampled text and the
                  serving host (rank 0's BatchingServer leading the others:
                  12 requests, each dispatch replayed on one process):
                  chunks bit for bit the one-process ones where a rank's
                  plain attention rounds as the one-process call's
                  (tp_attention, measured in the phase), else within
                  FULL_DEPTH_RTOL; beams' ids equal or their score within
                  TP_BEAM_SCORE_RTOL; the sampled text equal on every
                  rank; exact launches per call and per host dispatch on
                  every rank. The kernels phase holds the
                  row-parallel W8A8 (bit for bit) and int8_mm's fp32
                  output at T = 2 and 4, by o and down.
     tp-train     tensor-parallel training: mla_tpu_torch.train.main at
                  mla-2b (TRAINER_ARGS: fp32 masters, AdamW), a row a
                  rank a step, 1 step in this process on the rows the
                  data ranks read (the reference), then
                  `python -m torch.distributed.run --nproc_per_node 2` of
                  this script's --tp-train-child at --tp 2, sharing the
                  card over gloo (named; --tp_train_world 4 --tp_backend
                  nccl: tp 2 x fsdp 2, a card a rank): 2 steps, each
                  rank's step-1 loss and grad_norm within TRAIN_AGREE_RTOL
                  of the reference's and its masters' update within
                  TP_TRAIN_MASTER_RTOL, a control (copy_to_tp's backward
                  all-reduce skipped) outside it, exact launches a step
                  (flash forward 2L, dQ L, dK/dV L, FPS 2 on BH 128 at S
                  547, which the kernels phase holds), each rank's
                  parameter, optimizer and peak GiB and step ms (not tp
                  speed on a shared card).
     fsdp-train   layer-wise gathering over fsdp: the same trainer at
                  mla-2b (fp32 masters, AdamW), accumulation 2, 1 step in
                  this process on the rows and draws the data ranks read
                  (the reference), then 2 ranks of this script's
                  --fsdp-train-child (fsdp 2, sharing the card over gloo):
                  2 steps, each rank's step-1 loss and grad_norm within
                  TRAIN_AGREE_RTOL of the reference's and its masters'
                  update within TP_TRAIN_MASTER_RTOL on layer 0's
                  matrices and norms, a control (the gathers'
                  reduce-scatter skipped, each rank keeping its own
                  gradient) whose grad_norm misses TRAIN_AGREE_RTOL, exact
                  launches a step (flash forward 2L, dQ L, dK/dV L, FPS 2
                  a micro-batch); printed: each rank's layer-stack bytes
                  against the whole stack, the most whole layers alive at
                  once, its parameter, optimizer and peak GiB and step ms
                  (two ranks share the card's SMs and exchange through
                  its buffers, tensor.SharedCard: not fsdp speed).
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
 17. oxe          the Open-X path: a bridge_rt_1 data root written by the
                  port under build/chip_smoke_oxe (bridge_orig with two
                  256 x 256 views, fractal20220817_data at 256 x 320, each
                  8 episodes x 40 steps in 2 shards, in their raw schemas,
                  JPEG frames of quality 95, 4:2:0, from the port's
                  encoder); the JPEG decoder on the card's host: its C++
                  loops against their plain versions in both IDCTs on every
                  frame of one fractal episode and on the golden streams
                  (progressive and restart-interval ones), the golden
                  SHA-256 digests (JPEG_DIGESTS: the port's streams and
                  TensorFlow's and Pillow's decodes of them), a truncated
                  stream refused, decode ms a frame (p50, one thread) at
                  256 x 256 and 640 x 480 beside the host's CPU model; the
                  other formats (oxe_format_checks: every golden stream of
                  tests/data/frames, PNG, GIF, BMP, WebP, the JPEG variants
                  and the formats only Pillow reads (TIFF, Netpbm, TGA, ICO,
                  QOI, PCX, SGI), in both flavours from the C++ and the
                  plain loops against its recorded digests, a truncated
                  stream of each new format refused, decode ms at both
                  sizes, TIFF's in Pillow's flavour); the
                  interleaved stream at the trainer's 4 rows a step
                  (frames/s, host batch ms p50 and p95, the first batch),
                  its statistics against a recount of the written episodes,
                  each dataset's share of 2000 frames within 4 binomial
                  standard deviations of the balanced weights; then
                  train.main --data_mix bridge_rt_1 --use_pointcloud false
                  --use_contrastive false on mla-2b (fp32 masters,
                  per-device 2, global 4, buffer 256), 3 steps: S = OXE_S
                  (723), exact launches (no FPS), finite losses, step ms,
                  tokens/s, MFU, peak GiB and the loop's data wait. The
                  flash forward, dQ and dK/dV are held at its BH 256 / S
                  723 in the kernels phase.
 18. vlm-agree    one vlm-finetune AdamW step of the bf16 `mla-small` in its
                  VLM config (no point, tactile, contrastive or diffusion
                  parts) on the card and on the CPU from the same weights
                  and batch: two multimodal rows of the synthetic finetune
                  data through the LM collator (32 ids, S = 545, the flash
                  route); loss and grad_norm within TRAIN_AGREE_RTOL, the
                  flash_bwd control must miss grad_norm.
     hf-vlm       training from public-layout weights: a directory in
                  meta-llama/Llama-2-7b-hf's layout (its config.json widths,
                  32 layers, model.safetensors.index.json, two float16
                  shards, 13.5 GB) written by the port's own safetensors
                  writer from seeded values (write s and GB/s); then
                  `python -m mla_tpu_torch.train --vlm_stage align --model
                  mla-2b --hf_llama_dir DIR --global_batch_size 16
                  --max_steps 4` through train.main: the decoder equal bit
                  for bit to the files' first 8 layers cast to bf16, the 64
                  mean rows of the padded vocabulary included (numpy's
                  float16 means, as the JAX converter takes them), the
                  vision tower equal to the seeded init's, the projector
                  moved; then --vlm_stage finetune, 4 steps, on a
                  LLaVA-layout data root of 16 JPEG images at 640 x 480
                  (the port's encoder; build/chip_smoke_llava): the
                  decoder's weights moved, the tower unchanged, the
                  multimodal batch's pixels the plain accurate-IDCT
                  decoder's through the CLIP transform. Each run has a
                  language-only batch and a multimodal one past the first
                  step. Exact launches of every step (flash forward 2L,
                  dQ L, dK/dV L; L forwards and no backward for a
                  language-only align step, which reaches no trained leaf;
                  FPS, W8A8 and int8_matmul 0), finite losses, the last
                  step of each kind's ms, tokens/s and MFU, peak GiB, the
                  load's seconds and the bytes it read against the
                  directory's; then, on each run's final state, a
                  multimodal and a language-only batch timed apart: the
                  host's batch, and the step to a synchronize (median of
                  3). The flash
                  kernels are held at the stage's BH 512 / S 1025
                  (multimodal) and S 512 (language-only) in the kernels
                  phase. The fixture and the runs are removed at the end.

The second-to-last line of output is a JSON object with each kernel's
numbers, each row naming its path and, for the flash kernels, its shape
(launches counted on the serving host's client runs for W8A8, the
flash forward and FPS, timed at its bucket-4 shapes: one layer's W8A8 at
M = 2136 and 72, flash at BH 128 / S 534, FPS at B = 4; on the trainer's
first run for dQ and dK/dV, timed at its diffusion micro-batch, BH 256 at
S 547; on the AR serving path for the weight-only int8 product, timed at
its serving shapes; on the data phase's trainer run for the flash
forward, dQ and dK/dV, timed at BH 256 / S 979; on the oxe phase's
trainer run for the same three, timed at BH 256 / S 723; on the hf-vlm phase's
align and finetune runs for the same three, timed at BH 512 / S 1025;
on the eval phase's three mla-7b runs for the flash forward and FPS,
timed at B = 1 (BH 32 / S 534; FPS at B = 1); and on the tp phase's rank 0
for the row-parallel W8A8 (w8a8_matmul_rowpar: its int32 products) and
int8_mm's fp32 output, timed as a rank's launches at T = 2 by o and down
(M = 534 and 18; 1 and 535); the other paths' counts
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
import math
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
# the kernels line's rows: the serving host's largest bucket, and the eval
# entry's one observation a call
FPS_ROW_B = {4: "serve-host", 1: "eval"}


def check_fps(torch, report, control):
    """FPS at both stages, FPS_BATCHES, starts 0 and 7: indices identical to
    the plain version's; the control (the last point left out of the
    distance field, so it is never sampled) must differ at every stage. The
    last cloud of each batch holds its last point far outside the unit
    cube, so the sound kernel samples it second and the control cannot.
    Times kernel (CUDA graph), plain version and the bound; each row sums
    the stages at one batch of FPS_ROW_B."""
    from mla_tpu_torch.ops import cuda, pointops

    gen = torch.Generator(device="cuda").manual_seed(2)
    tots = {B: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "b_bytes": 0.0, "b_ops": 0.0} for B in FPS_ROW_B}
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
            if B in FPS_ROW_B:
                plain_ms = cuda_ms(torch, lambda: pointops.furthest_point_sample_plain(xyz, npoint, zero), 2, 1)
                tot = tots[B]
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
    return [{
        "name": "furthest_point_sample", "route": "cuda", "source": "mla_tpu_torch/csrc/fps.cu",
        "replaces": "mla_tpu/ops/pointops_pallas.py:28", "max_abs_err": 0.0,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if tot["b_bytes"] >= tot["b_ops"] else "operations", "library_ms": None,
        "path": FPS_ROW_B[B], "shape": f"B {B}",
    } for B, tot in tots.items()]


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
# a rank of the tp-train phase: the world's 2 rows x 4 repeats on 16 of
# the 32 heads at TRAINER_S
TP_TRAIN_BH = 2 * 4 * 16
# the data phase's trainer on real frames: the collated prompt of 192 ids,
# the fused block of 256 point, 256 front, 256 wrist and 1 tactile tokens,
# the 18-token diffusion block; 2 rows x 4 repeats x 32 heads
DATA_S, DATA_BH = 192 + 769 + 18, 2 * 4 * 32
# the oxe phase's trainer on bridge_rt_1 without point clouds: the prompt
# of 192 ids, the fused block of 513 tokens, the 18-token diffusion block;
# 2 rows x 4 repeats x 32 heads
OXE_S, OXE_BH = 192 + 513 + 18, 2 * 4 * 32
# the hf-vlm phase's VLM stage on mla-2b: 16 rows, the LM collator's 512
# ids (--vlm_max_length's default) with the 513-token fused block spliced
# after BOS (multimodal batches), or the 512 ids alone (language-only)
VLM_ROWS, VLM_MAX_LENGTH = 16, 512
VLM_S, VLM_LANG_S, VLM_BH = VLM_MAX_LENGTH + 513, VLM_MAX_LENGTH, VLM_ROWS * 32
FLASH_SHAPES = ((32, PREFIX_LEN, "serving prefill"), (2 * 32, PREFIX_LEN, "serving host bucket 2"),
                (4 * 32, PREFIX_LEN, "serving host bucket 4"), (8 * 32, 563, "training"),
                (8 * 32, 819, "post-training"), (8 * 32, TRAINER_S, "trainer"),
                (2 * 32, TRAINER_AR_S, "trainer AR mode"), (TP_TRAIN_BH, TRAINER_S, "tp-train rank"),
                (DATA_BH, DATA_S, "data trainer"),
                (OXE_BH, OXE_S, "oxe trainer"), (VLM_BH, VLM_S, "hf-vlm"), (VLM_BH, VLM_LANG_S, "hf-vlm language-only"))
# the shapes the kernels line times: the serving host's, the data phase's,
# the oxe phase's, the VLM stage's multimodal batch and the eval entry's
# B = 1 prefill
FLASH_ROW_SHAPES = {"serving host bucket 4": "serve-host", "data trainer": "data", "oxe trainer": "oxe",
                    "hf-vlm": "hf-vlm", "serving prefill": "eval", "tp-train rank": "tp-train"}
# the controls drop the last, ragged tile of 64 keys (queries): at a length
# that is a multiple of 64 there is none, and a control is the kernel itself
FLASH_TILE = 64


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
    last, ragged key tile dropped) must miss that check without padding
    wherever S has a ragged tile.
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
            if case == "no padding" and S % FLASH_TILE and ec <= FLASH_ATOL and ec_lse <= FLASH_LSE_ATOL:
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
    diffusion micro-batch, BH 256 at S = 547, of the data phase's, BH 256
    at DATA_S, of the oxe phase's, BH 256 at OXE_S, and of the hf-vlm
    phase's multimodal batch, VLM_BH at VLM_S."""
    flash_bwd_at(torch, report, control, TRAIN_BH, TRAIN_S, "training")
    flash_bwd_at(torch, report, control, TRAIN_BH, POST_S, "post-training")
    rows = flash_bwd_at(torch, report, control, TRAIN_BH, TRAINER_S, "trainer")
    flash_bwd_at(torch, report, control, 2 * 32, TRAINER_AR_S, "trainer AR mode")
    data_rows = flash_bwd_at(torch, report, control, DATA_BH, DATA_S, "data trainer")
    for row in data_rows:
        row["path"] = "data"
    oxe_rows = flash_bwd_at(torch, report, control, OXE_BH, OXE_S, "oxe trainer")
    for row in oxe_rows:
        row["path"] = "oxe"
    vlm_rows = flash_bwd_at(torch, report, control, VLM_BH, VLM_S, "hf-vlm")
    for row in vlm_rows:
        row["path"] = "hf-vlm"
    flash_bwd_at(torch, report, control, VLM_BH, VLM_LANG_S, "hf-vlm language-only")
    tp_rows = flash_bwd_at(torch, report, control, TP_TRAIN_BH, TRAINER_S, "tp-train rank")
    for row in tp_rows:
        row["path"] = "tp-train"
    return rows + data_rows + oxe_rows + vlm_rows + tp_rows


def flash_bwd_at(torch, report, control, BH, S, what):
    """dQ and dK/dV kernels at BH heads of sequence S, with and without a
    padded key tail: every gradient row within FLASH_BWD_ROW_RTOL of the
    plain version's, bit-identical over two launches; the control
    library must exceed the tolerance in each gradient wherever S has a
    ragged tile. Times the kernels
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
        if S % FLASH_TILE and not worst > FLASH_BWD_ROW_RTOL:
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
        return cuda.load("int8_mm", lib, symbols=("int8_mm",))
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
        return cuda.load("w8a8", lib, symbols=("w8a8_matmul",))
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


# the tensor-parallel row-parallel products: o and down of the int8 mla-7b
# split on K over T ranks; W8A8 at the serving prefill and suffix rows, the
# weight-only product at a decode step and the AR prefill
ROWPAR_T = (2, 4)
ROWPAR_LINEARS = ((4096, 4096), (11008, 4096))
# W8A8 at one request's prefill and suffix rows and at buckets 2 and 4 of
# the serving host over a mesh; the weight-only product at a decode step of
# one row and of 4 beams (tp phase, TP_BEAMS), and the AR prefill
ROWPAR_W8A8_M = (PREFIX_LEN, SUFFIX_LEN, 2 * PREFIX_LEN, 4 * PREFIX_LEN, 2 * SUFFIX_LEN, 4 * SUFFIX_LEN)
ROWPAR_INT8_M = (1, 4, PREFIX_LEN + 1)
ROWPAR_ROW_T = 2  # the kernels line's rows: the tp phase's group


def rowpar_w8a8(torch, x, w_qt, ws, T: int):
    """The row-parallel W8A8 of T ranks in one process: K cut in T, each
    slice's row scale, one global s_x (their max: the all-reduce MAX), each
    rank's int32 sums added (the all-reduce SUM), the rescale. Returns (y,
    acc, the steps' outputs)."""
    from mla_tpu_torch.ops import quantization as q

    Kl = x.shape[1] // T
    xs = [x[:, t * Kl:(t + 1) * Kl].contiguous() for t in range(T)]
    ws_t = [w_qt[:, t * Kl:(t + 1) * Kl].contiguous() for t in range(T)]
    scales = [q.w8a8_row_scale(xt) for xt in xs]
    sx = torch.stack(scales).amax(0)
    accs = [q.w8a8_matmul_acc(xt, wt, sx) for xt, wt in zip(xs, ws_t)]
    acc = torch.stack(accs).sum(0, dtype=torch.int32)
    return q.w8a8_rescale(acc, sx, ws, x.dtype), acc, (xs, ws_t, scales, sx, accs)


def check_rowpar(torch, report, w8a8_control, int8_control):
    """The two row-parallel modes of tensor parallelism at T = 2 and 4 in one
    process. W8A8 (w8a8_row_scale, w8a8_matmul_acc, w8a8_rescale): each step
    equal to its plain version, and y and the int32 sums equal to the
    one-card kernel on the whole rows bit for bit; the control (the last K
    tile dropped) must miss. The weight-only product's fp32-output mode
    (int8_mm_f32out): each rank's partials within INT8_COL_RTOL of the plain
    version per column, bit-identical over two launches, their sum rounded
    to bf16 within AR_AGREE_RTOL of the one-card product's scale; the
    control must miss the plain version. Times a rank's launches (CUDA
    graphs, weights cycled past L2) beside the one-card kernel, the plain
    version, the bound and a library yardstick."""
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.ops import quantization as q

    gen = torch.Generator(device="cuda").manual_seed(18)
    rows = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "err": 0.0, "b_bytes": 0.0,
                   "b_ops": 0.0} for name in ("w8a8_matmul_rowpar", "int8_matmul_f32out")}
    readings = {"w8a8": [], "int8_mm": []}

    def add(name, ms, plain_ms, b, lib_ms, nbytes, ops, kind):
        r = rows[name]
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b), ("library_ms", lib_ms)):
            r[k] += v
        r["b_bytes"] += nbytes / PEAK_BYTES * 1e3
        r["b_ops"] += ops / PEAK_OPS[kind] * 1e3

    for T in ROWPAR_T:
        for K, N in ROWPAR_LINEARS:
            Kl = K // T
            for M in ROWPAR_W8A8_M:
                where = f"T={T} M={M} K={K} (rank K {Kl}) N={N}"
                x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                w_q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
                w_qt = w_q.t().contiguous()
                ws = torch.rand((N,), generator=gen, device="cuda") * 1e-3 + 1e-4
                y1, acc1 = q.w8a8_matmul(x, w_qt, ws, return_acc=True)
                y, acc, (xs, wts, scales, sx, accs) = rowpar_w8a8(torch, x, w_qt, ws, T)
                with kernel_from(cuda, "w8a8", w8a8_control):
                    _, acc_c, _ = rowpar_w8a8(torch, x, w_qt, ws, T)
                torch.cuda.synchronize()
                for t in range(T):
                    if not torch.equal(scales[t], q.w8a8_row_scale_plain(xs[t])):
                        raise AssertionError(f"w8a8 row-parallel {where}: rank {t}'s row scale differs from plain")
                    if not torch.equal(accs[t], q.w8a8_matmul_acc_plain(xs[t], wts[t], sx)):
                        raise AssertionError(f"w8a8 row-parallel {where}: rank {t}'s int32 sums differ from plain")
                if not torch.equal(y, q.w8a8_rescale_plain(acc, sx, ws, x.dtype)):
                    raise AssertionError(f"w8a8 row-parallel {where}: the rescale differs from plain")
                if not (torch.equal(acc, acc1) and torch.equal(y, y1)):
                    raise AssertionError(f"w8a8 row-parallel {where}: not the one-card kernel's sums and output "
                                         f"({int((acc != acc1).sum())} sums, {int((y != y1).sum())} outputs differ)")
                if torch.equal(acc_c, acc1):
                    raise AssertionError(f"w8a8 row-parallel {where}: the check passes the control")
                entry = {"where": where, "identical": True, "control_missed": int((acc_c != acc1).sum())}
                if T == ROWPAR_ROW_T:
                    copies_kn = weight_copies(torch, gen, Kl, N)
                    copies = [c.t().contiguous() for c in copies_kn]
                    whole = [c.t().contiguous() for c in weight_copies(torch, gen, K, N)]
                    x0 = xs[0]
                    cyc, cyc_kn, cyc_whole = itertools.cycle(copies), itertools.cycle(copies_kn), itertools.cycle(whole)
                    ms = graph_ms(torch, lambda: q.w8a8_rescale(
                        q.w8a8_matmul_acc(x0, next(cyc), q.w8a8_row_scale(x0)), sx, ws, x.dtype))
                    one_ms = graph_ms(torch, lambda: q.w8a8_matmul(x, next(cyc_whole), ws))
                    plain_ms = cuda_ms(torch, lambda: q.w8a8_rescale_plain(q.w8a8_matmul_acc_plain(
                        x0, copies[0], q.w8a8_row_scale_plain(x0)), sx, ws, x.dtype), 3, 1)

                    def library():
                        xq, s = q.quantize_rows(x0)
                        return (torch._int_mm(xq, next(cyc_kn)).float() * s * ws).to(torch.bfloat16)

                    lib_ms = graph_ms(torch, library)
                    # x's slice, the rank's weight rows and scales in; its int32
                    # partials (which leave the rank) and y out
                    nbytes, ops = M * Kl * 2 + Kl * N + N * 4 + M * N * 4 + M * N * 2, 2.0 * M * Kl * N
                    b, by = bound_ms(nbytes, ops, "int8")
                    add("w8a8_matmul_rowpar", ms, plain_ms, b, lib_ms, nbytes, ops, "int8")
                    entry.update(ms=ms, one_card_ms=one_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b,
                                 bound_by=by)
                    log(f"w8a8 row-parallel {where}: y and acc identical to the one-card kernel, the control "
                        f"missed; a rank's 3 launches {ms:.4f} ms (one card, whole K {one_ms:.4f} ms), plain "
                        f"{plain_ms:.4f} ms, _int_mm {lib_ms:.4f} ms, bound {b:.4f} ms ({by})")
                    report["shapes"].append({"kernel": "w8a8_matmul_rowpar", "T": T, "M": M, "K": Kl, "N": N,
                                             "ms": ms, "one_card_ms": one_ms, "plain_ms": plain_ms,
                                             "library_ms": lib_ms, "bound_ms": b, "bound_by": by, "max_abs_err": 0.0})
                    del copies, copies_kn, whole
                readings["w8a8"].append(entry)
            for M in ROWPAR_INT8_M:
                where = f"T={T} M={M} K={K} (rank K {Kl}) N={N}"
                x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                w_q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
                ws = torch.rand((N,), generator=gen, device="cuda") * 1e-3 + 1e-4
                y1 = q.int8_matmul(x, w_q, ws)
                xs = [x[:, t * Kl:(t + 1) * Kl].contiguous() for t in range(T)]
                wqs = [w_q[t * Kl:(t + 1) * Kl].contiguous() for t in range(T)]
                parts = [q.int8_matmul(xt, wt, ws, out_dtype=torch.float32) for xt, wt in zip(xs, wqs)]
                again = q.int8_matmul(xs[0], wqs[0], ws, out_dtype=torch.float32)
                with kernel_from(cuda, "int8_mm", int8_control):
                    bad = q.int8_matmul(xs[0], wqs[0], ws, out_dtype=torch.float32)
                y = torch.stack(parts).sum(0).to(torch.bfloat16)
                torch.cuda.synchronize()
                if not (parts[0].dtype == torch.float32 and torch.equal(parts[0], again)):
                    raise AssertionError(f"int8_mm fp32 output {where}: two launches differ")
                rel = max(col_rel_err(p, q.int8_matmul_plain(xt, wt, ws, torch.float32))
                          for p, xt, wt in zip(parts, xs, wqs))
                rel_c = col_rel_err(bad, q.int8_matmul_plain(xs[0], wqs[0], ws, torch.float32))
                err = float((y.float() - y1.float()).abs().max())
                scale = float(y1.float().abs().max())
                if not rel <= INT8_COL_RTOL or not rel_c > INT8_COL_RTOL:
                    raise AssertionError(f"int8_mm fp32 output {where}: columns {rel} of their norm from plain, "
                                         f"control {rel_c} (tol {INT8_COL_RTOL})")
                if not err <= AR_AGREE_RTOL * scale:
                    raise AssertionError(f"int8_mm row-parallel {where}: the summed partials are {err} from the "
                                         f"one-card product (scale {scale}, tol {AR_AGREE_RTOL})")
                entry = {"where": where, "col_rel_err": rel, "control_col_rel_err": rel_c, "sum_vs_one_card": err,
                         "scale": scale}
                if T == ROWPAR_ROW_T:
                    copies, whole = weight_copies(torch, gen, Kl, N), weight_copies(torch, gen, K, N)
                    x0 = xs[0]
                    cyc, cyc_whole = itertools.cycle(copies), itertools.cycle(whole)
                    ms = graph_ms(torch, lambda: q.int8_matmul(x0, next(cyc), ws, out_dtype=torch.float32))
                    one_ms = graph_ms(torch, lambda: q.int8_matmul(x, next(cyc_whole), ws))
                    plain_ms = cuda_ms(torch, lambda: q.int8_matmul_plain(x0, copies[0], ws, torch.float32), 3, 1)
                    nbytes, ops = M * Kl * 2 + Kl * N + N * 4 + M * N * 4, 2.0 * M * Kl * N
                    b, by = bound_ms(nbytes, ops, "bf16")
                    add("int8_matmul_f32out", ms, plain_ms, b, 0.0, nbytes, ops, "bf16")
                    entry.update(ms=ms, one_card_ms=one_ms, plain_ms=plain_ms, bound_ms=b, bound_by=by)
                    log(f"int8_mm fp32 output {where}: columns within {rel:.3e} of plain (control {rel_c:.3e}), "
                        f"the summed partials {err / scale:.3e} of the one-card product's scale; a rank's launch "
                        f"{ms:.4f} ms (one card, whole K {one_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b:.4f} ms "
                        f"({by})")
                    report["shapes"].append({"kernel": "int8_matmul_f32out", "T": T, "M": M, "K": Kl, "N": N,
                                             "ms": ms, "one_card_ms": one_ms, "plain_ms": plain_ms,
                                             "library_ms": None, "bound_ms": b, "bound_by": by, "max_abs_err": err})
                    rows["int8_matmul_f32out"]["err"] = max(rows["int8_matmul_f32out"]["err"], err)
                    del copies, whole
                readings["int8_mm"].append(entry)
        log(f"row-parallel T={T}: W8A8 identical to the one-card kernel at M = {ROWPAR_W8A8_M}, int8_mm's fp32 "
            f"partials within tolerance at M = {ROWPAR_INT8_M}, by o and down; both controls missed")
    report["rowpar"] = readings
    out = []
    for name, replaces, src in (("w8a8_matmul_rowpar", "mla_tpu/ops/quantization.py:347", "w8a8.cu"),
                                ("int8_matmul_f32out", "mla_tpu/ops/quantization.py:264", "int8_mm.cu")):
        r = rows[name]
        out.append({"name": name, "route": "cuda", "source": f"mla_tpu_torch/csrc/{src}", "replaces": replaces,
                    "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": "bytes" if r["b_bytes"] >= r["b_ops"] else "operations",
                    "library_ms": r["library_ms"] if name == "w8a8_matmul_rowpar" else None, "path": "tp"})
    return out


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


def drive_ar(torch, pol, img, pc, ids, T: int, feed=None, params=None):
    """A policy's prefill and T cached decode steps: (fp32 logits [T + 1,
    V] on the CPU, the ids fed, seconds), each step fed feed[i] (None: the
    run's own greedy id), through the policy's int8 product, on `params`
    (None: the policy's tree; over a mesh, the tree its tp_scope yields)."""
    from mla_tpu_torch.models import mla

    dev, cfg = pol.device, pol.cfg
    params = pol.params if params is None else params
    t0 = time.perf_counter()
    with torch.inference_mode():
        prefix = mla.build_prefix_embeds(
            params, pol.state, cfg, torch.as_tensor(ids, device=dev).long(),
            {"front_image": torch.as_tensor(img, device=dev)[None]}, torch.as_tensor(pc, device=dev)[None])
        n = prefix.shape[1]
        kv, logits = mla.prefill(params, cfg, prefix, n + T + mla.CACHE_MARGIN, int8_mode=pol.int8_mode)
        out, toks = [logits[0].float().cpu()], []
        for i in range(T):
            toks.append(int(logits[0].argmax()) if feed is None else feed[i])
            logits = mla.decode_step(params, cfg, kv, n + i, torch.tensor([toks[-1]], device=dev),
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


REQUESTS = 2  # requests per sampler in the serve phases


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
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "decoder_tree_gib": {"w8a8": tree_gib(policy.params["llm_backbone"]),
                                            "weight_only": tree_gib(ar_policy.params["llm_backbone"])}}
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
    return launches


# --------------------------------------------------------------------------- #
# the eval entry: python -m mla_tpu_torch.eval_rlbench on serve-http's run dir
# --------------------------------------------------------------------------- #

EVAL_ROOT = Path("build") / "chip_smoke_eval"
EVAL_FRAMES, EVAL_CAMERA = 8, (480, 640)
# a raw sensor cloud of 16 384 returns, brought to the model's 1024 points by
# the voxel pass (1 cm cells) and the exact-count step
EVAL_RAW_POINTS, EVAL_VOXEL = 16384, 0.01
# the stub simulator: close_box ends in success at the last step, close_fridge
# runs out of steps; every step is a diff_ar step (both heads)
EVAL_TASKS, EVAL_EPISODES, EVAL_STEPS = ("close_box", "close_fridge"), 1, 3
EVAL_AGREE_FRAMES = 3
EVAL_KERNELS = ("flash_attention", "furthest_point_sample", "w8a8_matmul", "int8_matmul")


def check_launches(got: dict, expected: dict, what: str) -> None:
    if got != expected:
        raise AssertionError(f"{what}: launches {got}, expected {expected}")


def eval_trace(path: Path, frames: int, seed: int) -> dict:
    """An offline trace in eval_rlbench's format, written to `path`:
    distinct 640 x 480 uint8 frames, raw clouds of EVAL_RAW_POINTS returns (a
    table plane with 2 mm of sensor noise and an object on it, in a shuffled
    order), depths, the instruction (serve-http's 22-id prompt: S = 534)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = EVAL_CAMERA
    n_obj = EVAL_RAW_POINTS // 4
    n_tab = EVAL_RAW_POINTS - n_obj
    table = np.stack([rng.uniform(-0.3, 0.7, (frames, n_tab)), rng.uniform(-0.45, 0.45, (frames, n_tab)),
                      0.75 + rng.normal(0, 0.002, (frames, n_tab))], -1)
    obj = rng.uniform([0.0, -0.2, 0.8], [0.4, 0.2, 0.9], (frames, 1, 3)) + rng.normal(0, 0.04, (frames, n_obj, 3))
    trace = {"images": rng.integers(0, 256, size=(frames, h, w, 3), dtype=np.uint8),
             "point_clouds": rng.permutation(np.concatenate([table, obj], 1), axis=1).astype(np.float32),
             "depths": rng.uniform(0.3, 2.0, (frames, h, w)).astype(np.float32),
             "instruction": np.asarray(HTTP_INSTRUCTION)}
    np.savez(path, **trace)
    return trace


class EvalEnv:
    """A stub of lift3d's RLBenchEnv replaying a trace: reset gives frame 0,
    the k-th step frame k; close_box is done, with success, at its
    EVAL_STEPS-th step, any other task never. Steps and teardowns are kept."""

    trace: dict = {}
    steps: list = []
    closed: list = []

    def __init__(self, task_name, camera_name):
        self.task, self.t = task_name, 0

    def _obs(self):
        import numpy as np

        i = self.t % len(EvalEnv.trace["images"])
        return {"image": EvalEnv.trace["images"][i], "point_cloud": EvalEnv.trace["point_clouds"][i],
                "depth": EvalEnv.trace["depths"][i], "instruction": HTTP_INSTRUCTION,
                "robot_state": np.linspace(-0.5, 0.5, 7, dtype=np.float32)}

    def reset(self):
        self.t = 0
        return self._obs()

    def step(self, action):
        EvalEnv.steps.append((self.task, action))
        self.t += 1
        done = self.task == "close_box" and self.t >= EVAL_STEPS
        return self._obs(), float(done), done, {"success": done}

    def shutdown(self):
        EvalEnv.closed.append(self.task)


def _eval_run(torch, argv, noise=None, timings=None, keep=None) -> None:
    """mla_tpu_torch.eval_rlbench.main(argv) in this process, through a
    wrapped load_policy: with `noise`, the policy's x_T and the chunk before
    its clip and unnormalization; with `timings`, each
    predict_action_diff_ar's output (its "timings": [AR s, diffusion s]);
    `keep` takes the policy."""
    from mla_tpu_torch import eval_rlbench as ev

    real = ev.load_policy

    def load_policy(args):
        pol = real(args)
        if keep is not None:
            keep.append(pol)
        if noise is not None:
            diff = pol.predict_action_diff
            pol.predict_action_diff = lambda *a, **k: diff(*a, noise=noise, return_normalized=True, **k)
        if timings is not None:
            both = pol.predict_action_diff_ar
            pol.predict_action_diff_ar = lambda *a, **k: timings.append(both(*a, **k)) or timings[-1]
        return pol

    ev.load_policy = load_policy
    try:
        rc = ev.main(list(argv))
    finally:
        ev.load_policy = real
        gc.collect()
        torch.cuda.empty_cache()
    if rc != 0:
        raise AssertionError(f"eval: eval_rlbench.main({argv}) returned {rc}")


def _files(root: Path) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


def _media(task: str, episode: int, steps: int, depths: bool = True) -> set:
    out = {f"{task}/images/episode{episode}/frame_{j:04d}.png" for j in range(steps)}
    if depths:
        out |= {f"{task}/depths/episode{episode}/depth_{j:04d}.npy" for j in range(steps)}
    return out


def _layout(out: Path, want: set, videos: set) -> bool:
    """The output tree is `want`, with the episodes' videos or without them
    (imageio writes mp4 only where it has a backend); True with videos."""
    got = _files(out)
    if got not in (want, want | videos):
        raise AssertionError(f"eval: {out} holds {sorted(got ^ want)[:8]} beyond or short of the reference layout")
    return got == want | videos


def eval_step_profile(torch, policy, trace) -> dict:
    """Where an eval step's time goes: the host's preprocessing of a 640 x
    480 frame (eval_rlbench's: resize, crop, CLIP normalization, mask), then
    predict_action_diff (DDIM-8) on that float frame as the entry calls it,
    and on the uint8 frame resized on the host (the serving host's route,
    CLIP on the card): host wall ms, median of 3, and the device's busy ms
    under torch.profiler (its CUDA activity alone: the kernels' time is all
    it reads), so its idle share, and the seconds the profiles took."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from mla_tpu_torch.eval_rlbench import _frame
    from mla_tpu_torch.native.pointops_host import prepare_pointcloud
    from mla_tpu_torch.serve import _prep_image

    size = policy.cfg.vision.image_size
    frame = trace["images"][1]
    pc = prepare_pointcloud(trace["point_clouds"][1], policy.cfg.point.input_points, cell=EVAL_VOXEL)
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        img = _frame(frame, policy)
        host.append((time.perf_counter() - t0) * 1e3)
    out = {"host_preprocess_ms": float(np.median(host)), "profile_s": 0.0}
    for name, im in (("float", img), ("uint8", _prep_image(frame, size))):
        def call():
            policy.predict_action_diff(im, pc, HTTP_INSTRUCTION, unnorm_key="rlbench")

        call()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        out["profile_s"] += time.perf_counter() - t0
        if busy <= 0:
            raise AssertionError(f"eval step profile ({name}): the profiler saw no device time")
        wall = float(np.median(walls))
        out[name] = {"wall_ms": wall, "device_busy_ms": busy, "idle_share": max(0.0, 1.0 - busy / wall)}
    return out


def _pcts(ms) -> dict:
    import numpy as np

    return {"p50": float(np.percentile(ms, 50)), "p95": float(np.percentile(ms, 95))}


def eval_phase(torch, report):
    """python -m mla_tpu_torch.eval_rlbench through main([...]) on serve-http's
    bf16 mla-7b run dir: the offline replay of EVAL_FRAMES 640 x 480 frames
    with 16 384-point raw clouds (--voxel_cell 0.01) with DDIM-8, then DPM-4;
    then the simulator loop over a stub lift3d RLBenchEnv replaying the
    trace, 2 tasks x 1 episode x 3 steps in --predict_mode diff_ar. Exact
    launches of every run, the chunks' shape, finiteness and gripper, the
    reference output layout, a PNG frame decoded equal to its trace frame,
    results.json; per-step latency percentiles and prepare_pointcloud's host
    ms; one DDIM-8 step profiled (eval_step_profile). Then mla-small (bf16, no int8) through the same entry on the card
    and on the CPU, the same x_T injected: the chunks within AGREE_RTOL.
    Returns the launches of the three counted mla-7b runs."""
    import numpy as np

    from mla_tpu_torch import params as P
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.native.pointops_host import grid_subsample, prepare_pointcloud
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.training.checkpointing import export_reference_pt, write_run_metadata
    from mla_tpu_torch.vla.rlds import png

    readings, totals = {}, {k: 0 for k in EVAL_KERNELS}
    cfg = get_model_config("mla-7b")
    L, S, H, A = cfg.llama.num_layers, cfg.point.num_stages, cfg.action_horizon, cfg.action_dim
    shutil.rmtree(EVAL_ROOT, ignore_errors=True)
    EVAL_ROOT.mkdir(parents=True)
    trace_path = EVAL_ROOT / "trace.npz"
    trace = eval_trace(trace_path, EVAL_FRAMES, 61)

    prep_ms, voxels = [], []
    for c in trace["point_clouds"]:
        t0 = time.perf_counter()
        pts = prepare_pointcloud(c, cfg.point.input_points, cell=EVAL_VOXEL)
        prep_ms.append((time.perf_counter() - t0) * 1e3)
        voxels.append(int(grid_subsample(c, EVAL_VOXEL).shape[0]))
        if pts.shape != (cfg.point.input_points, 3):
            raise AssertionError(f"eval: prepare_pointcloud gave {pts.shape}")
    readings["prepare_pointcloud_ms"], readings["voxels_kept"] = prep_ms, voxels
    log(f"eval: prepare_pointcloud {EVAL_RAW_POINTS} -> {cfg.point.input_points} points (voxel {EVAL_VOXEL} m keeps "
        f"{min(voxels)}-{max(voxels)}) on the host: p50 {np.percentile(prep_ms, 50):.2f} ms, max {max(prep_ms):.2f} ms "
        f"over {EVAL_FRAMES} clouds")

    common = ["--run_dir", str(SERVE_HTTP_ROOT / "mla-7b"), "--model", "mla-7b", "--unnorm_key", "rlbench",
              "--device", "cuda", "--voxel_cell", str(EVAL_VOXEL)]
    per_chunk = {"flash_attention": L, "furthest_point_sample": S, "w8a8_matmul": 0, "int8_matmul": 0}
    videos = {"offline/videos/episode0_video_steps.mp4"}
    # the gripper is binarized to 0 or 1 before the q01/q99 map
    low, high = (SERVE_STATS["rlbench"]["action"][q][-1] for q in ("q01", "q99"))
    gripper = {0.5 * (b + 1) * (high - low) + low for b in (0.0, 1.0)}
    for name, extra in (("DDIM-8", ()), ("DPM-4", ("--sampler", "dpm", "--num_dpm_steps", "4"))):
        out = EVAL_ROOT / name
        cuda.launches.clear()
        t0 = time.perf_counter()
        _eval_run(torch, common + ["--offline_trace", str(trace_path), "--output_dir", str(out), *extra])
        wall = time.perf_counter() - t0
        got = {k: cuda.launches[k] for k in EVAL_KERNELS}
        check_launches(got, {k: v * EVAL_FRAMES for k, v in per_chunk.items()}, f"eval offline {name}")
        for k in EVAL_KERNELS:
            totals[k] += got[k]
        blob = np.load(out / "predicted_actions.npz")
        a, lat = blob["actions"], blob["latencies"] * 1e3
        if a.shape != (EVAL_FRAMES, H, A) or not np.isfinite(a).all() or not set(np.unique(a[..., -1])) <= gripper:
            raise AssertionError(f"eval offline {name}: actions {a.shape}, finite {np.isfinite(a).all()}, gripper "
                                 f"{np.unique(a[..., -1])[:4]}")
        video = _layout(out, {"eval.log", "predicted_actions.npz"} | _media("offline", 0, EVAL_FRAMES), videos)
        last = EVAL_FRAMES - 1
        frame = png.decode((out / f"offline/images/episode0/frame_{last:04d}.png").read_bytes())
        if not np.array_equal(frame, trace["images"][last]):
            raise AssertionError(f"eval offline {name}: the written frame {last} is not the trace's")
        readings[name] = {"step_ms": lat.tolist(), "warm": _pcts(lat[1:]), "wall_s": wall, "launches": got,
                          "video": video}
        log(f"eval offline {name}: {EVAL_FRAMES} steps in {wall:.1f} s (load_vla included), step ms "
            f"{[round(float(x), 1) for x in lat]}: p50 {np.percentile(lat[1:], 50):.1f}, p95 "
            f"{np.percentile(lat[1:], 95):.1f} (steps 2-{EVAL_FRAMES}); launches {got} "
            f"({per_chunk['flash_attention']} flash and {S} FPS a chunk); layout as the reference's"
            f"{', with' if video else ', without'} the mp4")

    EvalEnv.trace, EvalEnv.steps, EvalEnv.closed = trace, [], []
    stubs = {"lift3d": None, "lift3d.envs": None, "lift3d.envs.rlbench_env": None}
    for mod in stubs:
        stubs[mod] = sys.modules.get(mod)
        sys.modules[mod] = type(sys)(mod)
    sys.modules["lift3d.envs.rlbench_env"].RLBenchEnv = EvalEnv
    out, timings, kept = EVAL_ROOT / "sim", [], []
    try:
        cuda.launches.clear()
        t0 = time.perf_counter()
        _eval_run(torch, common + ["--tasks", *EVAL_TASKS, "--num_episodes", str(EVAL_EPISODES), "--max_steps",
                                   str(EVAL_STEPS), "--predict_mode", "diff_ar", "--output_dir", str(out)],
                  timings=timings, keep=kept)
        wall = time.perf_counter() - t0
        got = {k: cuda.launches[k] for k in EVAL_KERNELS}
    finally:
        for mod, old in stubs.items():
            if old is None:
                sys.modules.pop(mod, None)
            else:
                sys.modules[mod] = old
    steps = len(EVAL_TASKS) * EVAL_EPISODES * EVAL_STEPS
    # a diff_ar step: predict_action_ar's prefill (P = 535) and
    # predict_action_diff's (P = 534) through flash, each front-end pass 2 FPS;
    # the decode steps and the suffix evaluations attend plainly
    check_launches(got, {k: 2 * v * steps for k, v in per_chunk.items()}, "eval simulator diff_ar")
    for k in EVAL_KERNELS:
        totals[k] += got[k]
    if len(EvalEnv.steps) != steps or EvalEnv.closed != list(EVAL_TASKS) or len(timings) != steps:
        raise AssertionError(f"eval simulator: {len(EvalEnv.steps)} steps, teardowns {EvalEnv.closed}, "
                             f"{len(timings)} timed")
    for task, action in EvalEnv.steps:
        if np.asarray(action).shape != (A,) or not np.isfinite(action).all():
            raise AssertionError(f"eval simulator {task}: executed action {np.asarray(action).shape}")
    if json.loads((out / "results.json").read_text()) != {"close_box": 1.0, "close_fridge": 0.0}:
        raise AssertionError(f"eval simulator: results {(out / 'results.json').read_text()}")
    text = (out / "eval.log").read_text()
    episodes = len(EVAL_TASKS) * EVAL_EPISODES
    if not (text.count("average ar infer time") == text.count("average diff infer time") == episodes
            and (out / "close_box_success_rate.txt").read_text() == "1.0000\n"
            and (out / "close_fridge_success_rate.txt").read_text() == "0.0000\n"):
        raise AssertionError("eval simulator: the log's telemetry lines or the success-rate files")
    want = {"eval.log", "results.json"} | {f"{t}_success_rate.txt" for t in EVAL_TASKS}
    vids = set()
    for task in EVAL_TASKS:
        for ep in range(EVAL_EPISODES):
            want |= _media(task, ep, EVAL_STEPS)
            vids.add(f"{task}/videos/episode{ep}_video_steps.mp4")
    video = _layout(out, want, vids)
    ar_ms, diff_ms = (np.array([out_["timings"][i] for out_ in timings]) * 1e3 for i in (0, 1))
    readings["diff_ar"] = {"ar_ms": ar_ms.tolist(), "diff_ms": diff_ms.tolist(), "ar": _pcts(ar_ms[1:]),
                           "diff": _pcts(diff_ms[1:]), "wall_s": wall, "launches": got, "video": video}
    log(f"eval simulator diff_ar: {len(EVAL_TASKS)} tasks x {EVAL_EPISODES} episodes x {EVAL_STEPS} steps in "
        f"{wall:.1f} s, results {{'close_box': 1.0, 'close_fridge': 0.0}}; AR head ms p50 "
        f"{np.percentile(ar_ms[1:], 50):.1f}, p95 {np.percentile(ar_ms[1:], 95):.1f}; diffusion head (DDIM-8) ms p50 "
        f"{np.percentile(diff_ms[1:], 50):.1f}, p95 {np.percentile(diff_ms[1:], 95):.1f} (steps 2-{steps}); "
        f"launches {got} ({2 * L} flash and {2 * S} FPS a step); layout as the reference's"
        f"{', with' if video else ', without'} the mp4s")
    prof = readings["step_profile"] = eval_step_profile(torch, kept[0], trace)
    log(f"eval step profile (DDIM-8, B = 1): the host's preprocessing of a 640 x 480 frame "
        f"{prof['host_preprocess_ms']:.1f} ms, then predict_action_diff on the float frame "
        f"{prof['float']['wall_ms']:.1f} ms (device busy {prof['float']['device_busy_ms']:.1f}, idle share "
        f"{prof['float']['idle_share']:.3f}); on the uint8 frame (CLIP on the card) {prof['uint8']['wall_ms']:.1f} "
        f"ms (busy {prof['uint8']['device_busy_ms']:.1f}, idle {prof['uint8']['idle_share']:.3f}); the two profiles "
        f"{prof['profile_s']:.1f} s")
    del kept
    gc.collect()
    torch.cuda.empty_cache()

    # the card against the CPU through the same entry: mla-small, no int8
    scfg = get_model_config("mla-small")
    small = EVAL_ROOT / "mla-small"
    params, state = P.init(scfg, seed=63, device="cpu")
    live_head(torch, params, 64)
    write_run_metadata(small, {"base_vlm": "mla-small"}, scfg, SERVE_STATS)
    (small / "checkpoints").mkdir()
    export_reference_pt(small / "checkpoints" / "mla-small.pt", {"params": params, "model_state": state}, scfg)
    del params, state
    short = EVAL_ROOT / "trace_agree.npz"
    eval_trace(short, EVAL_AGREE_FRAMES, 62)
    noise = np.random.default_rng(65).standard_normal((scfg.action_horizon, scfg.action_dim)).astype(np.float32)
    chunks = {}
    for dev in ("cuda", "cpu"):
        out = EVAL_ROOT / f"agree_{dev}"
        t0 = time.perf_counter()
        _eval_run(torch, ["--run_dir", str(small), "--model", "mla-small", "--unnorm_key", "rlbench", "--device",
                          dev, "--voxel_cell", str(EVAL_VOXEL), "--offline_trace", str(short), "--output_dir", str(out),
                          "--no-save_media"], noise=noise)
        chunks[dev] = np.load(out / "predicted_actions.npz")["actions"]
        log(f"eval agree mla-small on {dev}: {EVAL_AGREE_FRAMES} frames in {time.perf_counter() - t0:.1f} s")
    card, cpu = chunks["cuda"], chunks["cpu"]
    scale = float(np.abs(cpu).max())
    err = float(np.abs(card - cpu).max())
    other = float(np.abs(card[1] - cpu[0]).max())
    readings["agree"] = {"max_abs_err": err, "scale": scale, "rtol": AGREE_RTOL, "another_frame": other}
    log(f"eval agree: the card's normalized chunks vs the CPU's (same run dir, frames, x_T): max err {err:.4e}, scale "
        f"{scale:.4e}, rel {err / scale:.4e} (tol {AGREE_RTOL}); another frame's chunk differs by {other:.4e} "
        f"(a reading)")
    if card.shape != (EVAL_AGREE_FRAMES, scfg.action_horizon, scfg.action_dim) or not err <= AGREE_RTOL * scale:
        raise AssertionError(f"eval agree: card vs CPU {err} against scale {scale}")
    report["eval"] = readings
    shutil.rmtree(EVAL_ROOT, ignore_errors=True)
    return totals


# --------------------------------------------------------------------------- #
# the diffusion modules off the policy's path: DiT-B's loss, the bound, bpd
# --------------------------------------------------------------------------- #

# CogACT's action head (DiT-B on a 4096-wide condition) at B = 64, fp32 with
# TF32 off (main turns it off): card against CPU on the same inputs and
# draws. The sums of the products run in other orders (~1e-6 relative
# through 12 blocks), and the KL terms divide by posterior variances down to
# ~1e-4, which scales that up
DIFF_B, DIFF_BPD_ROWS, DIFF_RTOL = 64, 4, 1e-4
# the decoder's term at t = 0 is log(cdf_plus - cdf_min); where a bin's mass
# is tiny but its fp32 cdfs are not saturated, that difference is a few ulps
# of ~1 and keeps no correct digit on either device (each rounds its own
# tanh): such an element may move its row's mean by up to ILL_GAP nats
ILL_MASS = 1e-5
ILL_GAP = math.log(ILL_MASS) + 1.0 - math.log(1e-12)


def decoder_ill(x0, mean, log_var):
    """[rows, elements]: the decoder term's elements whose bin mass, in
    float64, lies under ILL_MASS."""
    import numpy as np

    x, m, s = (np.asarray(a.detach().float().cpu() if hasattr(a, "detach") else a, np.float64)
               for a in (x0, mean, log_var))

    def cdf(v):
        return 0.5 * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (v + 0.044715 * v**3)))

    inv = np.exp(-0.5 * s)
    plus, minus = cdf(inv * (x - m + 1 / 255)), cdf(inv * (x - m - 1 / 255))
    mass = np.where(x < -0.999, plus, np.where(x > 0.999, 1 - minus, plus - minus))
    return (mass < ILL_MASS).reshape(len(x), -1)


def bits_close(got, want, ill, scale: float = 1.0):
    """(worst |got - want| / |want|, within DIFF_RTOL and the slack):
    per-row values, the rows' decoder elements in `ill` each allowed
    ILL_GAP nats over the row's mean (times `scale`). Rows of a [rows, T]
    array (the loop's per-step terms) are held to DIFF_RTOL of their own
    largest magnitude: at the smallest t, x_0 -> eps divides by
    sqrt(1 / alpha_bar - 1) ~ 1e-2, which scales fp32 rounding up where
    the terms are smallest."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    slack = np.asarray(ill).sum(1) * ILL_GAP / (np.asarray(ill).shape[1] * np.log(2.0)) * scale
    slack = slack.reshape(slack.shape + (1,) * (got.ndim - 1))
    ref = np.abs(want) if want.ndim == 1 else np.abs(want).max(axis=1, keepdims=True)
    return float((np.abs(got - want) / np.maximum(ref, 1e-30)).max()), \
        bool((np.abs(got - want) <= DIFF_RTOL * ref + slack).all())


def diffusion(torch, report):
    """dit_loss forward and backward, training_losses (MSE, KL,
    RESCALED_KL) and calc_bpd_loop over all 100 steps on DiT-B at B = 64,
    fp32, on the card and on the CPU from the same weights, inputs and
    replayed draws (noise, t, the condition dropout; the loop's per-step
    noise): the loss and each gradient leaf, each row's losses and the
    loop's outputs within DIFF_RTOL (the loop on the CPU for its first
    DIFF_BPD_ROWS rows, which it computes independently of the others). The
    seconds each took on each device."""
    import numpy as np

    from mla_tpu_torch import params as P
    from mla_tpu_torch.diffusion import gaussian as gd
    from mla_tpu_torch.diffusion import likelihood as lk
    from mla_tpu_torch.models import action_model as am

    cfg = am.dit_config("DiT-B", token_size=4096, in_channels=7, future_action_window_size=15)
    base = am.dit_init(cfg, seed=71, device="cpu")
    fc2 = base["final_layer"]["mlp"]["fc2"]  # zero in the reference init
    fc2["w"] = torch.randn(fc2["w"].shape, generator=torch.Generator().manual_seed(72)) * 0.02
    sched = gd.create_schedule("")
    T, H, C = sched.num_timesteps, cfg.future_action_window_size + 1, cfg.in_channels
    rng = np.random.default_rng(73)
    x = np.clip(rng.normal(0, 0.5, (DIFF_B, H, C)), -1, 1).astype(np.float32)
    z = rng.normal(size=(DIFF_B, 1, cfg.token_size)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    t = (np.arange(DIFF_B) * 37 % T).astype(np.int64)  # t = 0 in row 0, the rest spread over the schedule
    drop = (rng.uniform(size=DIFF_B) < 0.25).astype(np.int64)
    bpd_noise = rng.standard_normal((T, DIFF_B) + x.shape[1:]).astype(np.float32)
    losses = (lk.LossType.MSE, lk.LossType.KL, lk.LossType.RESCALED_KL)
    res, secs = {}, {}

    def timed(dev, key, fn):
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if dev == "cuda":
            torch.cuda.synchronize()
        secs.setdefault(dev, {})[key] = time.perf_counter() - t0
        return out

    for dev in ("cuda", "cpu"):
        p = P.tree_to(base, dev)
        leaves = dict(P.tree_items(p))
        for v in leaves.values():
            v.requires_grad_()
        X, Z, N, TT, D = (torch.from_numpy(a).to(dev) for a in (x, z, noise, t, drop))
        out = {}

        def loss_backward():
            loss = am.dit_loss(p, cfg, sched, X, Z, None, override_noise=N, override_t=TT, override_drop=D)
            loss.backward()
            return loss

        out["dit_loss"] = float(timed(dev, "dit_loss fwd+bwd", loss_backward).detach())
        out["grads"] = {k: v.grad.detach().cpu().numpy() for k, v in leaves.items()}
        with torch.no_grad():
            def fn(xx, tt):
                return am.dit_forward(p, cfg, xx, tt, Z[: xx.shape[0]])

            for lt in losses:
                out[lt.name] = timed(dev, f"training_losses {lt.name}", lambda: lk.training_losses(
                    sched, fn, X, TT, N, loss_type=lt)["loss"]).cpu().numpy()
            rows = DIFF_B if dev == "cuda" else DIFF_BPD_ROWS
            bpd = timed(dev, f"calc_bpd_loop {T} steps, {rows} rows", lambda: lk.calc_bpd_loop(
                sched, fn, X[:rows], noise=torch.from_numpy(bpd_noise[:, :rows]).to(dev)))
            out["bpd"] = {k: v.cpu().numpy() for k, v in bpd.items()}
            if dev == "cuda":  # the decoder terms' moments, the card's: rows with t = 0, the loop's last step
                m = lk.p_mean_variance(sched, fn, gd.q_sample(sched, X, TT, N), TT, clip_denoised=False)
                out["ill_losses"] = decoder_ill(x, m["mean"], m["log_variance"]) & (t == 0)[:, None]
                t0s = torch.zeros((DIFF_BPD_ROWS,), dtype=torch.long, device=dev)
                x1 = gd.q_sample(sched, X[:DIFF_BPD_ROWS], t0s, torch.from_numpy(bpd_noise[-1, :DIFF_BPD_ROWS]).to(dev))
                m = lk.p_mean_variance(sched, fn, x1, t0s)
                out["ill_bpd"] = decoder_ill(x[:DIFF_BPD_ROWS], m["mean"], m["log_variance"])
        res[dev] = out
        del p, leaves
    card, cpu = res["cuda"], res["cpu"]
    k = DIFF_BPD_ROWS
    errs, oks = {}, {}
    errs["dit_loss"] = abs(card["dit_loss"] - cpu["dit_loss"]) / abs(cpu["dit_loss"])
    oks["dit_loss"] = errs["dit_loss"] <= DIFF_RTOL
    g = max(float(np.abs(card["grads"][n] - cpu["grads"][n]).max()) / max(float(np.abs(cpu["grads"][n]).max()), 1e-30)
            for n in cpu["grads"])
    errs["gradient leaves (of their scale)"], oks["gradient leaves (of their scale)"] = g, g <= DIFF_RTOL
    none = np.zeros((DIFF_B, 1), bool)
    for lt in losses:
        errs[lt.name], oks[lt.name] = bits_close(card[lt.name], cpu[lt.name],
                                                 card["ill_losses"] if lt.is_vb() else none,
                                                 T if lt == lk.LossType.RESCALED_KL else 1.0)
    cb, pb = card["bpd"], cpu["bpd"]
    for name in ("prior_bpd", "xstart_mse", "mse"):
        errs[f"bpd {name}"], oks[f"bpd {name}"] = bits_close(cb[name][:k], pb[name], np.zeros((k, 1), bool))
    errs["bpd vb, t > 0"], oks["bpd vb, t > 0"] = bits_close(cb["vb"][:k, :-1], pb["vb"][:, :-1],
                                                             np.zeros((k, 1), bool))
    for name, got, want in (("bpd vb, t = 0", cb["vb"][:k, -1], pb["vb"][:, -1]),
                            ("bpd total_bpd", cb["total_bpd"][:k], pb["total_bpd"])):
        errs[name], oks[name] = bits_close(got, want, card["ill_bpd"])
    finite = all(np.isfinite(v).all() for v in cb.values()) and all(np.isfinite(card[lt.name]).all() for lt in losses)
    ill = {"training_losses t = 0 rows": int(card["ill_losses"].sum()), "bpd t = 0": int(card["ill_bpd"].sum())}
    report["diffusion"] = {"rel_err": errs, "ok": oks, "seconds": secs, "rtol": DIFF_RTOL, "ill_conditioned": ill,
                           "tf32": bool(torch.backends.cuda.matmul.allow_tf32)}
    log(f"diffusion DiT-B B={DIFF_B} fp32 (TF32 {'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}), card vs "
        f"CPU, relative errors (tol {DIFF_RTOL}; decoder elements with a bin mass under {ILL_MASS}: {ill}): "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    for dev in ("cuda", "cpu"):
        log(f"diffusion seconds on {dev}: " + ", ".join(f"{n} {s:.3f}" for n, s in secs[dev].items()))
    if not finite or not all(oks.values()):
        raise AssertionError(f"diffusion: card vs CPU out of tolerance {[n for n, ok in oks.items() if not ok]} "
                             f"or non-finite ({finite})")



TRAIN_AGREE_RTOL = 2e-3
TRAIN_STEPS = 3  # steps of each train phase: the first, then two timed


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
        step = strategy.make_train_step(cfg, tcfg, sched)
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


def llama_step_counts(cfg) -> dict:
    """The launches of one llama training step with remat: the flash
    forward twice a layer (the forward and its recompute), dQ and dK/dV
    once, FPS once a point-tokenizer stage, no int8 product."""
    L = cfg.llama.num_layers
    return {"flash_attention": 2 * L, "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
            "furthest_point_sample": cfg.point.num_stages, "w8a8_matmul": 0, "int8_matmul": 0}


def train(torch, report):
    """mla-2b through train_step: TRAIN_STEPS AdamW steps at B = 8, S = 563,
    remat on, llama_step_counts a step."""
    return train_steps(torch, report, "train", "mla-2b", llama_step_counts, {})


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
    TRAIN_STEPS AdamW steps at B = 8, S = 819, remat on; the three
    generation losses and the tactile contrastive loss non-zero, the frozen
    vision towers without gradients and unchanged, llama_step_counts a
    step."""
    from mla_tpu_torch import train_step as ts

    return train_steps(torch, report, "post-train", "mla-2b", llama_step_counts, dict(ts.POST_FRANKA))


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
         lambda: policy.predict_action_batch([r[0] for r in reqs[:2]], [r[1] for r in reqs[:2]], list(INSTRUCTIONS),
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
    """The full mla-phi through train_step: TRAIN_STEPS AdamW steps at B =
    8, S = 563, remat on; FPS 2 a step and no other launch (head_dim 80)."""
    return train_steps(torch, report, "phi-train", "mla-phi", lambda cfg: phi_counts(), {})


# --------------------------------------------------------------------------- #
# mla-mistral (Mistral-7B widths, GQA 32:8, intermediate 14336): served in
# int8 (W8A8 chunks, weight-only AR) at full depth and trained at 8 layers;
# the int4 weight path (mla-7b-int4: int4 products in plain PyTorch, as JAX
# runs them in XLA); Phi-2 post-training; the point-cloud library
# --------------------------------------------------------------------------- #

# (K, N) of mla-mistral's fused q|k|v (32 + 2 x 8 heads of 128), o, fused
# gate|up and down linears
MISTRAL_LINEARS = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)]
MISTRAL_W8A8_M = (PREFIX_LEN, SUFFIX_LEN)
MISTRAL_INT8_M = INT8_M
MISTRAL_AGREE_LAYERS = 4
# the narrow GQA model of the agreement checks: mla-small's widths with
# Mistral's 4:1 heads and its MLP ratio
MISTRAL_NARROW = dict(hidden_size=1024, intermediate_size=3584, num_heads=8, num_kv_heads=2, contrastive_layer=2)
MISTRAL_TRAIN_PARAMS = 1.745e9  # the 8-layer decoder's N, for MFU by 6N
INT4_AGREE_LAYERS = 4
# pointlib: KMeansEmbed's grouping of raw clouds (8192 points, 256 groups)
POINTLIB_B, POINTLIB_N, POINTLIB_GROUPS = 8, 8192, 256
# card vs CPU k-means: the centroids' fp32 sums differ in order, so a point
# equidistant to two centroids within that may change sides; at most this
# share of the labels may differ, each of them such a near tie
POINTLIB_LABEL_SHARE = 1e-3
POINTLIB_RTOL = 1e-4


def check_mistral_kernels(torch, report, w8a8_control, int8_control):
    """W8A8 and int8_mm at mla-mistral's shapes: W8A8 at M = 534 and 18 by
    MISTRAL_LINEARS, int32 accumulators identical to the plain version's,
    the control (last K tile dropped) missed at every shape; int8_mm at M =
    1, 4, 535 by the same linears, each column within INT8_COL_RTOL, two
    launches identical, the control missed. Each timed (CUDA graphs,
    weights cycled past L2) beside its plain version, the PyTorch call and
    the bound; one layer's sum per row count."""
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.ops import quantization as q

    gen = torch.Generator(device="cuda").manual_seed(40)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    readings = {"w8a8": {}, "int8_mm": {}}
    for M in MISTRAL_W8A8_M:
        layer = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        for K, N in MISTRAL_LINEARS:
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            copies = weight_copies(torch, gen, K, N)
            kmajor = [c.t().contiguous() for c in copies]
            ws = torch.rand((N,), generator=gen, device="cuda") * 1e-3 + 1e-4
            y, acc = q.w8a8_matmul(x, kmajor[0], ws, return_acc=True)
            yp, accp = q.w8a8_matmul_plain(x, copies[0].t(), ws, return_acc=True)
            with kernel_from(cuda, "w8a8", w8a8_control):
                _, acc_c = q.w8a8_matmul(x, kmajor[0], ws, return_acc=True)
            torch.cuda.synchronize()
            where = f"mistral w8a8 M={M} K={K} N={N}"
            if not torch.equal(acc, accp) or not torch.equal(y, yp):
                raise AssertionError(f"{where}: the kernel differs from the plain version "
                                     f"({int((acc != accp).sum())} accumulators)")
            if torch.equal(acc_c, accp):
                raise AssertionError(f"{where}: the check passes the control")

            def library(w):
                xq, sx = q.quantize_rows(x)
                return (torch._int_mm(xq, w).float() * sx * ws).to(torch.bfloat16)

            cyc, cyc_lib = itertools.cycle(kmajor), itertools.cycle(copies)
            ms = graph_ms(torch, lambda: q.w8a8_matmul(x, next(cyc), ws))
            plain_ms = cuda_ms(torch, lambda: q.w8a8_matmul_plain(x, kmajor[0], ws), 3, 1)
            lib_ms = graph_ms(torch, lambda: library(next(cyc_lib)))
            b, by = bound_ms(M * K * 2 + K * N + N * 4 + M * N * 2, 2.0 * M * K * N, "int8")
            plan = q.w8a8_plan(M, K, N, sms)
            log(f"{where}: acc identical, control missed in {int((acc_c != accp).sum())} entries; kernel {ms:.4f} ms "
                f"({'narrow' if plan.narrow else 'wide'}, {plan.tiles} tiles x {plan.splits} splits), plain "
                f"{plain_ms:.4f} ms, _int_mm {lib_ms:.4f} ms, bound {b:.4f} ms ({by})")
            report["shapes"].append({"kernel": "w8a8_matmul", "model": "mla-mistral", "M": M, "K": K, "N": N,
                                     "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b,
                                     "bound_by": by, "max_abs_err": 0.0, "splits": plan.splits,
                                     "narrow": plan.narrow})
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms), ("bound_ms", b)):
                layer[k] += v
            del copies, kmajor
        readings["w8a8"][M] = layer
        log(f"mistral w8a8 M={M}: one layer's 4 linears {layer['ms']:.4f} ms, plain {layer['plain_ms']:.4f} ms, "
            f"_int_mm {layer['library_ms']:.4f} ms, bound {layer['bound_ms']:.4f} ms")
    for M in MISTRAL_INT8_M:
        layer = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        for K, N in MISTRAL_LINEARS:
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            copies = weight_copies(torch, gen, K, N)
            ws = torch.rand((N,), generator=gen, device="cuda") * 1e-3 + 1e-4
            y, again, want = (q.int8_matmul(x, copies[0], ws), q.int8_matmul(x, copies[0], ws),
                              q.int8_matmul_plain(x, copies[0], ws))
            with kernel_from(cuda, "int8_mm", int8_control):
                bad = q.int8_matmul(x, copies[0], ws)
            torch.cuda.synchronize()
            where = f"mistral int8_mm M={M} K={K} N={N}"
            rel, rel_c = col_rel_err(y, want), col_rel_err(bad, want)
            if not torch.equal(y, again):
                raise AssertionError(f"{where}: two launches differ")
            if not rel <= INT8_COL_RTOL:
                raise AssertionError(f"{where}: a column is {rel} of its norm from the plain version")
            if not rel_c > INT8_COL_RTOL:
                raise AssertionError(f"{where}: the check passes the control ({rel_c})")
            cyc = itertools.cycle(copies)
            ms = graph_ms(torch, lambda: q.int8_matmul(x, next(cyc), ws))
            plain_ms = cuda_ms(torch, lambda: q.int8_matmul_plain(x, copies[0], ws), 3, 1)
            w_t = itertools.cycle([c.t().contiguous() for c in copies])
            s_b = ws.to(torch.bfloat16)
            lib_ms = graph_ms(torch, lambda: torch._weight_int8pack_mm(x, next(w_t), s_b))
            b, by = bound_ms(M * K * 2 + K * N + N * 4 + M * N * 2, 2.0 * M * K * N, "bf16")
            plan = q.int8_mm_plan(M, K, N, sms, False)
            log(f"{where}: columns within {rel:.3e} (tol {INT8_COL_RTOL}), control {rel_c:.3e}; kernel {ms:.4f} ms "
                f"({'narrow' if plan.narrow else 'wide'}, {plan.tiles} tiles x {plan.splits} splits), plain "
                f"{plain_ms:.4f} ms, _weight_int8pack_mm {lib_ms:.4f} ms, bound {b:.4f} ms ({by})")
            report["shapes"].append({"kernel": "int8_matmul", "model": "mla-mistral", "M": M, "K": K, "N": N,
                                     "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b,
                                     "bound_by": by, "max_abs_err": float((y.float() - want.float()).abs().max()),
                                     "col_rel_err": rel, "control_col_rel_err": rel_c, "narrow": plan.narrow,
                                     "splits": plan.splits})
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms), ("bound_ms", b)):
                layer[k] += v
            del copies, w_t
        readings["int8_mm"][M] = layer
        log(f"mistral int8_mm M={M}: one layer's 4 linears {layer['ms']:.4f} ms, plain {layer['plain_ms']:.4f} ms, "
            f"_weight_int8pack_mm {layer['library_ms']:.4f} ms, bound {layer['bound_ms']:.4f} ms")
    report["mistral_kernels"] = readings


def check_fps_pointlib(torch, report, control):
    """FPS at pointlib's k-means start, POINTLIB_N -> POINTLIB_GROUPS points,
    B = POINTLIB_B: indices identical to the plain version's at starts 0
    and 7, the control (the last point left out) missed; timed beside its
    plain version and the bound."""
    from mla_tpu_torch.ops import cuda, pointops

    gen = torch.Generator(device="cuda").manual_seed(41)
    B, N, npoint = POINTLIB_B, POINTLIB_N, POINTLIB_GROUPS
    xyz = torch.rand((B, N, 3), generator=gen, device="cuda")
    xyz[-1, -1] = 2.0
    differs = 0
    for start in (0, 7):
        s = torch.full((B,), start, dtype=torch.int32, device="cuda")
        got, want = pointops.furthest_point_sample(xyz, npoint, s), pointops.furthest_point_sample_plain(xyz, npoint, s)
        with kernel_from(cuda, "fps", control):
            bad = pointops.furthest_point_sample(xyz, npoint, s)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fps B={B} N={N} npoint={npoint} start={start}: indices differ")
        differs += int((bad != want).sum())
    if differs == 0:
        raise AssertionError(f"fps N={N} npoint={npoint}: the check passes the control")
    out = torch.empty((B, npoint), dtype=torch.int32, device="cuda")
    zero = torch.zeros((B,), dtype=torch.int32, device="cuda")
    ms = graph_ms(torch, lambda: cuda.call("fps", xyz.data_ptr(), zero.data_ptr(), out.data_ptr(), B, N, npoint), 10)
    plain_ms = cuda_ms(torch, lambda: pointops.furthest_point_sample_plain(xyz, npoint, zero), 2, 1)
    b, by = bound_ms(B * (N * 12 + npoint * 4), 9.0 * B * N * npoint, "fp32")
    log(f"fps B={B} N={N} npoint={npoint} (pointlib's k-means start): indices identical at starts 0 and 7, the "
        f"control differs in {differs}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.6f} ms ({by})")
    report["shapes"].append({"kernel": "furthest_point_sample", "model": "pointlib", "B": B, "N": N,
                             "npoint": npoint, "ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": b,
                             "bound_by": by, "max_abs_err": 0.0, "control_differs": differs})


def mistral_config(num_layers: int = None, **narrow):
    """mla-mistral (bf16, Mistral-7B widths, full-width front-ends), its
    decoder cut to num_layers or narrowed by `narrow` (LlamaConfig fields)."""
    from dataclasses import replace

    from mla_tpu_torch.conf.models import get_model_config

    cfg = get_model_config("mla-mistral")
    if num_layers is not None:
        narrow["num_layers"] = num_layers
    return replace(cfg, llama=replace(cfg.llama, **narrow))


def int8_agree(torch, report, key: str, cfg, seed: int, control):
    """An int8 model card vs CPU from the same weights: a W8A8 DDIM-8 chunk
    within AGREE_RTOL of its scale; the weight-only prefill and 7 decode
    steps fed the CPU's greedy ids, fp32 logits within AR_AGREE_RTOL, the
    card's run through the int8_mm control outside it."""
    from mla_tpu_torch import params as P
    from mla_tpu_torch.models.mla import MLAPolicy
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.ops.quantization import quantize_model

    params, state = P.init(cfg, seed=seed, device="cpu")
    live_head(torch, params, seed + 1)
    params = quantize_model(params)
    img, pc, ids, noise = request_inputs(cfg, seed + 2)
    chunk = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        pol = MLAPolicy(params, state, cfg, device=dev)
        chunk[dev] = pol.predict_action_diff(img, pc, "", input_ids=ids, noise=noise, return_normalized=True)
        log(f"{key} W8A8 DDIM-8 on {dev}: {time.perf_counter() - t0:.2f} s")
    scale, err = float(abs(chunk["cpu"]).max()), float(abs(chunk["cuda"] - chunk["cpu"]).max())
    T = cfg.action_dim
    pols = {dev: MLAPolicy(params, state, cfg, device=dev, int8_mode="weight_only") for dev in ("cuda", "cpu")}
    cpu, cpu_ids, _ = drive_ar(torch, pols["cpu"], img, pc, ids, T)
    gpu, _, ar_s = drive_ar(torch, pols["cuda"], img, pc, ids, T, cpu_ids)
    with kernel_from(cuda, "int8_mm", control):
        ctrl, _, _ = drive_ar(torch, pols["cuda"], img, pc, ids, T, cpu_ids)
    lscale = float(cpu.abs().max())
    lerr, lerr_c = float((gpu - cpu).abs().max()), float((ctrl - cpu).abs().max())
    log(f"{key}: chunk max |gpu - cpu| {err:.4e} of scale {scale:.4e}, rel {err / scale:.4e} (tol {AGREE_RTOL}); "
        f"AR logits rel {lerr / lscale:.4e} (tol {AR_AGREE_RTOL}, card prefill + {T} steps {ar_s:.2f} s), the "
        f"int8_mm control rel {lerr_c / lscale:.4e}; CPU ids {cpu_ids}")
    report[key.replace("-", "_")] = {"chunk_max_abs_err": err, "chunk_scale": scale, "rtol": AGREE_RTOL,
                                     "logits_max_abs_err": lerr, "logits_scale": lscale, "ar_rtol": AR_AGREE_RTOL,
                                     "control_logits_max_abs_err": lerr_c, "cpu_ids": cpu_ids}
    if not (chunk["cuda"].shape == (cfg.action_horizon, cfg.action_dim) and err <= AGREE_RTOL * scale):
        raise AssertionError(f"{key}: GPU and CPU chunks disagree: {err} vs scale {scale}")
    if not lerr <= AR_AGREE_RTOL * lscale:
        raise AssertionError(f"{key}: GPU and CPU logits disagree: {lerr} vs scale {lscale}")
    if not lerr_c > AR_AGREE_RTOL * lscale:
        raise AssertionError(f"{key} passes the int8_mm control: {lerr_c} vs scale {lscale}")


def check_mistral_agreement(torch, report, control):
    """A narrow GQA mla-mistral (MISTRAL_NARROW, 4 layers) in int8, card vs
    CPU: int8_agree."""
    cfg = mistral_config(MISTRAL_AGREE_LAYERS, **MISTRAL_NARROW)
    int8_agree(torch, report, "mistral-agree", cfg, 50, control)


def serve_calls(torch, key: str, policy, cfg, expected: dict, requests: int = REQUESTS, samplers=("ddim", "dpm"),
                ar: bool = False) -> dict:
    """`requests` chunks a sampler (and, with ar, predict_action_ar) through
    the policy after one warm-up each: finite outputs of their shapes, each
    call's launches expected[call], the launch counts set to 0 before the
    timed calls; returns {call: [ms]} and the totals."""
    import numpy as np

    from mla_tpu_torch.ops import cuda

    img, pc, ids, noise = request_inputs(cfg, 100)
    calls = {s: (lambda s=s: policy.predict_action_diff(img, pc, "", input_ids=ids, noise=noise, sampler=s))
             for s in samplers}
    if ar:
        calls["ar"] = lambda: policy.predict_action_ar(img, pc, "", input_ids=ids)
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    cuda.launches.clear()
    lat = {name: [] for name in calls}
    for i in range(requests):
        img, pc, ids, noise = request_inputs(cfg, i)
        for name, fn in calls.items():
            before = dict(cuda.launches)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            ms = (time.perf_counter() - t) * 1e3
            counts = {k: cuda.launches[k] - before.get(k, 0) for k in expected[name]}
            shape = (cfg.action_dim,) if name == "ar" else (cfg.action_horizon, cfg.action_dim)
            if out.shape != shape or not np.isfinite(out).all():
                raise AssertionError(f"{key} {name} request {i}: bad shape {out.shape} or non-finite values")
            if counts != expected[name]:
                raise AssertionError(f"{key} {name} request {i}: launches {counts}, expected {expected[name]}")
            lat[name].append(ms)
            log(f"{key} {name} request {i}: {ms:.2f} ms, launches {counts}")
    return {"latency_ms": lat, "p50_ms": {k: float(np.median(v)) for k, v in lat.items()},
            "launches": dict(cuda.launches), "expected_per_call": expected}


def tree_gib(tree) -> float:
    from mla_tpu_torch import params as P

    return sum(t.numel() * t.element_size() for t in P.tree_leaves(tree)) / 2**30


def mistral_serve(torch, report):
    """The int8 mla-mistral at full width and depth from a seeded init on the
    card: W8A8 DDIM-8 and DPM-4 chunks (launches W8A8 4L(1 + 8) / 4L(1 + 4),
    flash L, FPS 2), then a weight-only policy over the same int8 leaves:
    predict_action_ar (int8_matmul 4L x 8 forwards + 8 lm_heads, flash L,
    FPS 2); p50 ms of each."""
    from mla_tpu_torch import params as P
    from mla_tpu_torch.models.mla import MLAPolicy
    from mla_tpu_torch.ops.quantization import quantize_model

    cfg = mistral_config()
    t0 = time.perf_counter()
    params, state = P.init(cfg, seed=51, device="cuda")
    live_head(torch, params, 52)
    params = quantize_model(params)
    torch.cuda.empty_cache()
    L, stages = cfg.llama.num_layers, cfg.point.num_stages
    out = {}
    for mode, calls in (("w8a8", ("ddim", "dpm")), ("weight_only", ("ar",))):
        policy = MLAPolicy(params, state, cfg, norm_stats=STATS, int8_mode=mode)
        torch.cuda.synchronize()
        log(f"mistral-serve: int8 mla-mistral ({L} layers, GQA {cfg.llama.num_heads}:{cfg.llama.num_kv_heads}) "
            f"{mode} policy built on the card ({time.perf_counter() - t0:.1f} s), its tree "
            f"{tree_gib(policy.params):.2f} GiB, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        common = {"flash_attention": L, "furthest_point_sample": stages}
        expected = {"ddim": {**common, "w8a8_matmul": 4 * L * (1 + 8), "int8_matmul": 0},
                    "dpm": {**common, "w8a8_matmul": 4 * L * (1 + 4), "int8_matmul": 0},
                    "ar": {**common, "w8a8_matmul": 0, "int8_matmul": 4 * L * (1 + cfg.action_dim) + 1 + cfg.action_dim}}
        res = serve_calls(torch, "mistral-serve", policy, cfg, {c: expected[c] for c in calls},
                          samplers=[c for c in calls if c != "ar"], ar="ar" in calls)
        res["policy_tree_gib"] = tree_gib(policy.params)
        out[mode] = res
        del policy
        torch.cuda.empty_cache()
    log(f"mistral-serve ({gpu_line()}): p50 DDIM-8 {out['w8a8']['p50_ms']['ddim']:.2f} ms, DPM-4 "
        f"{out['w8a8']['p50_ms']['dpm']:.2f} ms, predict_action_ar {out['weight_only']['p50_ms']['ar']:.2f} ms; "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    report["mistral_serve"] = out
    del params
    return {**out["w8a8"]["launches"], "int8_matmul": out["weight_only"]["launches"].get("int8_matmul", 0)}


def check_mistral_train_agreement(torch, report, control):
    """One AdamW step of the narrow GQA mla-mistral (bf16, 4 layers; B = 2)
    on the card and on the CPU from the same weights, batch and draws: loss
    and grad_norm within TRAIN_AGREE_RTOL; the card's step through the
    flash_bwd control must miss grad_norm."""
    from mla_tpu_torch.vla.dummy import synthetic_batch

    cfg = mistral_config(MISTRAL_AGREE_LAYERS, **MISTRAL_NARROW)
    out = agreement_steps(torch, control, cfg, synthetic_batch(cfg, B=2, L=32, seed=10),
                          ("total_loss", "diff_loss", "img_pc_contrastive_loss", "grad_norm"),
                          "mistral-train-agree narrow GQA mistral bf16 B=2")
    sound = {k: abs(out["cuda"][k] - out["cpu"][k]) / abs(out["cpu"][k]) for k in ("total_loss", "grad_norm")}
    ctrl = {k: abs(out["control"][k] - out["cpu"][k]) / abs(out["cpu"][k]) for k in ("total_loss", "grad_norm")}
    log(f"mistral-train-agree: relative |gpu - cpu| loss {sound['total_loss']:.4e}, grad_norm "
        f"{sound['grad_norm']:.4e} (tol {TRAIN_AGREE_RTOL}); control grad_norm {ctrl['grad_norm']:.4e}")
    report["mistral_train_agree"] = {**out, "rel_err": sound, "control_rel_err": ctrl, "rtol": TRAIN_AGREE_RTOL}
    if not all(v <= TRAIN_AGREE_RTOL for v in sound.values()):
        raise AssertionError(f"GPU and CPU mistral training steps disagree: {sound}")
    if not ctrl["grad_norm"] > TRAIN_AGREE_RTOL:
        raise AssertionError(f"mistral-train-agree passes the control: grad_norm off by {ctrl['grad_norm']}")
    report["mistral_train_agree"]["grads"] = {
        heads: grad_agreement(torch, mistral_config(MISTRAL_AGREE_LAYERS, **{**MISTRAL_NARROW, "num_kv_heads": kv}),
                              f"mistral-train-agree grads {heads}")
        for heads, kv in (("gqa 8:2", MISTRAL_NARROW["num_kv_heads"]), ("mha 8:8", MISTRAL_NARROW["num_heads"]))}


GRAD_LEAVES = ("attn/q/w", "attn/k/w", "attn/v/w", "attn/o/w")


def grad_agreement(torch, cfg, what: str) -> dict:
    """One forward and backward of `cfg` (no optimizer, no clipping) from
    agreement_steps' weights, batch and draws on the card and on the CPU:
    ||g_card - g_cpu|| / ||g_cpu|| of each decoder attention leaf (q, k, v,
    o; stacked over layers) and of the worst leaf, and the global gradient
    norm each way: the fp32 sum of squares of optim.global_norm, the
    fp32 torch.linalg.vector_norm the step took before, and float64."""
    from mla_tpu_torch import params as P
    from mla_tpu_torch.diffusion import gaussian as gd
    from mla_tpu_torch.models import mla as mla_mod
    from mla_tpu_torch.training.strategy import as_tensors
    from mla_tpu_torch.vla.dummy import synthetic_batch

    params, state = P.init(cfg, seed=8, device="cpu")
    if "final_layer" in params:
        live_head(torch, params, 9)
    batch, draws = synthetic_batch(cfg, B=2, L=32, seed=10), _draws(cfg, 2, 11)
    sched = gd.create_schedule("", diffusion_steps=100)
    grads, norms = {}, {}
    for dev in ("cuda", "cpu"):
        p = P.tree_map(lambda t: t.detach().to(dev, copy=True).requires_grad_(t.is_floating_point()), params)
        total, _ = mla_mod.mla_train_loss(p, P.tree_to(state, dev), cfg, sched, as_tensors(batch, dev),
                                          repeated_diffusion_steps=1, remat=True, **draws)
        total.backward()
        g = {path: t.grad.detach() for path, t in P.tree_items(p) if t.grad is not None}
        norms[dev] = {
            "sum_sq_fp32": float(torch.sqrt(sum(torch.sum(torch.square(v.float())) for v in g.values()))),
            "vector_norm_fp32": float(torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(v, dtype=torch.float32) for v in g.values()]))),
            "float64": float(torch.sqrt(sum(torch.sum(torch.square(v.double())) for v in g.values()))),
        }
        grads[dev] = {path: v.float().cpu() for path, v in g.items()}
        del p, total, g
    rel = {path: float((grads["cuda"][path] - w).norm() / max(float(w.norm()), 1e-30))
           for path, w in grads["cpu"].items()}
    total_sq = sum(float(w.double().norm()) ** 2 for w in grads["cpu"].values())
    # each leaf's share of the card-vs-CPU difference of the squared norm
    share = {path: (float(grads["cuda"][path].double().norm()) ** 2 - float(w.double().norm()) ** 2) / total_sq
             for path, w in grads["cpu"].items()}
    top = sorted(share, key=lambda k: -abs(share[k]))[:4]
    attn = {leaf: rel[f"llm_backbone/layers/{leaf}"] for leaf in GRAD_LEAVES}
    worst = max(rel, key=rel.get)
    norm_rel = {dev: {k: v / n["float64"] - 1 for k, v in n.items() if k != "float64"} for dev, n in norms.items()}
    log(f"{what}: attention gradients card vs CPU {', '.join(f'{k} {v:.3e}' for k, v in attn.items())}; worst leaf "
        f"{worst} {rel[worst]:.3e}; global norm vs float64: card sum-of-squares {norm_rel['cuda']['sum_sq_fp32']:.3e}, "
        f"vector_norm {norm_rel['cuda']['vector_norm_fp32']:.3e}; CPU sum-of-squares "
        f"{norm_rel['cpu']['sum_sq_fp32']:.3e}, vector_norm {norm_rel['cpu']['vector_norm_fp32']:.3e}; float64 card "
        f"vs CPU {norms['cuda']['float64'] / norms['cpu']['float64'] - 1:.3e}, the squared norm's difference by leaf "
        f"{', '.join(f'{k} {share[k]:+.3e} (rel {rel[k]:.2e})' for k in top)}")
    return {"attn_rel": attn, "worst_leaf": worst, "worst_rel": rel[worst], "norms": norms, "norm_rel": norm_rel,
            "norm_sq_share": {k: share[k] for k in top}}


def train_steps(torch, report, key: str, model: str, counts, flags: dict) -> dict:
    """TRAIN_STEPS AdamW steps of train_step.build(model, B = 8, text 32,
    **flags) on the card: finite losses (with the generation heads on, every
    head's and the tactile contrastive loss non-zero; in the post-training
    stage the frozen towers without gradients and unchanged), each step's
    launches counts(cfg); step ms (median past the first), tokens/s, MFU by
    6N (N the decoder's), peak GiB."""
    import numpy as np

    from mla_tpu_torch import params as P
    from mla_tpu_torch import train_step as ts
    from mla_tpu_torch.models.mla import LOSS_KEYS
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.training import metrics

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    run = ts.build(model, 8, 32, "cuda", seed=0, **flags)
    cfg, params = run["cfg"], run["state"]["params"]
    S = 32 + cfg.fused_len + cfg.diff_block_len
    towers = {p: t.detach().clone() for p, t in P.tree_items(params)
              if p.startswith(("vision_tower_2d/", "vision_tower_3d/")) and flags.get("stage") == "post-training"}
    n = run["flops_per_token"] / 6
    expected = counts(cfg)
    torch.cuda.synchronize()
    log(f"{key}: {model} ({cfg.llama.num_layers} layers) built on the card in {time.perf_counter() - t0:.1f} s, S = "
        f"{S}, decoder N = {n / 1e9:.4f} B, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
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
        log(f"{key} step {i}: loss {losses['total_loss']:.5f}, grad_norm {gnorm:.5f}, {times[-1]:.1f} ms, "
            f"launches {counts}")
        if not all(np.isfinite(v) for v in (*losses.values(), gnorm)):
            raise AssertionError(f"{key} step {i}: non-finite loss or grad_norm: {losses}, {gnorm}")
        if cfg.use_generation:
            for k in ("tactile_contrastive_loss", "image_gen_loss", "point_cloud_gen_loss", "tactile_gen_loss"):
                if losses[k] == 0.0:
                    raise AssertionError(f"{key} step {i}: {k} is 0")
        if counts != expected:
            raise AssertionError(f"{key} step {i}: launches {counts}, expected {expected}")
        steps.append({**losses, "grad_norm": gnorm, "ms": times[-1]})
    for p, t in P.tree_items(params):
        if p in towers and (t.requires_grad or t.grad is not None or not torch.equal(t, towers[p])):
            raise AssertionError(f"{key}: the frozen leaf {p} got a gradient or moved")
    step_ms = float(np.median(times[1:]))
    tok_s = run["tokens_per_step"] / (step_ms / 1e3)
    peak = metrics.bf16_peak_flops(torch.cuda.get_device_name(0))
    mfu = tok_s * 6 * n / peak if peak else None
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"{key} {model} B=8 S={S} ({gpu_line()}): step {step_ms:.1f} ms (median of steps 1..{TRAIN_STEPS - 1}), "
        f"{tok_s:.0f} tokens/s, MFU {mfu if mfu is None else round(mfu, 4)} (6N, N = {n / 1e9:.4f} B), peak "
        f"{peak_gib:.2f} GiB; launches {dict(cuda.launches)}")
    report[key.replace("-", "_")] = {"steps": steps, "S": S, "layers": cfg.llama.num_layers, "step_ms_median": step_ms,
                                     "tokens_per_s": tok_s, "mfu": mfu, "decoder_params": n, "peak_gib": peak_gib,
                                     "frozen_leaves_checked": len(towers), "launches": dict(cuda.launches),
                                     "expected_per_step": expected}
    del run, params
    return dict(cuda.launches)


def mistral_train(torch, report):
    """mla-mistral at full width with its decoder cut to 8 layers
    (train_step.ONE_CARD_LAYERS): TRAIN_STEPS AdamW steps at B = 8, S =
    563, remat on; launches flash forward 2L, dQ L, dK/dV L, FPS 2."""
    return train_steps(torch, report, "mistral-train", "mla-mistral", llama_step_counts, {})


def check_int4_agreement(torch, report):
    """int4 on the card against the CPU: int4_linear's integer partial sums
    (group 128) at mla-7b's four linears, M = 534 and 18, with TF32 off and
    on, identical to the exact sums (float64 on the CPU) of the first 32
    and last 16 rows; then an int4 mla-7b cut to INT4_AGREE_LAYERS layers,
    one DDIM-8 chunk card vs CPU within AGREE_RTOL of its scale."""
    from dataclasses import replace

    from mla_tpu_torch import params as P
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.models.mla import MLAPolicy
    from mla_tpu_torch.ops import quantization as q

    gen = torch.Generator(device="cuda").manual_seed(60)
    checked = []
    for K, N in LINEARS:
        w = P.tree_to(q.quantize_weight_int4(torch.randn((K, N), generator=gen, device="cuda") * 0.02), "cpu")
        w4 = q.unpack_int4(w["w_q4"])
        groups = w["w_scale4"].shape[0]
        for M in (PREFIX_LEN, SUFFIX_LEN):
            xq, _ = q.quantize_rows(torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16).cpu())
            # the exact sums (float64) of the first 32 and last 16 rows: a
            # row's sums do not depend on the others, and the card runs all M
            rows = torch.arange(M) if M <= 48 else torch.cat([torch.arange(32), torch.arange(M - 16, M)])
            want = torch.bmm(xq[rows].double().reshape(len(rows), groups, -1).transpose(0, 1),
                             w4.double().reshape(groups, K // groups, N))
            for tf32 in (False, True):
                torch.backends.cuda.matmul.allow_tf32 = tf32
                got = q.int4_partials(xq.cuda(), q.unpack_int4(w["w_q4"].cuda()), groups)[:, rows.cuda()].cpu()
                torch.backends.cuda.matmul.allow_tf32 = False
                if not torch.equal(got.double(), want):
                    raise AssertionError(f"int4-agree K={K} N={N} M={M} tf32={tf32}: the partial sums differ in "
                                         f"{int((got.double() != want).sum())} entries")
            checked.append(f"K={K} N={N} M={M}")
    log(f"int4-agree: integer partial sums identical card vs CPU (TF32 off and on) at {checked}")
    cfg = get_model_config("mla-7b")
    cfg = replace(cfg, llama=replace(cfg.llama, num_layers=INT4_AGREE_LAYERS))
    params, state = P.init(cfg, seed=61, device="cuda")
    live_head(torch, params, 62)
    params = P.tree_to(q.quantize_model_int4(params), "cpu")
    state = P.tree_to(state, "cpu")
    img, pc, ids, noise = request_inputs(cfg, 63)
    chunk = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        pol = MLAPolicy(params, state, cfg, device=dev)
        chunk[dev] = pol.predict_action_diff(img, pc, "", input_ids=ids, noise=noise, return_normalized=True)
        log(f"int4-agree mla-7b-int4 {INT4_AGREE_LAYERS} layers DDIM-8 on {dev}: {time.perf_counter() - t0:.2f} s")
        del pol
    scale, err = float(abs(chunk["cpu"]).max()), float(abs(chunk["cuda"] - chunk["cpu"]).max())
    log(f"int4-agree: chunk max |gpu - cpu| {err:.4e} of scale {scale:.4e}, rel {err / scale:.4e} (tol {AGREE_RTOL})")
    report["int4_agree"] = {"partials_identical": checked, "chunk_max_abs_err": err, "chunk_scale": scale,
                            "rtol": AGREE_RTOL}
    if not err <= AGREE_RTOL * scale:
        raise AssertionError(f"int4-agree: GPU and CPU chunks disagree: {err} vs scale {scale}")


def int4_serve(torch, report):
    """mla-7b-int4 (group 128) at full depth from a seeded init on the card:
    DDIM-8 and DPM-4 chunks and predict_action_ar, each with its exact
    launches (flash L and FPS 2 a call; no W8A8 and no int8_matmul: the int4
    products and the dequantized int4 lm_head are plain PyTorch); p50 ms,
    the int4 tree's GiB against the int8 trees' (serve)."""
    from mla_tpu_torch import params as P
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.models.mla import MLAPolicy
    from mla_tpu_torch.ops.quantization import quantize_model_int4

    cfg = get_model_config("mla-7b")
    t0 = time.perf_counter()
    params, state = P.init(cfg, seed=64, device="cuda")
    live_head(torch, params, 65)
    params = quantize_model_int4(params)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    policy = MLAPolicy(params, state, cfg, norm_stats=STATS)
    del params
    torch.cuda.synchronize()
    L = cfg.llama.num_layers
    gib = tree_gib(policy.params["llm_backbone"])
    int8_gib = report.get("serve", {}).get("decoder_tree_gib")  # the serve phase's int8 mla-7b policies
    log(f"int4-serve: mla-7b-int4 built on the card in {time.perf_counter() - t0:.1f} s; its decoder tree "
        f"{gib:.2f} GiB (the int8 mla-7b's, W8A8 and weight-only: {int8_gib}), "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated ({(torch.cuda.memory_allocated() - before) / 2**30:.2f} "
        f"by the fused serving tree)")
    common = {"flash_attention": L, "furthest_point_sample": cfg.point.num_stages, "w8a8_matmul": 0, "int8_matmul": 0}
    torch.cuda.reset_peak_memory_stats()
    res = serve_calls(torch, "int4-serve", policy, cfg, {"ddim": common, "dpm": common, "ar": common}, ar=True)
    res.update({"decoder_tree_gib": gib, "int8_decoder_tree_gib": int8_gib,
                "allocated_gib": torch.cuda.memory_allocated() / 2**30,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    log(f"int4-serve ({gpu_line()}): p50 DDIM-8 {res['p50_ms']['ddim']:.2f} ms, DPM-4 {res['p50_ms']['dpm']:.2f} ms, "
        f"predict_action_ar {res['p50_ms']['ar']:.2f} ms; peak {res['peak_gib']:.2f} GiB in the calls")
    report["int4_serve"] = res
    del policy
    return res["launches"]


def phi_post_config(num_layers: int = None, **narrow):
    """mla-phi in the Franka post-training stage (train_step.POST_FRANKA's
    flags, the heads at the decoder's width), its decoder cut or narrowed
    as phi_config, the heads' dropout 0 (the card's and the CPU's
    generators differ)."""
    from dataclasses import replace

    from mla_tpu_torch import train_step as ts
    from mla_tpu_torch.conf.models import _gen_cfg

    flags = {k: v for k, v in ts.POST_FRANKA.items() if k != "stage"}
    cfg = ts.model_config("mla-phi", **flags)
    if num_layers is not None:
        narrow["num_layers"] = num_layers
    cfg = replace(cfg, llama=replace(cfg.llama, **narrow))
    g = _gen_cfg(cfg.llama.hidden_size, True, True, True)
    g = replace(g, use_image=flags["gen_image"], use_pointcloud=flags["gen_pointcloud"],
                use_tactile=flags["gen_tactile"], image=replace(g.image, dropout=0.0),
                point=replace(g.point, dropout=0.0), tactile=replace(g.tactile, dropout=0.0))
    return replace(cfg, gen=g)


def check_phi_post_agreement(torch, report):
    """One AdamW step of a hidden-1280 phi (4 layers, head_dim 80) with the
    generation heads at its width, in the Franka post-training stage, on the
    card and on the CPU from the same weights, batch, wrist view and draws:
    the losses (POST_AGREE_KEYS; image_gen_loss of |total_loss|) within
    TRAIN_AGREE_RTOL; the card's step from the shifted-o-bias control must
    miss grad_norm."""
    from mla_tpu_torch import train_step as ts
    from mla_tpu_torch.models.mla import LOSS_KEYS
    from mla_tpu_torch.vla.dummy import add_extra_views, synthetic_batch

    cfg = phi_post_config(4, hidden_size=1280, intermediate_size=5120, num_heads=16, contrastive_layer=2)
    batch = add_extra_views(synthetic_batch(cfg, B=2, L=32, seed=10), cfg, seed=12)
    S = 32 + cfg.fused_len + cfg.diff_block_len
    out = agreement_steps(torch, None, cfg, batch, LOSS_KEYS + ("grad_norm",),
                          f"phi-post-agree phi hidden 1280 with heads, bf16 B=2 S={S}",
                          stage=ts.POST_FRANKA["stage"], perturb=lambda p: shifted_o_bias(torch, p, 66))

    def rel(dev):
        r = {k: abs(out[dev][k] - out["cpu"][k]) / abs(out["cpu"][k]) for k in POST_AGREE_KEYS}
        r["image_gen_loss (of |total_loss|)"] = (abs(out[dev]["image_gen_loss"] - out["cpu"]["image_gen_loss"])
                                                 / abs(out["cpu"]["total_loss"]))
        return r

    sound, ctrl = rel("cuda"), rel("control")
    log(f"phi-post-agree: relative |gpu - cpu| {({k: float(f'{v:.4e}') for k, v in sound.items()})} "
        f"(tol {TRAIN_AGREE_RTOL}); control grad_norm {ctrl['grad_norm']:.4e}")
    report["phi_post_agree"] = {**out, "S": S, "rel_err": sound, "control_rel_err": ctrl, "rtol": TRAIN_AGREE_RTOL}
    for k in ("tactile_contrastive_loss", "image_gen_loss", "point_cloud_gen_loss", "tactile_gen_loss"):
        if out["cpu"][k] == 0.0:
            raise AssertionError(f"phi-post-agree: {k} is 0 on the CPU, the head did not run")
    if not all(v <= TRAIN_AGREE_RTOL for v in sound.values()):
        raise AssertionError(f"GPU and CPU phi post-training steps disagree: {sound}")
    if not ctrl["grad_norm"] > TRAIN_AGREE_RTOL:
        raise AssertionError(f"phi-post-agree passes the control: grad_norm off by {ctrl['grad_norm']}")


def phi_post_train(torch, report):
    """train_step --model mla-phi --post_franka at full width and depth:
    TRAIN_STEPS AdamW steps at B = 8, S = 819, remat on, the heads' dropout
    as in the stage; FPS 2 a step and no other kernel (head_dim 80)."""
    from mla_tpu_torch import train_step as ts

    return train_steps(torch, report, "phi-post-train", "mla-phi", lambda cfg: phi_counts(), dict(ts.POST_FRANKA))


def pointlib_phase(torch, report):
    """The point-cloud library on the card against the CPU: KMeansEmbed on
    POINTLIB_B clouds of POINTLIB_N points into POINTLIB_GROUPS groups (its
    k-means starts from one FPS launch, counted), dilated kNN, the edge and
    max-relative graph convolutions (on the CPU's neighbours) and PCViews'
    six depth images. The k-means labels and kNN indices may differ only at
    near ties (POINTLIB_LABEL_SHARE); the centroids and group features of
    the groups whose members agree, and every other float, within
    POINTLIB_RTOL of their scale."""
    import numpy as np

    from mla_tpu_torch import params as P
    from mla_tpu_torch.models import pointlib as pl
    from mla_tpu_torch.ops import cuda

    rng = np.random.default_rng(70)
    B, N, K = POINTLIB_B, POINTLIB_N, POINTLIB_GROUPS
    xyz = rng.uniform([-0.3, -0.45, 0.75], [0.7, 0.45, 1.6], size=(B, N, 3)).astype(np.float32)
    p = pl.kmeans_embed_init(71, encoder_dim=256)
    gp = pl.graph_conv_init(72, 3, 64)
    out, ms, launches, cpu_idx = {}, {}, {}, None
    for dev in ("cpu", "cuda"):
        x = torch.from_numpy(xyz).to(dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            cuda.launches.clear()
        t0 = time.perf_counter()
        cent, feats, _, labels = pl.kmeans_embed(P.tree_to(p, dev), x, num_groups=K)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(cuda.launches)
        ms[dev] = (time.perf_counter() - t0) * 1e3
        small = x[:, :1024]
        idx = pl.dilated_knn(8, 2, small)
        nbr = idx if cpu_idx is None else cpu_idx.to(dev)
        cpu_idx = idx.cpu() if cpu_idx is None else cpu_idx
        out[dev] = {k: v.cpu() for k, v in {
            "centroids": cent, "features": feats, "labels": labels, "dilated_knn": idx,
            "edge_conv": pl.edge_conv(P.tree_to(gp, dev), small, nbr),
            "mr_conv": pl.mr_conv(P.tree_to(gp, dev), small, nbr),
            "depth": pl.PCViews(device=dev).get_img(small - small.mean(1, keepdim=True), resolution=128),
        }.items()}
    if launches.get("furthest_point_sample") != 1:
        raise AssertionError(f"pointlib: the k-means launched FPS {launches.get('furthest_point_sample')} times, not 1")
    got, want = out["cuda"], out["cpu"]
    moved = got["labels"] != want["labels"]
    labels_differ = int(moved.sum())
    # a group is compared where no point joined or left it
    touched = torch.zeros((B, K), dtype=torch.bool)
    for lab in (got["labels"], want["labels"]):
        for b in range(B):
            touched[b, lab[b][moved[b]]] = True
    kept = ~touched
    errs = {}
    for k in ("centroids", "features"):
        w = want[k].float()
        errs[k] = float((got[k].float() - w)[kept].abs().max()) / float(w.abs().max())
    for k in ("edge_conv", "mr_conv", "depth"):
        w = want[k].float()
        errs[k] = float((got[k].float() - w).abs().max()) / float(w.abs().max())
    knn_differ = int((got["dilated_knn"] != want["dilated_knn"]).sum())
    log(f"pointlib ({B} clouds x {N} points -> {K} groups): KMeansEmbed on the card {ms['cuda']:.1f} ms, on the CPU "
        f"{ms['cpu']:.1f} ms; FPS launches {launches.get('furthest_point_sample')}; labels differing {labels_differ} "
        f"of {B * N} ({int(kept.sum())} of {B * K} groups compared); dilated kNN indices differing {knn_differ} of "
        f"{want['dilated_knn'].numel()}; max error of scale {({k: float(f'{v:.3e}') for k, v in errs.items()})} "
        f"(tol {POINTLIB_RTOL})")
    report["pointlib"] = {"card_ms": ms["cuda"], "cpu_ms": ms["cpu"], "launches": launches,
                          "labels_differ": labels_differ, "groups_compared": int(kept.sum()),
                          "dilated_knn_differ": knn_differ, "rel_err": errs, "rtol": POINTLIB_RTOL}
    if labels_differ > POINTLIB_LABEL_SHARE * B * N or knn_differ > POINTLIB_LABEL_SHARE * want["dilated_knn"].numel():
        raise AssertionError(f"pointlib: {labels_differ} labels and {knn_differ} kNN indices differ card vs CPU")
    bad = {k: v for k, v in errs.items() if not v <= POINTLIB_RTOL}
    if bad:
        raise AssertionError(f"pointlib: card and CPU disagree: {bad}")
    return launches


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


@contextlib.contextmanager
def checkpoint_writes_skipped():
    """Within the block, train.main's checkpoint saves write nothing and
    take no time; the steps they were asked for are collected. For the runs
    that repeat the trainer phase's ~20 GiB save, which that phase times
    and checks bit for bit (the AR loss mode's, data's, oxe's,
    trainer-viz's, hf-vlm's and the sharded phases'), so the script keeps
    to its time."""
    from mla_tpu_torch.training import checkpointing

    real, steps = checkpointing.save_checkpoint, []

    def skip(run_dir, train_state, *, step, epoch=0, loss=None, **_):
        steps.append(step)
        return Path(run_dir) / "checkpoints" / checkpointing._ckpt_name(step, epoch, loss)

    checkpointing.save_checkpoint = skip
    try:
        yield steps
    finally:
        checkpointing.save_checkpoint = real


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
        shards = first["state"]["shards"]
        if {m.dtype for p, m in zip(shards.paths, shards.masters) if p.startswith("llm_backbone/")} != {torch.float32}:
            raise AssertionError("trainer: the decoder's master weights are not fp32")
        del shards
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
        pairs += [(f"masters/{p}", a, b) for p, a, b in zip(live["shards"].paths, live["shards"].masters,
                                                            fresh["shards"].masters)]
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
        with checkpoint_writes_skipped():
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
        with checkpoint_writes_skipped():
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


# the oxe phase: `--data_mix bridge_rt_1` (scripts/pretrain.sh's OXE
# lineage) from bridge_orig and fractal20220817_data in their raw schemas,
# JPEG frames from the port's encoder, written by the port's writer
OXE_ROOT = Path("build") / "chip_smoke_oxe"
OXE_SIZES = {"bridge_orig": (256, 256), "fractal20220817_data": (256, 320)}  # the datasets' published frames
OXE_QUALITY = 95
OXE_INSTRUCTIONS = {"bridge_orig": (b"put the spoon in the pot", b"open the drawer"),
                    "fractal20220817_data": (b"pick coke can", b"move the apple near the sponge")}


# seeded frames through the port's encoder, and the SHA-256 of TensorFlow's
# decode_image (the fast IDCT, "ifast") and of Pillow's convert("RGB") (the
# accurate one, "islow") of each; tests/test_torch_jpeg.py recomputes them
# with TensorFlow and Pillow
JPEG_GOLDEN = {  # name: (height, width, quality, subsampling, progressive, restart interval)
    "bridge 4:2:0": (256, 256, 95, "4:2:0", False, 0),
    "fractal 4:2:0 progressive": (256, 320, 95, "4:2:0", True, 0),
    "llava 4:4:4 restarts": (480, 640, 90, "4:4:4", False, 7),
    "odd 4:2:0 restarts progressive": (97, 131, 75, "4:2:0", True, 5),
}
JPEG_DIGESTS = {  # name: SHA-256 of the stream and of each decode's uint8 [H, W, 3] bytes
    "bridge 4:2:0": {
        "stream": "0c8fa220568af6d66387018a3a3cba4c22be103650c9f9144238a2d6e94aa363",
        "ifast": "8214932368feb52a1b3ad0d4b5f870fe98218ab26b6c0e4bfe3975833e0788a3",
        "islow": "d85f14038fd7d4587ee48fa84cd80b14263f12459f1cd71536b9c8c74e19645c"},
    "fractal 4:2:0 progressive": {
        "stream": "7b2cca6073b57a19b3b67fe0b1eec6fe36dd99d62ec09c146b0daddfaceb3c87",
        "ifast": "c80b11d1011b26ec6f62d13a46bdb124bd770c45edba5e2cd9a6fdad4cda5102",
        "islow": "615b401365c0254f83b6950edd9aad30edcf636064f9ee81151a11ae889cbe9f"},
    "llava 4:4:4 restarts": {
        "stream": "19d6d11f88e2633835b7e6dedbe238f7dde2a643a3a685deed04a2379564edae",
        "ifast": "a75101d1f4b1b57abd7e1943c9c1ab629f3d70ef406ab1d9b448a5b0d0efc319",
        "islow": "017f106967d300c6acd89af6a403a63447d60a1fe642acce274808ba6125240d"},
    "odd 4:2:0 restarts progressive": {
        "stream": "2ecea245932bbc201e32feb0a3ac5c4c15fe8ccd7d793b2d60655d0fd4c13139",
        "ifast": "187861e1de99424433770285deec0b0e705b652e3f1ad93c9bbd9cede8fe2edd",
        "islow": "ada6fc54515eb3ce09e116515f2c776f3850225afd609ab17ba9f471e15f27f9"},
}


def jpeg_golden_streams() -> dict:
    """{name: JPEG bytes} of JPEG_GOLDEN, each frame _camera_frame's."""
    from mla_tpu_torch.vla.rlds import jpeg

    return {name: jpeg.encode(_camera_frame((81, i), (h, w), i), q, sub, prog, rst)
            for i, (name, (h, w, q, sub, prog, rst)) in enumerate(JPEG_GOLDEN.items())}


def oxe_fixture(root: Path, episodes: int, steps: int, shards: int, seed: int, keep_pixels: bool = False) -> dict:
    """bridge_orig (image_0 and image_1, the 7-float state, flat 7-DoF
    actions with a continuous gripper, an instruction a step) and
    fractal20220817_data (image, base_pose_tool_reached, gripper_closed,
    the dict action with a relative gripper, natural_language_instruction
    in the observation), `episodes` each of `steps` steps in `shards`
    shards, frames JPEG (quality OXE_QUALITY, 4:2:0) from the port's
    encoder, encoded in a pool of threads. Returns {name: raw episodes}
    (the frames as JPEG bytes, and decoded by the port's IFAST decoder
    under 'pixels' with keep_pixels)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from mla_tpu_torch.vla.rlds import jpeg
    from mla_tpu_torch.vla.rlds.tfds_compat import write_rlds_dataset

    views = {"bridge_orig": ("image_0", "image_1"), "fractal20220817_data": ("image",)}
    keys = [(name, e, t, v) for name in views for e in range(episodes) for t in range(steps)
            for v in range(len(views[name]))]

    def encoded(key):
        name, e, t, v = key
        img = _camera_frame((seed, len(name), e, t, v), OXE_SIZES[name], t + 11 * v + 3 * e)
        return jpeg.encode(img, OXE_QUALITY, "4:2:0")

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        frames = dict(zip(keys, pool.map(encoded, keys)))
    rng = np.random.default_rng(seed)
    out = {}
    for name, cams in views.items():
        eps = []
        for e in range(episodes):
            imgs = {cam: np.asarray([frames[name, e, t, v] for t in range(steps)], object)
                    for v, cam in enumerate(cams)}
            lang = np.asarray([OXE_INSTRUCTIONS[name][e % 2]] * steps, object)
            if name == "bridge_orig":
                grip = np.clip(rng.choice([0.0, 1.0, 0.5], steps, p=[0.45, 0.45, 0.1]) + rng.normal(0, 0.01, steps),
                               0, 1)
                act = np.concatenate([rng.normal(0, 0.02, (steps, 6)), grip[:, None]], 1).astype(np.float32)
                act[0] = 0.0  # bridge's all-zero first action
                obs = {**imgs, "state": np.cumsum(rng.normal(0, 0.01, (steps, 7)), 0).astype(np.float32)}
                step = {"observation": obs, "action": act, "language_instruction": lang}
            else:
                obs = {**imgs, "natural_language_instruction": lang,
                       "base_pose_tool_reached": rng.normal(0, 0.3, (steps, 7)).astype(np.float32),
                       "gripper_closed": rng.integers(0, 2, (steps, 1)).astype(np.float32)}
                action = {"world_vector": rng.normal(0, 0.05, (steps, 3)).astype(np.float32),
                          "rotation_delta": rng.normal(0, 0.05, (steps, 3)).astype(np.float32),
                          "gripper_closedness_action": rng.choice([-1.0, 0.0, 1.0], (steps, 1),
                                                                  p=[0.1, 0.8, 0.1]).astype(np.float32)}
                step = {"observation": obs, "action": action}
            eps.append({"steps": step})
        write_rlds_dataset(root, name, eps, num_shards=shards)
        if keep_pixels:
            for ep in eps:
                ep["pixels"] = {cam: np.stack([jpeg.decode(b, "ifast") for b in ep["steps"]["observation"][cam]])
                                for cam in cams}
        out[name] = eps
    return out


# golden streams of tests/data/frames/ that a mixed LLaVA root holds in place of every other JPEG, in turn
LLAVA_OTHER_FORMATS = ("tiff_jpeg_640x480.tif", "tiff_g4_640x480.tif", "tiff_lzw_pred_256x256.tif",
                       "tiff_deflate_pred_256x256.tif", "netpbm_p5_maxval1000.pgm", "tga_rle.tga", "ico_bmp32.ico",
                       "qoi.qoi", "pcx.pcx", "sgi16.sgi")


def llava_jpeg_fixture(root: Path, images: int, size, seed: int, stage: str = "finetune",
                       mixed: bool = False) -> Path:
    """A LLaVA-layout data root (conf/datasets.py's llava-v15 paths) for the
    VLM stage: a chat json of `images` multimodal examples, every image a
    JPEG (quality 90, 4:2:0) from the port's encoder, and two language-only
    ones. With `mixed`, every other image is instead one of
    LLAVA_OTHER_FORMATS in turn (formats only Pillow reads). Returns the
    image directory."""
    from mla_tpu_torch.conf.datasets import get_dataset_config
    from mla_tpu_torch.vla.rlds import jpeg

    cfg = get_dataset_config("llava-v15")
    ann_rel, img_rel = cfg.components_for_stage(stage)
    base = Path(root) / cfg.dataset_root_dir
    img_dir = base / img_rel
    (img_dir / "coco").mkdir(parents=True, exist_ok=True)
    examples = []
    for i in range(images):
        if mixed and i % 2:
            name = LLAVA_OTHER_FORMATS[(i // 2) % len(LLAVA_OTHER_FORMATS)]
            rel = f"coco/{i:06d}{Path(name).suffix}"
            (img_dir / rel).write_bytes((FRAMES_DIR / name).read_bytes())
        else:
            rel = f"coco/{i:06d}.jpg"
            (img_dir / rel).write_bytes(jpeg.encode(_camera_frame((seed, i), size, i), 90, "4:2:0"))
        examples.append({"id": str(i), "image": rel, "conversations": [
            {"from": "human", "value": "<image>\nWhat is on the table?"},
            {"from": "gpt", "value": f"a red block and {i % 5 + 1} cups"}]})
    for i in range(2):
        examples.append({"id": f"text{i}", "conversations": [
            {"from": "human", "value": "Say hello."}, {"from": "gpt", "value": "Hello there."}]})
    (base / ann_rel).parent.mkdir(parents=True, exist_ok=True)
    (base / ann_rel).write_text(json.dumps(examples))
    return img_dir


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

    # fitted to the written proprio's own width: no frame's proprio is zeroed
    ds, n, stats = make_interleaved_dataset("franka", str(root), shuffle_buffer_size=1, load_pointcloud=True,
                                            load_tactile=True, image_size=DATA_EXACT_SIZE,
                                            stats_cache_dir=str(root / "cache"),
                                            proprio_dim=written[0]["steps"]["observation"]["proprio"].shape[-1])
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
        with checkpoint_writes_skipped() as skipped:
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
                          "run_s": run_s, "save_skipped_at_step": skipped}
        log(f"data trainer mla-2b ({' '.join(DATA_ARGS[4:])}), fp32 masters, buffer {DATA_BUFFER}, S = {S} "
            f"({gpu_line()}): run {run_s:.1f} s, total losses {losses['total_loss']}, step {ms:.1f} ms (the last), "
            f"{tok_s:.0f} tokens/s, MFU {mfu if mfu is None else round(mfu, 4)}, peak {peak_gib:.2f} GiB, data wait "
            f"ms {[round(w, 1) for w in wait_ms]} (p50 {rep['trainer']['data_wait_ms_p50']:.1f}, max "
            f"{rep['trainer']['data_wait_ms_max']:.1f}), launches a step {rep['trainer']['launches_per_step']}, "
            f"the save skipped at step {skipped}")
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


OXE_EPISODES, OXE_STEPS, OXE_SHARDS = 8, 40, 2
OXE_BUFFER = 256
OXE_TIMED_BATCHES = 20
OXE_SHARE_FRAMES = 2000
OXE_DECODE_REPS = 30
OXE_RUN_STEPS = 3
OXE_ARGS = ("--vla.type", "prism-dinosiglip-224px+oxe+diffusion", "--model", "mla-2b", "--data_mix", "bridge_rt_1",
            "--use_diff", "true", "--use_pointcloud", "false", "--use_contrastive", "false",
            "--per_device_batch_size", "2", "--global_batch_size", "4")


def host_cpu() -> str:
    """The host's CPU model, as lscpu or the kernel reports it, and its
    architecture."""
    import platform

    model = None
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        model = next((l.split(":", 1)[1].strip() for l in out.splitlines() if l.startswith("Model name")), None)
    except (OSError, subprocess.SubprocessError):
        pass
    if not model:
        try:
            with open("/proc/cpuinfo") as f:
                model = next((l.split(":", 1)[1].strip() for l in f if l.startswith("model name")), None)
        except OSError:
            pass
    return f"{model or platform.processor() or 'model unknown'} ({platform.machine()}, {os.cpu_count()} threads)"


def _sha(a) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(a if isinstance(a, bytes) else np.ascontiguousarray(a).tobytes()).hexdigest()


def oxe_jpeg_checks(written) -> dict:
    """The decoder on the card's host: the C++ loops against their plain
    versions, both IDCTs, on every frame of one fractal episode and on the
    golden streams (progressive and restart-interval ones among them); the
    golden digests (the port's encoder gives the same bytes here, and its
    fast and accurate decodes TensorFlow's and Pillow's pixels); the
    control, a truncated stream, refused; decode ms a frame (p50 of
    OXE_DECODE_REPS, one thread) at 256 x 256 and 640 x 480."""
    import numpy as np

    from mla_tpu_torch.native import jpeg_host
    from mla_tpu_torch.vla.rlds import jpeg

    frames = list(written["fractal20220817_data"][0]["steps"]["observation"]["image"])
    golden = jpeg_golden_streams()
    bad = []
    for i, data in enumerate(frames + list(golden.values())):
        for dct in ("ifast", "islow"):
            if not np.array_equal(jpeg.decode(data, dct), jpeg.decode(data, dct, jpeg_host.PLAIN)):
                bad.append((i, dct))
    digests = {name: {"stream": _sha(data), "ifast": _sha(jpeg.decode(data, "ifast")),
                      "islow": _sha(jpeg.decode(data, "islow"))} for name, data in golden.items()}
    wrong = {name: sorted(k for k in d if d[k] != JPEG_DIGESTS[name][k]) for name, d in digests.items()}
    wrong = {k: v for k, v in wrong.items() if v}
    data = golden["bridge 4:2:0"]
    try:
        jpeg.decode(data[:len(data) // 2])
        control = None
    except ValueError as e:
        control = str(e)
    timing = {}
    for label, img in (("256x256", _camera_frame((91,), (256, 256), 1)), ("640x480", _camera_frame((92,), (480, 640), 2))):
        data = jpeg.encode(img, OXE_QUALITY, "4:2:0")
        for dct in ("ifast", "islow"):
            jpeg.decode(data, dct)
            ms = []
            for _ in range(OXE_DECODE_REPS):
                t = time.perf_counter()
                jpeg.decode(data, dct)
                ms.append((time.perf_counter() - t) * 1e3)
            timing[f"{label} {dct}"] = float(np.percentile(ms, 50))
    return {"plain_vs_cpp_frames": len(frames) + len(golden), "plain_vs_cpp_mismatches": bad, "digests": digests,
            "digests_differing": wrong, "truncated_control": control, "decode_ms_p50": timing, "cpu": host_cpu()}


FRAMES_DIR = Path(__file__).resolve().parent / "tests" / "data" / "frames"
# one golden stream a format or variant new since the JPEG decoder: each is cut in half and must be refused
FORMAT_DECODE_REPS = 15
FORMAT_CUTS = ("png16_adam7.png", "gif_offset_transparent.gif", "bmp_top_down.bmp", "webp_simple_filter.webp",
               "webp_lossless.webp", "jpeg_arith_progressive.jpg", "jpeg_ycck.jpg", "jpeg_lossless.jpg",
               "tiff_lzw.tif", "tiff_g4.tif", "tiff_jpeg.tif", "netpbm_p5_maxval1000.pgm", "tga_rle.tga",
               "ico_bmp32.ico", "qoi.qoi", "pcx.pcx", "sgi16.sgi")
# the golden TIFF frames timed in Pillow's flavour (libtiff writes them; the port writes no TIFF)
FORMAT_TIFF_TIMED = {"256x256": ("tiff_lzw_pred_256x256.tif", "tiff_deflate_pred_256x256.tif"),
                     "640x480": ("tiff_g4_640x480.tif", "tiff_jpeg_640x480.tif")}


def oxe_format_checks() -> dict:
    """The other frame formats on the card's host (vla/rlds/frames.py):
    every golden stream of tests/data/frames/ decoded in both flavours by
    the C++ loops and (but for the larger timing frames) the plain ones,
    each against digests.json (TensorFlow's and Pillow's pixels, recorded
    where both ran; null where one refuses, and then the port must raise);
    a truncated stream of each new format refused in both flavours; decode
    ms a frame (p50 of FORMAT_DECODE_REPS, one thread) at 256 x 256 and 640 x
    480 in TensorFlow's flavour: 16-bit Adam7 PNG, GIF, BMP and
    arithmetic-coded JPEG from the port's encoders, lossy and lossless WebP
    from the timing frames (the port writes no WebP); and in Pillow's the
    timing TIFFs of FORMAT_TIFF_TIMED: LZW and Deflate, both with Predictor
    2, at 256 x 256, Group 4 and JPEG (YCbCr) at 640 x 480."""
    import numpy as np

    from mla_tpu_torch.vla.rlds import bmp, frames, gif, jpeg, png

    index = json.loads((FRAMES_DIR / "digests.json").read_text())
    wrong, checked = [], 0
    for name, want in index.items():
        data = (FRAMES_DIR / name).read_bytes()
        for flavour in ("tf", "pillow"):
            for plain in ((False,) if want.get("timing") else (False, True)):
                try:
                    got = frames.digest(frames.decode(data, flavour, plain=plain))
                except (ValueError, NotImplementedError):
                    got = None
                checked += 1
                if got != want[flavour]:
                    wrong.append((name, flavour, "plain" if plain else "C++"))
    refused = {}
    for name in FORMAT_CUTS:
        data = (FRAMES_DIR / name).read_bytes()
        msgs = []
        for flavour in ("tf", "pillow"):
            try:
                frames.decode(data[:len(data) // 2], flavour)
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        refused[name] = msgs
    timing = {}
    for label, size in (("256x256", (256, 256)), ("640x480", (480, 640))):
        img = _camera_frame((93,), size, 3)
        h, w = size
        idx = ((img[..., 0] >> 5) << 5 | (img[..., 1] >> 5) << 2 | img[..., 2] >> 6).astype(np.uint8)
        table = np.stack([(np.arange(256) >> 5) << 5, ((np.arange(256) >> 2) & 7) << 5, (np.arange(256) & 3) << 6], -1)
        streams = {
            "png 16-bit adam7": png.encode_samples(img.astype(np.uint16) * 257, 2, 16, interlace=True),
            "gif": gif.encode([idx], table),
            "bmp": bmp.encode(img[:, :, ::-1].tobytes(), w, h, 24, top_down=True),
            "jpeg arithmetic": jpeg.encode(img, OXE_QUALITY, "4:2:0", arithmetic=True),
            "webp lossy": (FRAMES_DIR / f"webp_lossy_{label}.webp").read_bytes(),
            "webp lossless": (FRAMES_DIR / f"webp_lossless_{label}.webp").read_bytes(),
        }
        timed = [(kind, data, "tf") for kind, data in streams.items()]
        timed += [(name.split("_" + label)[0].replace("_", " "), (FRAMES_DIR / name).read_bytes(), "pillow")
                  for name in FORMAT_TIFF_TIMED[label]]
        for kind, data, flavour in timed:
            frames.decode(data, flavour)
            ms = []
            for _ in range(FORMAT_DECODE_REPS):
                t = time.perf_counter()
                frames.decode(data, flavour)
                ms.append((time.perf_counter() - t) * 1e3)
            timing[f"{label} {kind}"] = float(np.percentile(ms, 50))
    return {"streams": len(index), "decodes_checked": checked, "digests_differing": wrong,
            "truncated_refused": refused, "decode_ms_p50": timing, "cpu": host_cpu()}


def formats_phase(torch, report):
    """oxe_format_checks alone (the oxe phase runs them in a whole run)."""
    rep = report["formats"] = oxe_format_checks()
    log(f"formats: {rep}")
    if rep["digests_differing"] or not all(all(m) for m in rep["truncated_refused"].values()):
        raise AssertionError(f"formats: {rep}")


def oxe(torch, report):
    """The Open-X path: the bridge_rt_1 fixture (oxe_fixture: OXE_EPISODES x
    OXE_STEPS steps of bridge_orig and of fractal20220817_data in
    OXE_SHARDS shards, JPEG frames); oxe_jpeg_checks; the interleaved
    stream at the trainer's 4 rows a step (frames/s, host batch ms, the
    first batch), its statistics against a numpy recount of the written
    episodes, each dataset's share of OXE_SHARE_FRAMES frames against the
    balanced weights (4 binomial standard deviations); then train.main with
    OXE_ARGS at mla-2b: exact launches, finite losses, S = OXE_S, step ms,
    tokens/s, MFU, peak GiB and the loop's data wait. Returns the trainer
    run's launches."""
    import numpy as np

    from mla_tpu_torch import train
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.training import metrics
    from mla_tpu_torch.vla import datasets as vdata
    from mla_tpu_torch.vla.materialize import get_vla_dataset_and_collator
    from mla_tpu_torch.vla.rlds import dataset as rds

    rep = report["oxe"] = {}
    runs = OXE_ROOT.parent / "chip_smoke_oxe_runs"
    home = os.environ.get("HOME")
    for d in (OXE_ROOT, runs):
        shutil.rmtree(d, ignore_errors=True)
    os.environ["HOME"] = str((OXE_ROOT / "home").resolve())
    try:
        t = time.perf_counter()
        written = oxe_fixture(OXE_ROOT, OXE_EPISODES, OXE_STEPS, OXE_SHARDS, 63)
        mb = sum(p.stat().st_size for p in OXE_ROOT.rglob("*.tfrecord-*")) / 1e6
        rep["fixture"] = {"write_s": time.perf_counter() - t, "episodes": OXE_EPISODES, "steps": OXE_STEPS,
                          "shards": OXE_SHARDS, "mb": mb}
        log(f"oxe: bridge_orig (2 views 256 x 256) and fractal20220817_data (256 x 320), {OXE_EPISODES} x "
            f"{OXE_STEPS} steps each in {OXE_SHARDS} shards, JPEG q{OXE_QUALITY} 4:2:0 from the port's encoder: "
            f"{mb:.1f} MB in {rep['fixture']['write_s']:.1f} s")

        t = time.perf_counter()
        rep["jpeg"] = j = oxe_jpeg_checks(written)
        log(f"oxe jpeg (host {j['cpu']}): C++ vs plain on {j['plain_vs_cpp_frames']} streams x 2 IDCTs, mismatches "
            f"{j['plain_vs_cpp_mismatches'] or 'none'}; golden digests differing {j['digests_differing'] or 'none'}; "
            f"truncated control {'refused: ' + j['truncated_control'] if j['truncated_control'] else 'DECODED'}; "
            f"decode ms a frame (p50, one thread) {j['decode_ms_p50']} ({time.perf_counter() - t:.1f} s)")
        if j["plain_vs_cpp_mismatches"] or j["digests_differing"] or not j["truncated_control"]:
            raise AssertionError(f"oxe jpeg: {j}")
        t = time.perf_counter()
        rep["formats"] = fm = oxe_format_checks()
        log(f"oxe formats (host {fm['cpu']}): {fm['streams']} golden streams, {fm['decodes_checked']} decodes (C++ "
            f"and plain, both flavours) against their digests, differing {fm['digests_differing'] or 'none'}; "
            f"truncated streams refused {sorted(k for k, m in fm['truncated_refused'].items() if all(m))}; decode "
            f"ms a frame (p50, one thread) {fm['decode_ms_p50']} ({time.perf_counter() - t:.1f} s)")
        if fm["digests_differing"] or not all(all(m) for m in fm["truncated_refused"].values()):
            raise AssertionError(f"oxe formats: {fm}")

        # -- the interleaved stream at the trainer's rows ---------------------
        cfg = get_model_config("mla-2b", use_pointcloud=False, use_contrastive=False)
        rows = 4
        t = time.perf_counter()
        ds, collator, stats, n = get_vla_dataset_and_collator(
            data_root_dir=str(OXE_ROOT), data_mix="bridge_rt_1", model_cfg=cfg, per_host_batch_size=rows,
            shuffle_buffer_size=OXE_BUFFER, seed=0)
        stats_s = time.perf_counter() - t
        it = iter(ds)
        t = time.perf_counter()
        first = collator([next(it) for _ in range(rows)])
        first_s = time.perf_counter() - t
        batch_ms = []
        for _ in range(OXE_TIMED_BATCHES):
            t = time.perf_counter()
            collator([next(it) for _ in range(rows)])
            batch_ms.append((time.perf_counter() - t) * 1e3)
        it.close()
        frames_s = rows * OXE_TIMED_BATCHES / (sum(batch_ms) / 1e3)
        sizes = {"bridge_orig": OXE_EPISODES * (OXE_STEPS - 2), "fractal20220817_data": OXE_EPISODES * OXE_STEPS}
        counted = {k: int(stats[k]["num_transitions"]) for k in sizes}
        p = {k: v / sum(sizes.values()) for k, v in sizes.items()}
        want_len = int(max(v / p[k] for k, v in sizes.items()))
        if counted != sizes or n != want_len:
            raise AssertionError(f"oxe: transitions {counted}, dataset_len {n}; a recount gives {sizes}, {want_len}")
        shares_ds, _, _ = rds.make_interleaved_dataset("bridge_rt_1", str(OXE_ROOT), shuffle_buffer_size=OXE_BUFFER,
                                                       load_pointcloud=False, image_size=32, proprio_dim=cfg.action_dim)
        names = [bytes(f["dataset_name"]).decode() for f in shares_ds.take(OXE_SHARE_FRAMES)]
        shares = {}
        for k, pk in p.items():
            c, sigma = names.count(k), (OXE_SHARE_FRAMES * pk * (1 - pk)) ** 0.5
            shares[k] = {"count": c, "expected": OXE_SHARE_FRAMES * pk, "sigma": sigma,
                         "z": (c - OXE_SHARE_FRAMES * pk) / sigma}
        if any(abs(v["z"]) > 4 for v in shares.values()):
            raise AssertionError(f"oxe: shares {shares}")
        shapes = {k: list(v.shape) for k, v in first.items() if hasattr(v, "shape")}
        shapes.update({f"images/{k}": list(v.shape) for k, v in first["images"].items()})
        rep["pipeline"] = {
            "rows_per_batch": rows, "transitions": counted, "dataset_len": n, "stats_pass_s": stats_s,
            "first_batch_s": first_s, "host_batch_ms": batch_ms, "host_batch_ms_p50": float(np.percentile(batch_ms, 50)),
            "host_batch_ms_p95": float(np.percentile(batch_ms, 95)), "frames_per_s": frames_s, "shares": shares,
            "batch_shapes": shapes, "threads": os.cpu_count()}
        log(f"oxe pipeline (bridge_rt_1, {rows} rows a batch, buffer {OXE_BUFFER}, {host_cpu()}): statistics pass {stats_s:.2f} s, first batch {first_s:.2f} s, host batch p50 "
            f"{rep['pipeline']['host_batch_ms_p50']:.1f} ms p95 {rep['pipeline']['host_batch_ms_p95']:.1f} ms over "
            f"{OXE_TIMED_BATCHES}, {frames_s:.1f} frames/s; transitions {counted} (a recount agrees), dataset_len {n}; "
            f"shares of {OXE_SHARE_FRAMES} frames {{{', '.join(f'{k}: {v['count']} (z {v['z']:+.2f})' for k, v in shares.items())}}}; "
            f"batch {shapes}")

        # -- the trainer on the mixture ---------------------------------------
        args = list(OXE_ARGS) + ["--data_root_dir", str(OXE_ROOT), "--shuffle_buffer_size", str(OXE_BUFFER),
                                 "--max_steps", str(OXE_RUN_STEPS), "--save_interval", str(OXE_RUN_STEPS),
                                 "--run_root_dir", str(runs), "--run_id", "oxe"]
        torch.cuda.reset_peak_memory_stats()
        cuda.launches.clear()
        t = time.perf_counter()
        with checkpoint_writes_skipped() as skipped:
            out = train.main(args)
        torch.cuda.synchronize()
        totals = {k: cuda.launches[k] for k in TRAINER_KERNELS}
        run_s = time.perf_counter() - t
        cfg = out["cfg"]
        S = vdata.PaddedCollatorForActionPrediction().max_prompt_len + cfg.fused_len + cfg.diff_block_len
        if S != OXE_S:
            raise AssertionError(f"oxe: S = {S}, but the kernels were checked at OXE_S = {OXE_S}")
        # no point cloud: no point tokenizer, so no FPS
        expected = {**trainer_counts(cfg, micro_batches=OXE_RUN_STEPS * 2), "furthest_point_sample": 0}
        if totals != expected:
            raise AssertionError(f"oxe: launches {totals} in {OXE_RUN_STEPS} steps of accumulation 2, "
                                 f"expected {expected}")
        losses = {k: list(out["metrics"].windows[k]) for k in ("total_loss", "diff_loss")}
        if not all(np.isfinite(v).all() and len(v) == OXE_RUN_STEPS for v in losses.values()):
            raise AssertionError(f"oxe: losses {losses}")
        tokens = rows * 4 * S
        peak_flops = metrics.bf16_peak_flops(torch.cuda.get_device_name(0))
        ms, tok_s, mfu = _trainer_step_line(out, tokens, out["metrics"].flops_per_token, peak_flops)
        wait_ms = [w * 1e3 for w in out["data_wait_s"]]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        rep["trainer"] = {"S": S, "BH": OXE_BH, "tokens_per_step": tokens, "losses": losses, "step_ms": ms,
                          "step_times_s": list(out["metrics"].windows["step_time"]), "tokens_per_s": tok_s,
                          "mfu": mfu, "peak_gib": peak_gib, "data_wait_ms": wait_ms,
                          "data_wait_ms_p50": float(np.percentile(wait_ms, 50)), "data_wait_ms_max": max(wait_ms),
                          "launches": totals, "launches_per_step": {k: v // OXE_RUN_STEPS for k, v in totals.items()},
                          "run_s": run_s, "save_skipped_at_step": skipped}
        log(f"oxe trainer mla-2b ({' '.join(OXE_ARGS[4:])}), fp32 masters, buffer {OXE_BUFFER}, S = {S} "
            f"({gpu_line()}): run {run_s:.1f} s, total losses {losses['total_loss']}, step {ms:.1f} ms (the last), "
            f"{tok_s:.0f} tokens/s, MFU {mfu if mfu is None else round(mfu, 4)}, peak {peak_gib:.2f} GiB, data wait "
            f"ms {[round(w, 1) for w in wait_ms]}, launches a step {rep['trainer']['launches_per_step']}, the save "
            f"skipped at step {skipped}")
        del out
    finally:
        if home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = home
        gc.collect()
        for d in (OXE_ROOT, runs):
            shutil.rmtree(d, ignore_errors=True)
    return totals


HF_ROOT = Path("build") / "chip_smoke_hf"
HF_RUNS = Path("build") / "chip_smoke_hf_runs"
# the finetune run's LLaVA-layout root: VLM_ROWS JPEG images at 640 x 480
LLAVA_ROOT = Path("build") / "chip_smoke_llava"
LLAVA_SIZE = (480, 640)
# meta-llama/Llama-2-7b-hf's published config.json (its widths and the
# float16 of its files); the fixture writes this layout from seeded values
HF_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu",
    "hidden_size": 4096, "initializer_range": 0.02, "intermediate_size": 11008, "max_position_embeddings": 4096,
    "model_type": "llama", "num_attention_heads": 32, "num_hidden_layers": 32, "num_key_value_heads": 32,
    "pretraining_tp": 1, "rms_norm_eps": 1e-05, "rope_scaling": None, "tie_word_embeddings": False,
    "torch_dtype": "float16", "transformers_version": "4.31.0.dev0", "use_cache": True, "vocab_size": 32000,
}
HF_SHARDS = 2
# 4 steps: the 12 synthetic examples make one multimodal and one
# language-only batch an epoch, so the second epoch's multimodal batch gives
# a step time past the first step's warm-up
VLM_STEPS = 4
VLM_KERNELS = ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "furthest_point_sample",
               "w8a8_matmul", "int8_matmul")


def hf_layer_shapes(c) -> dict:
    """{HF name suffix: shape} of one Llama decoder layer of config `c`."""
    D, I = c["hidden_size"], c["intermediate_size"]
    return {"self_attn.q_proj.weight": (D, D), "self_attn.k_proj.weight": (D, D), "self_attn.v_proj.weight": (D, D),
            "self_attn.o_proj.weight": (D, D), "mlp.gate_proj.weight": (I, D), "mlp.up_proj.weight": (I, D),
            "mlp.down_proj.weight": (D, I), "input_layernorm.weight": (D,), "post_attention_layernorm.weight": (D,)}


def hf_fixture(torch, root: Path, seed: int) -> dict:
    """A directory in meta-llama/Llama-2-7b-hf's layout: config.json,
    model.safetensors.index.json and HF_SHARDS float16 shards written by
    the port's save_file, from values drawn on the card (normal(0, 0.02)
    weights, norm scales 1 + normal(0, 0.02)). -> {write_s, gb, files}."""
    from mla_tpu_torch.models.safetensors_io import save_file

    c = HF_CONFIG
    L = c["num_hidden_layers"]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(shape, norm=False):
        t = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float16) * 0.02
        return (t + 1 if norm else t).cpu()

    root.mkdir(parents=True)
    (root / "config.json").write_text(json.dumps(c, indent=2))
    per = -(-L // HF_SHARDS)
    weight_map, total, write_s = {}, 0, 0.0
    for shard in range(HF_SHARDS):
        name = f"model-{shard + 1:05d}-of-{HF_SHARDS:05d}.safetensors"
        tensors = {}
        if shard == 0:
            tensors["model.embed_tokens.weight"] = draw((c["vocab_size"], c["hidden_size"]))
        for i in range(shard * per, min(L, (shard + 1) * per)):
            for suffix, shape in hf_layer_shapes(c).items():
                tensors[f"model.layers.{i}.{suffix}"] = draw(shape, norm=suffix.endswith("layernorm.weight"))
        if shard == HF_SHARDS - 1:
            tensors["model.norm.weight"] = draw((c["hidden_size"],), norm=True)
            tensors["lm_head.weight"] = draw((c["vocab_size"], c["hidden_size"]))
        t0 = time.perf_counter()
        save_file(tensors, root / name, metadata={"format": "pt"})
        write_s += time.perf_counter() - t0
        weight_map.update({k: name for k in tensors})
        total += sum(t.numel() * 2 for t in tensors.values())
        del tensors
    (root / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": dict(sorted(weight_map.items()))}, indent=2))
    return {"write_s": write_s, "gb": total / 1e9, "files": sorted(p.name for p in root.iterdir())}


def hf_expected_decoder(torch, root: Path, cfg) -> dict:
    """The decoder the port must load from `root`: each file tensor (read
    with safetensors_io) of the first cfg.llama.num_layers layers,
    transposed to [in, out] and stacked, cast to cfg.llama.param_dtype on
    the card; the vocabulary padded with the mean rows as the JAX
    converter computes them (np.mean of the float16 arrays, rounded to
    float16). -> {path: tensor}."""
    import numpy as np

    from mla_tpu_torch.models.safetensors_io import SafetensorsFile

    files = [SafetensorsFile(f) for f in sorted(root.glob("*.safetensors"))]
    where = {k: f for f in files for k in f.keys()}
    dt, L, V = cfg.llama.param_dtype, cfg.llama.num_layers, cfg.llama.vocab_size

    def get(k):
        return where[k].get_tensor(k)

    def stack(suffix, t=True):
        return torch.stack([(get(f"model.layers.{i}.{suffix}").t() if t else get(f"model.layers.{i}.{suffix}"))
                            .to("cuda") for i in range(L)]).to(dt)

    emb = get("model.embed_tokens.weight").numpy()
    head = get("lm_head.weight").numpy()
    n_new = V - emb.shape[0]
    emb_pad = np.concatenate([emb, np.tile(emb.mean(axis=0, keepdims=True), (n_new, 1))], axis=0)
    head_pad = np.concatenate([head.T, np.tile(head.T.mean(axis=1, keepdims=True), (1, n_new))], axis=1)
    out = {"embed/table": torch.from_numpy(emb_pad).to("cuda").to(dt),
           "lm_head/w": torch.from_numpy(np.ascontiguousarray(head_pad)).to("cuda").to(dt),
           "final_ln/scale": get("model.norm.weight").to("cuda").to(dt),
           "layers/input_ln/scale": stack("input_layernorm.weight", t=False),
           "layers/post_ln/scale": stack("post_attention_layernorm.weight", t=False)}
    for group, names in (("attn", ("q", "k", "v", "o")), ("mlp", ("gate", "up", "down"))):
        for n in names:
            hf = f"self_attn.{n}_proj.weight" if group == "attn" else f"mlp.{n}_proj.weight"
            out[f"layers/{group}/{n}/w"] = stack(hf)
    return out


def vlm_counts(cfg, multimodal, llm_trained: bool) -> dict:
    """The kernel launches of VLM steps, one per entry of `multimodal`: a
    step whose loss reaches a trained leaf runs the forward twice (remat)
    and the backward once per layer; a language-only align step reaches
    none, so it runs the forward once and no backward."""
    L = cfg.llama.num_layers
    out = dict.fromkeys(VLM_KERNELS, 0)
    for mm in multimodal:
        backward = llm_trained or mm
        out["flash_attention"] += (2 if backward else 1) * L
        out["flash_attention_bwd_dq"] += L if backward else 0
        out["flash_attention_bwd_dkv"] += L if backward else 0
    return out


def check_vlm_agreement(torch, report, control):
    """One vlm-finetune AdamW step of the bf16 mla-small (the VLM config:
    no point, tactile, contrastive or diffusion parts) on the card and on
    the CPU from the same weights and batch: two multimodal rows of the
    synthetic finetune data, 32 collated ids, S = 32 + 513 = 545, so the
    flash kernels run on the card. Loss and grad_norm within
    TRAIN_AGREE_RTOL; the flash_bwd control must miss grad_norm."""
    from mla_tpu_torch.conf.datasets import get_dataset_config
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.train import vlm_model_batch
    from mla_tpu_torch.vla.tokenizer import SimpleTokenizer
    from mla_tpu_torch.vla.vlm_datasets import get_vlm_dataset_and_collator

    cfg = get_model_config("mla-small", use_diff=False, use_pointcloud=False, use_tactile=False,
                           use_contrastive=False, use_generation=False)
    ds, collator = get_vlm_dataset_and_collator("finetune", get_dataset_config("llava-v15"), None, SimpleTokenizer(),
                                                image_size=cfg.vision.image_size, max_length=32)
    batch = vlm_model_batch(collator([ds[0], ds[1]]))
    S = batch["input_ids"].shape[1] + cfg.fused_len
    out = agreement_steps(torch, control, cfg, batch, ("total_loss", "ar_loss", "grad_norm"),
                          f"vlm-agree vlm-finetune mla-small bf16 B=2 S={S}", stage="vlm-finetune")

    def rel(dev):
        return {k: abs(out[dev][k] - out["cpu"][k]) / abs(out["cpu"][k]) for k in ("total_loss", "grad_norm")}

    sound, ctrl = rel("cuda"), rel("control")
    log(f"vlm-agree: relative |gpu - cpu| loss {sound['total_loss']:.4e}, grad_norm {sound['grad_norm']:.4e} "
        f"(tol {TRAIN_AGREE_RTOL}); control grad_norm {ctrl['grad_norm']:.4e}")
    report["vlm_agree"] = {**out, "S": S, "rel_err": sound, "control_rel_err": ctrl, "rtol": TRAIN_AGREE_RTOL}
    if S < 256:
        raise AssertionError(f"vlm-agree: S = {S} does not take the flash route")
    if not all(v <= TRAIN_AGREE_RTOL for v in sound.values()):
        raise AssertionError(f"vlm-agree: GPU and CPU steps disagree: {sound}")
    if not ctrl["grad_norm"] > TRAIN_AGREE_RTOL:
        raise AssertionError(f"vlm-agree passes the control: grad_norm off by {ctrl['grad_norm']}")


def _vlm_run(torch, train, stage: str, extra=()):
    """train.main(--vlm_stage stage) on mla-2b from HF_ROOT, its closing
    checkpoint write skipped (the trainer phase times and checks one): the
    run's output, its kernel launches and its seconds."""
    from mla_tpu_torch.ops import cuda

    args = ["--vlm_stage", stage, "--model", "mla-2b", "--hf_llama_dir", str(HF_ROOT), "--global_batch_size",
            str(VLM_ROWS), "--max_steps", str(VLM_STEPS), "--run_root_dir", str(HF_RUNS), "--run_id", stage, *extra]
    torch.cuda.reset_peak_memory_stats()
    cuda.launches.clear()
    t0 = time.perf_counter()
    with checkpoint_writes_skipped() as skipped:
        out = train.main(args)
    torch.cuda.synchronize()
    if skipped != [VLM_STEPS]:
        raise AssertionError(f"hf-vlm {stage}: the run's saves {skipped}, expected one at step {VLM_STEPS}")
    return out, {k: cuda.launches[k] for k in VLM_KERNELS}, time.perf_counter() - t0


def jpeg_rows_equal(ds, rows, pixels, image_size: int) -> int:
    """How many rows of a collated batch hold the CLIP transform of the plain
    loops' decode of their image in Pillow's flavour, whatever its format
    (a JPEG's by the accurate IDCT)."""
    import numpy as np

    from mla_tpu_torch.vla.rlds import frames
    from mla_tpu_torch.vla.vlm_datasets import default_image_transform

    transform = default_image_transform(image_size)
    equal = 0
    for r, i in enumerate(rows):
        data = (ds.image_dir / ds.examples[i]["image"]).read_bytes()
        want = transform(frames.decode(data, "pillow", plain=True))
        equal += int(np.array_equal(np.asarray(pixels[r]), want))
    return equal


def vlm_step_split(torch, out, stage: str, peak_flops, data_root=None) -> dict:
    """Where a VLM step's time goes, on a run's final state: for a
    multimodal and a language-only batch of VLM_ROWS rows (the examples of
    that kind, synthetic or under `data_root`, cycled, as the sampler pads
    a batch), the host's batch (items, collator, vlm_model_batch) and then
    the step from its first launch to a synchronize, each the median of 3,
    with the step's tokens/s and MFU (6N). The trainer's own clock runs
    from one step's commit to the next and does not wait for the card, so
    it mixes the two. These steps go on training the run's state. Under a
    data root of images, the multimodal batch's pixels must equal the CLIP
    transform of the plain loops' decode of each image in Pillow's flavour
    (a JPEG's by the accurate IDCT): the count of rows that do is returned
    under 'jpeg_rows_equal'."""
    import numpy as np

    from mla_tpu_torch.conf.datasets import get_dataset_config
    from mla_tpu_torch.diffusion import gaussian as gd
    from mla_tpu_torch.train import vlm_model_batch
    from mla_tpu_torch.training import strategy
    from mla_tpu_torch.vla.tokenizer import SimpleTokenizer
    from mla_tpu_torch.vla.vlm_datasets import get_vlm_dataset_and_collator

    cfg, state = out["cfg"], out["state"]
    ds, collator = get_vlm_dataset_and_collator(stage, get_dataset_config("llava-v15"), data_root, SimpleTokenizer(),
                                                image_size=cfg.vision.image_size, max_length=VLM_MAX_LENGTH)
    step = strategy.make_train_step(cfg, strategy.TrainConfig(repeated_diffusion_steps=1, stage=f"vlm-{stage}"),
                                    gd.create_schedule("", diffusion_steps=100))
    split = {}
    for kind, S in (("multimodal", VLM_S), ("language-only", VLM_LANG_S)):
        rows = [i for i, ex in enumerate(ds.examples) if ("image" in ex) == (kind == "multimodal")]
        rows = (rows * VLM_ROWS)[:VLM_ROWS]
        host, dev = [], []
        for rep in range(3):
            t0 = time.perf_counter()
            collated = collator([ds[i] for i in rows])
            batch = vlm_model_batch(collated)
            t1 = time.perf_counter()
            if data_root is not None and kind == "multimodal" and rep == 0:
                split["jpeg_rows_equal"] = jpeg_rows_equal(ds, rows, collated["pixel_values"], cfg.vision.image_size)
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            host.append((t1 - t0) * 1e3)
            dev.append((time.perf_counter() - t1) * 1e3)
        ms = float(np.median(dev))
        tok_s = VLM_ROWS * S / (ms / 1e3)
        split[kind] = {"host_batch_ms": float(np.median(host)), "step_ms": ms, "tokens_per_s": tok_s,
                       "mfu": tok_s * out["metrics"].flops_per_token / peak_flops if peak_flops else None}
    return split


def hf_vlm(torch, report):
    """Training from public-layout weights: the HF fixture (hf_fixture, the
    full Llama-2-7b-hf layout), then `python -m mla_tpu_torch.train
    --vlm_stage align --model mla-2b --hf_llama_dir` (VLM_ROWS rows,
    VLM_STEPS steps): the decoder equal to the files' first 8 layers cast
    to bf16, the mean rows included, bit for bit (the decoder is frozen in
    align, so the run's last state shows the load); the vision tower
    unchanged and the projector moved; then --vlm_stage finetune on a
    LLaVA-layout data root of VLM_ROWS images, JPEG at 640 x 480 and every
    other one a golden stream of a format only Pillow reads (TIFF JPEG,
    Group 4, LZW and Deflate, Netpbm, TGA, ICO, QOI: llava_jpeg_fixture
    mixed): the decoder's weights moved, the tower unchanged, the
    multimodal batch's pixels those of the plain loops' decode in Pillow's
    flavour through the CLIP transform. Each run has a
    language-only batch and a multimodal one past the first step. Exact
    launches per step; the last step of each kind: ms, tokens/s, MFU; peak
    GiB, the load's seconds and bytes; then vlm_step_split. Returns the
    launches of both runs."""
    import numpy as np

    from mla_tpu_torch import params as P
    from mla_tpu_torch import train
    from mla_tpu_torch.training import metrics

    rep = {}
    for d in (HF_ROOT, HF_RUNS, LLAVA_ROOT):
        shutil.rmtree(d, ignore_errors=True)
    totals = dict.fromkeys(VLM_KERNELS, 0)
    try:
        t = time.perf_counter()
        llava_jpeg_fixture(LLAVA_ROOT, VLM_ROWS, LLAVA_SIZE, 73, mixed=True)
        rep["llava_fixture"] = {"images": VLM_ROWS, "size": LLAVA_SIZE, "write_s": time.perf_counter() - t}
        rep["fixture"] = hf_fixture(torch, HF_ROOT, 71)
        fx = rep["fixture"]
        log(f"hf-vlm: a Llama-2-7b-hf layout ({HF_CONFIG['num_hidden_layers']} layers, float16, {HF_SHARDS} shards, "
            f"{fx['files']}) written by the port's save_file: {fx['gb']:.2f} GB in {fx['write_s']:.1f} s, "
            f"{fx['gb'] / fx['write_s']:.2f} GB/s (the writes, through the page cache)")
        peak_flops = metrics.bf16_peak_flops(torch.cuda.get_device_name(0))
        for stage in ("align", "finetune"):
            data_root = str(LLAVA_ROOT) if stage == "finetune" else None
            out, launches, run_s = _vlm_run(torch, train, stage, ("--data_root_dir", data_root) if data_root else ())
            cfg, params, load = out["cfg"], out["state"]["params"], out["hf_load"]
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            mm = out["multimodal"]
            expected = vlm_counts(cfg, mm, llm_trained=stage == "finetune")
            if launches != expected:
                raise AssertionError(f"hf-vlm {stage}: launches {launches} over steps {mm} (multimodal?), expected "
                                     f"{expected}")
            for k in VLM_KERNELS:
                totals[k] += launches[k]
            losses = list(out["metrics"].windows["ar_loss"])
            if not (len(losses) == VLM_STEPS and np.isfinite(losses).all()):
                raise AssertionError(f"hf-vlm {stage}: losses {losses}")
            if False not in mm or True not in mm[1:]:
                raise AssertionError(f"hf-vlm {stage}: steps {mm} (multimodal?) lack a language-only batch or a "
                                     "multimodal one past the first step")
            step_s = list(out["metrics"].windows["step_time"])
            # the last step of each kind (the first step is the warm-up): ms,
            # tokens/s and MFU (the trainer's 6N a token) at its S
            by_kind = {}
            for kind, S in (("multimodal", VLM_S), ("language-only", VLM_LANG_S)):
                i = max(j for j, m in enumerate(mm) if m == (kind == "multimodal"))
                tok_s = VLM_ROWS * S / step_s[i]
                by_kind[kind] = {"step": i, "S": S, "ms": step_s[i] * 1e3, "tokens_per_s": tok_s,
                                 "mfu": tok_s * out["metrics"].flops_per_token / peak_flops if peak_flops else None}
            # the decoder against the files, the tower and projector against the seeded init
            want = hf_expected_decoder(torch, HF_ROOT, cfg)
            llm = dict(P.tree_items(params["llm_backbone"]))
            differ = [k for k, w in want.items() if llm[k].dtype != w.dtype or not torch.equal(llm[k], w)]
            init, _ = P.init(cfg, seed=7, device="cuda")  # train_vlm's default seed
            tower_same = all(torch.equal(a, b) for (_, a), (_, b) in zip(P.tree_items(params["vision_tower_2d"]),
                                                                         P.tree_items(init["vision_tower_2d"])))
            proj_moved = any(not torch.equal(a, b) for (_, a), (_, b) in zip(P.tree_items(params["projector_2d"]),
                                                                             P.tree_items(init["projector_2d"])))
            del init, want
            pad_rows = cfg.llama.vocab_size - HF_CONFIG["vocab_size"]
            steps_line = ", ".join(
                f"{k} (step {v['step']}, S = {v['S']}) {v['ms']:.1f} ms, {v['tokens_per_s']:.0f} tokens/s, MFU "
                f"{v['mfu'] if v['mfu'] is None else round(v['mfu'], 4)}" for k, v in by_kind.items())
            log(f"hf-vlm {stage} mla-2b ({gpu_line()}): run {run_s:.1f} s; the HF load {load['seconds']:.1f} s, "
                f"{load['bytes_read'] / 1e9:.2f} GB of tensors read of the directory's {load['dir_bytes'] / 1e9:.2f} "
                f"GB; steps {['multimodal' if m else 'language-only' for m in mm]}, ar losses {losses}, step ms "
                f"{[round(t * 1e3, 1) for t in step_s]}; the last {steps_line}; peak {peak_gib:.2f} GiB; launches "
                f"{launches}; decoder leaves differing from the files' {differ or 'none'} ({len(llm)} leaves, "
                f"{pad_rows} mean rows); vision tower unchanged {tower_same}, projector moved {proj_moved}")
            if stage == "align" and differ:
                raise AssertionError(f"hf-vlm align: the decoder differs from the files in {differ}")
            # finetune moves every weight matrix; a bf16 norm scale near 1
            # (a step of 2^-7) may stay put under updates of lr 2e-5
            stayed = sorted(k for k in set(llm) - set(differ) if not k.endswith("/scale"))
            if stage == "finetune" and stayed:
                raise AssertionError(f"hf-vlm finetune: decoder weights unchanged from the files: {stayed}")
            if not tower_same or not proj_moved:
                raise AssertionError(f"hf-vlm {stage}: vision tower unchanged {tower_same}, projector moved "
                                     f"{proj_moved}")
            split = vlm_step_split(torch, out, stage, peak_flops, data_root)
            jpeg_equal = split.pop("jpeg_rows_equal", None)
            log(f"hf-vlm {stage}{' on ' + str(VLM_ROWS) + ' images (JPEG ' + str(LLAVA_SIZE[1]) + ' x ' + str(LLAVA_SIZE[0]) + ' and other formats)' if data_root else ''}: "
                "the host's batch, then the step to a synchronize (median of 3): " + ", ".join(
                    f"{k} {v['host_batch_ms']:.1f} ms + {v['step_ms']:.1f} ms ({v['tokens_per_s']:.0f} tokens/s, MFU "
                    f"{v['mfu'] if v['mfu'] is None else round(v['mfu'], 4)})" for k, v in split.items())
                + (f"; the multimodal batch's rows equal to the plain loops' decode: {jpeg_equal} of {VLM_ROWS}"
                   if data_root else ""))
            if data_root and jpeg_equal != VLM_ROWS:
                raise AssertionError(f"hf-vlm {stage}: {jpeg_equal} of {VLM_ROWS} image rows equal the plain decode")
            rep[stage] = {"run_s": run_s, "hf_load": load, "multimodal": mm, "losses": losses, "steps": by_kind,
                          "data_root": data_root, "jpeg_rows_equal": jpeg_equal,
                          "split": split, "peak_gib": peak_gib, "step_times_s": step_s, "launches": launches,
                          "expected": expected, "decoder_leaves_differing": differ, "pad_rows": pad_rows}
            del out, params
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        gc.collect()
        for d in (HF_ROOT, HF_RUNS, LLAVA_ROOT):
            shutil.rmtree(d, ignore_errors=True)
    report["hf_vlm"] = rep
    return totals


# --------------------------------------------------------------------------- #
# dp: training over a process group
# --------------------------------------------------------------------------- #

DP_ROOT = Path("build") / "chip_smoke_dp"
DP_EQ_STEPS = 2
DP_EQ_RTOL = 1e-6
DP_PLAIN_TRAINER_MS = (606.0, 613.7)  # the one-device trainer's step at mla-2b, as PERF.md section 5 records it
DP_LAUNCH = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@contextlib.contextmanager
def nccl_world_of_one(torch):
    """A one-rank NCCL process group in this process (NCCL refuses two ranks
    on one device) and torchrun's variables for it, which train.main reads,
    for the block; both gone after it."""
    import torch.distributed as dist

    from mla_tpu_torch.parallel.mesh import initialize_distributed

    saved = {k: os.environ.get(k) for k in DP_LAUNCH}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(_free_port()))
    try:
        initialize_distributed("cuda")
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_equality(torch, report) -> dict:
    """DP_EQ_STEPS steps of mla-small (fp32 masters, bf16 compute,
    accumulation 2, 2 diffusion repeats, B = 4) from the same weights, batch
    and per-step generators over the one-process mesh (no group, no
    collective) and over the NCCL world-1 mesh: the losses and launches equal,
    grad_norm and every updated master within DP_EQ_RTOL of its largest
    magnitude."""
    from dataclasses import replace

    from mla_tpu_torch import params as P
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.diffusion import gaussian as gd
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.parallel.mesh import make_mesh
    from mla_tpu_torch.training import optim, strategy
    from mla_tpu_torch.utils import step_generator
    from mla_tpu_torch.vla.dummy import synthetic_batch

    base = get_model_config("mla-small")
    cfg = replace(base, llama=replace(base.llama, param_dtype=torch.float32))
    params, state = P.init(cfg, seed=8, device="cuda")
    live_head(torch, params, 9)
    batch = synthetic_batch(cfg, B=4, L=32, seed=10)
    sched = gd.create_schedule("", diffusion_steps=100)
    tcfg = strategy.TrainConfig(grad_accumulation_steps=2, repeated_diffusion_steps=2, learning_rate=1e-4)
    runs = {}
    # the card's gather / scatter backward sums with atomics unless asked
    # not to; a step that differs from itself cannot be held to another
    torch.use_deterministic_algorithms(True, warn_only=True)
    for mode in ("plain", "plain-again", "sharded"):
        p = P.tree_map(lambda t: t.detach().clone(), params)
        opt, _, _ = optim.make_optimizer(p, **tcfg.optimizer_settings())
        st = strategy.init_train_state(p, opt, P.tree_map(lambda t: t.clone(), state),
                                       mesh=make_mesh(dp=1) if mode == "sharded" else None,
                                       compute_dtype=cfg.llama.compute_dtype)
        step = strategy.make_train_step(cfg, tcfg, sched)
        cuda.launches.clear()
        metrics = []
        for i in range(DP_EQ_STEPS):
            st, m = step(st, batch, step_generator(0, i, "cuda"))
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        launches = {k: cuda.launches[k] for k in TRAINER_KERNELS}
        masters = st["shards"].host_state(st)["params"]
        copies = sorted({str(leaf.dtype) for leaf in st["shards"].gatherer.leaves
                         if leaf.path.startswith("llm_backbone/layers/")})
        runs[mode] = {"metrics": metrics, "launches": launches, "masters": dict(P.tree_items(masters)),
                      "layer_dtypes": copies}
        del st, step, opt, p
        gc.collect()
        torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    a, b, c = runs["sharded"], runs["plain"], runs["plain-again"]
    repeat = {"loss_equal": all(x["total_loss"] == y["total_loss"] for x, y in zip(c["metrics"], b["metrics"])),
              "leaves_identical": sum(torch.equal(c["masters"][p], w) for p, w in b["masters"].items())}
    loss_equal = all(x["total_loss"] == y["total_loss"] for x, y in zip(a["metrics"], b["metrics"]))
    gn = max(abs(x["grad_norm"] / y["grad_norm"] - 1) for x, y in zip(a["metrics"], b["metrics"]))
    leaf = {p: float((a["masters"][p].double() - w.double()).abs().max() / max(float(w.abs().max()), 1e-30))
            for p, w in b["masters"].items()}
    worst = max(leaf, key=leaf.get)
    identical = sum(torch.equal(a["masters"][p], w) for p, w in b["masters"].items())
    out = {"losses": [m["total_loss"] for m in a["metrics"]], "plain_losses": [m["total_loss"] for m in b["metrics"]],
           "plain_repeat": repeat, "loss_equal": loss_equal, "grad_norm_rel": gn,
           "worst_leaf": worst, "worst_leaf_rel": leaf[worst], "leaves_identical": identical,
           "leaves": len(leaf), "launches": a["launches"], "plain_launches": b["launches"],
           "sharded_layer_dtypes": a["layer_dtypes"], "plain_layer_dtypes": b["layer_dtypes"]}
    log(f"dp equality mla-small fp32 masters, NCCL world 1, {DP_EQ_STEPS} steps of accumulation 2: losses "
        f"{out['losses']} ({'equal' if loss_equal else 'DIFFERENT'} to the one-process step's {out['plain_losses']}; "
        f"the one-process step run again: losses {'equal' if repeat['loss_equal'] else 'DIFFERENT'}, "
        f"{repeat['leaves_identical']} masters bit-identical), grad_norm rel "
        f"{gn:.3e}, worst master {worst} {leaf[worst]:.3e} (tol {DP_EQ_RTOL}), {identical} of {len(leaf)} masters "
        f"bit-identical; decoder layers gathered in {a['layer_dtypes']} (one-process: {b['layer_dtypes']}); launches "
        f"{a['launches']} vs {b['launches']}")
    if not (loss_equal and a["launches"] == b["launches"] and gn <= DP_EQ_RTOL and leaf[worst] <= DP_EQ_RTOL):
        raise AssertionError(f"dp: the NCCL world-1 step differs from the one-process step: {out}")
    return out


def dp_agree(torch, report):
    """dp_equality over a world-1 NCCL group in this process."""
    with nccl_world_of_one(torch):
        report["dp_agree"] = dp_equality(torch, report)


def dp_phase(torch, report):
    """2 steps of mla_tpu_torch.train --model mla-2b --dp 1 (the trainer
    phase's flags: fp32 masters, accumulation 2) in this process at world
    size 1 over NCCL with exact launches, the save skipped; step ms,
    tokens/s, MFU, peak GiB and the rank's optimizer GiB (fp32 masters
    and moments) beside the one-device trainer's. Returns the run's
    launches."""
    import numpy as np

    from mla_tpu_torch import train
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.training import metrics

    rep = {}
    shutil.rmtree(DP_ROOT, ignore_errors=True)
    args = list(TRAINER_ARGS) + ["--run_root_dir", str(DP_ROOT / "runs"), "--dp", "1"]
    try:
        # -- 2 steps in this process at world size 1 ---------------------------
        with nccl_world_of_one(torch):
            torch.cuda.reset_peak_memory_stats()
            cuda.launches.clear()
            with checkpoint_writes_skipped() as skipped:
                out = train.main(args + ["--run_id", "dp-in-process", "--max_steps", "2"])
            torch.cuda.synchronize()
            totals = {k: cuda.launches[k] for k in TRAINER_KERNELS}
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            shards = out["state"]["shards"]
            opt_gib = shards.optimizer_bytes()["held"] / 2**30
            masters_gib = sum(m.numel() * m.element_size() for m in shards.masters if m is not None) / 2**30
            cfg, state = out["cfg"], out["state"]
            copies = sorted({str(leaf.dtype) for leaf in shards.gatherer.leaves})
        expected = trainer_counts(cfg, micro_batches=2 * 2)
        if totals != expected:
            raise AssertionError(f"dp: steps 1-2 in this process launched {totals}, expected {expected}")
        losses = list(out["metrics"].windows["total_loss"])
        if not (int(state["step"]) == 2 and all(np.isfinite(losses))):
            raise AssertionError(f"dp: the run in this process reached step {state['step']}, losses {losses}")
        S = 16 + cfg.fused_len + cfg.diff_block_len
        tokens = 4 * 4 * S
        peak = metrics.bf16_peak_flops(torch.cuda.get_device_name(0))
        ms, tok_s, mfu = _trainer_step_line(out, tokens, out["metrics"].flops_per_token, peak)
        rep["in_process"] = {"losses": losses, "step_ms": ms, "tokens_per_s": tok_s, "mfu": mfu,
                             "peak_gib": peak_gib, "optimizer_gib": opt_gib, "masters_gib": masters_gib,
                             "compute_dtypes": copies, "launches": totals, "save_skipped_at_step": skipped,
                             "step_times_s": list(out["metrics"].windows["step_time"]),
                             "plain_trainer_ms": DP_PLAIN_TRAINER_MS}
        log(f"dp: steps 1-2 of mla-2b at world 1 in this process ({gpu_line()}): losses {losses}, step 2 {ms:.1f} ms "
            f"(one-device trainer "
            f"{DP_PLAIN_TRAINER_MS[0]}-{DP_PLAIN_TRAINER_MS[1]} ms in PERF.md), {tok_s:.0f} tokens/s, MFU "
            f"{mfu if mfu is None else round(mfu, 4)}, peak {peak_gib:.2f} GiB, the rank's optimizer "
            f"{opt_gib:.2f} GiB (masters {masters_gib:.2f} GiB; N ranks hold 1/N of it), gathered in "
            f"{copies}, launches {totals}, the save skipped at step {skipped}")
        del out, state, shards
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(DP_ROOT, ignore_errors=True)
    report["dp"] = rep
    return totals


# tensor parallelism: the int8 mla-7b at full width and depth served by
# the ranks (child processes of this script) of each mesh of TP_MESHES (T:
# one tp group; T x F: F fsdp ranks beside it, each holding 1/F of every
# leaf), held to the one-process policy on the same weights and x_T. On one
# card the ranks share it over gloo, which the caller names (NCCL refuses
# two ranks on one device; parallel/tensor.SharedCard exchanges through
# buffers on the card), so their times are not tensor-parallel speed.
TP_MESHES = "2,2x2"
TP_SEED = 180
TP_ROOT = Path("build") / "chip_smoke_tp"
TP_TIMEOUT = 600
TP_KERNELS = ("w8a8_matmul", "w8a8_row_scale", "w8a8_matmul_acc", "w8a8_rescale", "int8_matmul",
              "int8_matmul_f32out", "flash_attention", "furthest_point_sample")
TP_CHUNK_RTOL = 1e-3  # of the chunk's scale, where a chunk is not bit-identical
# the AR logits: the weight-only products sum in fp32 in another order
# under tp (a rank's split of K, its partials added across the group), so
# a bf16 output rounds one ulp apart where its sum lies near a rounding
# boundary (with K = 4096 random terms, ~1e-4 relative), as the card's
# kernel differs from its plain version (ar-agree); 4 layers give ~1e-2 of
# the logits' scale, 32 random layers ~2.5e-2 (PERF.md section 6), as the
# serving host's rows grow. Both sides' decode steps are fed the
# one-process greedy ids; the logits are held to AR_AGREE_RTOL on the
# decoder cut to TP_CUT_LAYERS and to TP_AR_FULL_DEPTH_RTOL at 32 layers,
# where predict_action_ar's own ids must equal. That limit sits above the
# sound readings (2.2-2.7e-2) and below a group whose row-parallel sums
# drop the other ranks' partials (the control, which it must reject)
TP_CUT_LAYERS = BUCKET_ROWS_LAYERS
TP_AR_FULL_DEPTH_RTOL = 5e-2
# ROADMAP item 16 (a) and (b) on each mesh, the same calls in one process:
# the batched DPM-4 chunks at bucket TP_BUCKET (W8A8, M = 4 x 534 prefill
# rows a rank), beam search (TP_BEAMS beams over TP_BEAM_TOKENS tokens) and
# sampled text (TP_SAMPLING, TP_TEXT_TOKENS tokens) through the weight-only
# policy (int8_mm's fp32 partials at M = B x K rows), beam search through
# the W8A8 policy too (the serving default), and the serving host:
# a BatchingServer on rank 0 leading the other ranks (serving.lead and
# follow), each client's waves of requests submitted at once, every
# dispatch replayed here through the one-process policy
TP_BUCKET = 4
TP_BEAMS, TP_BEAM_TOKENS = 4, 8
TP_TEXT_TOKENS = 8
TP_SAMPLING = dict(temperature=0.7, top_k=50)
TP_AR_MODE = "weight_only"
# two clients' waves of requests, at once, then the first client's tail
# waves alone (so every bucket of 1/2/4 is dispatched): 12 requests
TP_HOST_WAVES, TP_HOST_TAIL = ((4, 2), (2, 1)), (2, 1)
# each call's decoder forwards and int8 mode; a beam search of n tokens
# runs n - 1 decode steps, greedy and sampled decoding n
TP_FORWARDS = {"ddim": 1 + 8, "dpm": 1 + 4, "ar": None, "batched": 1 + 4, "beams": TP_BEAM_TOKENS,
               "beams_w8a8": TP_BEAM_TOKENS, "sampled": 1 + TP_TEXT_TOKENS}
TP_MODES = {"ddim": "w8a8", "dpm": "w8a8", "ar": "weight_only", "batched": "w8a8", "beams": TP_AR_MODE,
            "beams_w8a8": "w8a8", "sampled": TP_AR_MODE}
# the plain attention (ops/attention.py: the read-only suffix and the decode
# step) runs a layer's heads as the batch of cuBLAS's GEMMs, so a tp rank's
# call holds 1/T of the one-process call's heads; where that changes the
# rounding of a head's output (tp_attention, measured in the phase), a
# call's chunk is held to FULL_DEPTH_RTOL (32 random W8A8 layers grow a
# bf16 ulp as they grow the bucket rows' batch-dependent roundings) in place
# of TP_CHUNK_RTOL
TP_ATTENTION_ROWS = {"suffix": (1, 2, TP_BUCKET), "decode": (1, TP_BEAMS)}
# beam search over a rank's roundings (the weight-only products' fp32 order,
# the decode attention over its heads) may pick another best beam than one
# process: its length-penalized log-prob is then held to the one process's
# within TP_BEAM_SCORE_RTOL (read on an H100: 9.5e-4 in W8A8, 2.1e-3
# weight-only)
TP_BEAM_SCORE_RTOL = 1e-2


def tp_expected(cfg, T: int) -> dict:
    """Each call's launches on a rank of a tp group of T (1: one process):
    a forward's four int8 linears a layer, of which o and down are
    row-parallel under tp (W8A8: row scale, int32 product and rescale;
    weight-only: fp32 partials), the int8 lm_head of each AR forward (its
    vocabulary split), the flash prefill on the rank's heads and FPS 2
    (at any batch)."""
    L = cfg.llama.num_layers
    out = {}
    for call, mode in TP_MODES.items():
        forwards = TP_FORWARDS[call] or 1 + cfg.action_dim
        e = dict.fromkeys(TP_KERNELS, 0)
        e.update(flash_attention=L, furthest_point_sample=cfg.point.num_stages)
        if mode == "weight_only":
            e["int8_matmul"] = (4 if T == 1 else 2) * L * forwards
            e["int8_matmul_f32out"] = 0 if T == 1 else 2 * L * forwards
        elif T == 1:
            e["w8a8_matmul"] = 4 * L * forwards
        else:
            for k in ("w8a8_matmul", "w8a8_row_scale", "w8a8_matmul_acc", "w8a8_rescale"):
                e[k] = 2 * L * forwards
        if call in ("ar", "beams", "beams_w8a8", "sampled"):
            e["int8_matmul"] += forwards  # the lm_head, fp32
        out[call] = e
    return out


def tp_attention(torch, cfg) -> dict:
    """{(kind, rows, T): outputs that differ}: the plain attention of the
    int8 mla-7b's shapes (the read-only suffix: 18 queries over the 535-slot
    prefix, rows B; a decode step: 1 query, rows B x K) on all the heads at
    once against the same heads in T calls of 1/T of them (a tp rank's),
    bf16, seeded."""
    from mla_tpu_torch.ops import attention

    H, hd = cfg.llama.num_heads, cfg.llama.head_dim
    gen = torch.Generator(device="cuda").manual_seed(TP_SEED)
    out = {}
    for kind, rows_list in TP_ATTENTION_ROWS.items():
        S, Sc, cache_len = (SUFFIX_LEN, PREFIX_LEN + SUFFIX_LEN + 33, PREFIX_LEN) if kind == "suffix" else (
            1, PREFIX_LEN + TP_BEAM_TOKENS + 32, PREFIX_LEN + 3)
        for rows in rows_list:
            draws = 1 if kind == "suffix" else 8  # a decode step has few outputs: several draws show a difference
            q, k, v, kc, vc = (torch.randn((rows * draws, H, n, hd), generator=gen, device="cuda").to(torch.bfloat16)
                               for n in (S, S, S, Sc, Sc))
            mask = torch.arange(Sc, device="cuda")[None].expand(rows, -1) < cache_len + S

            def run(d, a, b):
                r = slice(d * rows, (d + 1) * rows)
                return attention.decoder_attention(q[r, a:b].contiguous(), k[r, a:b].contiguous(),
                                                   v[r, a:b].contiguous(), (kc[r, a:b].clone(), vc[r, a:b].clone()),
                                                   cache_len, mask, cache_read_only=kind == "suffix")

            for T in (2, 4):
                n = H // T
                out[(kind, rows, T)] = sum(int((torch.cat([run(d, t * n, (t + 1) * n) for t in range(T)], dim=1)
                                                != run(d, 0, H)).sum()) for d in range(draws))
    return out


def tp_policies(torch, cfg, mesh, cut: bool = True) -> dict:
    """The seeded int8 mla-7b (live head) and its W8A8 and weight-only
    policies over `mesh` (None: one process), and with `cut` a weight-only
    policy of it cut to TP_CUT_LAYERS ('cut'); the whole trees are freed."""
    from dataclasses import replace

    from mla_tpu_torch import params as P
    from mla_tpu_torch.models.mla import MLAPolicy
    from mla_tpu_torch.ops.quantization import quantize_model

    pols = {}
    short = replace(cfg, llama=replace(cfg.llama, num_layers=TP_CUT_LAYERS))
    for c, modes in ((cfg, ("w8a8", "weight_only")), (short, ("cut",)))[: 2 if cut else 1]:
        params, state = P.init(c, seed=TP_SEED, device="cuda")
        live_head(torch, params, TP_SEED + 1)
        params = quantize_model(params)
        pols.update({mode: MLAPolicy(params, state, c, norm_stats=STATS, mesh=mesh,
                                     int8_mode="weight_only" if mode == "cut" else mode) for mode in modes})
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return pols


def tp_calls(torch, cfg, pols, feed=None) -> dict:
    """One request through DDIM-8, DPM-4 (W8A8) and predict_action_ar's
    ids (weight-only), TP_BUCKET rows through the batched DPM-4 (W8A8),
    the request through TP_BEAMS-beam search and sampled generate_text
    (TP_AR_MODE): outputs, launches and host ms of each call (a first
    call: no warm-up, the ranks' calls over gloo take seconds); then the AR
    logits of a prefill and the decode steps, at full depth and cut, fed
    feed[key] (None: their own greedy ids; drive_ar, in the policy's tp
    block), and under a tp group the full-depth logits once more with the
    row-parallel all-reduce SUM skipped (the control); over fsdp each
    call's layer gathers and most whole layers alive (fsdp.counts) and the
    layer stack a rank holds."""
    import numpy as np

    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.parallel import fsdp, tensor

    img, pc, ids, noise = request_inputs(cfg, TP_SEED)
    frames, clouds = serve_frames(cfg, TP_BUCKET, TP_SEED + 2)
    calls = {s: (lambda s=s: pols["w8a8"].predict_action_diff(img, pc, "", input_ids=ids, noise=noise, sampler=s,
                                                              return_normalized=True)) for s in ("ddim", "dpm")}
    calls["ar"] = lambda: pols["weight_only"].generate_ids(img, pc, ids, cfg.action_dim)[0]
    calls["batched"] = lambda: pols["w8a8"].dispatch_action_diff_batched(
        np.stack(frames), np.stack(clouds), input_ids=np.repeat(ids, TP_BUCKET, 0), seed=TP_SEED, sampler="dpm",
        return_normalized=True)()
    calls["beams"] = lambda: pols[TP_AR_MODE].generate_ids(img, pc, ids, TP_BEAM_TOKENS, num_beams=TP_BEAMS)
    calls["beams_w8a8"] = lambda: pols["w8a8"].generate_ids(img, pc, ids, TP_BEAM_TOKENS, num_beams=TP_BEAMS)
    calls["sampled"] = lambda: pols[TP_AR_MODE].generate_text(img, pc, "", input_ids=ids,
                                                              max_new_tokens=TP_TEXT_TOKENS, seed=TP_SEED,
                                                              **TP_SAMPLING)
    torch.cuda.synchronize()
    out = {"launches": {}, "ms": {}, "gathers": {}}
    for name, fn in calls.items():
        cuda.launches.clear()
        fsdp.reset_counts()
        t = time.perf_counter()
        got = fn()
        if name.startswith("beams"):  # the ids [1, n] and the best beam's score
            got, out[f"{name}_score"] = got[0], float(got[1][0])
        out[name] = np.asarray(got)
        torch.cuda.synchronize()
        out["ms"][name] = (time.perf_counter() - t) * 1e3
        out["launches"][name] = {k: cuda.launches[k] for k in TP_KERNELS}
        out["gathers"][name] = {k: fsdp.counts[k] for k in ("layer_gathers", "max_live_layers", "live_layers")}
    for key in [k for k in ("weight_only", "cut") if k in pols]:
        with pols[key].tp_scope() as params:
            logits, fed, _ = drive_ar(torch, pols[key], img, pc, ids, cfg.action_dim, feed and feed[key], params)
        out[f"{key}_logits"], out[f"{key}_fed"] = logits.numpy(), fed
    if pols["weight_only"].mesh is not None:
        real = tensor.reduce_from_tp
        tensor.reduce_from_tp = lambda x: x
        try:
            with pols["weight_only"].tp_scope() as params:
                logits, _, _ = drive_ar(torch, pols["weight_only"], img, pc, ids, cfg.action_dim,
                                        feed["weight_only"], params)
        finally:
            tensor.reduce_from_tp = real
        out["control_logits"] = logits.numpy()
    out["decoder_gib"] = {mode: tree_gib(pols[mode].params["llm_backbone"]) for mode in ("w8a8", "weight_only")}
    out["layer_bytes"] = {mode: pols[mode].gatherer.layer_bytes() for mode in ("w8a8", "weight_only")
                          if pols[mode].gatherer is not None}
    return out


def tp_child(root: Path, backend: str, fsdp: int) -> int:
    """One rank of the tp phase (its launch variables set by the parent,
    which starts it ahead of its turn): imports, waits for root/go (the
    group's address, written when its mesh's turn comes), then
    joins the group over `backend` on cuda:LOCAL_RANK, builds its part of
    the int8 mla-7b over serving_mesh(fsdp) (one rank at a time where the
    ranks share a card: each draws the whole tree there; the policy over
    the decoder cut to TP_CUT_LAYERS only at fsdp 1) and writes tp_calls'
    results, its decode steps fed the ids of root/feed.json, to
    root/rank{R}.pt."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.parallel import mesh as tmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    go, deadline = root / "go", time.monotonic() + TP_TIMEOUT
    while not go.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{go} was not written within {TP_TIMEOUT} s")
        time.sleep(0.05)
    os.environ["MLA_COORDINATOR_ADDRESS"] = go.read_text()
    launch = tmesh.initialize_distributed("cuda", backend=backend)
    mesh = tmesh.serving_mesh(fsdp=fsdp)
    cfg = get_model_config("mla-7b")
    t0 = time.perf_counter()
    shared = torch.cuda.device_count() < launch["world"]
    for turn in range(launch["world"] if shared else 1):
        if not shared or turn == launch["rank"]:
            pols = tp_policies(torch, cfg, mesh, cut=fsdp == 1)
        if shared:
            dist.barrier()
    build_s = time.perf_counter() - t0
    build_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    out = tp_calls(torch, cfg, pols, json.loads((root / "feed.json").read_text()))
    out["host"] = tp_host(torch, cfg, pols["w8a8"])
    out.update(build_s=build_s, build_peak_gib=build_peak_gib, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               device=torch.cuda.get_device_name(launch["device"]), backend=backend,
               mesh={"tp": mesh.tp, "fsdp": mesh.fsdp})
    torch.save(out, root / f"rank{launch['rank']}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def tp_host(torch, cfg, policy) -> dict:
    """The serving host over the policy's mesh: on rank 0 a BatchingServer
    (DPM-4, buckets 1/2/4) on `policy`, which leads the other ranks
    (serving.lead), two client threads submitting TP_HOST_WAVES, then the
    first client's TP_HOST_TAIL alone; each
    dispatch's arguments and normalized chunks recorded for the replay.
    The other ranks follow (serving.follow) until rank 0 closes the
    channel. Each rank's launches over the run."""
    import threading

    import numpy as np

    from mla_tpu_torch import serving
    from mla_tpu_torch.ops import cuda

    torch.cuda.synchronize()
    cuda.launches.clear()
    t0 = time.perf_counter()
    if policy.mesh.rank != 0:
        n = serving.follow(policy)
        torch.cuda.synchronize()
        return {"followed": n, "launches": {k: cuda.launches[k] for k in TP_KERNELS}}
    channel = serving.lead(policy)
    log, real = [], policy.dispatch_action_diff_batched

    def recording(images, pointclouds, **kw):
        finalize = real(images, pointclouds, return_normalized=True, **kw)

        def recorded():
            chunks = finalize()
            log.append({"images": images, "pointclouds": pointclouds, "kw": kw, "chunks": chunks})
            return chunks
        return recorded

    policy.dispatch_action_diff_batched = recording
    _, _, ids, _ = request_inputs(cfg, TP_SEED)
    waves = TP_HOST_WAVES + (TP_HOST_TAIL,)
    frames, clouds = serve_frames(cfg, sum(sum(w) for w in waves), TP_SEED + 3)
    results, errors = [], []
    server = serving.BatchingServer(policy, sampler="dpm", max_wait_ms=SERVE_WAIT_MS)
    try:
        def client(c):
            start = sum(sum(w) for w in waves[:c])
            for k in waves[c]:
                try:
                    futs = [server.submit(frames[i], clouds[i], input_ids=ids, seed=i) for i in range(start, start + k)]
                    results.extend(f.result(timeout=TP_TIMEOUT) for f in futs)
                except Exception as e:  # noqa: BLE001 - counted, reported by the parent
                    errors.append(repr(e))
                start += k

        threads = [threading.Thread(target=client, args=(c,)) for c in range(len(TP_HOST_WAVES))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        client(len(TP_HOST_WAVES))  # the first client's tail, alone
        stats = server.stats()
    finally:
        server.close()
        channel.close()
        del policy.dispatch_action_diff_batched
    torch.cuda.synchronize()
    return {"requests": len(results), "errors": errors + ([f"{stats['errors']} server errors"] if stats["errors"]
                                                          else []),
            "buckets": stats["batch_size_hist"], "dispatches": len(log), "log": log,
            "finite": all(np.isfinite(r).all() and r.shape == (cfg.action_horizon, cfg.action_dim) for r in results),
            "s": time.perf_counter() - t0, "launches": {k: cuda.launches[k] for k in TP_KERNELS}}


def tp_spawn(backend: str, tp: int, fsdp: int) -> list:
    """tp * fsdp ranks of this script (--tp-child) for serving_mesh(fsdp),
    started ahead of their turn: they import and wait for their root's go
    file (tp_ranks writes it)."""
    world, root = tp * fsdp, TP_ROOT / f"{tp}x{fsdp}"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    env = {k: v for k, v in os.environ.items() if k not in DP_LAUNCH + ("MLA_COORDINATOR_ADDRESS",)}
    return [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--tp-child", str(root), backend,
                              str(fsdp)],
                             env={**env, "MLA_NUM_PROCESSES": str(world), "MLA_PROCESS_ID": str(r),
                                  "LOCAL_RANK": str(r)},
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]


def tp_replay(one, host: dict) -> list:
    """Rank 0's serving-host dispatches replayed through the one-process
    policy `one` (dispatch_action_diff_batched, normalized chunks): each
    dispatch's bucket, whether it was bit-identical, and its largest error
    of the replay's scale."""
    import numpy as np

    out = []
    for d in host["log"]:
        again = one.dispatch_action_diff_batched(d["images"], d["pointclouds"], return_normalized=True, **d["kw"])()
        out.append({"bucket": int(d["images"].shape[0]), "identical": bool(np.array_equal(again, d["chunks"])),
                    "max_err_of_scale": float(np.abs(again - d["chunks"]).max()) / float(np.abs(again).max())})
    return out


def tp_chunk_tol(attn: dict, rows: int, tp: int) -> float:
    """A tp chunk's tolerance at `rows` rows where it is not bit-identical:
    FULL_DEPTH_RTOL where the plain suffix attention of a rank's heads
    rounds apart from the one-process call's at those rows (tp_attention),
    else TP_CHUNK_RTOL."""
    return FULL_DEPTH_RTOL if attn[("suffix", rows, tp)] else TP_CHUNK_RTOL


def tp_ranks(torch, cfg, ref, procs, backend: str, tp: int, fsdp: int, one, attn, beside=None) -> tuple:
    """The ranks `procs` (tp_spawn's) over serving_mesh(fsdp), their decode
    steps fed the reference's ids; each rank held to `ref` (see tp_phase),
    rank 0's serving-host dispatches replayed through the one-process W8A8
    policy `one`, the tolerances where a call is not bit-identical by
    `attn` (tp_attention's), each rank's decoder GiB logged beside `beside`
    (an earlier mesh's entry at the same tp). Returns (the report's entry,
    rank 0's launches, the failures)."""
    import numpy as np

    world, root = tp * fsdp, TP_ROOT / f"{tp}x{fsdp}"
    (root / "feed.json").write_text(json.dumps({key: ref[f"{key}_fed"] for key in ("weight_only", "cut")}))
    (root / "go.partial").write_text(f"127.0.0.1:{_free_port()}")
    (root / "go.partial").rename(root / "go")
    t0 = time.perf_counter()
    try:
        outs = [p.communicate(timeout=TP_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    label = f"{world}" if fsdp == 1 else f"{world} (tp {tp} x fsdp {fsdp})"
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"tp: rank {r} of {label} exited {p.returncode}:\n"
                                 + "\n".join(text.splitlines()[-30:]))
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(world)]
    shared = torch.cuda.device_count() < world  # ranks share cards: their times are not tensor-parallel speed
    rep = {"backend": backend, "world": world, "tp": tp, "fsdp": fsdp, "s": time.perf_counter() - t0, "ranks": [],
           "cards_shared": shared}
    want = tp_expected(cfg, tp)
    forwards = {c: n or 1 + cfg.action_dim for c, n in TP_FORWARDS.items()}
    L = cfg.llama.num_layers
    keys = ("ddim", "dpm", "ar", "batched", "beams", "beams_w8a8", "sampled", "weight_only_logits") + (
        ("cut_logits",) if fsdp == 1 else ())
    failed = []
    host = ranks[0]["host"]
    host_want = {k: v * host["dispatches"] for k, v in want["dpm"].items()}
    replay = tp_replay(one, host)
    rep["host"] = {k: host[k] for k in ("requests", "buckets", "dispatches", "s", "errors")}
    rep["host"]["replay"] = replay
    if (host["errors"] or host["requests"] != sum(sum(w) for w in TP_HOST_WAVES + (TP_HOST_TAIL,))
            or not host["finite"] or set(host["buckets"]) != {1, 2, 4}):
        failed.append(f"the serving host over {label}: {host['requests']} requests answered, errors "
                      f"{host['errors']}, finite [16, 7] chunks {host['finite']}, buckets {host['buckets']}")
    for d in replay:
        tol = tp_chunk_tol(attn, d["bucket"], tp)
        if not d["identical"] and not d["max_err_of_scale"] <= tol:
            failed.append(f"the serving host over {label}: a bucket-{d['bucket']} dispatch's chunks are "
                          f"{d['max_err_of_scale']} of their scale from its replay on one process (tol {tol})")
    log(f"tp serving host over {label}: {host['requests']} requests from {len(TP_HOST_WAVES)} clients (the first's "
        f"tail {TP_HOST_TAIL} alone) in "
        f"{host['dispatches']} dispatches, buckets {host['buckets']}, {host['s']:.1f} s; replayed on one process: "
        + ", ".join(f"bucket {d['bucket']} " + ("identical" if d["identical"] else
                                                f"NOT identical, {d['max_err_of_scale']:.4g} of its scale (tol "
                                                f"{tp_chunk_tol(attn, d['bucket'], tp)})") for d in replay))
    for r, got in enumerate(ranks):
        if got["mesh"] != {"tp": tp, "fsdp": fsdp}:
            failed.append(f"rank {r} of {label} served over {got['mesh']}")
        if got["launches"] != want:
            failed.append(f"rank {r} of {label} launched {got['launches']}, expected {want}")
        if r > 0 and got["host"]["followed"] != host["dispatches"]:
            failed.append(f"rank {r} of {label} followed {got['host']['followed']} of rank 0's "
                          f"{host['dispatches']} dispatches")
        if got["host"]["launches"] != host_want:
            failed.append(f"rank {r} of {label} launched {got['host']['launches']} in the serving host, expected "
                          f"{host_want} ({host['dispatches']} DPM-4 dispatches)")
        gathers = {c: L * n if fsdp > 1 else 0 for c, n in forwards.items()}
        for c, n in gathers.items():
            g = got["gathers"][c]
            if g["layer_gathers"] != n or g["live_layers"] != 0 or g["max_live_layers"] > 2:
                failed.append(f"rank {r} of {label}: {c} gathered {g}, expected {n} layer gathers, <= 2 whole "
                              "layers alive and none after the call")
        for key in keys:
            if not np.array_equal(got[key], ranks[0][key]):
                failed.append(f"rank {r} of {label}: its {key} differs from rank 0's")
        entry = {"ms": got["ms"], "decoder_gib": got["decoder_gib"], "peak_gib": got["peak_gib"],
                 "build_peak_gib": got["build_peak_gib"], "build_s": got["build_s"], "device": got["device"],
                 "gathers": got["gathers"], "layer_bytes": got["layer_bytes"]}
        for mode, b in got["layer_bytes"].items():
            if not b["held"] <= b["stack"] / fsdp + b["unit"]:
                failed.append(f"rank {r} of {label}: its {mode} layer stack holds {b['held']} bytes, over "
                              f"{b['stack']} / {fsdp} + {b['unit']}")
        for sampler in ("ddim", "dpm", "batched"):
            a, b = got[sampler], ref[sampler]
            identical = bool(np.array_equal(a, b))
            err = float(np.abs(a - b).max()) / float(np.abs(b).max())
            tol = tp_chunk_tol(attn, TP_BUCKET, tp) if sampler == "batched" else TP_CHUNK_RTOL
            entry[sampler] = {"identical": identical, "max_err_of_scale": err, "tol": tol}
            if not identical and not err <= tol:
                failed.append(f"rank {r} of {label}: its {sampler} chunk is {err} of its scale from the "
                              f"one-process chunk (tol {tol})")
        if not np.array_equal(got["ar"], ref["ar"]):
            failed.append(f"rank {r} of {label}: AR ids {got['ar'].tolist()}, one process {ref['ar'].tolist()}")
        for key in ("beams", "beams_w8a8"):
            # ids equal, else the best beam's score within
            # TP_BEAM_SCORE_RTOL of the one process's, logged as not equal
            equal = bool(np.array_equal(got[key], ref[key]))
            err = abs(got[f"{key}_score"] - ref[f"{key}_score"]) / abs(ref[f"{key}_score"])
            entry[key] = {"equal": equal, "score": got[f"{key}_score"], "score_err": err}
            if not equal and not err <= TP_BEAM_SCORE_RTOL:
                failed.append(f"rank {r} of {label}: {key} ids {got[key].tolist()} (score {got[f'{key}_score']}), "
                              f"one process {ref[key].tolist()} ({ref[f'{key}_score']})")
        entry["sampled_equals_one_process"] = bool(np.array_equal(got["sampled"], ref["sampled"]))
        for key, tol in (("cut", AR_AGREE_RTOL), ("weight_only", TP_AR_FULL_DEPTH_RTOL))[0 if fsdp == 1 else 1:]:
            a, b = got[f"{key}_logits"], ref[f"{key}_logits"]
            step_err = np.abs(a - b).max(axis=1) / float(np.abs(b).max())
            if not float(step_err.max()) <= tol:
                failed.append(f"rank {r} of {label}: its {key} AR logits are {float(step_err.max())} of their "
                              f"scale from the one process's (tol {tol})")
            entry[f"{key}_logits_step_err_of_scale"] = [float(e) for e in step_err]
        b = ref["weight_only_logits"]
        entry["control_err_of_scale"] = float(np.abs(got["control_logits"] - b).max()) / float(np.abs(b).max())
        if not entry["control_err_of_scale"] > TP_AR_FULL_DEPTH_RTOL:
            failed.append(f"rank {r} of {label}: the control (row-parallel sums skipped) is only "
                          f"{entry['control_err_of_scale']} of the logits' scale from the one process's "
                          f"(tol {TP_AR_FULL_DEPTH_RTOL})")
        rep["ranks"].append(entry)
        chunks = ", ".join(f"{name} " + ("identical" if entry[k]["identical"] else
                                         f"NOT identical, {entry[k]['max_err_of_scale']} of its scale")
                           for k, name in (("ddim", "DDIM-8"), ("dpm", "DPM-4"),
                                           ("batched", f"bucket-{TP_BUCKET} DPM-4")))
        chunks += "".join(f"; {TP_BEAMS} beams ({mode}) " + (
            "ids equal" if entry[k]["equal"] else f"ids NOT equal, score {entry[k]['score_err']:.3g} from one "
            f"process's (tol {TP_BEAM_SCORE_RTOL})") for k, mode in (("beams", TP_AR_MODE), ("beams_w8a8", "w8a8")))
        chunks += "; sampled text " + ("equal to one process's" if entry["sampled_equals_one_process"] else
                                       "equal on every rank, NOT to one process's")
        side = (f" (tp {tp} alone: {beside['ranks'][r % len(beside['ranks'])]['decoder_gib']['w8a8']:.2f} / "
                f"{beside['ranks'][r % len(beside['ranks'])]['decoder_gib']['weight_only']:.2f})" if beside else "")
        cut = (f"{TP_CUT_LAYERS} layers {[round(e, 5) for e in entry['cut_logits_step_err_of_scale']]}, "
               if "cut_logits_step_err_of_scale" in entry else "")
        log(f"tp rank {r} of {label} ({backend}, {got['device']}): chunks to the one-process ones: {chunks}; "
            f"decoder {got['decoder_gib']['w8a8']:.2f} GiB (W8A8) / {got['decoder_gib']['weight_only']:.2f} GiB "
            f"(weight-only){side}; layer gathers a call {[got['gathers'][c]['layer_gathers'] for c in forwards]} "
            f"(DDIM-8, DPM-4, AR), at most {max(g['max_live_layers'] for g in got['gathers'].values())} whole "
            f"layers alive; peak {got['peak_gib']:.2f} GiB (build {got['build_peak_gib']:.2f}, {got['build_s']:.1f} "
            f"s); first calls: DDIM-8 {got['ms']['ddim']:.1f} ms, DPM-4 {got['ms']['dpm']:.1f} ms, ids "
            f"{got['ms']['ar']:.1f} ms, bucket-{TP_BUCKET} DPM-4 {got['ms']['batched']:.1f} ms, {TP_BEAMS} beams "
            f"{got['ms']['beams']:.1f} / {got['ms']['beams_w8a8']:.1f} ms, sampled text {got['ms']['sampled']:.1f} ms"
            f"{' (ranks sharing cards: not TP speed)' if shared else ''}; AR logits by "
            f"step, of their scale: {cut}{cfg.llama.num_layers} layers "
            f"{[round(e, 5) for e in entry['weight_only_logits_step_err_of_scale']]}"
            f" (tol {TP_AR_FULL_DEPTH_RTOL}; the control {entry['control_err_of_scale']:.4f})")
    totals = {k: sum(ranks[0]["launches"][c][k] for c in want) for k in TP_KERNELS}
    return rep, totals, failed


def tp_phase(torch, report, backend: str = "gloo", meshes: str = TP_MESHES):
    """The int8 mla-7b (32 layers, seeded) served by the one-process policy,
    then, for each mesh of `meshes` (comma-separated: T, a tp group of T
    ranks, or TxF, T tp ranks beside F fsdp ranks, serving_mesh(fsdp=F)),
    by that many ranks (this script's children, over `backend`; gloo for
    ranks that share one card, whose times are then not tensor-parallel
    speed): every rank's DDIM-8, DPM-4 and bucket-4 DPM-4 chunks equal to
    each other and to the one-process chunks bit for bit (else within
    tp_chunk_tol of their scale, logged as not identical),
    predict_action_ar's ids equal, the 4-beam ids equal (else the best
    beam's score within TP_BEAM_SCORE_RTOL), the sampled text equal on
    every rank (logged against one process's), the serving host (rank 0
    leading the others) answering TP_HOST_WAVES' and TP_HOST_TAIL's
    requests at buckets 1, 2 and 4 with each
    dispatch's chunks equal to its replay through the one-process policy
    (else within tp_chunk_tol at its bucket), the AR
    logits of a prefill and 7 decode steps (fed the one-process ids)
    within AR_AGREE_RTOL of their scale on the decoder cut to TP_CUT_LAYERS
    (at fsdp 1) and within TP_AR_FULL_DEPTH_RTOL at full depth (the control
    with the row-parallel sums skipped outside it), each call's launches
    exactly tp_expected's at T (the host's: its dispatches times a DPM-4
    call's, on every rank), at fsdp F > 1 L layer gathers a forward,
    at most 2 whole layers alive and a layer stack of at most 1/F of the
    rank's plus a leaf owned whole, each rank's decoder GiB. Returns the
    first mesh's rank 0 launches of the row-parallel modes."""
    from mla_tpu_torch.conf.models import get_model_config

    cfg = get_model_config("mla-7b")
    t0 = time.perf_counter()
    shapes = [tuple(int(n) for n in (spec.split("x") if "x" in spec else (spec, 1))) for spec in meshes.split(",")]
    # every mesh's ranks start now and import while the reference and the
    # meshes before theirs run; each joins its group when its turn comes
    spawned = [tp_spawn(backend, tp, fsdp) for tp, fsdp in shapes]
    try:
        pols = tp_policies(torch, cfg, None)
        ref = tp_calls(torch, cfg, pols)
        one = pols["w8a8"]  # replays the meshes' serving-host dispatches
        del pols
        gc.collect()
        torch.cuda.empty_cache()
        attn = tp_attention(torch, cfg)
        log("tp: the plain attention of a rank's 1/T of the heads against all of them, outputs that differ: "
            + ", ".join(f"{kind} {rows} rows T={T}: {n}" for (kind, rows, T), n in attn.items()))
        if ref["launches"] != tp_expected(cfg, 1):
            raise AssertionError(f"tp: the one-process calls launched {ref['launches']}, expected "
                                 f"{tp_expected(cfg, 1)}")
        rep = {"one_process": {"ms": ref["ms"], "decoder_gib": ref["decoder_gib"], "s": time.perf_counter() - t0},
               "attention_differs": {f"{kind} {rows} rows T={T}": n for (kind, rows, T), n in attn.items()},
               "worlds": {}}
        log(f"tp: one process, int8 mla-7b, first calls: DDIM-8 {ref['ms']['ddim']:.1f} ms, DPM-4 "
            f"{ref['ms']['dpm']:.1f} ms, "
            f"predict_action_ar ids {ref['ms']['ar']:.1f} ms, bucket-{TP_BUCKET} DPM-4 {ref['ms']['batched']:.1f} ms, "
            f"{TP_BEAMS} beams {ref['ms']['beams']:.1f} ms, sampled text {ref['ms']['sampled']:.1f} ms, decoder "
            f"{ref['decoder_gib']['w8a8']:.2f} GiB (W8A8) / {ref['decoder_gib']['weight_only']:.2f} GiB (weight-only)")
        failed, first = [], None
        for spec, (tp, fsdp), procs in zip(meshes.split(","), shapes, spawned):
            beside = next((w for w in rep["worlds"].values() if w["tp"] == tp and w["fsdp"] == 1), None)
            rep["worlds"][spec], totals, bad = tp_ranks(torch, cfg, ref, procs, backend, tp, fsdp, one, attn,
                                                        beside)
            rep["worlds"][spec]["expected"] = tp_expected(cfg, tp)
            failed += bad
            first = first or totals
    finally:
        for p in (p for procs in spawned for p in procs):
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(TP_ROOT, ignore_errors=True)
        one = None
    report["tp"] = rep
    if failed:
        raise AssertionError("tp: " + "; ".join(failed))
    return {"w8a8_matmul_rowpar": first["w8a8_matmul_acc"], "int8_matmul_f32out": first["int8_matmul_f32out"]}


# tensor-parallel training: the trainer (train.main) at mla-2b with the
# trainer phase's flags (fp32 masters, AdamW) over a tp group of
# TP_TRAIN_WORLD ranks (torchrun of this script's child), 1 row a card: a
# micro-batch of per-device x world rows, so each rank runs the world's 2
# rows (x 4 diffusion repeats) on its 16 of the 32 heads, BH 128 at S 547;
# held to one process running the same global rows (per-device = world: the
# data ranks' rows in data-rank order, data_ranks_rows) and per-step draws.
# On one card the ranks share it over gloo,
# named explicitly (NCCL refuses two ranks on one device; the tp
# collectives are staged through the host), so their step times are not
# tp speed.
TP_TRAIN_WORLD = 2
TP_TRAIN_ROOT = Path("build") / "chip_smoke_tp_train"
TP_TRAIN_TIMEOUT = 300
TP_TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "furthest_point_sample")
# the masters after step 1, as their update Delta = master - init on the
# compared leaves (layer 0 of q, o, up and down, the column- and
# row-parallel products of both blocks; layer 0's two norms; the final
# norm and every leaf of at most 2^16 elements, each rank's whole copy):
# |Delta_rank - Delta_one| / |Delta_one| over a rank's parts, by group
# (delta_rel). AdamW's first step moves each element by lr times ~sign(g)
# (eps 1e-8), so an element whose bf16 gradient lies within its rounding
# of 0 flips sign: the sound reading is ~2 sqrt(share of such elements).
# The control (copy_to_tp's backward all-reduce skipped) leaves the norms'
# gradient with one rank's heads, flips a large share of their signs and
# must miss this limit there
TP_TRAIN_MASTER_RTOL = 0.5
TP_TRAIN_COMPARED = ("layers/attn/q/w", "layers/attn/o/w", "layers/mlp/up/w", "layers/mlp/down/w",
                     "layers/input_ln/scale", "layers/post_ln/scale")
TP_TRAIN_SMALL = 1 << 16


@contextlib.contextmanager
def data_ranks_rows(data_world: int, accum: int = 1):
    """Within the block, a synthetic batch of B rows is the global batch
    that data_world data ranks read, each the batch of B / data_world rows
    from its own DummyDataset (whose seed does not fold the rank), in the
    order of the step's `accum` global micro-batches: micro-batch i is
    every rank's i-th block of rows, in rank order."""
    import numpy as np

    from mla_tpu_torch.vla import dummy

    real = dummy.synthetic_batch

    def cat(parts):
        if isinstance(parts[0], dict):
            return {k: cat([p[k] for p in parts]) for k in parts[0]}
        return np.concatenate(parts, axis=0)

    def tiled(cfg, B=2, L=16, seed=0, training=True):
        rows = real(cfg, B // data_world, L, seed=seed, training=training)
        m = B // data_world // accum

        def part(tree, i):
            if isinstance(tree, dict):
                return {k: part(v, i) for k, v in tree.items()}
            return tree[i * m : (i + 1) * m]

        return cat([part(rows, i) for i in range(accum) for _ in range(data_world)])

    dummy.synthetic_batch = tiled
    try:
        yield
    finally:
        dummy.synthetic_batch = real


def sharded_train_args(world: int, one_process: bool, accum: int, root: Path) -> list:
    """The trainer's flags for micro-batches of `world` rows (1 row a card
    on `world` ranks; the one process: world rows a card), `accum` of them
    a step."""
    per_device = world if one_process else 1
    return list(TRAINER_ARGS) + ["--per_device_batch_size", str(per_device), "--global_batch_size",
                                 str(world * accum), "--run_root_dir", str(root / "runs")]


def compared_masters(torch, shards) -> dict:
    """{path: this rank's part of a compared master, on the host}: layer 0
    of the stacked decoder leaves of TP_TRAIN_COMPARED, the small leaves
    whole."""
    out = {}
    for k, (path, shape) in enumerate(zip(shards.paths, shards.shapes)):
        layer = path.startswith("llm_backbone/layers/")
        if (path.endswith(TP_TRAIN_COMPARED) if layer else math.prod(shape) <= TP_TRAIN_SMALL):
            # whole over fsdp (every rank of the fsdp group takes part); of a
            # stacked leaf cut along another dim than [L], layer 0's slices only
            m, d = shards.masters[k], shards.specs[path].dim
            if layer and d:
                m = shards._fsdp_whole(k, m[0], d - 1)
            else:
                m = shards._fsdp_whole(k, m, d)
                m = m[0] if layer else m
            out[path] = m.detach().to("cpu", torch.float32, copy=True)
    return out


@contextlib.contextmanager
def recorded_steps(torch):
    """Within the block, the steps of strategy.make_train_step record each
    step's metrics, host ms (synchronized) and TP_TRAIN_KERNELS launches,
    and the compared masters' update of step 1 (compared_masters after it,
    less before it)."""
    from mla_tpu_torch.ops import cuda
    from mla_tpu_torch.training import strategy

    real, rec = strategy.make_train_step, {"steps": []}

    def make(*a, **k):
        step = real(*a, **k)

        def run(state, batch, generator=None, draws=None):
            first = not rec["steps"]
            before = compared_masters(torch, state["shards"]) if first else None
            torch.cuda.synchronize()
            cuda.launches.clear()
            t = time.perf_counter()
            state, m = step(state, batch, generator, draws)
            torch.cuda.synchronize()
            rec["steps"].append({"ms": (time.perf_counter() - t) * 1e3,
                                 "launches": {k: cuda.launches[k] for k in TP_TRAIN_KERNELS},
                                 "metrics": {k: float(v) for k, v in m.items()}})
            if first:
                rec["delta"] = {p: a - before[p] for p, a in compared_masters(torch, state["shards"]).items()}
            return state, m

        return run

    strategy.make_train_step = make
    try:
        yield rec
    finally:
        strategy.make_train_step = real


def delta_rel(torch, got: dict, ref: dict, shards) -> dict:
    """This rank's update of the compared masters against the one-process
    update's part (its tp slice), by group: the tp-split leaves ('split'),
    layer 0's two norms ('norms': held whole, their gradient is the
    column-parallel inputs' through copy_to_tp), layer 0's matrices that
    no tp group splits ('layers') and the rest ('rest'):
    |got - ref| / |ref| over each group, with its worst leaf and the share
    of elements whose update has the other sign."""
    from mla_tpu_torch.parallel.sharding import tp_part

    groups = {}
    for path, g in got.items():
        d = shards.tp_dims[path]
        if d is not None and path.startswith("llm_backbone/layers/"):
            d -= 1  # layer 0 of a stacked leaf
        r = tp_part(ref[path].float(), d, shards.mesh.tp_rank, shards.mesh.tp)
        layer = path.startswith("llm_backbone/layers/")
        name = ("split" if d is not None else "norms" if layer and path.endswith("/scale") else "layers" if layer
                else "rest")
        e, n = float((g - r).pow(2).sum()), float(r.pow(2).sum())
        acc = groups.setdefault(name, {"err": 0.0, "norm": 0.0, "flips": 0.0, "n": 0, "leaves": {}})
        acc["err"], acc["norm"] = acc["err"] + e, acc["norm"] + n
        acc["flips"], acc["n"] = acc["flips"] + float(((g > 0) != (r > 0)).sum()), acc["n"] + g.numel()
        acc["leaves"][path] = (e / n) ** 0.5 if n else 0.0
    out = {}
    for name, acc in groups.items():
        w = max(acc["leaves"], key=acc["leaves"].get)
        out[name] = {"rel": (acc["err"] / acc["norm"]) ** 0.5 if acc["norm"] else 0.0, "worst_leaf": w,
                     "worst_leaf_rel": acc["leaves"][w], "sign_flip_share": acc["flips"] / acc["n"]}
    return out


def skipped_collective(control: str):
    """(module, name, stand-in) of what a control run of a sharded-train
    phase skips: copy_to_tp's backward all-reduce (tp-train) or the
    gathers' reduce-scatter, each rank keeping its own gradient
    (fsdp-train)."""
    import torch.distributed as dist

    from mla_tpu_torch.parallel import tensor

    if control == "copy_to_tp":
        return tensor, "copy_to_tp", lambda x: x
    return tensor, "reduce_scatter", lambda flat, g: flat.chunk(dist.get_world_size(g))[dist.get_rank(g)].clone()


def sharded_train_child(argv, control: str) -> int:
    """One rank of the tp-train or fsdp-train phase (torchrun's variables
    set): joins the group over argv[1] on cuda:LOCAL_RANK, runs
    train.main(argv[2:]) for 2 steps (checkpoint writes skipped), then one
    step of a fresh run with `control` skipped (skipped_collective); writes
    each run's step records, its compared masters' update held to
    root/ref.pt, its GiB, layer-stack bytes, the most whole layers alive at
    once and launches to root/rank{R}.pt."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mla_tpu_torch import train
    from mla_tpu_torch.parallel import fsdp
    from mla_tpu_torch.parallel import mesh as tmesh
    from mla_tpu_torch.params import tree_items

    root, backend, args = Path(argv[0]), argv[1], list(argv[2:])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launch = tmesh.initialize_distributed("cuda", backend=backend)
    ref = torch.load(root / "ref.pt", weights_only=True)
    out = {"device": torch.cuda.get_device_name(launch["device"]), "backend": backend}
    torch.cuda.reset_peak_memory_stats()
    fsdp.reset_counts()
    with checkpoint_writes_skipped(), recorded_steps(torch) as rec:
        run = train.main(args + ["--run_id", "sharded", "--max_steps", "2"])
    sh, params = run["state"]["shards"], run["state"]["params"]
    out.update(steps=rec["steps"], delta=delta_rel(torch, rec["delta"], ref["delta"], sh),
               mesh={"dp": sh.mesh.dp, "fsdp": sh.mesh.fsdp, "tp": sh.mesh.tp},
               params_gib=sum(t.numel() * t.element_size() for _, t in tree_items(params)) / 2**30,
               optimizer_gib=sh.optimizer_bytes()["held"] / 2**30, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               q_local=sh.shapes[sh.paths.index("llm_backbone/layers/attn/q/w")], layer_bytes=sh.layer_bytes(params),
               gathers={k: fsdp.counts[k] for k in ("layer_gathers", "layer_reduce_scatters", "max_live_layers")})
    del run, sh, params
    gc.collect()
    torch.cuda.empty_cache()
    mod, name, stand_in = skipped_collective(control)
    real = getattr(mod, name)
    setattr(mod, name, stand_in)
    try:
        with checkpoint_writes_skipped(), recorded_steps(torch) as ctrl:
            run = train.main(args + ["--run_id", "sharded-control", "--max_steps", "1"])
    finally:
        setattr(mod, name, real)
    out["control"] = {"steps": ctrl["steps"], "delta": delta_rel(torch, ctrl["delta"], ref["delta"],
                                                                run["state"]["shards"])}
    del run
    torch.save(out, root / f"rank{launch['rank']}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def sharded_train_phase(torch, report, key: str, root: Path, backend: str, n: int, tp: int, accum: int,
                        groups, control_missed) -> dict:
    """mla-2b through train.main on one process, 1 step of `accum`
    micro-batches of n rows, the rows the n / tp data ranks read
    (data_ranks_rows; the reference: its step-1 loss and grad_norm, its
    compared masters' update), then `python -m torch.distributed.run
    --nproc_per_node n` of this script's --KEY-child (tp `tp`, fsdp =
    n / tp) over `backend`, 2 steps: each rank's step-1 loss and
    grad_norm within TRAIN_AGREE_RTOL of the reference's, its masters'
    update within TP_TRAIN_MASTER_RTOL on `groups` (delta_rel),
    control_missed(rank's control record, its step-1 rel errors) true;
    each step's flash forward, dQ, dK/dV and FPS launches exactly
    trainer_counts' for `accum` micro-batches; each rank's parameter,
    optimizer and peak GiB, layer-stack bytes, the most whole layers alive
    at once and step ms. Returns rank 0's launches in its 2 steps."""
    from mla_tpu_torch import train

    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rep = {"backend": backend, "world": n, "tp": tp, "accum": accum, "cards_shared": torch.cuda.device_count() < n}
    try:
        t0 = time.perf_counter()
        with checkpoint_writes_skipped(), recorded_steps(torch) as ref, data_ranks_rows(n // tp, accum):
            one = train.main(sharded_train_args(n, True, accum, root) + ["--run_id", "one", "--max_steps", "1"])
        cfg = one["cfg"]
        S = 16 + cfg.fused_len + cfg.diff_block_len
        del one
        gc.collect()
        torch.cuda.empty_cache()
        torch.save({"delta": {p: d.to(torch.bfloat16) for p, d in ref["delta"].items()}}, root / "ref.pt")
        want = {k: v for k, v in trainer_counts(cfg, micro_batches=accum).items() if k in TP_TRAIN_KERNELS}
        if ref["steps"][0]["launches"] != want:
            raise AssertionError(f"{key}: the one-process step launched {ref['steps'][0]['launches']}, "
                                 f"expected {want}")
        rep["one_process"] = {"step": ref["steps"][0], "s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        env = {k: v for k, v in os.environ.items() if k not in DP_LAUNCH}
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n), "--master_addr",
               "127.0.0.1", "--master_port", str(_free_port()), str(Path(__file__).resolve()), f"--{key}-child",
               str(root), backend, *sharded_train_args(n, False, accum, root), "--tp", str(tp)]
        proc = subprocess.run(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              timeout=TP_TRAIN_TIMEOUT)
        lines = proc.stdout.splitlines()
        if proc.returncode != 0:
            raise AssertionError(f"{key}: torchrun exited {proc.returncode}:\n" + "\n".join(lines[-40:]))
        strategy = [l for l in lines if "strategy ::" in l]
        if not (strategy and f"'tp': {tp}" in strategy[0] and f"'fsdp': {n // tp}" in strategy[0]):
            raise AssertionError(f"{key}: strategy line {strategy}")
        ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(n)]
        rep.update(s=time.perf_counter() - t0, strategy=strategy[0].split(">> ")[-1], ranks=[])
        one = ref["steps"][0]["metrics"]
        failed = []
        for r, got in enumerate(ranks):
            m = got["steps"][0]["metrics"]
            rel = {k: abs(m[k] - one[k]) / abs(one[k]) for k in ("total_loss", "grad_norm")}
            c = got["control"]["steps"][0]["metrics"]
            ctrl = {k: abs(c[k] - one[k]) / abs(one[k]) for k in ("total_loss", "grad_norm")}
            entry = {k: got[k] for k in ("mesh", "params_gib", "optimizer_gib", "peak_gib", "q_local", "device",
                                         "layer_bytes", "gathers")}
            entry.update(rel_err=rel, delta=got["delta"], control_rel_err=ctrl, control_delta=got["control"]["delta"],
                         step_ms=[st["ms"] for st in got["steps"]], losses=[st["metrics"]["total_loss"]
                                                                            for st in got["steps"]],
                         launches=[st["launches"] for st in got["steps"]])
            rep["ranks"].append(entry)
            if not all(v <= TRAIN_AGREE_RTOL for v in rel.values()):
                failed.append(f"rank {r}: step 1 {rel} of the one-process step's (tol {TRAIN_AGREE_RTOL})")
            if not all(got["delta"][g]["rel"] <= TP_TRAIN_MASTER_RTOL for g in groups):
                failed.append(f"rank {r}: masters' update {got['delta']} (tol {TP_TRAIN_MASTER_RTOL} on {groups})")
            if not control_missed(got["control"], ctrl):
                failed.append(f"rank {r}: the control passes: {ctrl}, masters {got['control']['delta']}")
            for i, st in enumerate(got["steps"]):
                if st["launches"] != want:
                    failed.append(f"rank {r} step {i + 1}: launches {st['launches']}, expected {want}")
            if got["q_local"][-1] * tp != cfg.llama.hidden_size:
                failed.append(f"rank {r}: its q is {got['q_local']}, not 1/{tp} of the heads")
            lb, ga = got["layer_bytes"], got["gathers"]
            log(f"{key} rank {r} of {n} ({backend}, {got['device']}, mesh {got['mesh']}, accumulation {accum}): step 1 "
                f"loss {m['total_loss']:.6f} grad_norm {m['grad_norm']:.6f} against one process's "
                f"{one['total_loss']:.6f} {one['grad_norm']:.6f}: rel {rel['total_loss']:.3e} / "
                f"{rel['grad_norm']:.3e} (tol {TRAIN_AGREE_RTOL}); masters' update off by "
                + ", ".join(f"{g} {v['rel']:.4f} (signs {v['sign_flip_share']:.4f}, worst {v['worst_leaf']} "
                            f"{v['worst_leaf_rel']:.4f})" for g, v in sorted(got["delta"].items()))
                + f" of its norm (tol {TP_TRAIN_MASTER_RTOL} on {', '.join(groups)}); control: loss "
                f"{ctrl['total_loss']:.3e}, grad_norm {ctrl['grad_norm']:.3e}, masters "
                + ", ".join(f"{g} {v['rel']:.4f}" for g, v in sorted(got["control"]["delta"].items()))
                + f"; launches a step {got['steps'][0]['launches']}; layer stack {lb['held'] / 2**30:.3f} GiB held of "
                f"{lb['stack'] / 2**30:.3f} GiB whole (largest leaf owned whole {lb['unit'] / 2**30:.3f} GiB, whole "
                f"copies of cut leaves {lb['whole_copies']}), {ga['layer_gathers']} layer gathers and "
                f"{ga['layer_reduce_scatters']} reduce-scatters in 2 steps, at most {ga['max_live_layers']} whole "
                f"layers alive; params {got['params_gib']:.2f} GiB, optimizer {got['optimizer_gib']:.2f} GiB, peak "
                f"{got['peak_gib']:.2f} GiB; steps {[round(st['ms'], 1) for st in got['steps']]} ms"
                f"{' (ranks sharing one card over gloo: not parallel speed)' if rep['cards_shared'] else ''}")
        H = cfg.llama.num_heads
        log(f"{key}: one process ({n} rows a micro-batch, {accum} micro-batches, {gpu_line()}): step 1 "
            f"{ref['steps'][0]['ms']:.1f} ms, BH {n * 4 * H} at S {S}; a rank's BH {4 * H}; {rep['strategy']}")
        if S != TRAINER_S or TP_TRAIN_BH != 4 * H:
            failed.append(f"S {S}, BH {4 * H}: not the shapes the kernels phase checked")
        report[key.replace("-", "_")] = rep
        if failed:
            raise AssertionError(f"{key}: " + "; ".join(failed))
        return {k: sum(st["launches"][k] for st in ranks[0]["steps"]) for k in TP_TRAIN_KERNELS}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def tp_train_phase(torch, report, backend: str = "gloo", world: str = str(TP_TRAIN_WORLD)):
    """sharded_train_phase at tp 2 (fsdp = world / 2), a micro-batch a step;
    the control (copy_to_tp's backward all-reduce skipped) must move the
    norms' update past TP_TRAIN_MASTER_RTOL."""
    return sharded_train_phase(torch, report, "tp-train", TP_TRAIN_ROOT, backend, int(world), 2, 1, ("split", "norms"),
                               lambda ctrl, rel: ctrl["delta"]["norms"]["rel"] > TP_TRAIN_MASTER_RTOL)


# layer-wise gathering over fsdp: 2 ranks, fsdp 2, accumulation 2 (the
# reduce-scatter and the fp32 accumulators exercised twice a step); the
# control keeps each rank's own gradient, so the global norm of the parts
# is another number
FSDP_TRAIN_WORLD, FSDP_TRAIN_ACCUM = 2, 2
FSDP_TRAIN_ROOT = Path("build") / "chip_smoke_fsdp_train"


def fsdp_train_phase(torch, report, backend: str = "gloo"):
    """sharded_train_phase at fsdp FSDP_TRAIN_WORLD, accumulation
    FSDP_TRAIN_ACCUM: layer 0's matrices and norms within
    TP_TRAIN_MASTER_RTOL; the control (no reduce-scatter) must miss
    TRAIN_AGREE_RTOL on grad_norm."""
    return sharded_train_phase(torch, report, "fsdp-train", FSDP_TRAIN_ROOT, backend, FSDP_TRAIN_WORLD, 1,
                               FSDP_TRAIN_ACCUM, ("layers", "norms"),
                               lambda ctrl, rel: rel["grad_norm"] > TRAIN_AGREE_RTOL)


# the qualification entry at mla-small, full width: 1 weight seed, 2
# scenarios, DDIM-8 and DPM-4 against DDIM-100, W8A8 against bf16
QUALIFY_TRAIN_STEPS = 10
QUALIFY_ARGS = ("--model", "mla-small", "--compare_int8", "--weight_seeds", "0", "--scenarios", "2", "--samplers",
                "ddim8", "dpm4", "--train_steps", str(QUALIFY_TRAIN_STEPS))
QUALIFY_INT8_RMS = 0.1  # W8A8 against bf16, relative to the chunk's rms (5.2e-3 after 120 steps, PERF.md)


def qualify_counts(cfg, steps: int, scenarios: int, samplers) -> dict:
    """The launches of `python -m mla_tpu_torch.qualify_samplers` with
    QUALIFY_ARGS: each train step (no remat) the flash forward, dQ and dK/dV
    once a layer and FPS once a stage; each policy call one prefill (flash
    a layer) and one front-end pass (FPS a stage): a scenario's DDIM-100,
    its samplers, the bf16 DDIM-8 base and the W8A8 DDIM-8, whose every
    decoder linear (4 a layer) runs W8A8 at the prefill and at each of its
    8 evaluations."""
    L, stages = cfg.llama.num_layers, cfg.point.num_stages
    calls = scenarios * (1 + len(samplers) + 2)
    return {"flash_attention": L * (steps + calls), "flash_attention_bwd_dq": L * steps,
            "flash_attention_bwd_dkv": L * steps, "furthest_point_sample": stages * (steps + calls),
            "w8a8_matmul": scenarios * 4 * L * (1 + 8), "int8_matmul": 0}


def qualify_phase(torch, report):
    """The sampler qualification entry on the card
    (mla_tpu_torch.qualify_samplers.run with QUALIFY_ARGS): its training
    phase through the production step, then DDIM-8 and DPM-4 against
    DDIM-100 and W8A8 against bf16 on the same weights and x_T; finite
    metrics, W8A8 within QUALIFY_INT8_RMS, exact launches (counts set to 0
    just before the entry, read just after). Returns the launches."""
    import numpy as np

    from mla_tpu_torch import qualify_samplers as qs
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.ops import cuda

    args = qs.parser().parse_args(list(QUALIFY_ARGS))
    cfg = get_model_config(args.model, use_contrastive=False)
    expected = qualify_counts(cfg, args.train_steps, args.scenarios, args.samplers)
    torch.cuda.synchronize()
    cuda.launches.clear()
    t = time.perf_counter()
    result = qs.run(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    totals = {k: cuda.launches[k] for k in expected}
    values = [v for m in result["samplers"].values() for v in m.values()] + list(result["int8_vs_bf16"].values())
    log(f"qualify: {' '.join(QUALIFY_ARGS)} on the card ({gpu_line()}) in {run_s:.1f} s: {json.dumps(result)}; "
        f"launches {totals}")
    report["qualify"] = {"args": list(QUALIFY_ARGS), "result": result, "run_s": run_s, "launches": totals,
                         "expected": expected}
    if not all(np.isfinite(v) for v in values):
        raise AssertionError(f"qualify: non-finite metrics {result}")
    if not result["int8_vs_bf16"]["rel_rms"] < QUALIFY_INT8_RMS:
        raise AssertionError(f"qualify: W8A8 against bf16 {result['int8_vs_bf16']} (limit {QUALIFY_INT8_RMS})")
    check_launches(totals, expected, "qualify")
    return totals


AUGMENT_ROOT = Path("build") / "chip_smoke_augment"
AUGMENT_EPISODES, AUGMENT_STEPS = 2, 24
AUGMENT_FRAMES = 16
AUGMENT_TIMED = 6  # frames augmented on one thread


def augment_phase(torch, report):
    """The franka frame stream at mla-2b's image size with augment=True and
    without (frames/s of each), and augment_image on one thread over the
    frames' decoded views (ms a frame, both views, the default kwargs); the
    augmented frames move and repeat with the seed."""
    import numpy as np

    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.vla.rlds import dataset as rds
    from mla_tpu_torch.vla.rlds import transforms as T

    rep = {}
    home = os.environ.get("HOME")
    shutil.rmtree(AUGMENT_ROOT, ignore_errors=True)
    os.environ["HOME"] = str((AUGMENT_ROOT / "home").resolve())
    try:
        data_fixture(AUGMENT_ROOT, "franka", AUGMENT_EPISODES, AUGMENT_STEPS, DATA_CAMERA, DATA_POINTS, 1, 71)
        size = get_model_config("mla-2b").vision.image_size

        def frames(augment: bool):
            ds, _, _ = rds.make_interleaved_dataset("franka", str(AUGMENT_ROOT), shuffle_buffer_size=16,
                                                    image_size=size, augment=augment, seed=5, proprio_dim=7,
                                                    load_tactile=True)
            it = iter(ds)
            next(it)
            t = time.perf_counter()
            got = [next(it) for _ in range(AUGMENT_FRAMES)]
            return got, AUGMENT_FRAMES / (time.perf_counter() - t)

        plain, plain_fps = frames(False)
        aug, aug_fps = frames(True)
        again, _ = frames(True)
        keys = sorted(k for k in plain[0]["observation"] if k.startswith("image_"))
        moved = sum(not np.array_equal(a["observation"][k], b["observation"][k]) for a, b in zip(plain, aug)
                    for k in keys)
        same = all(np.array_equal(a["observation"][k], b["observation"][k]) for a, b in zip(aug, again) for k in keys)
        views = [[f["observation"][k][0] if f["observation"][k].ndim == 4 else f["observation"][k] for k in keys]
                 for f in plain]
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        ms = []
        for i, vs in enumerate(views[:AUGMENT_TIMED]):
            t = time.perf_counter()
            for j, v in enumerate(vs):
                T.augment_image(v, [i, j], **rds.DEFAULT_IMAGE_AUGMENT_KWARGS)
            ms.append((time.perf_counter() - t) * 1e3)
        torch.set_num_threads(threads)
        rep = {"image_size": size, "views": keys, "frames": AUGMENT_FRAMES, "frames_per_s_plain": plain_fps,
               "frames_per_s_augment": aug_fps, "augment_ms_per_frame": float(np.median(ms)),
               "augment_ms_per_frame_p95": float(np.percentile(ms, 95)), "moved_views": moved,
               "repeats_with_seed": same, "host_threads": os.cpu_count()}
        log(f"augment: franka frames at {size} px ({len(keys)} views, {os.cpu_count()} host threads): "
            f"{plain_fps:.1f} frames/s plain, {aug_fps:.1f} frames/s with augment=True; augment_image on one "
            f"thread {rep['augment_ms_per_frame']:.1f} ms a frame (median of {len(ms)}, p95 "
            f"{rep['augment_ms_per_frame_p95']:.1f}); {moved} of {len(keys) * AUGMENT_FRAMES} views moved, the "
            f"same seed {'repeats' if same else 'DOES NOT repeat'} the stream")
        if moved < len(keys) * AUGMENT_FRAMES // 2 or not same:
            raise AssertionError(f"augment: {rep}")
    finally:
        if home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = home
        shutil.rmtree(AUGMENT_ROOT, ignore_errors=True)
    report["augment"] = rep


# the phases of mla-mistral, the int4 weight path, Phi-2 post-training, the
# point-cloud library, training over a process group and the train-time
# frame augmentation, which --only can run alone
NEW_PHASES = ("mistral-agree", "mistral-serve", "mistral-train-agree", "mistral-train", "int4-agree", "int4-serve",
              "phi-post-agree", "phi-post-train", "pointlib", "dp-agree", "dp", "augment", "qualify", "tp", "tp-train",
              "fsdp-train", "formats")
# this script's own child processes: a rank of the tp phase, a rank of the
# tp-train phase, a rank of the fsdp-train phase
CHILDREN = {"--tp-child": lambda argv: tp_child(Path(argv[0]), argv[1], int(argv[2])),
            "--tp-train-child": lambda argv: sharded_train_child(argv, "copy_to_tp"),
            "--fsdp-train-child": lambda argv: sharded_train_child(argv, "reduce_scatter")}


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] in CHILDREN:
        return CHILDREN[sys.argv[1]](sys.argv[2:])
    parser = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.")
    parser.add_argument("--parent", help="a directory holding another version of flash_fwd.cu, flash_bwd.cu, "
                        "w8a8.cu, int8_mm.cu and fps.cu (such as the parent commit's, with its hopper.cuh) to time "
                        "against this tree's kernels")
    parser.add_argument("--only", help="a probe: the build, the kernels phase and only these comma-separated phases "
                        f"of {', '.join(NEW_PHASES)}; prints no result line")
    parser.add_argument("--tp_world", default=TP_MESHES, help="meshes of the tp phase (comma-separated, each in "
                        "turn against one reference: T ranks of one tp group, or TxF: tp T x fsdp F)")
    parser.add_argument("--tp_backend", default="gloo", help="the tp, tp-train and fsdp-train phases' backend: "
                        "gloo (ranks that share one card) or nccl (a card a rank)")
    parser.add_argument("--tp_train_world", default=str(TP_TRAIN_WORLD), help="ranks of the tp-train phase (tp 2, "
                        "fsdp = world / 2)")
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
    from concurrent.futures import ThreadPoolExecutor

    from mla_tpu_torch.native import jpeg_host, pointops_host, rlds_host, webp_host

    # the host helpers' g++ builds run beside the kernels' nvcc builds
    with ThreadPoolExecutor(4) as helpers:
        loads = [helpers.submit(m.load) for m in (rlds_host, jpeg_host, webp_host, pointops_host)]
        try:
            built = cuda.build()
        except BaseException:
            for _, proc in started.values():
                proc.kill()
                proc.wait()
            raise
        for f in loads:
            f.result()
    for name, text in built.items():
        log(f"built {name}.cu\n" + "\n".join("  " + l for l in text.strip().splitlines() if "registers" in l or "spill" in l))
    log(f"built {rlds_host.SRC.name}, {jpeg_host.SRC.name} and {webp_host.SRC.name} (the data pipeline's host "
        f"helpers) and {pointops_host.SRC.name} (the eval entry's), g++")
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
    only = set(args.only.split(",")) if args.only else None
    if only and not only <= set(NEW_PHASES):
        raise SystemExit(f"chip_smoke: --only takes phases of {NEW_PHASES}, got {sorted(only - set(NEW_PHASES))}")

    def phase(name, fn, *a):
        """Run one phase (unless --only leaves it out), then free the card's
        cache; its seconds go to the log and to report['phase_s']."""
        if only is not None and name not in only:
            return None
        t = time.perf_counter()
        out = fn(*a)
        gc.collect()
        torch.cuda.empty_cache()
        report.setdefault("phase_s", {})[name] = time.perf_counter() - t
        log(f"phase {name}: {report['phase_s'][name]:.1f} s")
        return out

    t = time.perf_counter()
    kernels = ([check_w8a8(torch, report, libs["w8a8"])] + check_fps(torch, report, libs["fps"])
               + check_flash(torch, report, libs["flash_fwd"]) + [check_int8_mm(torch, report, libs["int8_mm"])])
    train_kernels = check_flash_bwd(torch, report, libs["flash_bwd"])
    check_mistral_kernels(torch, report, libs["w8a8"], libs["int8_mm"])
    check_fps_pointlib(torch, report, libs["fps"])
    kernels += check_rowpar(torch, report, libs["w8a8"], libs["int8_mm"])
    report.setdefault("phase_s", {})["kernels"] = time.perf_counter() - t
    log(f"phase kernels: {report['phase_s']['kernels']:.1f} s")
    if args.parent:
        compare_parent(torch, report, {name: libs[("parent", name)] for name in PARENT_KERNELS}, w8a8_layout,
                       int8_layout)
    if only is None:
        phase("agree", check_agreement, torch, report)
        phase("ar-agree", check_ar_agreement, torch, report, libs["int8_mm"])
        t = time.perf_counter()
        totals, policy, ar_policy = serve(torch, report)
        ar_totals = ar_serve(torch, report, ar_policy)
        del ar_policy
        torch.cuda.empty_cache()
        host_totals = serve_host(torch, report, policy)
        del policy
        gc.collect()
        torch.cuda.empty_cache()
        report["phase_s"]["serve, ar-serve, serve-host"] = time.perf_counter() - t
        log(f"phase serve, ar-serve, serve-host: {report['phase_s']['serve, ar-serve, serve-host']:.1f} s")
        try:
            report["serve_http_launches"] = phase("serve-http", serve_http, torch, report)
            eval_totals = phase("eval", eval_phase, torch, report)
        finally:
            shutil.rmtree(SERVE_HTTP_ROOT, ignore_errors=True)
        phase("diffusion", diffusion, torch, report)
        phase("train-agree", check_train_agreement, torch, report, libs["flash_bwd"])
        train_totals = phase("train", train, torch, report)
        phase("post-train-agree", check_post_train_agreement, torch, report, libs["flash_bwd"])
        report["post_train_launches"] = phase("post-train", post_train, torch, report)
        phase("phi-agree", check_phi_agreement, torch, report)
        report["phi_serve_launches"] = phase("phi-serve", phi_serve, torch, report)
        phase("phi-train-agree", check_phi_train_agreement, torch, report)
        report["phi_train_launches"] = phase("phi-train", phi_train, torch, report)
    phase("mistral-agree", check_mistral_agreement, torch, report, libs["int8_mm"])
    report["mistral_serve_launches"] = phase("mistral-serve", mistral_serve, torch, report)
    phase("mistral-train-agree", check_mistral_train_agreement, torch, report, libs["flash_bwd"])
    report["mistral_train_launches"] = phase("mistral-train", mistral_train, torch, report)
    phase("int4-agree", check_int4_agreement, torch, report)
    report["int4_serve_launches"] = phase("int4-serve", int4_serve, torch, report)
    phase("phi-post-agree", check_phi_post_agreement, torch, report)
    report["phi_post_train_launches"] = phase("phi-post-train", phi_post_train, torch, report)
    report["pointlib_launches"] = phase("pointlib", pointlib_phase, torch, report)
    phase("dp-agree", dp_agree, torch, report)
    report["dp_launches"] = phase("dp", dp_phase, torch, report)
    phase("augment", augment_phase, torch, report)
    report["qualify_launches"] = phase("qualify", qualify_phase, torch, report)
    tp_totals = phase("tp", tp_phase, torch, report, args.tp_backend, args.tp_world)
    tp_train_totals = phase("tp-train", tp_train_phase, torch, report, args.tp_backend, args.tp_train_world)
    report["fsdp_train_launches"] = phase("fsdp-train", fsdp_train_phase, torch, report, args.tp_backend)
    if only is not None:
        phase("formats", formats_phase, torch, report)
        log(f"total: {time.perf_counter() - t_all:.1f} s (only {sorted(only)}: a partial run prints no result)")
        out_dir = Path("chiprun_out")
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_partial.json").write_text(json.dumps(report, indent=1))
        return 0
    phase("trainer-agree", check_trainer_agreement, torch, report, libs["flash_bwd"])
    trainer_totals = phase("trainer", trainer, torch, report)
    phase("trainer-viz", trainer_viz, torch, report)
    data_totals = phase("data", data, torch, report)
    oxe_totals = phase("oxe", oxe, torch, report)
    phase("vlm-agree", check_vlm_agreement, torch, report, libs["flash_bwd"])
    hf_totals = phase("hf-vlm", hf_vlm, torch, report)
    report["serve_launches"], report["ar_serve_launches"], report["train_launches"] = totals, ar_totals, train_totals
    report["serve_host_launches"], report["data_launches"] = host_totals, data_totals
    report["oxe_launches"] = oxe_totals
    report["hf_vlm_launches"], report["eval_launches"] = hf_totals, eval_totals
    # launches, by each row's path: the serving host's client runs for the
    # kernels it runs (W8A8, flash forward, FPS); the trainer's run for the
    # backward kernels; the AR serving path for int8_matmul; the data
    # phase's and the oxe phase's trainer runs and the hf-vlm phase's align
    # and finetune runs for the flash kernels at their shapes
    kernels += train_kernels
    by_path = {"serve-host": host_totals, "ar-serve": ar_totals, "trainer": trainer_totals, "data": data_totals,
               "oxe": oxe_totals, "hf-vlm": hf_totals, "eval": eval_totals, "tp": tp_totals,
               "tp-train": tp_train_totals}
    for k in kernels:
        k.setdefault("path", "serve-host" if k["name"] in host_totals else
                     "ar-serve" if k["name"] == "int8_matmul" else "trainer")
        k["launches"] = by_path[k["path"]][k["name"]]
    log(f"phase_s: {json.dumps({k: round(v, 1) for k, v in report['phase_s'].items()})}")
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
