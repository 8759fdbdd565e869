"""MLA training loss and serving: prefix embeds, prefill,
cached-suffix denoising, autoregressive decoding and the deployment policy.

Counterpart of mla_tpu/models/mla.py. `mla_train_loss` is the diffusion
training forward: the batch repeated `repeated_diffusion_steps` times, the
future-action window q-sampled at random t, the noise regressed, plus the
contrastive losses (point/image; tactile) and, in the post-training stage,
the generation heads' losses; without cfg.use_diff (the AR loss mode) the
LM loss of the labels takes the diffusion loss's place. The multimodal
prefix [BOS | fused | text[1:]] is prefilled once into a KV cache; each denoise
step then runs only the 18-token suffix [proprio, t, x_0..15] against the
cached prefix, reading the cache without writing it. This is exact with
respect to a full recompute, since the prefix is unchanged across steps and
attention is causal. The AR heads (action tokens, text, beam search) decode
one token per step against the same cache, writing each step's k/v in
place; beams ride the batch axis and the cache is regathered along it.
Every decoder call goes through prismatic.get_decoder, so the llama and
phi families serve and train through the same functions.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mla_tpu_torch import nn
from mla_tpu_torch.diffusion import gaussian as gd
from mla_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_2m
from mla_tpu_torch.models import action_model as am
from mla_tpu_torch.models import embedders
from mla_tpu_torch.models import llama as llama_mod
from mla_tpu_torch.models import prismatic
from mla_tpu_torch.parallel import fsdp
from mla_tpu_torch.parallel import tensor as tp
from mla_tpu_torch.parallel.sharding import serving_tp_dim
from mla_tpu_torch.params import tp_local, tree_items, tree_to
from mla_tpu_torch.vla.action_tokenizer import ActionTokenizer

ROADMAP_TP_SERVING = "ROADMAP.md queue 1, item 16 (tensor-parallel serving: {})"

DDIM_STEPS = 8     # the reference's DDIM respacing (MLAPolicy's default)
DPM_STEPS = 4      # DPM-Solver++(2M) model evaluations (the default)
CACHE_MARGIN = 32  # spare KV-cache slots past the prefix and the suffix (the default)


def serving_scores_dtype_from_env() -> torch.dtype:
    """The serving prefill's score dtype from MLA_PREFILL_SCORES ('bf16' or
    'fp32', the default), read when a policy is built, never at import, as
    the JAX package does. bf16 halves the score tensor of the plain
    attention (softmax still reduces in fp32); the flash kernel never
    materializes scores, so it is untouched."""
    return torch.bfloat16 if os.environ.get("MLA_PREFILL_SCORES", "fp32") == "bf16" else torch.float32

# token ids of the Llama-2 + MLA vocabulary
BOS_ID = 1
EOS_ID = 2
EMPTY_ID = 29871  # the '▁' token after "Out:"
PAD_ID = 32000
BOD_ID = 32001
EOD_ID = 32002

# CLIP normalization (the constants of the data pipeline, mla_tpu/vla/datasets.py)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


LOSS_KEYS = (
    "total_loss", "img_pc_contrastive_loss", "tactile_contrastive_loss", "diff_loss", "ar_loss",
    "image_gen_loss", "point_cloud_gen_loss", "tactile_gen_loss",
)


def _as_tensor(x, dtype, dev) -> torch.Tensor:
    """An injected draw (numpy array or tensor) as a tensor on dev."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype or x.dtype)
    return torch.as_tensor(np.array(x), dtype=dtype, device=dev)


def _tile_batch(tree, rep: int):
    """Repeat every tensor leaf of dim > 0 `rep` times along dim 0."""
    if isinstance(tree, dict):
        return {k: _tile_batch(v, rep) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dim() > 0:
        return tree.repeat(rep, *([1] * (tree.dim() - 1)))
    return tree


def mla_train_loss(
    params: Dict[str, Any], state: Dict[str, Any], cfg: prismatic.MLAModelConfig, sched: gd.Schedule,
    batch: Dict[str, Any], generator: Optional[torch.Generator] = None, *, repeated_diffusion_steps: int = 4,
    remat: bool = True, override_noise=None, override_t=None, fps_start: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[Dict[str, torch.Tensor], Dict[str, Any]]]:
    """One training forward -> (total_loss, (loss_dict, new_state)) for a
    batch of tensors on the parameters' device. With cfg.use_diff the batch
    is repeated `repeated_diffusion_steps` times, the future-action window
    q-sampled at random t and the noise regressed (diff_loss); without it
    (the AR loss mode) the total is the LM loss of the labels (ar_loss).
    The contrastive and generation losses add to either. The diffusion
    noise, t and the point tokenizer's FPS starts ([num_stages] x [rows])
    are drawn from `generator` unless given: override_noise [B * rep,
    horizon, action_dim], override_t [B * rep] and fps_start replace the
    draws (the parity tests feed the JAX package's). The generation heads'
    dropout draws from `generator` too, and is off without one."""
    dev = batch["input_ids"].device
    rows = batch["input_ids"].shape[0] * (repeated_diffusion_steps if cfg.use_diff else 1)
    if not cfg.use_diff:
        outputs, new_state = prismatic.vlm_forward(
            params, state, cfg, batch, training=True, use_diff=False, generator=generator, remat=remat,
            fps_start=fps_starts(cfg, fps_start, rows, generator, dev),
        )
        return _add_aux_losses(cfg, outputs, new_state, "ar_loss", outputs["lm_loss"])
    rbatch = _tile_batch(batch, repeated_diffusion_steps)
    future = rbatch["actions"][:, -cfg.action_horizon :, :].float()
    if override_noise is not None:
        noise = _as_tensor(override_noise, torch.float32, dev).reshape(future.shape)
    else:
        noise = torch.randn(future.shape, generator=generator, device=dev)
    if override_t is not None:
        t = _as_tensor(override_t, None, dev).long().reshape(rows)
    else:
        t = torch.randint(0, sched.num_timesteps, (rows,), generator=generator, device=dev)
    fps_start = fps_starts(cfg, fps_start, rows, generator, dev)
    x = gd.q_sample(sched, future, t, noise)
    rbatch = {**rbatch, "x": x, "t": t}
    # the reference computes the LM loss in diffusion mode and drops it from
    # the total; like the JAX package, skip the LM head instead
    rbatch.pop("labels", None)
    outputs, new_state = prismatic.vlm_forward(
        params, state, cfg, rbatch, training=True, use_diff=True, generator=generator, remat=remat,
        fps_start=fps_start,
    )
    return _add_aux_losses(cfg, outputs, new_state, "diff_loss", ((outputs["noise_pred"].float() - noise) ** 2).mean())


def draw_train_randomness(cfg: prismatic.MLAModelConfig, sched: gd.Schedule, batch_rows: int,
                          generator: Optional[torch.Generator], dev, *,
                          repeated_diffusion_steps: int = 4) -> Dict[str, Any]:
    """The draws mla_train_loss makes from `generator` for a batch of
    `batch_rows` rows, in its order, as its override keywords: the
    diffusion noise and t (diffusion mode) and the FPS starts. A
    distributed step draws them for the global micro-batch on every rank
    and gives each rank its rows."""
    rows = batch_rows * (repeated_diffusion_steps if cfg.use_diff else 1)
    out: Dict[str, Any] = {}
    if cfg.use_diff:
        out["override_noise"] = torch.randn((rows, cfg.action_horizon, cfg.action_dim), generator=generator, device=dev)
        out["override_t"] = torch.randint(0, sched.num_timesteps, (rows,), generator=generator, device=dev)
    out["fps_start"] = fps_starts(cfg, None, rows, generator, dev)
    return out


def fps_starts(cfg: prismatic.MLAModelConfig, given, rows: int, generator: Optional[torch.Generator], dev):
    """The point tokenizer's FPS starts: `given` as int32 tensors, else one
    draw per stage from `generator` ([rows] each), None without points."""
    if given is not None:
        return [_as_tensor(s, torch.int32, dev) for s in given]
    if not cfg.use_pointcloud:
        return None
    return [torch.randint(0, cfg.point.input_points >> si, (rows,), generator=generator, device=dev, dtype=torch.int32)
            for si in range(cfg.point.num_stages)]


def _add_aux_losses(cfg: prismatic.MLAModelConfig, outputs: Dict[str, Any], new_state: Dict[str, Any],
                    main_key: str, main_loss: torch.Tensor):
    """(total, (loss_dict, new_state)): `main_loss` under `main_key` plus the
    contrastive and generation losses the config turns on."""
    zero = torch.zeros((), dtype=torch.float32, device=main_loss.device)
    loss_dict = {k: zero for k in LOSS_KEYS}
    total = loss_dict[main_key] = main_loss
    if cfg.use_contrastive and "img_pc_contrastive_loss" in outputs:
        loss_dict["img_pc_contrastive_loss"] = outputs["img_pc_contrastive_loss"]
        total = total + outputs["img_pc_contrastive_loss"]
        if cfg.use_tactile and "tactile_contrastive_loss" in outputs:
            loss_dict["tactile_contrastive_loss"] = outputs["tactile_contrastive_loss"]
            total = total + outputs["tactile_contrastive_loss"]
    if cfg.use_generation and "generation_losses" in outputs:
        gl = outputs["generation_losses"]
        for key, on in (("image_gen_loss", cfg.gen.use_image), ("point_cloud_gen_loss", cfg.gen.use_pointcloud),
                        ("tactile_gen_loss", cfg.gen.use_tactile)):
            if on and key in gl:
                loss_dict[key] = gl[key]
                total = total + gl[key]
    loss_dict["total_loss"] = total
    return total, (loss_dict, new_state)


@functools.lru_cache(maxsize=8)
def _clip_constants(device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """CLIP mean and std [1, 3, 1, 1] on `device`, copied there once (a
    serving call then makes no host-to-device copy that waits), outside
    inference mode so a training forward can use them too."""
    with torch.inference_mode(False):
        return (torch.from_numpy(CLIP_MEAN).reshape(1, 3, 1, 1).to(device),
                torch.from_numpy(CLIP_STD).reshape(1, 3, 1, 1).to(device))


def _device_clip_preprocess(img_u8: torch.Tensor) -> torch.Tensor:
    """Raw uint8 [B, 3, S, S] -> CLIP-normalized fp32 [B, 4, S, S] with the
    all-ones mask channel, on the frame's device."""
    x = img_u8.float() / 255.0
    mean, std = _clip_constants(str(x.device))
    x = (x - mean) / std
    return torch.cat([x, torch.ones_like(x[:, :1])], dim=1)


def build_prefix_embeds(
    params: Dict[str, Any], state: Dict[str, Any], cfg: prismatic.MLAModelConfig,
    input_ids_prefix: torch.Tensor, images: Dict[str, torch.Tensor],
    point_cloud: Optional[torch.Tensor], *, with_uncond: bool = False,
) -> torch.Tensor:
    """[BOS | fused | text[1:]] embeddings. with_uncond appends the
    classifier-free-guidance prefix (every embedding replaced by the
    z_embedder `uncondition` vector) as extra batch rows. uint8 frames are
    CLIP-normalized here."""
    images = {k: _device_clip_preprocess(v) if v.dtype == torch.uint8 else v for k, v in images.items()}
    fused = prismatic.get_fused_tokens(params, state, cfg, images, point_cloud)["fused"]
    text_emb = prismatic.get_decoder(cfg).embed_tokens(params["llm_backbone"], input_ids_prefix)
    prefix = torch.cat([text_emb[:, :1], fused.to(text_emb.dtype), text_emb[:, 1:]], dim=1)
    if with_uncond:
        uncond = params["z_embedder"]["uncondition"].to(prefix.dtype)
        prefix = torch.cat([prefix, uncond[None].expand(prefix.shape)], dim=0)
    return prefix


def prefill(
    params: Dict[str, Any], cfg: prismatic.MLAModelConfig, prefix_embeds: torch.Tensor, cache_max_len: int,
    compute_logits: bool = True, *, int8_mode: str = "w8a8", scores_dtype: Optional[torch.dtype] = None,
) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """Run the prefix through the decoder into a new KV cache; returns
    (kv_cache, fp32 logits [B, V] of the last position, or None when
    compute_logits is off, as on the diffusion path). The lm_head runs on
    the last position only. On the card the attention is the flash kernel
    where it fits the head_dim (attention.sdpa); scores_dtype (None: fp32)
    is the score dtype of the plain attention where it runs instead."""
    B, P, _ = prefix_embeds.shape
    decoder = prismatic.get_decoder(cfg)
    cache = decoder.init_kv_cache(cfg.llama, B, cache_max_len, device=prefix_embeds.device)
    key_mask = (torch.arange(cache_max_len, device=prefix_embeds.device) < P)[None, :].expand(B, -1)
    out = decoder.forward(
        params["llm_backbone"], cfg.llama, prefix_embeds,
        kv_cache=cache, cache_len=0, key_mask=key_mask, compute_logits=False, int8_mode=int8_mode,
        scores_dtype=scores_dtype,
    )
    if not compute_logits:
        return out["kv_cache"], None
    return out["kv_cache"], decoder.lm_head_logits(params["llm_backbone"], out["last_hidden"][:, -1])


def make_suffix_denoise_fn(
    params: Dict[str, Any], cfg: prismatic.MLAModelConfig, kv_cache: Dict[str, torch.Tensor],
    prefix_len: int, proprio: torch.Tensor, *, int8_mode: str = "w8a8",
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The eps model (x, t) -> eps: a suffix forward [proprio, t, x_0..15]
    against the cached prefix. The prompt's tail id sits causally after the
    x tokens and cannot change eps, so it is not run."""
    B = proprio.shape[0]
    horizon = cfg.action_horizon
    cdt = cfg.llama.compute_dtype
    cache_max = kv_cache["k"].shape[3]
    decoder = prismatic.get_decoder(cfg)
    proprio_emb = embedders.action_embedder(params["proprio_embedder"], proprio.to(cdt))
    key_mask = (torch.arange(cache_max, device=proprio.device) < prefix_len + 2 + horizon)[None, :].expand(B, -1)

    def denoise_fn(x: torch.Tensor, t_model: torch.Tensor) -> torch.Tensor:
        x_emb = embedders.action_embedder(params["x_embedder"], x.to(cdt))
        t_emb = embedders.timestep_embedder(params["t_embedder"], t_model)[:, None, :]
        suffix = torch.cat([proprio_emb, t_emb.to(x_emb.dtype), x_emb], dim=1)
        out = decoder.forward(
            params["llm_backbone"], cfg.llama, suffix, kv_cache=kv_cache, cache_len=prefix_len,
            key_mask=key_mask, compute_logits=False, cache_read_only=True, int8_mode=int8_mode,
        )
        final = embedders.final_layer(params["final_layer"], out["last_hidden"])
        return final[:, 2 : 2 + horizon].float()

    return denoise_fn


def ddim_denoise_actions(
    params: Dict[str, Any], cfg: prismatic.MLAModelConfig, sched: gd.Schedule,
    kv_cache: Dict[str, torch.Tensor], prefix_len: int, proprio: torch.Tensor, noise: torch.Tensor,
    *, use_ddpm: bool = False, generator: Optional[torch.Generator] = None, cfg_scale: float = 0.0,
    sampler: str = "ddim", num_dpm_steps: int = DPM_STEPS, int8_mode: str = "w8a8",
) -> torch.Tensor:
    """Denoise loop over cached-suffix evaluations: DDIM (eta 0), DDPM, or
    DPM-Solver++(2M) with num_dpm_steps evaluations (`sched` is then the
    unspaced training schedule). With cfg_scale > 1 the cache holds
    [cond; uncond] rows and noise/proprio the doubled batch; the guided eps
    is uncond + scale * (cond - uncond)."""
    base_fn = make_suffix_denoise_fn(params, cfg, kv_cache, prefix_len, proprio, int8_mode=int8_mode)
    if cfg_scale > 1.0:
        def denoise_fn(x, t_model):
            half = x[: x.shape[0] // 2]
            cond, uncond = base_fn(torch.cat([half, half], dim=0), t_model).chunk(2, dim=0)
            guided = uncond + cfg_scale * (cond - uncond)
            return torch.cat([guided, guided], dim=0)
    else:
        denoise_fn = base_fn
    if sampler == "dpm":
        return dpm_solver_pp_2m(sched, denoise_fn, noise, num_steps=num_dpm_steps)
    if use_ddpm:
        return gd.ddpm_sample_loop(sched, denoise_fn, noise, generator=generator)
    return gd.ddim_sample_loop(sched, denoise_fn, noise)


def decode_step(
    params: Dict[str, Any], cfg: prismatic.MLAModelConfig, kv_cache: Dict[str, torch.Tensor], cache_len: int,
    tok: torch.Tensor, *, int8_mode: str = "w8a8",
) -> torch.Tensor:
    """One cached decode step: the tokens `tok` [B] at position cache_len;
    their k/v are written into the cache in place, and they attend over the
    cache's [0, cache_len]. Returns the fp32 next-token logits [B, V]."""
    B = tok.shape[0]
    cache_max = kv_cache["k"].shape[3]
    decoder = prismatic.get_decoder(cfg)
    emb = decoder.embed_tokens(params["llm_backbone"], tok[:, None])
    key_mask = (torch.arange(cache_max, device=tok.device) < cache_len + 1)[None, :].expand(B, -1)
    out = decoder.forward(
        params["llm_backbone"], cfg.llama, emb, kv_cache=kv_cache, cache_len=cache_len, key_mask=key_mask,
        int8_mode=int8_mode,
    )
    return out["logits"][:, -1]


def _select_token(logits: torch.Tensor, temperature: float, top_k: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy at temperature 0 (the first maximum on ties, as jnp.argmax);
    else a draw from softmax(logits / temperature), truncated to the top-k
    logits when top_k > 0."""
    if temperature <= 0:
        return logits.argmax(-1)
    scaled = logits.float() / temperature
    if top_k > 0:
        cutoff = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = scaled.masked_fill(scaled < cutoff, float("-inf"))
    return torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=generator)[:, 0]


def greedy_decode_actions(
    params: Dict[str, Any], cfg: prismatic.MLAModelConfig, kv_cache: Dict[str, torch.Tensor], prefix_len: int,
    last_logits: torch.Tensor, num_tokens: int, *, temperature: float = 0.0, top_k: int = 0,
    generator: Optional[torch.Generator] = None, int8_mode: str = "w8a8",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """AR decode of `num_tokens` tokens from the prefill's last logits [B, V];
    returns ([B, T] token ids, [B, T] max softmax probability of each step's
    distribution). Greedy at temperature 0, else sampled from `generator`
    (optionally top-k). Like the JAX scan, every step runs the decoder on its
    token, the last one included."""
    if temperature > 0 and generator is None:
        raise ValueError("sampling requires a torch.Generator")
    logits, toks, probs = last_logits, [], []
    for i in range(num_tokens):
        tok = _select_token(logits, temperature, top_k, generator)
        f32 = logits.float()
        probs.append(torch.exp(f32.max(-1).values - torch.logsumexp(f32, dim=-1)))
        toks.append(tok)
        logits = decode_step(params, cfg, kv_cache, prefix_len + i, tok, int8_mode=int8_mode)
    return torch.stack(toks, dim=1), torch.stack(probs, dim=1)


def beam_search_decode(
    params: Dict[str, Any], cfg: prismatic.MLAModelConfig, kv_cache: Dict[str, torch.Tensor], prefix_len: int,
    last_logits: torch.Tensor, num_tokens: int, *, num_beams: int, eos_id: int = EOS_ID,
    length_penalty: float = 1.0, int8_mode: str = "w8a8",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape beam search against the cached prefix; returns ([B, T]
    best-beam ids, [B] length-penalized log-prob scores). Beams ride the
    batch axis (row b's beams are rows b*K .. b*K+K-1), each step is one
    [B*K]-row decode step, the cache is regathered along the batch by the
    chosen parents, and a finished beam extends with EOS at log-prob 0 (its
    score frozen). Selection follows HF's scorer: score / len(tokens up to
    and including EOS) ** length_penalty."""
    B, V = last_logits.shape
    K = int(num_beams)
    if not 1 <= K <= V:
        raise ValueError(f"num_beams must be in [1, vocab], got {K}")
    dev = last_logits.device
    cache = {name: c.repeat_interleave(K, dim=1) for name, c in kv_cache.items()}
    scores, tok = torch.topk(torch.log_softmax(last_logits.float(), dim=-1), K, dim=-1)  # [B, K]
    finished = tok == eos_id
    lengths = torch.ones((B, K), dtype=torch.int32, device=dev)
    tokens = torch.zeros((B, K, num_tokens), dtype=torch.long, device=dev)
    tokens[:, :, 0] = tok
    batch_offset = (torch.arange(B, device=dev) * K)[:, None]
    # a finished beam's only continuation: EOS at log-prob 0
    eos_row = torch.full((V,), -1e9, device=dev)
    eos_row[eos_id] = 0.0
    for i in range(num_tokens - 1):
        logits = decode_step(params, cfg, cache, prefix_len + i, tok.reshape(B * K), int8_mode=int8_mode)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
        logp = torch.where(finished[:, :, None], eos_row, logp)
        scores, flat = torch.topk((scores[:, :, None] + logp).reshape(B, K * V), K, dim=-1)
        parent, tok = flat // V, flat % V
        was_finished = finished.gather(1, parent)
        lengths = lengths.gather(1, parent)
        tokens = tokens.gather(1, parent[:, :, None].expand(B, K, num_tokens))
        tokens[:, :, i + 1] = tok
        lengths = torch.where(was_finished, lengths, lengths + 1)
        finished = was_finished | (tok == eos_id)
        rows = (batch_offset + parent).reshape(-1)
        cache = {name: c.index_select(1, rows) for name, c in cache.items()}
    penalized = scores / lengths.float() ** length_penalty
    best = penalized.argmax(dim=1)
    b = torch.arange(B, device=dev)
    return tokens[b, best], penalized[b, best]


def cognition_feature(
    params: Dict[str, Any], state: Dict[str, Any], cfg: prismatic.MLAModelConfig, input_ids: torch.Tensor,
    images: Dict[str, torch.Tensor], point_cloud: Optional[torch.Tensor], *, int8_mode: str = "w8a8",
) -> torch.Tensor:
    """The DiT head's condition: the decoder's final-normed hidden state at
    the last position of [BOS | fused | ids[1:]], fp32 [B, 1, D] (one
    uncached forward; no mask, as in JAX, so padding ids are attended)."""
    prefix = build_prefix_embeds(params, state, cfg, input_ids, images, point_cloud)
    out = prismatic.get_decoder(cfg).forward(params["llm_backbone"], cfg.llama, prefix, compute_logits=False,
                                             int8_mode=int8_mode)
    return out["last_hidden"][:, -1:, :].float()


def unnormalize_actions(normalized: np.ndarray, action_stats: Dict[str, Any]) -> np.ndarray:
    """q01/q99 unnormalization + gripper binarize at 0.5."""
    mask = np.asarray(action_stats.get("mask", np.ones_like(action_stats["q01"], dtype=bool)))
    high, low = np.asarray(action_stats["q99"]), np.asarray(action_stats["q01"])
    a = np.clip(normalized, -1, 1)
    for g in range(6, a.shape[-1], 7):
        a[..., g] = np.where(a[..., g] < 0.5, 0.0, 1.0)
    return np.where(mask, 0.5 * (a + 1) * (high - low) + low, a)


def normalize_proprio(proprio: np.ndarray, proprio_stats: Dict[str, Any]) -> np.ndarray:
    mask = np.asarray(proprio_stats.get("mask", np.ones_like(proprio_stats["q01"], dtype=bool)))
    high, low = np.asarray(proprio_stats["q99"]), np.asarray(proprio_stats["q01"])
    p = np.where(mask, 2 * (proprio - low) / (high - low + 1e-8) - 1, proprio)
    return np.clip(p, -1, 1)


def build_prompt_ids(tokenizer, instruction: str, mode: str = "diff") -> np.ndarray:
    """Tokenize the VLA prompt with any callable tokenizer returning
    {'input_ids': [...]}, reproducing the reference's token surgery:
    'ar' ensures a trailing 29871; 'diff' ends the conditioning at it."""
    prompt = f"In: What action should the robot take to {instruction.lower()}?\nOut: ".rstrip()
    ids = list(tokenizer(prompt, add_special_tokens=True)["input_ids"])
    if ids[-1] != EMPTY_ID:
        ids = ids + [EMPTY_ID] if mode == "ar" else (ids + [EMPTY_ID, BOD_ID, EOD_ID, EMPTY_ID])[:-3]
    return np.asarray([ids], dtype=np.int32)


def _resolve_device(device) -> torch.device:
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("MLAPolicy: no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def _check_mesh(mesh, cfg: prismatic.MLAModelConfig, backbone: Dict[str, Any]) -> None:
    """Raise unless the port can serve `cfg`'s decoder over `mesh` (a mesh
    of more than one rank): dp = 1 (tp ranks, fsdp ranks or both), a llama
    decoder that is not int4, head counts that T divides (JAX's GSPMD can
    split mid-head; the port's layer splits whole heads)."""
    T, F = mesh.tp, mesh.fsdp
    if mesh.dp > 1:
        raise NotImplementedError(f"serving over dp {mesh.dp} x fsdp {F} x tp {T}: the port's serving mesh is dp "
                                  "= 1 (" + ROADMAP_TP_SERVING.format("(g) a serving mesh with dp beside tp or "
                                                                      "fsdp") + ")")
    if cfg.llm_family != "llama":
        raise NotImplementedError(f"a {cfg.llm_family} decoder over a serving mesh: "
                                  + ROADMAP_TP_SERVING.format("mla-phi"))
    if any(path.endswith("/w_q4") for path, _ in tree_items(backbone)):
        raise NotImplementedError("an int4 tree over a serving mesh: " + ROADMAP_TP_SERVING.format("int4"))
    H, Hkv = cfg.llama.num_heads, cfg.llama.num_kv_heads
    if H % T or Hkv % T:
        raise NotImplementedError(f"{H} heads and {Hkv} kv heads over tp {T}: T must divide both ("
                                  + ROADMAP_TP_SERVING.format("heads that T does not divide") + ")")


class MLAPolicy:
    """Deployment-facing policy: load once, call predict_action_* per step.

    A llama decoder's q|k|v and gate|up weights are fused for serving; with
    int8_mode "w8a8" its int8 weights are laid out K-major for the W8A8
    kernel (llama.fuse_for_serving(k_major=True)). A phi decoder serves its
    tree as it is (the JAX package fuses and quantizes llama trees only).
    The action tokenizer takes the 32000 ids below the Llama-2 vocabulary's
    end whatever the decoder's vocabulary, as in JAX.
    device=None means "cuda" and raises when no card is present; the CPU
    is used only when the caller passes device="cpu". int8_mode picks the
    product of the int8 decoder linears (nn.linear): "w8a8" (default),
    "weight_only" or "dequant". num_ddim_steps is the DDIM respacing used
    when a call names none; cache_margin the spare KV-cache slots;
    prefill_scores_dtype the diffusion prefill's score dtype (torch.bfloat16
    or torch.float32; None reads MLA_PREFILL_SCORES here), which only the
    plain attention reads.

    mesh (parallel/mesh.serving_mesh(fsdp=F)) serves over T = world / F
    tensor-parallel ranks composed with F fsdp ranks: the policy takes the
    whole tree, keeps this rank's tp part of the decoder by JAX's rules
    (params.tp_local), fuses it, and at F > 1 keeps only its fsdp part of
    every leaf of that tree (parallel/fsdp.serving_parts), gathered per
    use: the decoder layer by layer, the other leaves once a call. Every
    rank makes the same call with the same inputs and seed (any entry
    point: the chunks, one and batched, greedy, sampled and beam decoding,
    the text calls, the DiT batch) and gets the same result; a serving host
    instead has rank 0 send each batched call's rows to the others
    (`channel`: serving.lead, serving.follow). A phi decoder, an int4
    tree, head counts that T does not divide, and dp > 1 raise over a mesh
    (ROADMAP item 16)."""

    def __init__(
        self, params: Dict[str, Any], state: Dict[str, Any], cfg: prismatic.MLAModelConfig,
        tokenizer=None, norm_stats: Optional[Dict[str, Any]] = None, device=None, int8_mode: str = "w8a8",
        num_ddim_steps: int = DDIM_STEPS, cache_margin: int = CACHE_MARGIN,
        prefill_scores_dtype: Optional[torch.dtype] = None, mesh=None,
    ) -> None:
        if int8_mode not in nn.INT8_MODES:
            raise ValueError(f"int8_mode must be one of {nn.INT8_MODES}, got {int8_mode!r}")
        self.int8_mode = int8_mode
        self.device = _resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None  # a mesh of one is one process
        self.tp_split: frozenset = frozenset()
        self.gatherer: Optional[fsdp.ServingGatherer] = None
        if self.mesh is not None:
            _check_mesh(self.mesh, cfg, params["llm_backbone"])
            if self.mesh.tp > 1:
                backbone, self.tp_split = tp_local(params["llm_backbone"], self.mesh)
                params = {**params, "llm_backbone": backbone}
        params, state = tree_to(params, self.device), tree_to(state, self.device)
        if cfg.llm_family == "llama":
            params = {**params, "llm_backbone": llama_mod.fuse_for_serving(params["llm_backbone"],
                                                                          k_major=int8_mode == "w8a8")}
        if self.mesh is not None and self.mesh.fsdp > 1:
            split = self.tp_split
            params, self.gatherer = fsdp.serving_parts(
                params, self.mesh, lambda path, ndim: serving_tp_dim(path, ndim, split))
        self.params, self.state, self.cfg = params, state, cfg
        self.tokenizer = tokenizer
        self.norm_stats = norm_stats or {}
        self.action_tokenizer = ActionTokenizer(tokenizer, vocab_size=32000)
        self.sched_full = gd.create_schedule("", diffusion_steps=100)
        self.sched_ddim = gd.create_schedule(f"ddim{num_ddim_steps}", diffusion_steps=100)
        self.cache_margin = cache_margin
        self.prefill_scores_dtype = prefill_scores_dtype or serving_scores_dtype_from_env()
        # rank 0's parallel/mesh.Channel where it leads the mesh's other ranks
        # (serving.lead): each batched call's rows go to them before it runs
        self.channel = None

    @contextlib.contextmanager
    def tp_scope(self):
        """A block whose decoder ops run over the policy's mesh: the tp
        group, on the leaves tp_local split, and the fsdp gather of the
        layers held in parts. It yields the tree to call with: the policy's
        own, or at fsdp > 1 that tree with every leaf outside the layer
        stack gathered (once; the layers are gathered one at a time inside
        llama.run_layers). The policy's calls enter it; so must a caller
        that runs prefill or decode_step on the policy's tree itself, with
        the tree it yields."""
        if self.mesh is None:
            yield self.params
            return
        with tp.tp_group(self.mesh.tp_group, self.tp_split):
            if self.gatherer is None:
                yield self.params
                return
            with fsdp.gathering(self.gatherer):
                yield self.gatherer.tree(self.params)

    def _stats(self, unnorm_key: Optional[str], kind: str) -> Dict[str, Any]:
        if unnorm_key is None:
            if len(self.norm_stats) != 1:
                raise ValueError("multiple datasets: pass unnorm_key")
            unnorm_key = next(iter(self.norm_stats))
        return self.norm_stats[unnorm_key][kind]

    def get_action_stats(self, unnorm_key=None):
        return self._stats(unnorm_key, "action")

    def get_proprio_stats(self, unnorm_key=None):
        return self._stats(unnorm_key, "proprio")

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        """A host array on the policy's device. The copy is enqueued on the
        current stream without waiting (the staging copy is done when this
        returns), so a serving call issues no host sync before its result."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dtype is not None:
            t = t.to(dtype)
        return t.to(self.device, non_blocking=True)

    def _images(self, image) -> Dict[str, torch.Tensor]:
        img = self._tensor(image)
        return {"front_image": img[None] if img.dim() == 3 else img}

    def _points(self, pointcloud) -> Optional[torch.Tensor]:
        if pointcloud is None:
            return None
        pc = self._tensor(np.asarray(pointcloud, np.float32))
        return pc[None] if pc.dim() == 2 else pc

    def _sched(self, use_ddpm: bool, sampler: str, num_ddim_steps: Optional[int]) -> gd.Schedule:
        """The schedule of a call, as JAX's _diff_fn picks it: the training
        schedule for DDPM and DPM, else the DDIM respacing num_ddim_steps
        (None: the policy's)."""
        if use_ddpm or sampler == "dpm":
            return self.sched_full
        if num_ddim_steps is None:
            return self.sched_ddim
        return gd.create_schedule(f"ddim{num_ddim_steps}", diffusion_steps=100)

    def _run(self, ids: np.ndarray, images, pc, proprio, noise, *, use_ddpm=False, cfg_scale=0.0,
             sampler="ddim", num_dpm_steps=DPM_STEPS, num_ddim_steps=None, generator=None) -> torch.Tensor:
        """The serving graph: prefix embeds -> prefill -> denoise loop,
        enqueued on the current stream; nothing in it waits for the card."""
        cfg = self.cfg
        prefix_ids = self._tensor(np.asarray(ids[:, :-1], np.int64))
        tail_len = 1
        embed_len = prefix_ids.shape[1] + cfg.fused_len
        cache_max = embed_len + 2 + cfg.action_horizon + tail_len + self.cache_margin
        sched = self._sched(use_ddpm, sampler, num_ddim_steps)
        use_cfg = cfg_scale > 1.0
        with torch.inference_mode(), self.tp_scope() as params:
            prefix = build_prefix_embeds(params, self.state, cfg, prefix_ids, images, pc, with_uncond=use_cfg)
            kv, _ = prefill(params, cfg, prefix, cache_max, compute_logits=False, int8_mode=self.int8_mode,
                            scores_dtype=self.prefill_scores_dtype)
            if use_cfg:
                proprio, noise_x = torch.cat([proprio, proprio]), torch.cat([noise, noise])
            else:
                noise_x = noise
            samples = ddim_denoise_actions(
                params, cfg, sched, kv, prefix.shape[1], proprio, noise_x,
                use_ddpm=use_ddpm, generator=generator, cfg_scale=cfg_scale, sampler=sampler,
                num_dpm_steps=num_dpm_steps, int8_mode=self.int8_mode,
            )
        return samples[: noise.shape[0]]

    def predict_action_diff(
        self, image, pointcloud, instruction: str, cur_robot_state=None, unnorm_key: Optional[str] = None,
        num_ddim_steps: Optional[int] = None, use_ddim: bool = True, cfg_scale: float = 0.0, seed: int = 0,
        input_ids: Optional[np.ndarray] = None, noise: Optional[np.ndarray] = None, sampler: str = "ddim",
        num_dpm_steps: int = DPM_STEPS, return_normalized: bool = False,
    ) -> np.ndarray:
        """A [horizon, action_dim] chunk for one observation: DDIM with the
        policy's respacing (8) or num_ddim_steps, DPM-Solver++(2M) with
        num_dpm_steps evaluations with sampler='dpm', DDPM with
        use_ddim=False; `noise` overrides the seeded x_T; return_normalized
        returns the chunk before clip / binarize / unnormalization."""
        cfg = self.cfg
        if sampler == "dpm" and not use_ddim:
            raise ValueError("sampler='dpm' is an ODE sampler and conflicts with use_ddim=False")
        if input_ids is None:
            input_ids = build_prompt_ids(self.tokenizer, instruction, mode="diff")
        images, pc = self._images(image), self._points(pointcloud)
        if cur_robot_state is not None:
            proprio = normalize_proprio(np.asarray(cur_robot_state, np.float32), self.get_proprio_stats(unnorm_key))[None, None, :]
        else:
            proprio = np.zeros((1, 1, cfg.action_dim), np.float32)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        shape = (1, cfg.action_horizon, cfg.action_dim)
        if noise is None:
            x_t = torch.randn(shape, generator=gen, device=self.device)
        else:
            x_t = self._tensor(np.asarray(noise, np.float32)).reshape(shape)
        samples = self._run(
            np.asarray(input_ids), images, pc, self._tensor(np.asarray(proprio, np.float32)), x_t,
            use_ddpm=not use_ddim, cfg_scale=cfg_scale, sampler=sampler, num_dpm_steps=num_dpm_steps,
            num_ddim_steps=num_ddim_steps, generator=gen,
        )
        normalized = samples[0].cpu().numpy()
        if return_normalized:
            return normalized
        return unnormalize_actions(normalized, self.get_action_stats(unnorm_key))

    def predict_action_diff_batched(
        self, images, pointclouds, instruction: Optional[str] = None, unnorm_key: Optional[str] = None,
        seed: int = 0, input_ids: Optional[np.ndarray] = None, cur_robot_states=None, sampler: str = "ddim",
        num_dpm_steps: int = DPM_STEPS, num_ddim_steps: Optional[int] = None, return_normalized: bool = False,
    ) -> np.ndarray:
        """One prefill + denoise for B observations [B, 4, H, W] (or raw
        uint8 [B, 3, H, W]) / [B, P, 3]. Prompts share a token length:
        input_ids [B, L], or one row / one instruction broadcast. Rows of
        cur_robot_states may be None (then normalized zero). Returns [B,
        horizon, action_dim]. dispatch_action_diff_batched(...)()."""
        return self.dispatch_action_diff_batched(
            images, pointclouds, instruction, unnorm_key=unnorm_key, seed=seed, input_ids=input_ids,
            cur_robot_states=cur_robot_states, sampler=sampler, num_dpm_steps=num_dpm_steps,
            num_ddim_steps=num_ddim_steps, return_normalized=return_normalized,
        )()

    def dispatch_action_diff_batched(
        self, images, pointclouds, instruction: Optional[str] = None, unnorm_key: Optional[str] = None,
        seed: int = 0, input_ids: Optional[np.ndarray] = None, cur_robot_states=None, sampler: str = "ddim",
        num_dpm_steps: int = DPM_STEPS, num_ddim_steps: Optional[int] = None, return_normalized: bool = False,
    ) -> Callable[[], np.ndarray]:
        """The asynchronous form of predict_action_diff_batched: builds the
        ids, the proprio rows and x_T (a torch.Generator on the device seeded
        with `seed`, one [B, horizon, action_dim] draw), enqueues the
        prefill and the denoise loop on the current stream without a host
        sync, and returns finalize(), which makes the one device-to-host
        copy (waiting for the call) and unnormalizes. A serving host
        dispatches the next batch while this one runs
        (serving.BatchingServer). Whatever can refuse a request (the ids,
        the proprio statistics) runs on the host before the rows are sent
        (`channel`) or the device is touched."""
        cfg = self.cfg
        if input_ids is None:
            if instruction is None:
                raise ValueError("pass either instruction or input_ids")
            input_ids = build_prompt_ids(self.tokenizer, instruction, mode="diff")
        B = images.shape[0]
        ids = np.asarray(input_ids)
        if ids.shape[0] == 1 and B > 1:
            ids = np.repeat(ids, B, axis=0)
        if ids.shape[0] != B:
            raise ValueError(f"input_ids rows {ids.shape[0]} != batch {B}")
        proprio = np.zeros((B, 1, cfg.action_dim), np.float32)
        if cur_robot_states is not None and any(s is not None for s in cur_robot_states):
            # a row without proprio gets the normalized zero of the solo
            # path, whatever batch it lands in
            pstats = self.get_proprio_stats(unnorm_key)
            for b, s in enumerate(cur_robot_states):
                if s is not None:
                    proprio[b, 0] = normalize_proprio(np.asarray(s, np.float32), pstats)
        rows = dict(ids=ids, images=np.asarray(images), pointclouds=np.asarray(pointclouds, np.float32),
                    proprio=proprio, seed=seed, sampler=sampler, num_dpm_steps=num_dpm_steps,
                    num_ddim_steps=num_ddim_steps)
        if self.channel is not None:
            self.channel.send(("dispatch_rows", rows))
        try:
            samples = self.dispatch_rows(**rows)
        except BaseException as e:
            if self.channel is not None:
                self.channel.broken = e
            raise

        def finalize() -> np.ndarray:
            out = samples.cpu().numpy()  # waits for the call
            if return_normalized:
                return out
            stats = self.get_action_stats(unnorm_key)
            return np.stack([unnormalize_actions(out[b], stats) for b in range(B)])

        return finalize

    def dispatch_rows(self, ids: np.ndarray, images: np.ndarray, pointclouds: np.ndarray, proprio: np.ndarray,
                      seed: int, sampler: str, num_dpm_steps: int, num_ddim_steps: Optional[int]) -> torch.Tensor:
        """The device half of dispatch_action_diff_batched on its host rows
        (ids [B, L], frames, clouds, normalized proprio [B, 1, action_dim]):
        x_T drawn from a torch.Generator on this rank's device seeded with
        `seed`, then the serving graph, enqueued without a host sync.
        Returns the normalized chunks [B, horizon, action_dim] on the
        device. A follower of a serving mesh runs it for each of rank 0's
        batched calls (serving.follow)."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        x_t = torch.randn((ids.shape[0], cfg.action_horizon, cfg.action_dim), generator=gen, device=self.device)
        return self._run(ids, {"front_image": self._tensor(images)}, self._tensor(pointclouds),
                         self._tensor(proprio), x_t, sampler=sampler, num_dpm_steps=num_dpm_steps,
                         num_ddim_steps=num_ddim_steps)

    # --- autoregressive heads ----------------------------------------------
    def generate_ids(self, image, pointcloud, input_ids: np.ndarray, num_tokens: int, *, num_beams: int = 1,
                     temperature: float = 0.0, top_k: int = 0, length_penalty: float = 1.0,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """The AR core of predict_action_ar and generate_text: prefix embeds
        of [BOS | fused | input_ids[1:]] for B observations ([B, 4, H, W] or
        one [4, H, W] frame) -> prefill with logits -> greedy / sampled
        decode, or beam search with num_beams > 1. Returns ([B, num_tokens]
        ids, [B, num_tokens] max probabilities, or [B] beam scores). The
        cache holds the prefix, the new tokens and cache_margin spare
        slots.

        Over a mesh every rank selects the same tokens, and beam search the
        same parents, with no exchange of its own, because the logits are
        bit for bit the same on every rank: the vocab-split lm_head's
        slices are all-gathered (tensor.gather_from_tp), and the hidden
        state before it is the same, since the row-parallel all-reduce SUM
        (tensor.reduce_from_tp) hands every rank of a group the same sum
        (gloo and NCCL reduce each segment once and copy it out,
        tensor.SharedCard adds the ranks' buffers in rank order on each
        rank; W8A8's int32 sums are exact) and what follows runs the same
        ops on the same tensors. A sampled token is then the same draw of
        the same generator (seeded with `seed` on each rank's device)
        from the same probabilities."""
        if num_beams > 1 and temperature > 0:
            raise ValueError("beam search and sampling are mutually exclusive")
        cfg = self.cfg
        ids = np.asarray(input_ids)
        cache_max = ids.shape[1] + cfg.fused_len + num_tokens + self.cache_margin
        gen = None
        if temperature > 0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        with torch.inference_mode(), self.tp_scope() as params:
            prefix = build_prefix_embeds(params, self.state, cfg, self._tensor(ids.astype(np.int64)),
                                         self._images(image), self._points(pointcloud))
            kv, last = prefill(params, cfg, prefix, cache_max, int8_mode=self.int8_mode)
            if num_beams > 1:
                toks, extra = beam_search_decode(
                    params, cfg, kv, prefix.shape[1], last, num_tokens, num_beams=num_beams,
                    length_penalty=length_penalty, int8_mode=self.int8_mode,
                )
            else:
                toks, extra = greedy_decode_actions(
                    params, cfg, kv, prefix.shape[1], last, num_tokens, temperature=temperature,
                    top_k=top_k, generator=gen, int8_mode=self.int8_mode,
                )
        return toks.cpu().numpy(), extra.float().cpu().numpy()

    def predict_action_ar(
        self, image, pointcloud, instruction: str, unnorm_key: Optional[str] = None,
        input_ids: Optional[np.ndarray] = None, return_probs: bool = False,
    ):
        """Greedy decode of action_dim action tokens, decoded through the
        action tokenizer and unnormalized; with return_probs also the
        per-token max softmax probabilities."""
        if input_ids is None:
            input_ids = build_prompt_ids(self.tokenizer, instruction, mode="ar")
        toks, probs = self.generate_ids(image, pointcloud, input_ids, self.cfg.action_dim)
        normalized = self.action_tokenizer.decode_token_ids_to_actions(toks[0])
        actions = unnormalize_actions(normalized, self.get_action_stats(unnorm_key))
        if return_probs:
            return actions, [float(p) for p in probs[0]]
        return actions

    def _text_ids(self, prompt: str) -> np.ndarray:
        return np.asarray([self.tokenizer(f"In: {prompt}\nOut:".rstrip(), add_special_tokens=True)["input_ids"]],
                          np.int32)

    def _decode_to_eos(self, toks: np.ndarray) -> str:
        eos = np.nonzero(toks == EOS_ID)[0]
        if len(eos):
            toks = toks[: eos[0]]
        if self.tokenizer is None:
            return " ".join(str(t) for t in toks)
        return self.tokenizer.decode(toks)

    def generate_text(
        self, image, pointcloud, prompt: str, max_new_tokens: int = 64, input_ids: Optional[np.ndarray] = None,
        num_beams: int = 1, temperature: float = 0.0, top_k: int = 0, length_penalty: float = 1.0, seed: int = 0,
    ) -> str:
        """Multimodal text generation: greedy by default, sampled with
        temperature / top_k (seeded), or beam search with num_beams > 1 and
        HF's length_penalty. The output stops at the first EOS."""
        if input_ids is None:
            input_ids = self._text_ids(prompt)
        toks, _ = self.generate_ids(image, pointcloud, input_ids, max_new_tokens, num_beams=num_beams,
                                    temperature=temperature, top_k=top_k, length_penalty=length_penalty, seed=seed)
        return self._decode_to_eos(toks[0])

    def generate_text_batch(
        self, images, pointclouds, prompts: List[str], max_new_tokens: int = 64, num_beams: int = 1,
        temperature: float = 0.0, top_k: int = 0, length_penalty: float = 1.0, seed: int = 0,
    ) -> List[str]:
        """Batched generation: rows are grouped by prompt token length and
        each group runs as one batch (beams ride the [B*K] rows); padding
        prompts instead would shift the splice layout. The groups run in
        the order of their first prompt, so the ranks of a mesh run them in
        the same order."""
        ids_list = [self._text_ids(p) for p in prompts]
        groups: Dict[int, List[int]] = {}
        for i, ids in enumerate(ids_list):
            groups.setdefault(int(ids.shape[1]), []).append(i)
        out: List[Optional[str]] = [None] * len(prompts)
        for rows in groups.values():
            toks, _ = self.generate_ids(
                np.stack([np.asarray(images[i]) for i in rows]), np.stack([np.asarray(pointclouds[i]) for i in rows]),
                np.concatenate([ids_list[i] for i in rows]), max_new_tokens, num_beams=num_beams,
                temperature=temperature, top_k=top_k, length_penalty=length_penalty, seed=seed,
            )
            for j, i in enumerate(rows):
                out[i] = self._decode_to_eos(toks[j])
        return out  # type: ignore[return-value]

    def predict_action_diff_ar(
        self, front_image, pointcloud, instruction: str, cur_robot_state=None, unnorm_key: Optional[str] = None,
        num_ddim_steps: int = 8, seed: int = 0, sampler: str = "ddim", num_dpm_steps: int = DPM_STEPS,
    ) -> Dict[str, Any]:
        """Both heads for one observation: the AR action (with its per-token
        confidences) and the diffusion chunk (DDIM with num_ddim_steps, or
        DPM-Solver++(2M) with num_dpm_steps evaluations with sampler='dpm'),
        with the host wall time of each."""
        ar_ids = build_prompt_ids(self.tokenizer, instruction, mode="ar")
        t0 = time.perf_counter()
        ar_actions, ar_max_probs = self.predict_action_ar(
            front_image, pointcloud, instruction, unnorm_key=unnorm_key, input_ids=ar_ids, return_probs=True,
        )
        t_ar = time.perf_counter() - t0
        t0 = time.perf_counter()
        diff_actions = self.predict_action_diff(
            front_image, pointcloud, instruction, cur_robot_state=cur_robot_state, unnorm_key=unnorm_key,
            num_ddim_steps=num_ddim_steps, seed=seed, sampler=sampler, num_dpm_steps=num_dpm_steps,
        )
        t_diff = time.perf_counter() - t0
        return {"actions": diff_actions, "ar_actions": ar_actions,
                "ar_max_probs": ar_max_probs[-self.cfg.action_dim:], "timings": [t_ar, t_diff]}

    def predict_action_batch(
        self, images, pointclouds, instructions, action_model_params=None, action_model_cfg=None,
        unnorm_key: Optional[str] = None, cfg_scale: float = 1.5, num_ddim_steps: int = 10, seed: int = 0,
    ) -> np.ndarray:
        """The legacy CogACT path: a standalone DiT action head
        (models/action_model.py) conditioned on the decoder's last hidden
        state denoises a batch of chunks (DDIM, classifier-free guidance
        when cfg_scale > 1). Prompts are right-padded with PAD_ID to the
        longest. Returns [B, horizon, action_dim]. Over a mesh the
        condition runs on the tree tp_scope() yields; the DiT head is whole
        on every rank, as JAX's rules leave it."""
        if action_model_params is None:
            raise ValueError("predict_action_batch requires action_model params")
        cfg = self.cfg
        B = len(instructions)
        ids_list = [build_prompt_ids(self.tokenizer, ins, mode="ar") for ins in instructions]
        ids = np.full((B, max(x.shape[1] for x in ids_list)), PAD_ID, np.int32)
        for i, x in enumerate(ids_list):
            ids[i, : x.shape[1]] = x[0]
        dit = tree_to(action_model_params, self.device)
        sched = gd.create_schedule(f"ddim{num_ddim_steps}", diffusion_steps=100)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        with torch.inference_mode():
            images_b = {"front_image": self._tensor(np.stack([np.asarray(im) for im in images]))}
            pc_b = self._tensor(np.stack([np.asarray(p) for p in pointclouds]), torch.float32)
            with self.tp_scope() as params:
                z = cognition_feature(params, self.state, cfg, self._tensor(ids, torch.long), images_b, pc_b,
                                      int8_mode=self.int8_mode)
            noise = torch.randn((B, cfg.action_horizon, cfg.action_dim), generator=gen, device=self.device)
            if cfg_scale > 1.0:
                z_all = torch.cat([z, dit["uncondition"][None].expand(z.shape)], dim=0)
                samples = gd.ddim_sample_loop(
                    sched, lambda x, t: am.dit_forward_with_cfg(dit, action_model_cfg, x, t, z_all, cfg_scale),
                    torch.cat([noise, noise], dim=0),
                )[:B]
            else:
                samples = gd.ddim_sample_loop(sched, lambda x, t: am.dit_forward(dit, action_model_cfg, x, t, z), noise)
        return unnormalize_actions(samples.cpu().numpy(), self.get_action_stats(unnorm_key))
