"""MLA diffusion training loss and serving: prefix embeds, prefill,
cached-suffix denoising and the deployment policy.

Counterpart of mla_tpu/models/mla.py. `mla_train_loss` is the diffusion
training forward: the batch repeated `repeated_diffusion_steps` times, the
future-action window q-sampled at random t, the noise regressed, plus the
point/image contrastive loss. The AR loss mode is not ported yet. The
multimodal prefix
[BOS | fused | text[1:]] is prefilled once into a KV cache; each denoise
step then runs only the 18-token suffix [proprio, t, x_0..15] against the
cached prefix, reading the cache without writing it. This is exact with
respect to a full recompute, since the prefix is unchanged across steps and
attention is causal.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mla_tpu_torch.diffusion import gaussian as gd
from mla_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_2m
from mla_tpu_torch.models import embedders
from mla_tpu_torch.models import llama as llama_mod
from mla_tpu_torch.models import prismatic
from mla_tpu_torch.params import tree_to

DDIM_STEPS = 8     # the reference's DDIM respacing
DPM_STEPS = 4      # DPM-Solver++(2M) model evaluations
CACHE_MARGIN = 32  # spare KV-cache slots past the prefix and the suffix

# token ids of the Llama-2 + MLA vocabulary
BOS_ID = 1
EOS_ID = 2
EMPTY_ID = 29871  # the '▁' token after "Out:"
BOD_ID = 32001
EOD_ID = 32002

# CLIP normalization (the constants of the data pipeline, mla_tpu/vla/datasets.py)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


LOSS_KEYS = (
    "total_loss", "img_pc_contrastive_loss", "tactile_contrastive_loss", "diff_loss", "ar_loss",
    "image_gen_loss", "point_cloud_gen_loss", "tactile_gen_loss",
)


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
    batch of tensors on the parameters' device. The diffusion noise, t and
    the point tokenizer's FPS starts ([num_stages] x [B * rep]) are drawn
    from `generator` unless given: override_noise [B * rep, horizon,
    action_dim], override_t [B * rep] and fps_start replace the draws (the
    parity tests feed the JAX package's)."""
    if not cfg.use_diff:
        raise NotImplementedError("the AR loss mode (use_diff=False) is not ported yet")
    rbatch = _tile_batch(batch, repeated_diffusion_steps)
    future = rbatch["actions"][:, -cfg.action_horizon :, :].float()
    Br, dev = future.shape[0], future.device
    if override_noise is not None:
        noise = torch.as_tensor(np.array(override_noise), dtype=torch.float32, device=dev).reshape(future.shape)
    else:
        noise = torch.randn(future.shape, generator=generator, device=dev)
    if override_t is not None:
        t = torch.as_tensor(np.array(override_t), device=dev).long().reshape(Br)
    else:
        t = torch.randint(0, sched.num_timesteps, (Br,), generator=generator, device=dev)
    if fps_start is not None:
        fps_start = [torch.as_tensor(np.array(s), dtype=torch.int32, device=dev) for s in fps_start]
    elif cfg.use_pointcloud:
        fps_start = [
            torch.randint(0, cfg.point.input_points >> si, (Br,), generator=generator, device=dev, dtype=torch.int32)
            for si in range(cfg.point.num_stages)
        ]
    x = gd.q_sample(sched, future, t, noise)
    rbatch = {**rbatch, "x": x, "t": t}
    # the reference computes the LM loss in diffusion mode and drops it from
    # the total; like the JAX package, skip the LM head instead
    rbatch.pop("labels", None)
    outputs, new_state = prismatic.vlm_forward(
        params, state, cfg, rbatch, training=True, use_diff=True, generator=generator, remat=remat,
        fps_start=fps_start,
    )
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    loss_dict = {k: zero for k in LOSS_KEYS}
    total = loss_dict["diff_loss"] = ((outputs["noise_pred"].float() - noise) ** 2).mean()
    if cfg.use_contrastive and "img_pc_contrastive_loss" in outputs:
        loss_dict["img_pc_contrastive_loss"] = outputs["img_pc_contrastive_loss"]
        total = total + outputs["img_pc_contrastive_loss"]
    loss_dict["total_loss"] = total
    return total, (loss_dict, new_state)


def _device_clip_preprocess(img_u8: torch.Tensor) -> torch.Tensor:
    """Raw uint8 [B, 3, S, S] -> CLIP-normalized fp32 [B, 4, S, S] with the
    all-ones mask channel, on the frame's device."""
    x = img_u8.float() / 255.0
    mean = torch.as_tensor(CLIP_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.as_tensor(CLIP_STD, device=x.device).reshape(1, 3, 1, 1)
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
    text_emb = llama_mod.embed_tokens(params["llm_backbone"], input_ids_prefix)
    prefix = torch.cat([text_emb[:, :1], fused.to(text_emb.dtype), text_emb[:, 1:]], dim=1)
    if with_uncond:
        uncond = params["z_embedder"]["uncondition"].to(prefix.dtype)
        prefix = torch.cat([prefix, uncond[None].expand(prefix.shape)], dim=0)
    return prefix


def prefill(
    params: Dict[str, Any], cfg: prismatic.MLAModelConfig, prefix_embeds: torch.Tensor, cache_max_len: int,
) -> Dict[str, torch.Tensor]:
    """Run the prefix through the decoder into a new KV cache. The diffusion
    path needs no logits. On the card its attention is the flash kernel."""
    B, P, _ = prefix_embeds.shape
    cache = llama_mod.init_kv_cache(cfg.llama, B, cache_max_len, device=prefix_embeds.device)
    key_mask = (torch.arange(cache_max_len, device=prefix_embeds.device) < P)[None, :].expand(B, -1)
    return llama_mod.llama_forward(
        params["llm_backbone"], cfg.llama, prefix_embeds,
        kv_cache=cache, cache_len=0, key_mask=key_mask, compute_logits=False,
    )["kv_cache"]


def make_suffix_denoise_fn(
    params: Dict[str, Any], cfg: prismatic.MLAModelConfig, kv_cache: Dict[str, torch.Tensor],
    prefix_len: int, proprio: torch.Tensor,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The eps model (x, t) -> eps: a suffix forward [proprio, t, x_0..15]
    against the cached prefix. The prompt's tail id sits causally after the
    x tokens and cannot change eps, so it is not run."""
    B = proprio.shape[0]
    horizon = cfg.action_horizon
    cdt = cfg.llama.compute_dtype
    cache_max = kv_cache["k"].shape[3]
    proprio_emb = embedders.action_embedder(params["proprio_embedder"], proprio.to(cdt))
    key_mask = (torch.arange(cache_max, device=proprio.device) < prefix_len + 2 + horizon)[None, :].expand(B, -1)

    def denoise_fn(x: torch.Tensor, t_model: torch.Tensor) -> torch.Tensor:
        x_emb = embedders.action_embedder(params["x_embedder"], x.to(cdt))
        t_emb = embedders.timestep_embedder(params["t_embedder"], t_model)[:, None, :]
        suffix = torch.cat([proprio_emb, t_emb.to(x_emb.dtype), x_emb], dim=1)
        out = llama_mod.llama_forward(
            params["llm_backbone"], cfg.llama, suffix, kv_cache=kv_cache, cache_len=prefix_len,
            key_mask=key_mask, compute_logits=False, cache_read_only=True,
        )
        final = embedders.final_layer(params["final_layer"], out["last_hidden"])
        return final[:, 2 : 2 + horizon].float()

    return denoise_fn


def ddim_denoise_actions(
    params: Dict[str, Any], cfg: prismatic.MLAModelConfig, sched: gd.Schedule,
    kv_cache: Dict[str, torch.Tensor], prefix_len: int, proprio: torch.Tensor, noise: torch.Tensor,
    *, use_ddpm: bool = False, generator: Optional[torch.Generator] = None, cfg_scale: float = 0.0,
    sampler: str = "ddim",
) -> torch.Tensor:
    """Denoise loop over cached-suffix evaluations: DDIM (eta 0), DDPM, or
    DPM-Solver++(2M) with DPM_STEPS evaluations (`sched` is then the
    unspaced training schedule). With cfg_scale > 1 the cache holds
    [cond; uncond] rows and noise/proprio the doubled batch; the guided eps
    is uncond + scale * (cond - uncond)."""
    base_fn = make_suffix_denoise_fn(params, cfg, kv_cache, prefix_len, proprio)
    if cfg_scale > 1.0:
        def denoise_fn(x, t_model):
            half = x[: x.shape[0] // 2]
            cond, uncond = base_fn(torch.cat([half, half], dim=0), t_model).chunk(2, dim=0)
            guided = uncond + cfg_scale * (cond - uncond)
            return torch.cat([guided, guided], dim=0)
    else:
        denoise_fn = base_fn
    if sampler == "dpm":
        return dpm_solver_pp_2m(sched, denoise_fn, noise, num_steps=DPM_STEPS)
    if use_ddpm:
        return gd.ddpm_sample_loop(sched, denoise_fn, noise, generator=generator)
    return gd.ddim_sample_loop(sched, denoise_fn, noise)


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


class MLAPolicy:
    """Deployment-facing policy: load once, call predict_action_diff per step.

    The decoder's q|k|v and gate|up weights are fused for serving.
    device=None means "cuda" and raises when no card is present; the CPU
    is used only when the caller passes device="cpu"."""

    def __init__(
        self, params: Dict[str, Any], state: Dict[str, Any], cfg: prismatic.MLAModelConfig,
        tokenizer=None, norm_stats: Optional[Dict[str, Any]] = None, device=None,
    ) -> None:
        if cfg.llm_family != "llama":
            raise NotImplementedError(f"llm_family {cfg.llm_family!r} is not ported yet")
        self.device = _resolve_device(device)
        params, state = tree_to(params, self.device), tree_to(state, self.device)
        params = {**params, "llm_backbone": llama_mod.fuse_for_serving(params["llm_backbone"])}
        self.params, self.state, self.cfg = params, state, cfg
        self.tokenizer = tokenizer
        self.norm_stats = norm_stats or {}
        self.sched_full = gd.create_schedule("", diffusion_steps=100)
        self.sched_ddim = gd.create_schedule(f"ddim{DDIM_STEPS}", diffusion_steps=100)

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
        return torch.as_tensor(np.asarray(a), device=self.device, dtype=dtype)

    def _run(self, ids: np.ndarray, images, pc, proprio, noise, *, use_ddpm=False, cfg_scale=0.0,
             sampler="ddim", generator=None) -> torch.Tensor:
        """The serving graph: prefix embeds -> prefill -> denoise loop."""
        cfg = self.cfg
        prefix_ids = self._tensor(ids[:, :-1], torch.long)
        tail_len = 1
        embed_len = prefix_ids.shape[1] + cfg.fused_len
        cache_max = embed_len + 2 + cfg.action_horizon + tail_len + CACHE_MARGIN
        sched = self.sched_full if (use_ddpm or sampler == "dpm") else self.sched_ddim
        use_cfg = cfg_scale > 1.0
        with torch.inference_mode():
            prefix = build_prefix_embeds(self.params, self.state, cfg, prefix_ids, images, pc, with_uncond=use_cfg)
            kv = prefill(self.params, cfg, prefix, cache_max)
            if use_cfg:
                proprio, noise_x = torch.cat([proprio, proprio]), torch.cat([noise, noise])
            else:
                noise_x = noise
            samples = ddim_denoise_actions(
                self.params, cfg, sched, kv, prefix.shape[1], proprio, noise_x,
                use_ddpm=use_ddpm, generator=generator, cfg_scale=cfg_scale, sampler=sampler,
            )
        return samples[: noise.shape[0]]

    def predict_action_diff(
        self, image, pointcloud, instruction: str, cur_robot_state=None, unnorm_key: Optional[str] = None,
        use_ddim: bool = True, cfg_scale: float = 0.0, seed: int = 0, input_ids: Optional[np.ndarray] = None,
        noise: Optional[np.ndarray] = None, sampler: str = "ddim", return_normalized: bool = False,
    ) -> np.ndarray:
        """A [horizon, action_dim] chunk for one observation: DDIM-8 by
        default, DPM-Solver++(2M) with 4 evaluations with sampler='dpm', DDPM with
        use_ddim=False; `noise` overrides the seeded x_T; return_normalized
        returns the chunk before clip / binarize / unnormalization."""
        cfg = self.cfg
        if sampler == "dpm" and not use_ddim:
            raise ValueError("sampler='dpm' is an ODE sampler and conflicts with use_ddim=False")
        if input_ids is None:
            input_ids = build_prompt_ids(self.tokenizer, instruction, mode="diff")
        img = self._tensor(image)
        images = {"front_image": img[None] if img.dim() == 3 else img}
        pc = None
        if pointcloud is not None:
            pc = self._tensor(pointcloud, torch.float32)
            pc = pc[None] if pc.dim() == 2 else pc
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
            x_t = self._tensor(noise, torch.float32).reshape(shape)
        samples = self._run(
            np.asarray(input_ids), images, pc, self._tensor(proprio, torch.float32), x_t,
            use_ddpm=not use_ddim, cfg_scale=cfg_scale, sampler=sampler, generator=gen,
        )
        normalized = samples[0].cpu().numpy()
        if return_normalized:
            return normalized
        return unnormalize_actions(normalized, self.get_action_stats(unnorm_key))

    def predict_action_diff_batched(
        self, images, pointclouds, instruction: Optional[str] = None, unnorm_key: Optional[str] = None,
        seed: int = 0, input_ids: Optional[np.ndarray] = None, cur_robot_states=None, sampler: str = "ddim",
        return_normalized: bool = False,
    ) -> np.ndarray:
        """One prefill + denoise for B observations [B, 4, H, W] / [B, P, 3].
        Prompts share a token length: input_ids [B, L], or one row / one
        instruction broadcast. Rows of cur_robot_states may be None (then
        normalized zero). Returns [B, horizon, action_dim]."""
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
            pstats = self.get_proprio_stats(unnorm_key)
            for b, s in enumerate(cur_robot_states):
                if s is not None:
                    proprio[b, 0] = normalize_proprio(np.asarray(s, np.float32), pstats)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        x_t = torch.randn((B, cfg.action_horizon, cfg.action_dim), generator=gen, device=self.device)
        samples = self._run(
            ids, {"front_image": self._tensor(images)}, self._tensor(pointclouds, torch.float32),
            self._tensor(proprio), x_t, sampler=sampler,
        )
        out = samples.cpu().numpy()
        if return_normalized:
            return out
        stats = self.get_action_stats(unnorm_key)
        return np.stack([unnormalize_actions(out[b], stats) for b in range(B)])
