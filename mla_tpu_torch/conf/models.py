"""Model-architecture presets.

Counterpart of mla_tpu/conf/models.py. The flagship deployment config is
`mla-7b` (Llama-2-7B backbone); smaller presets exist for checks and tests;
`mla-mistral` and `mla-phi` (Phi-2, the phi family) swap the decoder under
the same front-ends. Each preset carries the generation heads' config at
its decoder width, as the JAX presets do.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Dict

import torch

from mla_tpu_torch.models import generation as gen_mod
from mla_tpu_torch.models import llama as llama_mod
from mla_tpu_torch.models import phi as phi_mod
from mla_tpu_torch.models import point_tokenizer as pt_mod
from mla_tpu_torch.models import prismatic
from mla_tpu_torch.models import vision_tokenizer as vt_mod


def _gen_cfg(token_size: int, use_generation: bool, use_tactile: bool, use_roi: bool) -> gen_mod.GenerationConfig:
    return gen_mod.GenerationConfig(
        token_size=token_size,
        use_image=use_generation,
        use_pointcloud=use_generation,
        use_tactile=use_generation and use_tactile,
        image=gen_mod.ImageGenConfig(token_size=token_size, use_roi=use_roi),
        point=gen_mod.PointGenConfig(token_size=token_size),
        tactile=gen_mod.TactileGenConfig(token_size=token_size),
    )


def _full_width(llama_cfg, use_diff, use_pointcloud, use_tactile, use_contrastive,
                use_generation, use_roi, camera_name, **kw) -> prismatic.MLAModelConfig:
    return prismatic.MLAModelConfig(
        llm_family=kw.pop("llm_family", "llama"),
        llama=llama_cfg,
        vision=vt_mod.VisionTokenizerConfig(),
        point=pt_mod.PointTokenizerConfig(),
        gen=_gen_cfg(llama_cfg.hidden_size, use_generation, use_tactile, use_roi),
        use_diff=use_diff, use_pointcloud=use_pointcloud, use_tactile=use_tactile,
        use_contrastive=use_contrastive, use_generation=use_generation,
        use_roi=use_roi, camera_name=camera_name, **kw,
    )


def mla_7b(use_diff=True, use_pointcloud=True, use_tactile=False, use_contrastive=True,
           use_generation=False, use_roi=False, camera_name="rlbench_front",
           param_dtype=torch.bfloat16, **kw) -> prismatic.MLAModelConfig:
    """Flagship: Llama-2-7B + 672px vision tokenizer + 1024-pt Point-PN."""
    return _full_width(
        replace(llama_mod.LLAMA2_7B, param_dtype=param_dtype), use_diff, use_pointcloud,
        use_tactile, use_contrastive, use_generation, use_roi, camera_name, **kw,
    )


def mla_2b(**kw) -> prismatic.MLAModelConfig:
    """mla-7b cut to 8 decoder layers, same widths and front-ends."""
    cfg = mla_7b(**kw)
    return replace(cfg, llama=replace(cfg.llama, num_layers=8))


def mla_medium(**kw) -> prismatic.MLAModelConfig:
    """~0.45B decoder (hidden 2048 x 6 layers, head_dim 128), full front-ends."""
    cfg = mla_7b(**kw)
    return replace(cfg, llama=replace(
        cfg.llama, hidden_size=2048, intermediate_size=5632, num_layers=6,
        num_heads=16, num_kv_heads=16, contrastive_layer=3,
    ), gen=_gen_cfg(2048, cfg.use_generation, cfg.use_tactile, cfg.use_roi))


def mla_small(**kw) -> prismatic.MLAModelConfig:
    """~120M decoder with production-shape hot loops (head_dim 128, full
    front-ends)."""
    cfg = mla_7b(**kw)
    return replace(cfg, llama=replace(
        cfg.llama, hidden_size=1024, intermediate_size=2816, num_layers=4,
        num_heads=8, num_kv_heads=8, contrastive_layer=2,
    ), gen=_gen_cfg(1024, cfg.use_generation, cfg.use_tactile, cfg.use_roi))


def mla_tiny(**kw) -> prismatic.MLAModelConfig:
    """Test size: the full architecture at toy widths, fp32 compute."""
    for k in ("use_generation", "use_tactile", "use_roi"):
        kw.setdefault(k, False)
    D = 64
    gen = gen_mod.GenerationConfig(
        token_size=D, use_image=kw["use_generation"], use_pointcloud=kw["use_generation"],
        use_tactile=kw["use_generation"] and kw["use_tactile"],
        image=gen_mod.ImageGenConfig(
            token_size=D, num_gen_queries=4, decoder_layers=1, decoder_heads=4, num_patches=16,
            use_roi=kw["use_roi"],
        ),
        point=gen_mod.PointGenConfig(token_size=D, trans_dim=32, decoder_layers=1, decoder_heads=4, group_size=4,
                                     num_groups=8),
        tactile=gen_mod.TactileGenConfig(token_size=D, decoder_layers=1),
    )
    llama_cfg = llama_mod.LlamaConfig(
        vocab_size=32064, hidden_size=D, intermediate_size=128, num_layers=4,
        num_heads=4, num_kv_heads=4, max_position_embeddings=256,
        contrastive_layer=2, compute_dtype=torch.float32,
    )
    return prismatic.MLAModelConfig(
        llama=llama_cfg,
        vision=vt_mod.VisionTokenizerConfig(image_size=168, hidden_dim=32, num_heads=4),
        point=pt_mod.PointTokenizerConfig(
            input_points=64, embed_dim=12, k_neighbors=8, lga_blocks=(2, 1),
            dim_expansion=(2, 2), out_dim=24,
        ),
        gen=gen, image_hidden_dim=32, point_token_dim=24, **kw,
    )


def mla_golden(use_diff=True, use_pointcloud=False, use_tactile=False, use_contrastive=False,
               use_generation=False, use_roi=False, camera_name="rlbench_front", num_layers=4,
               contrastive_layer=2, hidden_size=512, num_heads=8, intermediate_size=1376,
               **kw) -> prismatic.MLAModelConfig:
    """Reduced decoder (default hidden 512 x 4 layers) with the full-width
    front-ends, bf16 params and compute."""
    llama_cfg = llama_mod.LlamaConfig(
        vocab_size=32064, hidden_size=hidden_size, intermediate_size=intermediate_size,
        num_layers=num_layers, num_heads=num_heads, num_kv_heads=num_heads,
        max_position_embeddings=2048, contrastive_layer=contrastive_layer,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )
    return _full_width(llama_cfg, use_diff, use_pointcloud, use_tactile, use_contrastive,
                       use_generation, use_roi, camera_name, **kw)


def mla_mistral(use_diff=True, use_pointcloud=True, use_tactile=False, use_contrastive=True,
                use_generation=False, use_roi=False, camera_name="rlbench_front",
                param_dtype=torch.bfloat16, **kw) -> prismatic.MLAModelConfig:
    """Mistral-7B backbone (GQA, 8 KV heads) with the same front-ends."""
    return _full_width(
        replace(llama_mod.MISTRAL_7B, param_dtype=param_dtype), use_diff, use_pointcloud,
        use_tactile, use_contrastive, use_generation, use_roi, camera_name, **kw,
    )


def mla_phi(use_diff=True, use_pointcloud=True, use_tactile=False, use_contrastive=True,
            use_generation=False, use_roi=False, camera_name="rlbench_front",
            param_dtype=torch.bfloat16, **kw) -> prismatic.MLAModelConfig:
    """Phi-2 backbone (parallel attention + MLP blocks, partial RoPE) with
    the same front-ends (token_size 2560)."""
    return _full_width(
        replace(phi_mod.PHI_2, param_dtype=param_dtype), use_diff, use_pointcloud, use_tactile,
        use_contrastive, use_generation, use_roi, camera_name, llm_family=kw.pop("llm_family", "phi"), **kw,
    )


MODEL_REGISTRY: Dict[str, Callable[..., prismatic.MLAModelConfig]] = {
    "mla-7b": mla_7b,
    "prism-dinosiglip-224px+7b": mla_7b,
    "mla-2b": mla_2b,
    "mla-medium": mla_medium,
    "mla-small": mla_small,
    "mla-tiny": mla_tiny,
    "mla-golden": mla_golden,
    "mla-mistral": mla_mistral,
    "mla-phi": mla_phi,
}


def get_model_config(model_id: str, **overrides) -> prismatic.MLAModelConfig:
    if model_id not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model `{model_id}`. Available: {list(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[model_id](**overrides)
