"""Prismatic model-zoo metadata registry.

Counterpart of mla_tpu/models/registry.py (the port keeps its own copy of
this data): the released VLMs' ids and the fields consumers read (vision
and LLM backbone, resize strategy, max length), the alias lookup, and the
LLM backbones' decoder presets and prompt families.
"""

from __future__ import annotations

from typing import Dict

# The reproduction + key released prismatic VLMs (subset covering every
# backbone family the reference supports; description strings summarized).
MODEL_REGISTRY: Dict[str, Dict] = {
    "prism-dinosiglip-224px+7b": {
        "model_id": "prism-dinosiglip-224px+7b",
        "names": ["Prism-DINOSigLIP 224px 7B", "MLA base VLM"],
        "vision_backbone_id": "dinosiglip-vit-so-224px",
        "llm_backbone_id": "llama2-7b-pure",
        "arch_specifier": "no-align+fused-gelu-mlp",
        "image_resize_strategy": "resize-naive",
        "llm_max_length": 2048,
    },
    "prism-dinosiglip+7b": {
        "model_id": "prism-dinosiglip+7b",
        "names": ["Prism-DINOSigLIP 384px 7B"],
        "vision_backbone_id": "dinosiglip-vit-so-384px",
        "llm_backbone_id": "llama2-7b-pure",
        "arch_specifier": "no-align+fused-gelu-mlp",
        "image_resize_strategy": "resize-naive",
        "llm_max_length": 2048,
    },
    "reproduction-llava-v15+7b": {
        "model_id": "reproduction-llava-v15+7b",
        "names": ["LLaVa v1.5 7B (reproduction)"],
        "vision_backbone_id": "clip-vit-l-336px",
        "llm_backbone_id": "vicuna-v15-7b",
        "arch_specifier": "gelu-mlp",
        "image_resize_strategy": "letterbox",
        "llm_max_length": 2048,
    },
    "siglip-224px+7b": {
        "model_id": "siglip-224px+7b",
        "names": ["SigLIP 224px 7B"],
        "vision_backbone_id": "siglip-vit-so400m",
        "llm_backbone_id": "vicuna-v15-7b",
        "arch_specifier": "gelu-mlp",
        "image_resize_strategy": "resize-naive",
        "llm_max_length": 2048,
    },
    "dinosiglip-224px+7b": {
        "model_id": "dinosiglip-224px+7b",
        "names": ["DINOSigLIP 224px 7B"],
        "vision_backbone_id": "dinosiglip-vit-so-224px",
        "llm_backbone_id": "vicuna-v15-7b",
        "arch_specifier": "fused-gelu-mlp",
        "image_resize_strategy": "resize-naive",
        "llm_max_length": 2048,
    },
    "llama2+7b": {
        "model_id": "llama2+7b",
        "names": ["Llama-2 7B"],
        "vision_backbone_id": "clip-vit-l-336px",
        "llm_backbone_id": "llama2-7b-pure",
        "arch_specifier": "gelu-mlp",
        "image_resize_strategy": "letterbox",
        "llm_max_length": 2048,
    },
    "mistral-v0.1+7b": {
        "model_id": "mistral-v0.1+7b",
        "names": ["Mistral v0.1 7B"],
        "vision_backbone_id": "clip-vit-l-336px",
        "llm_backbone_id": "mistral-v0.1-7b-pure",
        "arch_specifier": "gelu-mlp",
        "image_resize_strategy": "letterbox",
        "llm_max_length": 2048,
    },
    "phi-2+3b": {
        "model_id": "phi-2+3b",
        "names": ["Phi-2 3B"],
        "vision_backbone_id": "clip-vit-l-336px",
        "llm_backbone_id": "phi-2-3b",
        "arch_specifier": "gelu-mlp",
        "image_resize_strategy": "letterbox",
        "llm_max_length": 2048,
    },
}

GLOBAL_REGISTRY: Dict[str, Dict] = {
    name: entry for entry in MODEL_REGISTRY.values() for name in [entry["model_id"]] + entry["names"]
}


# LLM backbone id -> (decoder config preset kwargs, prompt family).
# The decoder itself is models/llama.py (the llama architecture family
# covers mistral via GQA + rope theta; phi-2 uses parallel blocks and is
# noted as conversion-only).
LLM_BACKBONE_REGISTRY: Dict[str, Dict] = {
    "llama2-7b-pure": {"prompt_family": "llama2-pure", "hf_id": "meta-llama/Llama-2-7b-hf",
                       "cfg": dict()},
    "llama2-13b-pure": {"prompt_family": "llama2-pure", "hf_id": "meta-llama/Llama-2-13b-hf",
                        "cfg": dict(hidden_size=5120, intermediate_size=13824, num_layers=40, num_heads=40, num_kv_heads=40)},
    "llama2-7b-chat": {"prompt_family": "llama2-chat", "hf_id": "meta-llama/Llama-2-7b-chat-hf", "cfg": dict()},
    "vicuna-v15-7b": {"prompt_family": "vicuna-v15", "hf_id": "lmsys/vicuna-7b-v1.5", "cfg": dict()},
    "vicuna-v15-13b": {"prompt_family": "vicuna-v15", "hf_id": "lmsys/vicuna-13b-v1.5",
                       "cfg": dict(hidden_size=5120, intermediate_size=13824, num_layers=40, num_heads=40, num_kv_heads=40)},
    "mistral-v0.1-7b-pure": {"prompt_family": "mistral-instruct", "hf_id": "mistralai/Mistral-7B-v0.1",
                             "cfg": dict(intermediate_size=14336, num_kv_heads=8, vocab_size=32064)},
    "mistral-v0.1-7b-instruct": {"prompt_family": "mistral-instruct",
                                 "hf_id": "mistralai/Mistral-7B-Instruct-v0.1",
                                 "cfg": dict(intermediate_size=14336, num_kv_heads=8, vocab_size=32064)},
    "phi-2-3b": {"prompt_family": "phi-2", "hf_id": "microsoft/phi-2",
                 "cfg": dict()},  # PhiConfig defaults (models/phi.py PHI_2)
}


def get_model_description(model_id: str) -> Dict:
    if model_id not in GLOBAL_REGISTRY:
        # GLOBAL_REGISTRY also resolves human-readable alias names — list
        # everything the lookup actually accepts
        raise ValueError(f"Unknown model `{model_id}`; available: {sorted(GLOBAL_REGISTRY)}")
    return GLOBAL_REGISTRY[model_id]
