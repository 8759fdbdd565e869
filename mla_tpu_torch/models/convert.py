"""Export of the port's parameter trees in the reference's checkpoint layout.

Counterpart of the export half of mla_tpu/models/convert.py: our (params,
state) -> the reference's module-keyed {"model": {"llm_backbone": {...},
"vision_tower_2d": {...}, ...}} state dicts of fp32 numpy arrays, which
training/checkpointing.export_reference_pt saves with torch.save. It is the
one checkpoint format both packages write. Conventions:
  * torch nn.Linear stores [out, in]; the trees store [in, out] -> transpose
  * 1x1 convolutions get their [out, in, 1(,1)] kernel shape back
  * the patchify linear [3*14*14, C] -> the conv kernel [C, 3, 14, 14]
  * scan-stacked [L, ...] decoder leaves -> per-layer HF keys
  * batch-norm running statistics come from the model state
The import half (convert_*, load_*) is not ported yet (ROADMAP.md queue 1,
item 6).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _np(x) -> np.ndarray:
    """A tensor leaf (any dtype, any device) as an fp32 numpy array."""
    return x.detach().to("cpu", torch.float32, copy=True).numpy()


def _exp_lin(p: Dict[str, Any], prefix: str, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.weight"] = _np(p["w"]).T
    if "b" in p:
        out[f"{prefix}.bias"] = _np(p["b"])


def _exp_ln(p: Dict[str, Any], prefix: str, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.weight"] = _np(p["scale"])
    out[f"{prefix}.bias"] = _np(p["bias"])


def _exp_conv1x1(p: Dict[str, Any], prefix: str, out: Dict[str, np.ndarray], conv2d: bool) -> None:
    w = _np(p["w"]).T  # [out, in]
    out[f"{prefix}.weight"] = w[..., None, None] if conv2d else w[..., None]
    if "b" in p:
        out[f"{prefix}.bias"] = _np(p["b"])


def _exp_bn(p: Dict[str, Any], s: Dict[str, Any], prefix: str, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.weight"] = _np(p["scale"])
    out[f"{prefix}.bias"] = _np(p["bias"])
    out[f"{prefix}.running_mean"] = _np(s["mean"])
    out[f"{prefix}.running_var"] = _np(s["var"])
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def export_llama(params: Dict[str, Any], prefix: str = "llm.") -> Dict[str, np.ndarray]:
    """Inverse of convert_llama (scan-stacked -> per-layer HF keys)."""
    out: Dict[str, np.ndarray] = {}
    out[f"{prefix}model.embed_tokens.weight"] = _np(params["embed"]["table"])
    lp = params["layers"]
    L = _np(lp["input_ln"]["scale"]).shape[0]
    names = {
        "self_attn.q_proj": lp["attn"]["q"]["w"],
        "self_attn.k_proj": lp["attn"]["k"]["w"],
        "self_attn.v_proj": lp["attn"]["v"]["w"],
        "self_attn.o_proj": lp["attn"]["o"]["w"],
        "mlp.gate_proj": lp["mlp"]["gate"]["w"],
        "mlp.up_proj": lp["mlp"]["up"]["w"],
        "mlp.down_proj": lp["mlp"]["down"]["w"],
    }
    for i in range(L):
        for name, w in names.items():
            out[f"{prefix}model.layers.{i}.{name}.weight"] = _np(w[i]).T
        out[f"{prefix}model.layers.{i}.input_layernorm.weight"] = _np(lp["input_ln"]["scale"][i])
        out[f"{prefix}model.layers.{i}.post_attention_layernorm.weight"] = _np(lp["post_ln"]["scale"][i])
    out[f"{prefix}model.norm.weight"] = _np(params["final_ln"]["scale"])
    out[f"{prefix}lm_head.weight"] = _np(params["lm_head"]["w"]).T
    return out


def export_contrastive(params: Dict[str, Any], prefix: str = "llm.") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}

    def head(p, pre):
        _exp_lin(p["fc1"], f"{pre}.0", out)
        _exp_lin(p["fc2"], f"{pre}.2", out)

    if "coord" in params:
        c = f"{prefix}coordinate_aware_contrastive_loss_module"
        head(params["coord"]["image_head"], f"{c}.image_projection_head")
        head(params["coord"]["pointcloud_head"], f"{c}.pointcloud_projection_head")
    if "tactile" in params:
        t = f"{prefix}tactile_contrastive_loss_module"
        head(params["tactile"]["tactile_head"], f"{t}.tactile_projection_head")
        head(params["tactile"]["pointcloud_head"], f"{t}.pointcloud_projection_head")
        head(params["tactile"]["image_head"], f"{t}.image_projection_head")
    return out


def export_vision_tokenizer(params: Dict[str, Any], patch_stride: int = 14) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    w = _np(params["patch_embedding"]["w"]).T  # [C, 3*k*k]
    C = w.shape[0]
    out["patch_embedding.weight"] = w.reshape(C, 3, patch_stride, patch_stride)
    out["class_embedding"] = _np(params["class_embedding"])
    out["split_embedding"] = _np(params["split_embedding"])
    for name in ("local_attention", "global_attention"):
        p = params[name]
        _exp_ln(p["q_ln"], f"{name}.q.0", out)
        _exp_lin(p["q"], f"{name}.q.1", out)
        _exp_ln(p["kv_ln"], f"{name}.kv.0", out)
        _exp_lin(p["kv"], f"{name}.kv.1", out)
        _exp_lin(p["proj"], f"{name}.proj", out)
    return out


def export_point_tokenizer(
    params: Dict[str, Any], state: Dict[str, Any], lga_blocks=(2, 1)
) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    _exp_conv1x1(params["raw_embed"]["conv"], "patch_embed.EncP.raw_point_embed.net.0", out, conv2d=False)
    _exp_bn(params["raw_embed"]["bn"], state["raw_embed"]["bn"], "patch_embed.EncP.raw_point_embed.net.1", out)
    for si, nblocks in enumerate(lga_blocks):
        for bi in range(nblocks):
            base = f"patch_embed.EncP.LGA_list.{si}.linear2.{bi}"
            bp = params["stages"][si]["blocks"][bi]
            bs = state["stages"][si]["blocks"][bi]
            _exp_conv1x1(bp["net1"]["conv"], f"{base}.net1.0", out, conv2d=True)
            _exp_bn(bp["net1"]["bn"], bs["net1"]["bn"], f"{base}.net1.1", out)
            _exp_conv1x1(bp["net2"]["conv"], f"{base}.net2.0", out, conv2d=True)
            _exp_bn(bp["net2"]["bn"], bs["net2"]["bn"], f"{base}.net2.1", out)
    _exp_lin(params["proj"], "proj", out)
    out["cls_token"] = _np(params["cls_token"])
    out["pos_embed"] = _np(params["pos_embed"])
    _exp_ln(params["norm"], "norm", out)
    return out


def export_reference_checkpoint(params: Dict[str, Any], state: Dict[str, Any], cfg) -> Dict[str, Dict[str, np.ndarray]]:
    """Our (params, state) -> the reference's module-keyed {"model": {...}}
    payload (numpy values; the caller torch.save's it), the inverse of the
    JAX package's load_reference_checkpoint for the module groups we own."""
    model: Dict[str, Dict[str, np.ndarray]] = {}
    llm = export_llama(params["llm_backbone"])
    if "contrastive" in params:
        llm.update(export_contrastive(params["contrastive"]))
    model["llm_backbone"] = llm
    # every module is guarded, so LLM-only and ablation trees export too
    if "vision_tower_2d" in params:
        model["vision_tower_2d"] = export_vision_tokenizer(
            params["vision_tower_2d"], cfg.vision.patch_stride
        )
    if "projector_2d" in params:
        pj2 = {}
        for i, lp in enumerate(params["projector_2d"]["layers"]):
            _exp_lin(lp, f"mlp.{2 * i}", pj2)
        model["projector_2d"] = pj2
    if "vision_tower_3d" in params:
        model["vision_tower_3d"] = export_point_tokenizer(
            params["vision_tower_3d"], state["vision_tower_3d"], cfg.point.lga_blocks
        )
    if "projector_3d" in params:
        pj3 = {}
        _exp_lin(params["projector_3d"]["fc1"], "projector.0", pj3)
        _exp_lin(params["projector_3d"]["fc2"], "projector.2", pj3)
        model["projector_3d"] = pj3
    for name in ("proprio_embedder", "x_embedder", "tactile_embedder"):
        if name in params:
            e = {}
            _exp_lin(params[name]["fc1"], "mlp.fc1", e)
            _exp_lin(params[name]["fc2"], "mlp.fc2", e)
            model[name] = e
    if "t_embedder" in params:
        e = {}
        _exp_lin(params["t_embedder"]["fc1"], "mlp.0", e)
        _exp_lin(params["t_embedder"]["fc2"], "mlp.2", e)
        model["t_embedder"] = e
    if "final_layer" in params:
        e = {"norm_final.weight": _np(params["final_layer"]["norm"]["scale"])}
        _exp_lin(params["final_layer"]["mlp"]["fc1"], "mlp.fc1", e)
        _exp_lin(params["final_layer"]["mlp"]["fc2"], "mlp.fc2", e)
        model["final_layer"] = e
    return {"model": model}
