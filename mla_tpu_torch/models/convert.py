"""Checkpoint conversion: the reference's PyTorch checkpoints <-> our trees.

Counterpart of mla_tpu/models/convert.py. The reference's layout is a
module-keyed {"model": {"llm_backbone": {...}, "vision_tower_2d": {...},
...}} of per-module state dicts. Conventions bridged both ways:
  * torch nn.Linear stores [out, in]; the trees store [in, out] -> transpose
  * 1x1 convolutions [out, in, 1(,1)] <-> [in, out]
  * the patchify conv [C, 3, 14, 14] <-> the linear [3*14*14, C]
  * per-layer HF decoder keys <-> scan-stacked [L, ...] leaves
  * packed q|k|v (in_proj_weight) <-> qkv.w
  * batch-norm running statistics live in the model state, not the params

Import (`convert_*`, `load_reference_checkpoint`): torch tensors in,
tensors out, each leaf in its source dtype (JAX widens bf16 to fp32 here and
casts to the model's param dtype after, which gives the same values). A
state dict is read through `_OnDevice`, so every leaf is moved to the target
device as it is converted and a full-width decoder is stacked there, never
on the host.
Export (`export_*`): our (params, state) -> fp32 numpy state dicts, which
training/checkpointing.export_reference_pt saves with torch.save; it is the
one checkpoint format both packages write and read. HF directories
(`merge_hf_shards`, `load_hf_llama`; `convert_mistral`, `convert_phi`) are
read through models/safetensors_io, without the safetensors package, and
lazily; the vocabulary is padded with the mean rows JAX computes (np.mean
on the host in the source dtype), bit for bit.
"""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch


# --------------------------------------------------------------------------- #
# import: reference state dicts -> our params/state
# --------------------------------------------------------------------------- #


def _t(x) -> torch.Tensor:
    """A state-dict value (tensor or numpy array) as a tensor, dtype kept."""
    return x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


class _OnDevice(Mapping):
    """A state dict whose values are read as tensors on `device`."""

    def __init__(self, sd: Dict[str, Any], device) -> None:
        self._sd, self._device = sd, device

    def __getitem__(self, key: str) -> torch.Tensor:
        return _t(self._sd[key]).to(self._device)

    def __contains__(self, key) -> bool:
        return key in self._sd

    def __iter__(self):
        return iter(self._sd)

    def __len__(self) -> int:
        return len(self._sd)


def _T(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


def _lin(sd, prefix: str, bias: bool = True) -> Dict[str, torch.Tensor]:
    p = {"w": _T(sd[f"{prefix}.weight"])}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _ln(sd, prefix: str) -> Dict[str, torch.Tensor]:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _conv1x1(sd, prefix: str) -> Dict[str, torch.Tensor]:
    w = sd[f"{prefix}.weight"]  # [out, in, 1] or [out, in, 1, 1]
    p = {"w": _T(w.reshape(w.shape[0], w.shape[1]))}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _bn(sd, prefix: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    params = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
    state = {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}
    return params, state


def _mha_packed(sd, prefix: str) -> Dict[str, Any]:
    """torch nn.MultiheadAttention -> our {qkv, proj}."""
    return {
        "qkv": {"w": _T(sd[f"{prefix}.in_proj_weight"]), "b": sd[f"{prefix}.in_proj_bias"]},
        "proj": _lin(sd, f"{prefix}.out_proj"),
    }


def _decoder_layer(sd, prefix: str) -> Dict[str, Any]:
    """torch nn.TransformerDecoderLayer -> generation.decoder_layer params."""
    return {
        "self_attn": _mha_packed(sd, f"{prefix}.self_attn"),
        "cross_attn": _mha_packed(sd, f"{prefix}.multihead_attn"),
        "linear1": _lin(sd, f"{prefix}.linear1"),
        "linear2": _lin(sd, f"{prefix}.linear2"),
        "norm1": _ln(sd, f"{prefix}.norm1"),
        "norm2": _ln(sd, f"{prefix}.norm2"),
        "norm3": _ln(sd, f"{prefix}.norm3"),
    }


def _host(x: torch.Tensor) -> np.ndarray:
    """A leaf as the JAX converter holds it: a C-ordered numpy array on the
    host, bf16 widened to fp32 (numpy has no bf16), other dtypes kept."""
    x = x.detach().cpu()
    return np.ascontiguousarray((x.float() if x.dtype == torch.bfloat16 else x).numpy())


def _pad_rows(table: torch.Tensor, head_w: torch.Tensor, head_b: Optional[torch.Tensor], n_new: int):
    """(table, head_w, head_b) with `n_new` rows (columns of head_w [D, V],
    entries of head_b) appended, each the mean of the existing ones. The
    means are the JAX converter's, bit for bit: np.mean on the host over the
    same layouts ([V, D] tables, the transposed view of the lm_head weight),
    in the source dtype (float16 means are float32 sums rounded to float16),
    bf16 widened to fp32 first. A bf16 leaf that gets rows comes out fp32,
    as JAX's does."""

    def grow(x: torch.Tensor, mean: np.ndarray, dim: int) -> torch.Tensor:
        m = torch.from_numpy(np.ascontiguousarray(mean)).to(x.device)
        x = x.to(m.dtype)
        return torch.cat([x, m.expand(*(n_new if d == dim else -1 for d in range(x.dim())))], dim)

    table = grow(table, _host(table).mean(axis=0, keepdims=True), 0)
    head_w = grow(head_w, _host(head_w.t()).T.mean(axis=1, keepdims=True), 1)
    if head_b is not None:
        b = _host(head_b)
        head_b = grow(head_b, np.full((1,), b.mean(), b.dtype), 0)
    return table, head_w, head_b


def convert_llama(sd, num_layers: int, prefix: str = "llm.", target_vocab: Optional[int] = None) -> Dict[str, Any]:
    """The reference's LlamaForCausalLM (wrapped as `self.llm`) -> the
    stacked llama tree. `target_vocab` pads the embedding and lm_head rows
    with their means, the reference's resize for <PAD>/<BOD>/<EOD> plus the
    pad to 64 (`_pad_rows`: JAX's means, bit for bit)."""

    def k(s):
        return f"{prefix}{s}"

    def stack(fmt: str) -> torch.Tensor:
        return torch.stack([sd[k(fmt.format(i=i))].t() for i in range(num_layers)])

    def stack_vec(fmt: str) -> torch.Tensor:
        return torch.stack([sd[k(fmt.format(i=i))] for i in range(num_layers)])

    embed_table = sd[k("model.embed_tokens.weight")]
    lm_head_w = _T(sd[k("lm_head.weight")])
    if target_vocab is not None and embed_table.shape[0] < target_vocab:
        embed_table, lm_head_w, _ = _pad_rows(embed_table, lm_head_w, None, target_vocab - embed_table.shape[0])

    return {
        "embed": {"table": embed_table},
        "layers": {
            "attn": {
                "q": {"w": stack("model.layers.{i}.self_attn.q_proj.weight")},
                "k": {"w": stack("model.layers.{i}.self_attn.k_proj.weight")},
                "v": {"w": stack("model.layers.{i}.self_attn.v_proj.weight")},
                "o": {"w": stack("model.layers.{i}.self_attn.o_proj.weight")},
            },
            "mlp": {
                "gate": {"w": stack("model.layers.{i}.mlp.gate_proj.weight")},
                "up": {"w": stack("model.layers.{i}.mlp.up_proj.weight")},
                "down": {"w": stack("model.layers.{i}.mlp.down_proj.weight")},
            },
            "input_ln": {"scale": stack_vec("model.layers.{i}.input_layernorm.weight")},
            "post_ln": {"scale": stack_vec("model.layers.{i}.post_attention_layernorm.weight")},
        },
        "final_ln": {"scale": sd[k("model.norm.weight")]},
        "lm_head": {"w": lm_head_w},
    }


def convert_mistral(sd, num_layers: int, prefix: str = "llm.", target_vocab: Optional[int] = None) -> Dict[str, Any]:
    """HF MistralForCausalLM -> the stacked llama tree. Mistral shares
    Llama-2's key layout; only the shapes differ (GQA: k and v project to
    num_kv_heads * head_dim)."""
    return convert_llama(sd, num_layers, prefix=prefix, target_vocab=target_vocab)


def convert_phi(sd, num_layers: int, prefix: str = "llm.", target_vocab: Optional[int] = None) -> Dict[str, Any]:
    """HF PhiForCausalLM (the reference wraps it as `self.llm`) -> the
    stacked phi tree, with convert_llama's mean padding of the vocabulary
    (the lm_head bias too)."""
    from mla_tpu_torch.models.phi import convert_hf_phi

    params = convert_hf_phi(sd, num_layers, prefix=prefix)
    table, head = params["embed"]["table"], params["lm_head"]
    if target_vocab is not None and table.shape[0] < target_vocab:
        params["embed"]["table"], head["w"], head["b"] = _pad_rows(table, head["w"], head["b"],
                                                                   target_vocab - table.shape[0])
    return params


def convert_contrastive(sd, prefix: str = "llm.") -> Dict[str, Any]:
    """The contrastive projection heads grafted onto the reference's llama
    -> models/contrastive.py params."""

    def head(p):
        return {"fc1": _lin(sd, f"{p}.0"), "fc2": _lin(sd, f"{p}.2")}

    out: Dict[str, Any] = {}
    coord = f"{prefix}coordinate_aware_contrastive_loss_module"
    if f"{coord}.image_projection_head.0.weight" in sd:
        out["coord"] = {
            "image_head": head(f"{coord}.image_projection_head"),
            "pointcloud_head": head(f"{coord}.pointcloud_projection_head"),
        }
    tac = f"{prefix}tactile_contrastive_loss_module"
    if f"{tac}.tactile_projection_head.0.weight" in sd:
        out["tactile"] = {
            "tactile_head": head(f"{tac}.tactile_projection_head"),
            "pointcloud_head": head(f"{tac}.pointcloud_projection_head"),
            "image_head": head(f"{tac}.image_projection_head"),
        }
    return out


def convert_vision_tokenizer(sd) -> Dict[str, Any]:
    """The reference's VisionTokenizer state dict -> vision_tokenizer params."""

    def attn_block(p):
        return {
            "q_ln": _ln(sd, f"{p}.q.0"),
            "q": _lin(sd, f"{p}.q.1", bias=False),
            "kv_ln": _ln(sd, f"{p}.kv.0"),
            "kv": _lin(sd, f"{p}.kv.1", bias=False),
            "proj": _lin(sd, f"{p}.proj"),
        }

    pw = sd["patch_embedding.weight"]  # [C, 3, 14, 14]
    return {
        "patch_embedding": {"w": _T(pw.reshape(pw.shape[0], -1))},  # (3, kh, kw) flattened, our patchify
        "class_embedding": sd["class_embedding"],
        "split_embedding": sd["split_embedding"],
        "local_attention": attn_block("local_attention"),
        "global_attention": attn_block("global_attention"),
    }


def convert_point_tokenizer(sd, num_stages: int = 2, lga_blocks=(2, 1)) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The reference's PointTokenizer (Point-PN) -> (params, state)."""
    raw_p: Dict[str, Any] = {"conv": _conv1x1(sd, "patch_embed.EncP.raw_point_embed.net.0")}
    raw_p["bn"], bn_s = _bn(sd, "patch_embed.EncP.raw_point_embed.net.1")
    stages_p, stages_s = [], []
    for si in range(num_stages):
        blocks_p, blocks_s = [], []
        for bi in range(lga_blocks[si]):
            base = f"patch_embed.EncP.LGA_list.{si}.linear2.{bi}"
            n1_bn_p, n1_bn_s = _bn(sd, f"{base}.net1.1")
            n2_bn_p, n2_bn_s = _bn(sd, f"{base}.net2.1")
            blocks_p.append({"net1": {"conv": _conv1x1(sd, f"{base}.net1.0"), "bn": n1_bn_p},
                             "net2": {"conv": _conv1x1(sd, f"{base}.net2.0"), "bn": n2_bn_p}})
            blocks_s.append({"net1": {"bn": n1_bn_s}, "net2": {"bn": n2_bn_s}})
        stages_p.append({"blocks": blocks_p})
        stages_s.append({"blocks": blocks_s})
    params = {
        "raw_embed": raw_p,
        "stages": stages_p,
        "proj": _lin(sd, "proj"),
        "cls_token": sd["cls_token"],
        "pos_embed": sd["pos_embed"],
        "norm": _ln(sd, "norm"),
    }
    return params, {"raw_embed": {"bn": bn_s}, "stages": stages_s}


def convert_mlp_gelu(sd, depth: int = 2, prefix: str = "mlp") -> Dict[str, Any]:
    """MLP_GELU projector: Sequential indices 0, 2, 4, ... are the Linears."""
    return {"layers": [_lin(sd, f"{prefix}.{2 * i}") for i in range(depth)]}


def convert_mlp_projector(sd, prefix: str = "projector") -> Dict[str, Any]:
    """MLPProjector gelu-mlp."""
    return {"fc1": _lin(sd, f"{prefix}.0"), "fc2": _lin(sd, f"{prefix}.2")}


def convert_action_embedder(sd, prefix: str = "mlp") -> Dict[str, Any]:
    """ActionEmbedder (a timm Mlp): proprio, x and tactile embedders."""
    return {"fc1": _lin(sd, f"{prefix}.fc1"), "fc2": _lin(sd, f"{prefix}.fc2")}


def convert_timestep_embedder(sd, prefix: str = "mlp") -> Dict[str, Any]:
    return {"fc1": _lin(sd, f"{prefix}.0"), "fc2": _lin(sd, f"{prefix}.2")}


def convert_final_layer(sd) -> Dict[str, Any]:
    return {
        "norm": {"scale": sd["norm_final.weight"]},
        "mlp": {"fc1": _lin(sd, "mlp.fc1"), "fc2": _lin(sd, "mlp.fc2")},
    }


def convert_generation_manager(sd, gen_cfg) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """MultimodalGenerationManager: the image, point-cloud and tactile heads
    the generation config turns on -> (params, state)."""
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    if gen_cfg.use_image:
        p = "image_gen_module"
        params["image_gen_module"] = {
            "image_gen_queries": sd[f"{p}.image_gen_queries"],
            "mae_mask_token": sd[f"{p}.mae_mask_token"],
            "mae_pos_embed": sd[f"{p}.mae_pos_embed"],
            "intent_decoder": [_decoder_layer(sd, f"{p}.intent_decoder.layers.{i}") for i in range(2)],
            "mae_decoder": [_decoder_layer(sd, f"{p}.mae_decoder.layers.{i}")
                            for i in range(gen_cfg.image.decoder_layers)],
            "mae_patch_norm": _ln(sd, f"{p}.mae_patch_norm"),
            "mae_delta_head": _lin(sd, f"{p}.mae_delta_head"),
            "mae_alpha_head": _lin(sd, f"{p}.mae_alpha_head"),
            "mae_offset_head": _lin(sd, f"{p}.mae_offset_head"),
        }
    if gen_cfg.use_pointcloud:
        p = "pointcloud_gen_module"
        blocks = []
        for i in range(gen_cfg.point.decoder_layers):
            b = f"{p}.decoder_blocks.{i}"
            blocks.append({
                "attn": _mha_packed(sd, f"{b}.attn"),
                "norm1": _ln(sd, f"{b}.norm1"),
                "norm2": _ln(sd, f"{b}.norm2"),
                "fc1": _lin(sd, f"{b}.mlp.0"),
                "fc2": _lin(sd, f"{b}.mlp.3"),
            })
        bn_p, bn_s = _bn(sd, f"{p}.future_predictor.1")
        params["pointcloud_gen_module"] = {
            "feature_projector": _lin(sd, f"{p}.feature_projector"),
            "seq_to_patch": _lin(sd, f"{p}.seq_to_patch"),
            "pos_embed": sd[f"{p}.pos_embed"],
            "blocks": blocks,
            "pred_conv1": _conv1x1(sd, f"{p}.future_predictor.0"),
            "pred_bn": bn_p,
            "pred_conv2": _conv1x1(sd, f"{p}.future_predictor.3"),
        }
        state["pointcloud_gen_module"] = {"pred_bn": bn_s}
    if gen_cfg.use_tactile:
        p = "tactile_gen_module"
        params["tactile_gen_module"] = {
            "feature_projector": _lin(sd, f"{p}.feature_projector"),
            "tactile_query": sd[f"{p}.tactile_query"],
            "decoder": [_decoder_layer(sd, f"{p}.decoder.layers.{i}") for i in range(gen_cfg.tactile.decoder_layers)],
            "output_head": _lin(sd, f"{p}.output_head"),
        }
    return params, state


# the module groups of a reference checkpoint, each read by one converter
_SIMPLE_GROUPS = {
    "vision_tower_2d": convert_vision_tokenizer,
    "projector_2d": convert_mlp_gelu,
    "projector_3d": convert_mlp_projector,
    "proprio_embedder": convert_action_embedder,
    "x_embedder": convert_action_embedder,
    "t_embedder": convert_timestep_embedder,
    "tactile_embedder": convert_action_embedder,
    "final_layer": convert_final_layer,
}


def load_reference_checkpoint(
    ckpt_path, cfg, *, base_params: Optional[Dict[str, Any]] = None,
    base_state: Optional[Dict[str, Any]] = None, device="cpu",
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read a reference `.pt` checkpoint (module-keyed) into (params, state)
    trees on `device`. Module groups the checkpoint lacks come from
    `base_params` / `base_state` (the reference's permissive loading). The
    base dicts are updated in place and returned: a group the checkpoint
    holds replaces the base's, which is dropped before the group is read,
    so the device holds one copy of each group at a time. The file is read
    with weights_only=True and mmap: it must hold tensors only (JAX's
    export_reference_pt and the port's write those); a file with other
    Python objects is refused by torch."""
    blob = torch.load(ckpt_path, map_location="cpu", mmap=True, weights_only=True)
    model = blob["model"] if "model" in blob else blob
    # strip the reference's "vlm." prefix variance
    model = {(k[4:] if k.startswith("vlm.") else k): v for k, v in model.items()}

    params = base_params if base_params is not None else {}
    state = base_state if base_state is not None else {}

    def group(name):
        params.pop(name, None)
        return _OnDevice(model[name], device)

    if "llm_backbone" in model:
        sd = group("llm_backbone")
        params["llm_backbone"] = convert_llama(sd, cfg.llama.num_layers)
        contr = convert_contrastive(sd)
        if contr and cfg.use_contrastive:
            params["contrastive"] = {**params.get("contrastive", {}), **contr}
    for name, convert in _SIMPLE_GROUPS.items():
        if name in model:
            params[name] = convert(group(name))
    if "vision_tower_3d" in model:
        params["vision_tower_3d"], state["vision_tower_3d"] = convert_point_tokenizer(
            group("vision_tower_3d"), cfg.point.num_stages, cfg.point.lga_blocks)
    if "generation_manager" in model and cfg.use_generation:
        p, s = convert_generation_manager(group("generation_manager"), cfg.gen)
        params["generation_manager"] = p
        if s:
            state["generation_manager"] = s
    if cfg.use_diff and "z_embedder" not in params:
        # the reference's `uncondition` is a plain zeros tensor, not in its
        # state dict; recreate it
        params["z_embedder"] = {"uncondition": torch.zeros((1, cfg.token_size), device=device)}
    return params, state


# --------------------------------------------------------------------------- #
# Hugging Face checkpoint directories
# --------------------------------------------------------------------------- #


class LazyStateDict(Mapping):
    """A state dict whose tensors are read when asked for: each value comes
    from a loader, called on every access (a safetensors tensor over the
    mapped file costs nothing until touched). `bytes_read` counts the
    bytes of the tensors handed out, shared with the views `renamed`
    makes."""

    def __init__(self, loaders: Dict[str, Callable[[], torch.Tensor]], _count: Optional[list] = None) -> None:
        self._loaders = loaders
        self._count = _count if _count is not None else [0]

    @property
    def bytes_read(self) -> int:
        return self._count[0]

    def __getitem__(self, key: str) -> torch.Tensor:
        t = self._loaders[key]()
        self._count[0] += t.numel() * t.element_size()
        return t

    def __contains__(self, key) -> bool:
        return key in self._loaders

    def __iter__(self):
        return iter(self._loaders)

    def __len__(self) -> int:
        return len(self._loaders)

    def renamed(self, names: Dict[str, str]) -> "LazyStateDict":
        """A view holding names[new] = old for each pair."""
        return LazyStateDict({new: self._loaders[old] for new, old in names.items()}, self._count)


def merge_hf_shards(model_dir, bin_globs=("*.bin", "*.pt")) -> LazyStateDict:
    """An HF-style checkpoint directory as one flat state dict: its
    *.safetensors shards in sorted order when there are any (read with
    models/safetensors_io, no index file needed), else the torch-pickled
    shards matching `bin_globs`, in order (mapped, weights only). A key in
    a later shard replaces an earlier one, as JAX's dict update does. The
    tensors are read lazily and come back in their file's dtype, so a
    caller that converts 8 of 32 layers reads 8."""
    from mla_tpu_torch.models.safetensors_io import SafetensorsFile

    model_dir = Path(model_dir)
    loaders: Dict[str, Callable[[], torch.Tensor]] = {}
    st_files = sorted(model_dir.glob("*.safetensors"))
    if st_files:
        for path in st_files:
            f = SafetensorsFile(path)
            loaders.update({key: (lambda f=f, key=key: f.get_tensor(key)) for key in f.keys()})
    else:
        for pat in bin_globs:
            for path in sorted(model_dir.glob(pat)):
                sd = torch.load(str(path), map_location="cpu", mmap=True, weights_only=True)
                loaders.update({key: (lambda t=t: t) for key, t in sd.items()})
    return LazyStateDict(loaders)


def load_hf_llama(model_dir, cfg, device="cpu") -> Dict[str, Any]:
    """An HF Llama checkpoint directory (safetensors or pytorch_model*.bin)
    -> the stacked llama tree on `device`, in the files' dtype, the
    vocabulary padded to cfg.llama.vocab_size with the mean rows."""
    sd = merge_hf_shards(model_dir, bin_globs=("pytorch_model*.bin",))
    return convert_llama(_OnDevice(sd, device), cfg.llama.num_layers, prefix="", target_vocab=cfg.llama.vocab_size)


# --------------------------------------------------------------------------- #
# export: our trees -> reference-format state dicts
# --------------------------------------------------------------------------- #


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


def export_llama(params: Dict[str, Any], prefix: str = "llm.", dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Inverse of convert_llama (scan-stacked -> per-layer HF keys): fp32
    numpy arrays, or with `dtype` CPU tensors of that dtype, each transposed
    on its leaf's device (a bf16 decoder then leaves the card without an
    fp32 copy; numpy has no bf16)."""
    if dtype is None:
        leaf, leaf_t = _np, lambda x: _np(x).T
    else:
        def leaf(x):
            return x.detach().to(dtype).cpu()

        def leaf_t(x):
            return x.detach().to(dtype).t().contiguous().cpu()
    out: Dict[str, Any] = {}
    out[f"{prefix}model.embed_tokens.weight"] = leaf(params["embed"]["table"])
    lp = params["layers"]
    L = lp["input_ln"]["scale"].shape[0]
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
            out[f"{prefix}model.layers.{i}.{name}.weight"] = leaf_t(w[i])
        out[f"{prefix}model.layers.{i}.input_layernorm.weight"] = leaf(lp["input_ln"]["scale"][i])
        out[f"{prefix}model.layers.{i}.post_attention_layernorm.weight"] = leaf(lp["post_ln"]["scale"][i])
    out[f"{prefix}model.norm.weight"] = leaf(params["final_ln"]["scale"])
    out[f"{prefix}lm_head.weight"] = leaf_t(params["lm_head"]["w"])
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


def export_reference_checkpoint(params: Dict[str, Any], state: Dict[str, Any], cfg,
                                llm_dtype: Optional[torch.dtype] = None) -> Dict[str, Dict[str, Any]]:
    """Our (params, state) -> the reference's module-keyed {"model": {...}}
    payload (fp32 numpy values; the caller torch.save's it), the inverse of
    load_reference_checkpoint for the module groups we own. llm_dtype
    writes the decoder's leaves as tensors of that dtype (export_llama)."""
    model: Dict[str, Dict[str, Any]] = {}
    llm = export_llama(params["llm_backbone"], dtype=llm_dtype)
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
