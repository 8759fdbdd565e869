"""Parameter trees: the bridge from JAX and a seeded random init.

Trees are nested dicts (and lists) of tensors in the JAX package's layout,
so a JAX param/state pytree with numpy leaves carries across leaf for leaf
(`from_jax`). `init` builds the modules of an MLA model that the ported
paths run (with the decoder of its llm_family, llama or phi) (serving, the diffusion training step and the post-training
heads) with the JAX init's distributions, directly on the target device
from a torch.Generator, so a full-width 7B never passes through the host.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any, Dict, List, Tuple

import numpy as np
import torch

if TYPE_CHECKING:  # the model modules import this one (quantization uses tree_to)
    from mla_tpu_torch.models.prismatic import MLAModelConfig


def _leaf_from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def from_jax(tree, device=None):
    """JAX pytree (dicts/lists/tuples of numpy or jax arrays) -> the same tree
    of tensors, dtypes kept (bf16 through a uint16 view)."""
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax(v, device) for v in tree)
    t = _leaf_from_numpy(tree)
    return t.to(device) if device is not None else t


def tp_local(tree, mesh):
    """This rank's own tree over the tp axis of `mesh` (parallel/mesh.Mesh),
    and the TP_RULES keys whose leaves it holds in part: each leaf that
    JAX's rules split (parallel/sharding.tp_dim) becomes a contiguous copy
    of its slice mesh.tp_rank, the other leaves are kept whole, on the
    leaves' device. The layers read the keys from the tp group's block
    (parallel/tensor.tp_group); the caller frees the whole tree."""
    from mla_tpu_torch.parallel.sharding import tp_dim, tp_part, tp_rule

    tp, tp_rank = mesh.tp, mesh.tp_rank
    split = set()

    def part(path, leaf):
        d = tp_dim(path, tuple(leaf.shape), tp)
        if d is None:
            return leaf
        split.add(tp_rule(path))
        return tp_part(leaf, d, tp_rank, tp).clone(memory_format=torch.contiguous_format)

    def walk(t, prefix):
        if isinstance(t, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, f"{prefix}{n}/") for n, v in enumerate(t))
        return part(prefix[:-1], t)

    return walk(tree, ""), frozenset(split)


def tree_map(fn, tree):
    """The same tree with fn applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_to(tree, device):
    """Move every tensor leaf of a tree to `device`."""
    return tree_map(lambda t: t.to(device), tree)


class _Init:
    """Draws from one torch.Generator on one device."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def normal(self, shape, std=0.02, dtype=torch.float32):
        return torch.randn(shape, generator=self.gen, dtype=dtype, device=self.device).mul_(std)

    def uniform(self, shape, bound, dtype=torch.float32):
        u = torch.rand(shape, generator=self.gen, dtype=dtype, device=self.device)
        return u.mul_(2 * bound).sub_(bound)

    def trunc_normal(self, shape, std=0.02):
        """Normal truncated at +-2 std (timm's trunc_normal_), by inverting
        the normal CDF on the uniform draws between the cut points."""
        lo, hi = (0.5 * (1 + math.erf(c / math.sqrt(2))) for c in (-2.0, 2.0))
        u = torch.rand(shape, generator=self.gen, device=self.device).mul_(hi - lo).add_(lo)
        return torch.erfinv(u.mul_(2).sub_(1)).mul_(math.sqrt(2) * std).clamp_(-2 * std, 2 * std)

    def zeros(self, shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def ones(self, shape, dtype=torch.float32):
        return torch.ones(shape, dtype=dtype, device=self.device)

    def linear(self, i, o, bias=True, w_init="xavier", std=0.02):
        if w_init == "xavier":
            w = self.uniform((i, o), math.sqrt(6.0 / (i + o)))
        elif w_init == "normal":
            w = self.normal((i, o), std)
        elif w_init == "trunc_normal":
            w = self.trunc_normal((i, o), std)
        elif w_init == "torch":
            w = self.uniform((i, o), 1.0 / math.sqrt(i))
        else:
            raise ValueError(f"unknown w_init {w_init!r}")
        return {"w": w, "b": self.zeros((o,))} if bias else {"w": w}

    def norm(self, dim):
        return {"scale": self.ones((dim,)), "bias": self.zeros((dim,))}

    def mlp(self, i, h, o, w_init="xavier"):
        return {"fc1": self.linear(i, h, w_init=w_init), "fc2": self.linear(h, o, w_init=w_init)}


def _llama(it: _Init, cfg) -> Dict[str, Any]:
    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    kvd = cfg.num_kv_heads * cfg.head_dim
    dt = cfg.param_dtype

    def stacked(shape):
        return {"w": it.normal((L,) + shape, 0.02, dt)}

    return {
        "embed": {"table": it.normal((cfg.vocab_size, D), 0.02, dt)},
        "layers": {
            "attn": {"q": stacked((D, D)), "k": stacked((D, kvd)), "v": stacked((D, kvd)), "o": stacked((D, D))},
            "mlp": {"gate": stacked((D, I)), "up": stacked((D, I)), "down": stacked((I, D))},
            "input_ln": {"scale": it.ones((L, D), dt)},
            "post_ln": {"scale": it.ones((L, D), dt)},
        },
        "final_ln": {"scale": it.ones((D,), dt)},
        "lm_head": {"w": it.normal((D, cfg.vocab_size), 0.02, dt)},
    }


def _phi(it: _Init, cfg) -> Dict[str, Any]:
    """JAX phi_init: normal(0.02) weights, zero biases, LayerNorms of scale
    one and bias zero, a biased lm_head."""
    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    dt = cfg.param_dtype

    def stacked(shape):
        return {"w": it.normal((L,) + shape, 0.02, dt), "b": it.zeros((L, shape[-1]), dt)}

    return {
        "embed": {"table": it.normal((cfg.vocab_size, D), 0.02, dt)},
        "layers": {
            "attn": {"q": stacked((D, D)), "k": stacked((D, D)), "v": stacked((D, D)), "o": stacked((D, D))},
            "mlp": {"fc1": stacked((D, I)), "fc2": stacked((I, D))},
            "ln": {"scale": it.ones((L, D), dt), "bias": it.zeros((L, D), dt)},
        },
        "final_ln": {"scale": it.ones((D,), dt), "bias": it.zeros((D,), dt)},
        "lm_head": {"w": it.normal((D, cfg.vocab_size), 0.02, dt), "b": it.zeros((cfg.vocab_size,), dt)},
    }


DECODER_INIT = {"llama": _llama, "phi": _phi}


def _vision(it: _Init, cfg) -> Dict[str, Any]:
    C = cfg.hidden_dim

    def attn_block():
        return {
            "q_ln": it.norm(C), "q": it.linear(C, C, bias=False),
            "kv_ln": it.norm(C), "kv": it.linear(C, 2 * C, bias=False),
            "proj": it.linear(C, C),
        }

    return {
        "patch_embedding": it.linear(3 * cfg.patch_stride**2, C, bias=False, w_init="torch"),
        "class_embedding": it.normal((C,), 1.0),
        "split_embedding": it.normal((C,), 1.0),
        "local_attention": attn_block(),
        "global_attention": attn_block(),
    }


def _point(it: _Init, cfg) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    def conv_bn(i, o, bias=True):
        bn_state = {"bn": {"mean": it.zeros((o,)), "var": it.ones((o,))}}
        return {"conv": it.linear(i, o, bias=bias, w_init="torch"), "bn": it.norm(o)}, bn_state

    raw_p, raw_s = conv_bn(3, cfg.embed_dim, bias=False)
    stages_p, stages_s = [], []
    for si in range(cfg.num_stages):
        dim = cfg.stage_dims[si]
        bp, bs = [], []
        for _ in range(cfg.lga_blocks[si]):
            p1, s1 = conv_bn(dim, dim // 2)
            p2, s2 = conv_bn(dim // 2, dim)
            bp.append({"net1": p1, "net2": p2})
            bs.append({"net1": s1, "net2": s2})
        stages_p.append({"blocks": bp})
        stages_s.append({"blocks": bs})
    params = {
        "raw_embed": raw_p,
        "stages": stages_p,
        "proj": it.linear(cfg.encoder_out_dim, cfg.out_dim),
        "cls_token": it.normal((1, 1, cfg.out_dim), 0.02),
        "pos_embed": it.zeros((1, cfg.num_tokens + 1, cfg.out_dim)),
        "norm": it.norm(cfg.out_dim),
    }
    return params, {"raw_embed": raw_s, "stages": stages_s}


def _mha(it: _Init, dim: int) -> Dict[str, Any]:
    return {"qkv": it.linear(dim, 3 * dim), "proj": it.linear(dim, dim)}


def _decoder(it: _Init, num_layers: int, d: int, ffn: int) -> List[Dict[str, Any]]:
    """Post-norm decoder layers (generation.decoder_layer)."""
    return [{
        "self_attn": _mha(it, d), "cross_attn": _mha(it, d),
        "linear1": it.linear(d, ffn, w_init="torch"), "linear2": it.linear(ffn, d, w_init="torch"),
        "norm1": it.norm(d), "norm2": it.norm(d), "norm3": it.norm(d),
    } for _ in range(num_layers)]


def _generation(it: _Init, cfg) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The generation heads' params and state (JAX generation_manager_init)."""
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    if cfg.use_image:
        c, D = cfg.image, cfg.image.token_size
        alpha = it.linear(D, 1, w_init="normal")
        alpha["b"].fill_(-3.0)  # prefer copying the current patch at first
        params["image_gen_module"] = {
            "image_gen_queries": it.normal((1, c.num_gen_queries, D)),
            "mae_mask_token": it.normal((1, 1, D)),
            "mae_pos_embed": it.normal((1, c.num_patches, D)),
            "intent_decoder": _decoder(it, 2, D, 2 * D),
            "mae_decoder": _decoder(it, c.decoder_layers, D, 4 * D),
            "mae_patch_norm": it.norm(D),
            "mae_delta_head": it.linear(D, c.patch_dim, w_init="normal"),
            "mae_alpha_head": alpha,
            "mae_offset_head": it.linear(D, 2, w_init="normal", std=0.001),
        }
    if cfg.use_pointcloud:
        c, t = cfg.point, cfg.point.trans_dim
        params["pointcloud_gen_module"] = {
            "feature_projector": it.linear(c.token_size, t, w_init="trunc_normal"),
            "seq_to_patch": it.linear(t, c.num_groups * t, w_init="trunc_normal"),
            "pos_embed": it.trunc_normal((1, c.num_groups, t)),
            "blocks": [{"attn": _mha(it, t), "norm1": it.norm(t), "norm2": it.norm(t),
                        "fc1": it.linear(t, 4 * t, w_init="trunc_normal"),
                        "fc2": it.linear(4 * t, t, w_init="trunc_normal")} for _ in range(c.decoder_layers)],
            "pred_conv1": it.linear(t, t, w_init="torch"),
            "pred_bn": it.norm(t),
            "pred_conv2": it.linear(t, 3 * c.group_size, w_init="torch"),
        }
        state["pointcloud_gen_module"] = {"pred_bn": {"mean": it.zeros((t,)), "var": it.ones((t,))}}
    if cfg.use_tactile:
        c, D = cfg.tactile, cfg.tactile.token_size
        params["tactile_gen_module"] = {
            "feature_projector": it.linear(D, D, w_init="torch"),
            "tactile_query": it.normal((1, 1, D)),
            "decoder": _decoder(it, c.decoder_layers, D, 2 * D),
            "output_head": it.linear(D, c.tactile_dim, w_init="torch"),
        }
    return params, state


def tree_leaves(tree):
    """The tensor leaves of a tree, in a fixed order."""
    if isinstance(tree, dict):
        return [l for k in tree for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_items(tree, prefix: str = ""):
    """(path, leaf) pairs of a tree, paths as 'a/b/0/c'."""
    if isinstance(tree, dict):
        return [i for k, v in tree.items() for i in tree_items(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [i for n, v in enumerate(tree) for i in tree_items(v, f"{prefix}{n}/")]
    return [(prefix[:-1], tree)]


def init(cfg: MLAModelConfig, seed: int = 0, device="cuda") -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, state) of `cfg`, drawn on `device` with the JAX init's
    distributions (the values differ from JAX's: the generators differ). The
    final layer's fc2 is zero, as in the reference. The leaves do not require
    grad; training.optim.make_optimizer sets requires_grad per leaf."""
    it = _Init(seed, device)
    D = cfg.token_size
    params: Dict[str, Any] = {
        "llm_backbone": DECODER_INIT[cfg.llm_family](it, cfg.llama),
        "vision_tower_2d": _vision(it, cfg.vision),
        "projector_2d": {"layers": [it.linear(cfg.image_hidden_dim, D), it.linear(D, D)]},
        "proprio_embedder": it.mlp(cfg.action_dim, D, D, w_init="normal"),
    }
    state: Dict[str, Any] = {}
    if cfg.use_pointcloud:
        params["vision_tower_3d"], state["vision_tower_3d"] = _point(it, cfg.point)
        params["projector_3d"] = it.mlp(cfg.point_token_dim, D, D)
    if cfg.use_tactile:
        params["tactile_embedder"] = it.mlp(cfg.tactile_dim, D, D, w_init="normal")
    if cfg.use_diff:
        params["x_embedder"] = it.mlp(cfg.action_dim, D, D, w_init="normal")
        params["t_embedder"] = {"fc1": it.linear(256, D, w_init="normal"), "fc2": it.linear(D, D, w_init="normal")}
        params["z_embedder"] = {"uncondition": it.zeros((1, D))}
        final = {"norm": {"scale": it.ones((D,))}, "mlp": it.mlp(D, D, cfg.action_dim)}
        final["mlp"]["fc2"]["w"].zero_()
        params["final_layer"] = final
    if cfg.use_contrastive:
        # drawn last, so the serving modules' draws do not depend on it
        def head():
            return {"fc1": it.linear(D, D), "fc2": it.linear(D, 256)}

        params["contrastive"] = {"coord": {"image_head": head(), "pointcloud_head": head()}}
        if cfg.use_tactile:
            params["contrastive"]["tactile"] = {
                "tactile_head": head(), "pointcloud_head": head(), "image_head": head(),
            }
    if cfg.use_generation:
        params["generation_manager"], state["generation_manager"] = _generation(it, cfg.gen)
    return params, state
