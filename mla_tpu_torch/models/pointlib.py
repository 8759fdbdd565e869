"""OpenPoints-style point-cloud layer library.

Counterpart of mla_tpu/models/pointlib.py, the library surface beside the
Point-PN tokenizer that the model runs: the config registry, neighbourhood
features, batched k-means (its start from FPS, so the FPS kernel on a CUDA
tensor) and KMeansEmbed, dilated kNN and the graph convolutions, 3-NN
feature propagation, stochastic depth, the PEFT adapter and the multi-view
depth projection. Parameters are dicts of tensors in the JAX layout; an
`*_init` takes a seed (and a device) where JAX takes a key, and its draws
follow JAX's distributions, not its values. Random masks draw from a
`torch.Generator`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mla_tpu_torch import nn
from mla_tpu_torch.ops import pointops
from mla_tpu_torch.params import _Init

Params = Dict[str, Any]


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #


class Registry:
    """Name -> builder registry driven by config dicts with a NAME key."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._builders: Dict[str, Callable] = {}

    def register(self, fn: Optional[Callable] = None, *, name: Optional[str] = None):
        def deco(f):
            key = name or f.__name__
            if key in self._builders:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._builders[key] = f
            return f

        return deco(fn) if fn is not None else deco

    def get(self, name: str) -> Callable:
        if name not in self._builders:
            raise KeyError(f"{name!r} not in registry {self.name}; have {sorted(self._builders)}")
        return self._builders[name]

    def build(self, cfg: Dict[str, Any], **kwargs):
        """cfg = {"NAME": <registered name>, ...builder kwargs}."""
        cfg = dict(cfg)
        name = cfg.pop("NAME")
        return self.get(name)(**cfg, **kwargs)

    def __contains__(self, name: str) -> bool:
        return name in self._builders

    def keys(self):
        return sorted(self._builders)


MODELS = Registry("models")


def build_from_cfg(cfg: Dict[str, Any], registry: Registry = MODELS, **kwargs):
    return registry.build(cfg, **kwargs)


@MODELS.register(name="Point_PN")
def _build_point_pn(**cfg_kwargs):
    """(cfg, init, apply) of a Point_PN config; init(seed=0, device="cpu")
    returns (params, state)."""
    from mla_tpu_torch.models import point_tokenizer as pt
    from mla_tpu_torch.params import _point

    cfg = pt.PointTokenizerConfig(**cfg_kwargs)
    return cfg, (lambda seed=0, device="cpu": _point(_Init(seed, device), cfg)), pt.point_tokenizer


@MODELS.register(name="KMeansEmbed")
def _build_kmeans_embed(in_chans: int = 3, num_groups: int = 256, encoder_dim: int = 256, feature_type: str = "dp"):
    def init(seed=0, device="cpu"):
        return kmeans_embed_init(seed, in_chans, encoder_dim, feature_type, device=device)

    def apply(p, xyz):
        return kmeans_embed(p, xyz, num_groups=num_groups, feature_type=feature_type)

    return init, apply


# --------------------------------------------------------------------------- #
# Neighbourhood features
# --------------------------------------------------------------------------- #

CHANNEL_MAP: Dict[str, Callable[[int], int]] = {
    "fj": lambda x: x,
    "df": lambda x: x,
    "assa": lambda x: x * 3,
    "assa_dp": lambda x: x * 3 + 3,
    "dp_fj": lambda x: 3 + x,
    "pj": lambda x: x,
    "dp": lambda x: 3,
    "pi_dp": lambda x: x + 3,
    "pj_dp": lambda x: x + 3,
    "dp_fj_df": lambda x: x * 2 + 3,
    "dp_fi_df": lambda x: x * 2 + 3,
    "pi_dp_fj_df": lambda x: x * 2 + 6,
    "pj_dp_fj_df": lambda x: x * 2 + 6,
    "pj_dp_df": lambda x: x + 6,
    "dp_df": lambda x: x + 3,
}


def neighborhood_features(feature_type: str, p_j: torch.Tensor, p_i: torch.Tensor, f_j: Optional[torch.Tensor] = None,
                          f_i: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped features per CHANNEL_MAP key: p_j [B, N, K, 3] neighbour and
    p_i [B, N, 1, 3] center coordinates, f_j / f_i their features ('dp' =
    relative coordinates, 'pj_dp' = absolute and relative, 'dp_fj_df' =
    relative coordinates, neighbour features and feature deltas, ...)."""
    dp = p_j - p_i
    parts = {
        "dp": lambda: [dp],
        "pj": lambda: [p_j],
        "fj": lambda: [f_j],
        "df": lambda: [f_j - f_i],
        "pj_dp": lambda: [p_j, dp],
        "pi_dp": lambda: [p_i.expand_as(p_j), dp],
        "dp_fj": lambda: [dp, f_j],
        "dp_df": lambda: [dp, f_j - f_i],
        "dp_fj_df": lambda: [dp, f_j, f_j - f_i],
        "dp_fi_df": lambda: [dp, f_i.expand_as(f_j), f_j - f_i],
        "pj_dp_df": lambda: [p_j, dp, f_j - f_i],
        "pi_dp_fj_df": lambda: [p_i.expand_as(p_j), dp, f_j, f_j - f_i],
        "pj_dp_fj_df": lambda: [p_j, dp, f_j, f_j - f_i],
    }
    if feature_type not in parts:
        raise ValueError(f"unknown feature_type {feature_type!r}")
    return torch.cat(parts[feature_type](), dim=-1)


# --------------------------------------------------------------------------- #
# Batched k-means and KMeansEmbed
# --------------------------------------------------------------------------- #


def kmeans(xyz: torch.Tensor, num_clusters: int, num_iters: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Lloyd iterations from an FPS start (point 0 first): xyz [B,
    N, D] -> (centroids [B, K, D], labels [B, N] int64). Segment means by
    one-hot products; an empty cluster keeps its centroid."""
    cent = pointops.index_points(xyz, pointops.furthest_point_sample(xyz[..., :3], num_clusters).long())
    for _ in range(num_iters):
        labels = pointops.square_distance(xyz, cent).argmin(-1)
        onehot = torch.nn.functional.one_hot(labels, num_clusters).to(xyz.dtype)
        counts = onehot.sum(1)
        new = torch.einsum("bnk,bnd->bkd", onehot, xyz) / counts.clamp_min(1.0)[..., None]
        cent = torch.where(counts[..., None] > 0, new, cent)
    return cent, pointops.square_distance(xyz, cent).argmin(-1)


def kmeans_embed_init(seed: int = 0, in_chans: int = 3, encoder_dim: int = 256, feature_type: str = "dp",
                      device="cpu") -> Params:
    """KMeansEmbed: a per-point MLP, max-pooled per cluster, pooled back and
    concatenated, a second MLP, max-pooled per cluster."""
    it = _Init(seed, device)
    channels = CHANNEL_MAP[feature_type](in_chans)
    return {
        "conv1": {"fc1": it.linear(channels, 128), "ln": it.norm(128), "fc2": it.linear(128, 256)},
        "conv2": {"fc1": it.linear(512, 512), "ln": it.norm(512), "fc2": it.linear(512, encoder_dim)},
    }


def segment_max(values: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """values [B, N, C] max-reduced by label into [B, k, C]; an empty
    segment is 0 (torch_scatter's reduce='max')."""
    B, _, C = values.shape
    out = torch.full((B, k, C), float("-inf"), dtype=values.dtype, device=values.device)
    out = out.scatter_reduce(1, labels[..., None].expand(-1, -1, C), values, reduce="amax")
    return torch.where(torch.isfinite(out), out, 0.0)


def kmeans_embed(p: Params, xyz: torch.Tensor, num_groups: int = 256, feature_type: str = "dp", num_iters: int = 10):
    """xyz [B, N, 3] -> (centroids [B, K, 3], group features [B, K, C],
    each point's center p_i [B, N, 3], labels [B, N])."""
    cent, labels = kmeans(xyz, num_groups, num_iters)
    p_i = pointops.index_points(cent, labels)
    rel = xyz - p_i
    if feature_type == "dp":
        feats = rel
    elif feature_type == "pj_dp":
        feats = torch.cat([xyz, rel], -1)
    elif feature_type == "pi_dp":
        feats = torch.cat([p_i, rel], -1)
    else:
        raise ValueError(f"unsupported feature_type {feature_type!r}")

    def mlp(block, x):
        return nn.linear(block["fc2"], torch.relu(nn.layer_norm(block["ln"], nn.linear(block["fc1"], x))))

    per_point = mlp(p["conv1"], feats)
    pooled = segment_max(per_point, labels, num_groups)
    fused = torch.cat([pointops.index_points(pooled, labels), per_point], -1)
    return cent, segment_max(mlp(p["conv2"], fused), labels, num_groups), p_i, labels


# --------------------------------------------------------------------------- #
# Graph convolutions and dilated kNN
# --------------------------------------------------------------------------- #


def dilated_knn(k: int, dilation: int, xyz: torch.Tensor) -> torch.Tensor:
    """Of the k * dilation nearest, every dilation-th, nearest first (JAX's
    order: the kept neighbours depend on it)."""
    return pointops.knn(k * dilation, xyz, xyz)[..., ::dilation]


def graph_conv_init(seed: int, in_channels: int, out_channels: int, device="cpu") -> Params:
    it = _Init(seed, device)
    return {"fc": it.linear(in_channels * 2, out_channels), "ln": it.norm(out_channels)}


def edge_conv(p: Params, x: torch.Tensor, edge_index: torch.Tensor) -> torch.Tensor:
    """EdgeConv: max over k of MLP([x_i, x_j - x_i]); x [B, N, C],
    edge_index [B, N, K] -> [B, N, C_out]."""
    x_j = pointops.index_points(x, edge_index.long())
    x_i = x[:, :, None, :].expand_as(x_j)
    h = torch.cat([x_i, x_j - x_i], dim=-1)
    return torch.relu(nn.layer_norm(p["ln"], nn.linear(p["fc"], h))).amax(2)


def mr_conv(p: Params, x: torch.Tensor, edge_index: torch.Tensor) -> torch.Tensor:
    """Max-relative graph convolution: MLP([x_i, max over k of (x_j - x_i)])."""
    rel = (pointops.index_points(x, edge_index.long()) - x[:, :, None, :]).amax(2)
    return torch.relu(nn.layer_norm(p["ln"], nn.linear(p["fc"], torch.cat([x, rel], dim=-1))))


GCN_LAYERS = Registry("gcn_layers")
GCN_LAYERS.register(edge_conv, name="edgeconv")
GCN_LAYERS.register(edge_conv, name="edge")
GCN_LAYERS.register(mr_conv, name="mrconv")


def three_interpolate(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor, known_feats: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weighted 3-NN interpolation [B, N, C]."""
    return pointops.three_nn_interpolate(unknown_xyz, known_xyz, known_feats)


# --------------------------------------------------------------------------- #
# Stochastic depth and the PEFT adapter
# --------------------------------------------------------------------------- #


def drop_path(generator: Optional[torch.Generator], x: torch.Tensor, rate: float, training: bool = True) -> torch.Tensor:
    """Each sample's residual branch dropped with probability `rate`, the
    kept ones scaled by 1 / (1 - rate); the mask from `generator`."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def adapter_init(seed: int, embed_dims: int, reduction_dims: int, device="cpu") -> Params:
    """Xavier weights, biases ~ N(0, 1e-6)."""
    it = _Init(seed, device)
    p = {"ln1": it.linear(embed_dims, reduction_dims), "ln2": it.linear(reduction_dims, embed_dims)}
    p["ln1"]["b"] = it.normal((reduction_dims,), 1e-6)
    p["ln2"]["b"] = it.normal((embed_dims,), 1e-6)
    return p


def adapter(p: Params, x: torch.Tensor, identity: Optional[torch.Tensor] = None, *, drop_rate: float = 0.0,
            generator: Optional[torch.Generator] = None, training: bool = False) -> torch.Tensor:
    """identity + ln2(dropout(quick_gelu(ln1(x)))); identity defaults to x."""
    out = quick_gelu(nn.linear(p["ln1"], x))
    if training and drop_rate > 0.0:
        if generator is None:
            raise ValueError("dropout requires a torch.Generator")
        keep = 1.0 - drop_rate
        out = torch.where(torch.rand(out.shape, generator=generator, device=out.device) < keep, out / keep, 0.0)
    return (x if identity is None else identity) + nn.linear(p["ln2"], out)


# --------------------------------------------------------------------------- #
# Multi-view projection
# --------------------------------------------------------------------------- #

MV_TRANS = -1.6  # the cameras' z translation


def euler2mat(angle: torch.Tensor) -> torch.Tensor:
    """[3] or [B, 3] euler angles -> rotation [3, 3] / [B, 3, 3], R = Rx Ry Rz."""
    squeeze = angle.dim() == 1
    a = angle[None] if squeeze else angle
    x, y, z = a[:, 0], a[:, 1], a[:, 2]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    cz, sz, cy, sy, cx, sx = torch.cos(z), torch.sin(z), torch.cos(y), torch.sin(y), torch.cos(x), torch.sin(x)
    zmat = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one], -1).reshape(-1, 3, 3)
    ymat = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy], -1).reshape(-1, 3, 3)
    xmat = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx], -1).reshape(-1, 3, 3)
    rot = xmat @ ymat @ zmat
    return rot[0] if squeeze else rot


def point_transform(points: torch.Tensor, rot_mat: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    return points @ rot_mat - translation


def points2depth(points: torch.Tensor, image_height: int, image_width: int, size_x: int = 4,
                 size_y: int = 4) -> torch.Tensor:
    """Camera-frame points [B, N, 3] -> an inverse-depth-weighted depth image
    [B, H, W]: each point splats its depth over a size_x x size_y footprint,
    weighted by 1 / depth; samples off the canvas or behind the camera are
    masked."""
    if not (size_x % 2 == 0 or size_x == 1) or not (size_y % 2 == 0 or size_y == 1):
        raise ValueError(f"points2depth: footprint {size_x} x {size_y} must be even or 1")
    eps = 1e-12
    coord_x = (points[:, :, 0] / (points[:, :, 2] + eps)) * (image_width / image_height)
    coord_y = points[:, :, 1] / (points[:, :, 2] + eps)
    depth = points[:, :, 2]
    _x = (coord_x + 1) * image_height / 2
    _y = (coord_y + 1) * image_width / 2
    B, N = depth.shape
    dev = points.device
    _i = torch.linspace(-size_x / 2, size_x / 2 - 1, size_x, device=dev)
    _j = torch.linspace(-size_y / 2, size_y / 2 - 1, size_y, device=dev)
    ex = torch.ceil(_x[:, :, None, None] + _i[None, None, :, None]).expand(B, N, size_x, size_y)
    ey = torch.ceil(_y[:, :, None, None] + _j[None, None, None, :]).expand(B, N, size_x, size_y)
    value = depth[:, :, None, None].expand(B, N, size_x, size_y)
    masked = (ex >= 0) & (ex <= image_height - 1) & (ey >= 0) & (ey <= image_width - 1) & (value >= 0)
    ex, ey = ex % image_height, ey % image_width
    weight = masked.to(points.dtype) / (value + eps)
    coords = (ex * image_width + ey).to(torch.int64).reshape(B, -1)
    HW = image_height * image_width
    w_scat = torch.zeros((B, HW), dtype=points.dtype, device=dev).scatter_add(1, coords, weight.reshape(B, -1))
    wv_scat = torch.zeros((B, HW), dtype=points.dtype, device=dev).scatter_add(1, coords,
                                                                               (value * weight).reshape(B, -1))
    w_scat = w_scat + (w_scat == 0.0)
    return (wv_scat / w_scat).reshape(B, image_height, image_width)


# the six canonical camera poses: euler angles, then the translation
_PCVIEWS = np.asarray([
    [[0 * np.pi / 2, 0, np.pi / 2], [0, 0, MV_TRANS]],
    [[1 * np.pi / 2, 0, np.pi / 2], [0, 0, MV_TRANS]],
    [[2 * np.pi / 2, 0, np.pi / 2], [0, 0, MV_TRANS]],
    [[3 * np.pi / 2, 0, np.pi / 2], [0, 0, MV_TRANS]],
    [[0, -np.pi / 2, np.pi / 2], [0, 0, MV_TRANS]],
    [[0, np.pi / 2, np.pi / 2], [0, 0, MV_TRANS]],
])


class PCViews:
    """Six fixed orthogonal views; get_img projects a cloud into their depth
    images."""

    num_views = 6

    def __init__(self, device="cpu") -> None:
        angles = torch.tensor(_PCVIEWS[:, 0, :], dtype=torch.float32, device=device)
        self.rot_mat = euler2mat(angles).transpose(1, 2)
        self.translation = torch.tensor(_PCVIEWS[:, 1, :], dtype=torch.float32, device=device)[:, None, :]

    def get_img(self, points: torch.Tensor, resolution: int = 128, size_x: int = 1, size_y: int = 1) -> torch.Tensor:
        """[B, N, 3] -> [B * 6, resolution, resolution] depth images."""
        B, V = points.shape[0], self.num_views
        proj = point_transform(points.repeat_interleave(V, 0), self.rot_mat.repeat(B, 1, 1),
                               self.translation.repeat(B, 1, 1))
        return points2depth(proj, resolution, resolution, size_x, size_y)
