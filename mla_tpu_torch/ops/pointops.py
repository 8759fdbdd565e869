"""Point-cloud ops: FPS, kNN, gather, and the rest of the library surface
(ball query, grouping, 3-NN interpolation, the point-transformer ops).

Counterpart of mla_tpu/ops/pointops.py. `furthest_point_sample` launches the hand-written kernel
(csrc/fps.cu) on a CUDA tensor and runs `furthest_point_sample_plain`, the
loop of the JAX fallback, on a CPU tensor; the two give identical indices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mla_tpu_torch.ops import cuda


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2: src [..., N, C], dst [..., M, C] -> [..., N, M],
    as |a|^2 + |b|^2 - 2ab (the JAX and reference decomposition)."""
    src, dst = src.float(), dst.float()
    inner = src @ dst.transpose(-1, -2)
    s2 = (src * src).sum(-1)[..., :, None]
    d2 = (dst * dst).sum(-1)[..., None, :]
    return s2 + d2 - 2.0 * inner


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: points [B, N, C], idx [B, ...] -> [B, ..., C]."""
    B, _, C = points.shape
    flat = idx.reshape(B, -1, 1).expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> torch.Tensor:
    """The plain version: the JAX fallback's loop. Distance
    ((dx^2 + dy^2) + dz^2), running minimum, first index on ties."""
    B, N, _ = xyz.shape
    xyzf = xyz.float()
    batch = torch.arange(B, device=xyz.device)
    idx = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    far = start.long()
    for i in range(npoint):
        idx[:, i] = far.to(torch.int32)
        diff = xyzf - xyzf[batch, far][:, None, :]
        sq = diff * diff
        d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        dist = torch.minimum(dist, d)
        far = torch.argmax(dist, dim=-1)
    return idx


def furthest_point_sample(xyz: torch.Tensor, npoint: int, start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FPS indices int32 [B, npoint] for xyz [B, N, 3]; `start` [B] int32
    start indices (default 0, the deterministic mode)."""
    B, N, _ = xyz.shape
    if start is None:
        start = torch.zeros((B,), dtype=torch.int32, device=xyz.device)
    if not xyz.is_cuda:
        return furthest_point_sample_plain(xyz, npoint, start)
    xyz = xyz.float().contiguous()
    start = start.to(torch.int32).contiguous()
    cuda.check(xyz, "furthest_point_sample xyz", torch.float32, 3)
    cuda.check(start, "furthest_point_sample start", torch.int32, 1)
    if xyz.shape[2] != 3 or start.shape[0] != B or not 0 < npoint <= N:
        raise ValueError(f"furthest_point_sample: xyz {tuple(xyz.shape)}, start {tuple(start.shape)}, npoint {npoint}")
    if 16 * N > 227 * 1024:
        raise ValueError(f"furthest_point_sample: N={N} does not fit the kernel's shared memory")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B > 0:
        cuda.call("fps", xyz.data_ptr(), start.data_ptr(), out.data_ptr(), B, N, npoint)
        cuda.launches["furthest_point_sample"] += 1
    return out


def knn(nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """k nearest neighbours: xyz [B,N,3], new_xyz [B,S,3] -> idx [B,S,k] in
    JAX's top_k order, nearest first and ties to the lower index (a stable
    sort of the distances): dilated kNN keeps every d-th neighbour, so its
    result depends on the order."""
    d = square_distance(new_xyz, xyz)
    return torch.sort(d, dim=-1, stable=True).indices[..., :nsample]


def fps_knn(
    xyz: torch.Tensor, feats: torch.Tensor, group_num: int, k_neighbors: int, start: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """The FPS_kNN stage of Point-PN: (lc_xyz, lc_x, knn_xyz, knn_x), the
    sampled centers and features and their k neighbours'. `start` [B] are
    the FPS start indices (default 0, the serving mode; training draws
    them)."""
    fps_idx = furthest_point_sample(xyz, group_num, start).long()
    lc_xyz = index_points(xyz, fps_idx)
    lc_x = index_points(feats, fps_idx)
    knn_idx = knn(k_neighbors, xyz, lc_xyz)
    knn_xyz = index_points(xyz, knn_idx)
    knn_x = index_points(feats, knn_idx)
    return lc_xyz, lc_x, knn_xyz, knn_x


# --------------------------------------------------------------------------- #
# The rest of the library surface (mla_tpu/ops/pointops.py): ball query,
# grouping, 3-NN interpolation and the point-transformer ops. None is on
# the Point-PN path.
# --------------------------------------------------------------------------- #


def _gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [..., N, C], idx [..., M, K] (the same leading dims) -> [..., M,
    K, C]: row idx[..., m, k] of each leading slice."""
    lead = points.shape[:-2]
    flat = points.reshape(-1, *points.shape[-2:])
    out = index_points(flat, idx.reshape(flat.shape[0], *idx.shape[-2:]).long())
    return out.reshape(*lead, *idx.shape[-2:], points.shape[-1])


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """Fixed-radius neighbours [B, S, nsample]: the in-radius points in index
    order, the slots past their count filled with the first of them, and 0
    where none is in the ball (the pointops CUDA kernel's convention)."""
    d = square_distance(new_xyz, xyz)
    in_ball = d <= radius * radius
    N = xyz.shape[1]
    order = torch.where(in_ball, torch.arange(N, device=xyz.device), N)
    idx = torch.sort(order, dim=-1, stable=True).indices[..., :nsample]
    count = in_ball.sum(-1, keepdim=True)
    slot = torch.arange(nsample, device=xyz.device)
    idx = torch.where(slot < count, idx, idx[..., :1])
    return torch.where(count > 0, idx, 0)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, S, k] -> [B, S, k, C]."""
    return index_points(points, idx.long())


def three_nn_interpolate(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor, known_feats: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance-weighted 3-NN interpolation: unknown [B, N, 3],
    known [B, M, 3], feats [B, M, C] -> [B, N, C]. The squared distances
    (|a|^2 + |b|^2 - 2ab, which can dip below 0 for coincident points) are
    clamped at 0 before they are inverted, as in JAX."""
    d = square_distance(unknown_xyz, known_xyz)
    order = torch.sort(d, dim=-1, stable=True)
    d3, idx3 = order.values[..., :3], order.indices[..., :3]
    w = 1.0 / (d3.clamp_min(0.0) + eps)
    w = w / w.sum(-1, keepdim=True)
    gathered = index_points(known_feats, idx3)
    return (gathered * w[..., None].to(gathered.dtype)).sum(-2)


def subtraction(input1: torch.Tensor, input2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[..., i, j, :] = input1[..., i, :] - input2[..., idx[i, j], :];
    input1/input2 [..., N, C], idx [..., N, K] -> [..., N, K, C]."""
    return input1[..., :, None, :] - _gather_rows(input2, idx)


def aggregation(feat: torch.Tensor, position: torch.Tensor, weight: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Point-transformer vector attention: out[i, c] = sum_j (feat[idx[i, j],
    c] + position[i, j, c]) * weight[i, j, c % w_c]; feat [..., N, C],
    position [..., N, K, C], weight [..., N, K, w_c] (w_c divides C), idx
    [..., N, K] -> [..., N, C]."""
    g = _gather_rows(feat, idx)
    w = weight.repeat(*([1] * (weight.dim() - 1)), feat.shape[-1] // weight.shape[-1])
    return ((g + position) * w).sum(-2)


def query_and_group(nsample: int, xyz: torch.Tensor, new_xyz: Optional[torch.Tensor], feat: torch.Tensor,
                    idx: Optional[torch.Tensor] = None, use_xyz: bool = True) -> torch.Tensor:
    """kNN-group features around query centers with center-relative
    coordinates: xyz [B, N, 3], new_xyz [B, M, 3] (None: xyz), feat [B, N,
    C] -> [B, M, K, 3 + C] ([B, M, K, C] without use_xyz)."""
    if new_xyz is None:
        new_xyz = xyz
    if idx is None:
        idx = knn(nsample, xyz, new_xyz)
    grouped_xyz = index_points(xyz, idx.long()) - new_xyz[:, :, None, :]
    grouped_feat = index_points(feat, idx.long())
    return torch.cat([grouped_xyz, grouped_feat], dim=-1) if use_xyz else grouped_feat
