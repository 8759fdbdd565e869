"""Point-cloud ops of the point tokenizer: FPS, kNN, gather.

Counterpart of mla_tpu/ops/pointops.py (the part the Point-PN tokenizer
runs). `furthest_point_sample` launches the hand-written kernel
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
    """k nearest neighbours: xyz [B,N,3], new_xyz [B,S,3] -> idx [B,S,k].
    The downstream max-pool is order-invariant, so the order of neighbours
    may differ from JAX's top_k."""
    d = square_distance(new_xyz, xyz)
    return torch.topk(-d, nsample, dim=-1).indices


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
