"""ctypes wrapper of the host point ops, with their plain versions.

Counterpart of mla_tpu/native/pointops_host.py. `csrc/pointops_host.cpp`
holds voxel-grid subsampling, farthest point sampling, brute-force kNN and
the chamfer distance over [N, 3] float32 clouds; `prepare_pointcloud`
brings a raw sensor cloud to the model's point count for the eval entry.
The library is built at first use (`native/build.py`); a failed build
raises: nothing falls back to the plain versions (`*_plain`, numpy, the same
arithmetic), which stand beside each function for the tests.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from mla_tpu_torch.native.build import CSRC, load_library

SRC = CSRC / "pointops_host.cpp"

# the C++ grid packs signed voxel coordinates into 21-bit fields; a cloud
# reaching this many cells from the origin would alias far-apart voxels
_GRID_COORD_LIMIT = 1 << 20

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The helper library, built first where it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            lib = load_library("pointops_host")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.grid_subsample.argtypes, lib.grid_subsample.restype = [p, i, ctypes.c_float, p, i], i
            lib.fps.argtypes, lib.fps.restype = [p, i, i, i, p], None
            lib.knn.argtypes, lib.knn.restype = [p, i, p, i, i, p], None
            lib.chamfer.argtypes, lib.chamfer.restype = [p, i, p, i], ctypes.c_float
            _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _as_xyz(a: np.ndarray, name: str) -> np.ndarray:
    """The [N, 3] contract the C++ side strides by: an [N, 6] xyz+feature
    cloud would be read as interleaved pseudo-points."""
    out = np.ascontiguousarray(a, np.float32)
    if out.ndim != 2 or out.shape[1] != 3:
        raise ValueError(f"{name} must be [N, 3]; got {out.shape}")
    return out


def _sq_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(dx*dx + dy*dy) + dz*dz in float32, broadcast: the C++ order."""
    d = a - b
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


# --------------------------------------------------------------------------- #
# voxel-grid subsampling
# --------------------------------------------------------------------------- #


def _exact_grid(pts: np.ndarray, cell: float, max_out: int) -> np.ndarray:
    """First point per voxel on int64 voxel coordinates, which never alias."""
    grid = np.floor(pts / np.float32(cell)).astype(np.int64)
    _, first = np.unique(grid, axis=0, return_index=True)
    return np.sort(first)[:max_out].astype(np.int32)


def _beyond_hash(pts: np.ndarray, cell: float) -> bool:
    return float(np.abs(pts).max()) / float(cell) >= _GRID_COORD_LIMIT - 1


def grid_subsample(points: np.ndarray, cell: float, max_out: Optional[int] = None) -> np.ndarray:
    """Voxel-grid subsample: the index of the first point (in input order)
    of each voxel of side `cell`, at most max_out (default all) of them."""
    pts = _as_xyz(points, "points")
    n = pts.shape[0]
    max_out = n if max_out is None else max_out
    if n == 0 or cell <= 0 or max_out <= 0:
        return np.zeros(0, np.int32)
    if _beyond_hash(pts, cell):
        # not a fallback: JAX's rule for clouds the 21-bit hash cannot
        # address, which take the exact grid on any machine
        return _exact_grid(pts, cell, max_out)
    out = np.empty(max_out, np.int32)
    count = load().grid_subsample(_ptr(pts), n, float(cell), _ptr(out), max_out)
    return out[:count].copy()


def grid_subsample_plain(points: np.ndarray, cell: float, max_out: Optional[int] = None) -> np.ndarray:
    """The plain version of `grid_subsample`."""
    pts = _as_xyz(points, "points")
    n = pts.shape[0]
    max_out = n if max_out is None else max_out
    if n == 0 or cell <= 0 or max_out <= 0:
        return np.zeros(0, np.int32)
    return _exact_grid(pts, cell, max_out)


# --------------------------------------------------------------------------- #
# farthest point sampling, kNN, chamfer
# --------------------------------------------------------------------------- #


def _fps_args(points: np.ndarray, start: int):
    pts = _as_xyz(points, "points")
    if pts.shape[0] == 0:
        raise ValueError("farthest point sampling of an empty cloud")
    # wrapped like JAX's: a negative start counts from the end
    return pts, int(start) % pts.shape[0]


def fps_host(points: np.ndarray, m: int, start: int = 0) -> np.ndarray:
    """m farthest-point indices [m] int32, starting at `start`; ties go to
    the first index."""
    pts, start = _fps_args(points, start)
    out = np.zeros(m, np.int32)
    load().fps(_ptr(pts), pts.shape[0], m, start, _ptr(out))
    return out


def fps_host_plain(points: np.ndarray, m: int, start: int = 0) -> np.ndarray:
    """The plain version of `fps_host`."""
    pts, far = _fps_args(points, start)
    idx = np.zeros(m, np.int32)
    dist = np.full(pts.shape[0], np.finfo(np.float32).max, np.float32)
    for s in range(m):
        idx[s] = far
        dist = np.minimum(dist, _sq_dist(pts, pts[far]))
        far = int(dist.argmax())
    return idx


def knn_host(points: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """[q, k] int32: each query's k nearest points by ascending squared
    distance, the earlier index first on ties; with k > n each row is padded
    with its farthest neighbour."""
    pts, qs = _as_xyz(points, "points"), _as_xyz(queries, "queries")
    out = np.zeros((qs.shape[0], k), np.int32)
    load().knn(_ptr(pts), pts.shape[0], _ptr(qs), qs.shape[0], k, _ptr(out))
    return out


def knn_host_plain(points: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """The plain version of `knn_host`: a stable sort, as the C++ insertion
    keeps the earlier index on equal distances."""
    pts, qs = _as_xyz(points, "points"), _as_xyz(queries, "queries")
    if pts.shape[0] == 0 or k <= 0:
        return np.zeros((qs.shape[0], max(k, 0)), np.int32)
    order = np.argsort(_sq_dist(qs[:, None, :], pts[None, :, :]), axis=1, kind="stable")[:, :k].astype(np.int32)
    if order.shape[1] < k:
        order = np.concatenate([order, np.repeat(order[:, -1:], k - order.shape[1], axis=1)], axis=1)
    return order


def chamfer_distance_host(a: np.ndarray, b: np.ndarray) -> float:
    """Mean nearest Euclidean distance from a to b plus from b to a; 0 when
    either cloud is empty."""
    aa, bb = _as_xyz(a, "a"), _as_xyz(b, "b")
    return float(load().chamfer(_ptr(aa), aa.shape[0], _ptr(bb), bb.shape[0]))


def chamfer_distance_host_plain(a: np.ndarray, b: np.ndarray) -> float:
    """The plain version of `chamfer_distance_host`: the square roots in
    float64, summed in order (a running sum, as the C++ loop adds)."""
    aa, bb = _as_xyz(a, "a"), _as_xyz(b, "b")
    if aa.shape[0] == 0 or bb.shape[0] == 0:
        return 0.0
    d = _sq_dist(aa[:, None, :], bb[None, :, :])
    fwd = np.cumsum(np.sqrt(d.min(1).astype(np.float64)))[-1]
    bwd = np.cumsum(np.sqrt(d.min(0).astype(np.float64)))[-1]
    return float(np.float32(fwd / aa.shape[0] + bwd / bb.shape[0]))


# --------------------------------------------------------------------------- #
# the eval entry's cloud preparation
# --------------------------------------------------------------------------- #


def prepare_pointcloud(points: np.ndarray, target_n: int, *, cell: Optional[float] = None,
                       seed: int = 0) -> np.ndarray:
    """A raw sensor cloud [N, 3] as exactly `target_n` points for the point
    tokenizer: with `cell`, the voxel-grid pass first (the first point per
    voxel; it also deduplicates a cloud already of the right size, which the
    next step then fills back up); then a seeded random subset without
    replacement, kept in input order, when over, and draws with replacement
    appended when under. An empty cloud gives zeros (a dead frame must not
    end a closed-loop eval)."""
    pts = np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 3))
    if pts.shape[0] == 0:
        return np.zeros((target_n, 3), np.float32)
    if cell is not None:
        idx = grid_subsample(pts, cell)
        if idx.shape[0] > 0:
            pts = pts[idx]
    n = pts.shape[0]
    rng = np.random.default_rng(seed)
    if n > target_n:
        idx = rng.choice(n, size=target_n, replace=False)
        idx.sort()
        pts = pts[idx]
    elif n < target_n:
        pts = np.concatenate([pts, pts[rng.choice(n, size=target_n - n, replace=True)]], axis=0)
    return pts
