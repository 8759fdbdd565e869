"""The host point ops of the port (mla_tpu_torch/native/pointops_host.py,
csrc/pointops_host.cpp built with g++ at first use): each C++ function
against its plain numpy version, exactly, and against the JAX package's
mla_tpu.native.pointops_host on seeded clouds; prepare_pointcloud's cases;
the 21-bit grid rule; the [N, 3] contract; a broken source raises."""

import ctypes

import numpy as np
import pytest

from mla_tpu.native import pointops_host as jph
from mla_tpu_torch.native import build
from mla_tpu_torch.native import pointops_host as tph


def _cloud(seed, n, lo=-0.3, hi=0.7):
    return np.random.default_rng(seed).uniform(lo, hi, size=(n, 3)).astype(np.float32)


def _tied(seed, n):
    """A cloud with exact ties: every point appears twice, and one row of
    points on a lattice, equidistant from the lattice's centre."""
    base = _cloud(seed, n // 2)
    lattice = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32) * 0.25
    return np.concatenate([base, lattice, base, lattice]).astype(np.float32)


CLOUDS = [("uniform", lambda: _cloud(1, 700)), ("tied", lambda: _tied(2, 300)),
          ("sensor", lambda: _cloud(3, 2048, -1.5, 1.5))]


@pytest.mark.parametrize("name,make", CLOUDS, ids=[c[0] for c in CLOUDS])
def test_cpp_equals_plain(name, make):
    """Every C++ function against its plain version, bit for bit: indices
    equal, the chamfer distance's float32 equal."""
    pts = make()
    queries = np.concatenate([pts[:9], _cloud(4, 7)])
    for cell in (0.01, 0.05, 0.3):
        for max_out in (None, 5):
            np.testing.assert_array_equal(tph.grid_subsample(pts, cell, max_out),
                                          tph.grid_subsample_plain(pts, cell, max_out))
    for m, start in ((64, 0), (64, 7), (len(pts) + 3, -1)):
        np.testing.assert_array_equal(tph.fps_host(pts, m, start), tph.fps_host_plain(pts, m, start))
    for k in (1, 8, len(pts) + 3):
        np.testing.assert_array_equal(tph.knn_host(pts, queries, k), tph.knn_host_plain(pts, queries, k))
    assert tph.chamfer_distance_host(pts, queries) == tph.chamfer_distance_host_plain(pts, queries)
    assert tph.chamfer_distance_host(queries, pts[::3]) == tph.chamfer_distance_host_plain(queries, pts[::3])


def test_ties_keep_the_earlier_index():
    """Equal distances: kNN lists the earlier index first (the plain version
    sorts stably; a default argsort need not), FPS takes the first farthest."""
    pts = np.zeros((6, 3), np.float32)
    pts[3:] = 1.0
    np.testing.assert_array_equal(tph.knn_host(pts, pts[:1], 6)[0], [0, 1, 2, 3, 4, 5])
    np.testing.assert_array_equal(tph.knn_host_plain(pts, pts[:1], 6)[0], [0, 1, 2, 3, 4, 5])
    np.testing.assert_array_equal(tph.fps_host(pts, 3), [0, 3, 0])
    np.testing.assert_array_equal(tph.fps_host_plain(pts, 3), [0, 3, 0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_jax(seed, record_property):
    """The JAX package's native ops (built with -march=native and GCC's
    default contraction) on seeded random clouds: indices equal; the chamfer
    distance within 1e-6 relative (an FMA there may move its last bit)."""
    pts, queries = _cloud(seed, 1500), _cloud(seed + 10, 40)
    assert jph.native_available()
    for cell in (0.01, 0.05):
        np.testing.assert_array_equal(tph.grid_subsample(pts, cell), jph.grid_subsample(pts, cell))
    for start in (0, 11, -3):
        np.testing.assert_array_equal(tph.fps_host(pts, 256, start), jph.fps_host(pts, 256, start))
    for k in (1, 16):
        np.testing.assert_array_equal(tph.knn_host(pts, queries, k), jph.knn_host(pts, queries, k))
    got, want = tph.chamfer_distance_host(pts, queries), jph.chamfer_distance_host(pts, queries)
    record_property("chamfer_rel_err", abs(got - want) / want)
    assert got == pytest.approx(want, rel=1e-6)


def test_knn_pads_past_n_like_jax():
    pts, queries = _cloud(5, 6), _cloud(6, 4)
    got = tph.knn_host(pts, queries, 9)
    np.testing.assert_array_equal(got, jph.knn_host(pts, queries, 9))
    assert got.shape == (4, 9) and (got[:, 6:] == got[:, 5:6]).all()


@pytest.mark.parametrize("case", ["over", "under", "exact", "voxel_over", "voxel_exact", "voxel_under", "empty"])
def test_prepare_pointcloud_matches_jax(case):
    """The eval entry's cloud preparation: over and under the target, the
    voxel pass (which also deduplicates an exact-size cloud, then refills
    it), an empty cloud giving zeros; the same arrays as JAX's."""
    target = 256
    dense = np.repeat(_cloud(7, 300), 3, axis=0)  # duplicate returns
    pts, cell = {
        "over": (_cloud(8, 1000), None), "under": (_cloud(9, 100), None), "exact": (_cloud(10, target), None),
        "voxel_over": (_cloud(11, 4000), 0.02), "voxel_exact": (dense[:target], 0.01),
        "voxel_under": (dense, 0.2), "empty": (np.zeros((0, 3), np.float32), 0.01),
    }[case]
    got = tph.prepare_pointcloud(pts, target, cell=cell, seed=3)
    want = jph.prepare_pointcloud(pts, target, cell=cell, seed=3)
    assert got.shape == (target, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if case == "empty":
        assert not got.any()


def test_clouds_beyond_the_hash_take_the_exact_grid():
    """Two points 2^21 cells apart share the 21-bit key: the C++ hash alone
    keeps one of them. The port (as JAX) sends such a cloud to the exact
    int64 grid and keeps both; inside the range the hash is used."""
    pts = np.array([[0, 0, 0], [2 ** 21, 0, 0], [0.5, 0.2, 0.1]], np.float32)
    out = np.zeros(3, np.int32)
    lib = tph.load()
    assert lib.grid_subsample(pts.ctypes.data, 3, ctypes.c_float(1.0), out.ctypes.data, 3) == 1
    np.testing.assert_array_equal(tph.grid_subsample(pts, 1.0), [0, 1])
    np.testing.assert_array_equal(tph.grid_subsample(pts, 1.0), jph.grid_subsample(pts, 1.0))
    near = pts.copy()
    near[1, 0] = 2 ** 20 - 3  # just inside: the hash, which does not alias there
    np.testing.assert_array_equal(tph.grid_subsample(near, 1.0), [0, 1])
    np.testing.assert_array_equal(tph.grid_subsample(near, 1.0), tph.grid_subsample_plain(near, 1.0))


def test_refuses_a_wrong_shape():
    six = np.zeros((10, 6), np.float32)
    ok = _cloud(0, 10)
    for call in (lambda: tph.grid_subsample(six, 0.1), lambda: tph.fps_host(six, 4),
                 lambda: tph.knn_host(six, ok, 2), lambda: tph.knn_host(ok, six, 2),
                 lambda: tph.chamfer_distance_host(ok, six), lambda: tph.fps_host_plain(six, 4)):
        with pytest.raises(ValueError, match=r"\[N, 3\]"):
            call()
    with pytest.raises(ValueError, match="empty"):
        tph.fps_host(np.zeros((0, 3), np.float32), 4)
    assert tph.chamfer_distance_host(ok, np.zeros((0, 3), np.float32)) == 0.0
    assert tph.grid_subsample(np.zeros((0, 3), np.float32), 0.1).shape == (0,)


def test_a_broken_source_raises(tmp_path, monkeypatch):
    """A source that does not compile raises from the first call; nothing
    falls back to the plain version. A temporary copy, not the repo's file."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "pointops_host.cpp").write_text(tph.SRC.read_text().replace("extern \"C\" {", "extern \"C\" { syntax error"))
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tph, "_lib", None)
    with pytest.raises(RuntimeError, match="the build of pointops_host.cpp failed"):
        tph.fps_host(_cloud(0, 10), 4)
