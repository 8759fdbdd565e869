"""The point-cloud library of the port (mla_tpu_torch/models/pointlib.py and
the rest of ops/pointops.py) against the JAX package's on the CPU, at
tests/test_pointlib.py's sizes: the same inputs from numpy seeds and the
same weights through params.from_jax. Indices exact (the dilated kNN's
order included), floats within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu.models import pointlib as jpl
from mla_tpu.ops import pointops as jops
from mla_tpu_torch.models import pointlib as tpl
from mla_tpu_torch.ops import pointops as tops
from mla_tpu_torch.params import from_jax, tree_items

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _np(t):
    return t.detach().numpy()


def _blobs(seed=0, B=2, per=32, k=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(B, k, 3)) * 5
    return np.concatenate([centers[:, i : i + 1] + 0.1 * rng.normal(size=(B, per, 3)) for i in range(k)],
                          axis=1).astype(np.float32)


def test_registries_hold_jax_names():
    assert tpl.MODELS.keys() == jpl.MODELS.keys() == ["KMeansEmbed", "Point_PN"]
    assert tpl.GCN_LAYERS.keys() == jpl.GCN_LAYERS.keys()
    assert sorted(tpl.CHANNEL_MAP) == sorted(jpl.CHANNEL_MAP)
    assert all(tpl.CHANNEL_MAP[k](7) == jpl.CHANNEL_MAP[k](7) for k in jpl.CHANNEL_MAP)
    reg = tpl.Registry("test")

    @reg.register
    def widget(a, b=2):
        return a + b

    assert reg.build({"NAME": "widget", "a": 3}) == 5
    assert tpl.build_from_cfg({"NAME": "widget", "a": 1, "b": 10}, reg) == 11
    with pytest.raises(KeyError):
        reg.build({"NAME": "missing"})
    with pytest.raises(KeyError):
        reg.register(widget)


@pytest.mark.parametrize("feature_type", sorted(set(jpl.CHANNEL_MAP) - {"assa", "assa_dp"}))
def test_neighborhood_features_match_jax(feature_type):
    p_j, p_i, f_j, f_i = _rand((2, 5, 4, 3), 1), _rand((2, 5, 1, 3), 2), _rand((2, 5, 4, 6), 3), _rand((2, 5, 1, 6), 4)
    want = np.asarray(jpl.neighborhood_features(feature_type, *map(jnp.asarray, (p_j, p_i, f_j, f_i))))
    got = tpl.neighborhood_features(feature_type, *map(torch.from_numpy, (p_j, p_i, f_j, f_i)))
    np.testing.assert_allclose(_np(got), want, **TOL)


@pytest.mark.parametrize("pts", [_blobs(0), _rand((2, 96, 3), 11)], ids=["blobs", "normal"])
def test_kmeans_matches_jax(pts):
    jc, jl = jpl.kmeans(jnp.asarray(pts), num_clusters=4, num_iters=15)
    tc, tl = tpl.kmeans(torch.from_numpy(pts), num_clusters=4, num_iters=15)
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))
    np.testing.assert_allclose(_np(tc), np.asarray(jc), **TOL)


def test_segment_max_matches_jax():
    v, lab = _rand((2, 20, 5), 2), np.random.default_rng(2).integers(0, 6, size=(2, 20))
    want = np.asarray(jpl._segment_max(jnp.asarray(v), jnp.asarray(lab), 6))
    np.testing.assert_array_equal(_np(tpl.segment_max(torch.from_numpy(v), torch.from_numpy(lab), 6)), want)


@pytest.mark.parametrize("feature_type", ["dp", "pj_dp", "pi_dp"])
def test_kmeans_embed_matches_jax(feature_type):
    xyz = _rand((2, 64, 3), 1)
    p = jpl.kmeans_embed_init(jax.random.PRNGKey(0), encoder_dim=96, feature_type=feature_type)
    want = jpl.kmeans_embed(p, jnp.asarray(xyz), num_groups=8, feature_type=feature_type, num_iters=5)
    got = tpl.kmeans_embed(from_jax(p), torch.from_numpy(xyz), num_groups=8, feature_type=feature_type, num_iters=5)
    np.testing.assert_array_equal(_np(got[3]), np.asarray(want[3]))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
    # the port's init has JAX's layout
    tp = tpl.kmeans_embed_init(0, encoder_dim=96, feature_type=feature_type)
    assert {k: tuple(v.shape) for k, v in tree_items(tp)} == {k: tuple(v.shape) for k, v in tree_items(from_jax(p))}


@pytest.mark.parametrize("k,dilation", [(4, 1), (4, 2), (3, 3)])
def test_dilated_knn_order_matches_jax(k, dilation):
    xyz = _rand((2, 32, 3), 4)
    want = np.asarray(jpl.dilated_knn(k, dilation, jnp.asarray(xyz)))
    np.testing.assert_array_equal(_np(tpl.dilated_knn(k, dilation, torch.from_numpy(xyz))), want)
    # ties go to the lower index, as JAX's top_k: a cloud of repeated points
    dup = np.repeat(_rand((1, 8, 3), 5), 4, axis=1)
    want = np.asarray(jpl.dilated_knn(k, dilation, jnp.asarray(dup)))
    np.testing.assert_array_equal(_np(tpl.dilated_knn(k, dilation, torch.from_numpy(dup))), want)


@pytest.mark.parametrize("conv", ["edge_conv", "mr_conv"])
def test_graph_convs_match_jax(conv):
    x = _rand((2, 16, 6), 3)
    idx = jpl.dilated_knn(4, 2, jnp.asarray(x[..., :3]))
    p = jpl.graph_conv_init(jax.random.PRNGKey(1), 6, 8)
    want = np.asarray(getattr(jpl, conv)(p, jnp.asarray(x), idx))
    got = getattr(tpl, conv)(from_jax(p), torch.from_numpy(x), torch.from_numpy(np.asarray(idx)))
    np.testing.assert_allclose(_np(got), want, **TOL)
    assert tpl.GCN_LAYERS.get("edgeconv" if conv == "edge_conv" else "mrconv") is getattr(tpl, conv)


def test_adapter_matches_jax():
    x = _rand((2, 5, 16), 6)
    p = jpl.adapter_init(jax.random.PRNGKey(3), 16, 4)
    np.testing.assert_allclose(_np(tpl.adapter(from_jax(p), torch.from_numpy(x))),
                               np.asarray(jpl.adapter(p, jnp.asarray(x))), **TOL)
    ident = np.zeros_like(x)
    np.testing.assert_allclose(_np(tpl.adapter(from_jax(p), torch.from_numpy(x), identity=torch.from_numpy(ident))),
                               np.asarray(jpl.adapter(p, jnp.asarray(x), identity=jnp.asarray(ident))), **TOL)
    np.testing.assert_allclose(_np(tpl.quick_gelu(torch.from_numpy(x))), np.asarray(jpl.quick_gelu(jnp.asarray(x))),
                               **TOL)
    tp = tpl.adapter_init(0, 16, 4)
    assert {k: tuple(v.shape) for k, v in tree_items(tp)} == {k: tuple(v.shape) for k, v in tree_items(from_jax(p))}
    assert float(tp["ln1"]["b"].abs().max()) < 1e-5


def test_drop_path_and_adapter_dropout_draw_from_a_generator():
    x = torch.ones((64, 4))
    assert torch.equal(tpl.drop_path(None, x, 0.0), x)
    assert torch.equal(tpl.drop_path(torch.Generator().manual_seed(0), x, 0.9, training=False), x)
    y = tpl.drop_path(torch.Generator().manual_seed(0), x, 0.5)
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert torch.equal(y, tpl.drop_path(torch.Generator().manual_seed(0), x, 0.5))
    assert (y == y[:, :1]).all()  # one draw per sample
    p = from_jax(jpl.adapter_init(jax.random.PRNGKey(3), 4, 2))
    a = tpl.adapter(p, x, drop_rate=0.5, generator=torch.Generator().manual_seed(1), training=True)
    assert torch.equal(a, tpl.adapter(p, x, drop_rate=0.5, generator=torch.Generator().manual_seed(1), training=True))
    with pytest.raises(ValueError):
        tpl.adapter(p, x, drop_rate=0.5, training=True)


def test_multiview_projection_matches_jax():
    ang = np.random.default_rng(7).uniform(-np.pi, np.pi, size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tpl.euler2mat(torch.from_numpy(ang))), np.asarray(jpl.euler2mat(jnp.asarray(ang))),
                               **TOL)
    np.testing.assert_allclose(_np(tpl.euler2mat(torch.from_numpy(ang[0]))),
                               np.asarray(jpl.euler2mat(jnp.asarray(ang[0]))), **TOL)
    pts = np.random.default_rng(8).uniform(-1, 1, size=(2, 200, 3)).astype(np.float32)
    pts[:, :, 2] += 2.5
    for size in (4, 1):
        np.testing.assert_allclose(_np(tpl.points2depth(torch.from_numpy(pts), 32, 32, size, size)),
                                   np.asarray(jpl.points2depth(jnp.asarray(pts), 32, 32, size, size)), **TOL)
    cloud = np.random.default_rng(9).uniform(-0.5, 0.5, size=(2, 128, 3)).astype(np.float32)
    want = np.asarray(jpl.PCViews().get_img(jnp.asarray(cloud), resolution=32))
    got = tpl.PCViews().get_img(torch.from_numpy(cloud), resolution=32)
    assert got.shape == (12, 32, 32)
    np.testing.assert_allclose(_np(got), want, **TOL)


def test_model_registry_builds_point_pn_and_kmeans_embed():
    cfg_kw = {"NAME": "Point_PN", "input_points": 64, "embed_dim": 12, "k_neighbors": 8, "lga_blocks": (2, 1),
              "dim_expansion": (2, 2), "out_dim": 24}
    jcfg, jinit, _ = jpl.build_from_cfg(dict(cfg_kw))
    cfg, init, apply = tpl.build_from_cfg(dict(cfg_kw))
    jp, js = jinit(jax.random.PRNGKey(0))
    p, s = init(seed=0)
    assert {k: tuple(v.shape) for k, v in tree_items(p)} == {k: tuple(v.shape) for k, v in tree_items(from_jax(jp))}
    xyz = _rand((1, 64, 3), 10, 0.3)
    want = jpl.MODELS.get("Point_PN")(**{k: v for k, v in cfg_kw.items() if k != "NAME"})[2](
        jp, js, jnp.asarray(xyz), jcfg)
    got = apply(from_jax(jp), from_jax(js), torch.from_numpy(xyz), cfg)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-5)
    init2, apply2 = tpl.build_from_cfg({"NAME": "KMeansEmbed", "num_groups": 8, "encoder_dim": 32})
    cent, feats, _, _ = apply2(init2(seed=1), torch.from_numpy(xyz))
    assert cent.shape == (1, 8, 3) and feats.shape == (1, 8, 32)


# --------------------------------------------------------------------------- #
# The rest of ops/pointops.py
# --------------------------------------------------------------------------- #


def test_knn_ball_query_and_groups_match_jax():
    xyz, new = _rand((2, 48, 3), 12), _rand((2, 10, 3), 13)
    np.testing.assert_array_equal(_np(tops.knn(6, torch.from_numpy(xyz), torch.from_numpy(new))),
                                  np.asarray(jops.knn(6, jnp.asarray(xyz), jnp.asarray(new))))
    for radius, nsample in ((0.5, 8), (1.0, 16), (1e-3, 4)):
        want = np.asarray(jops.ball_query(radius, nsample, jnp.asarray(xyz), jnp.asarray(new)))
        np.testing.assert_array_equal(
            _np(tops.ball_query(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(new))), want)
    idx = np.random.default_rng(14).integers(0, 48, size=(2, 10, 5))
    feats = _rand((2, 48, 7), 15)
    np.testing.assert_array_equal(_np(tops.group_points(torch.from_numpy(feats), torch.from_numpy(idx))),
                                  np.asarray(jops.group_points(jnp.asarray(feats), jnp.asarray(idx))))
    for new_xyz in (new, None):
        for use_xyz in (True, False):
            want = np.asarray(jops.query_and_group(5, jnp.asarray(xyz), None if new_xyz is None else jnp.asarray(new_xyz),
                                                   jnp.asarray(feats), use_xyz=use_xyz))
            got = tops.query_and_group(5, torch.from_numpy(xyz),
                                       None if new_xyz is None else torch.from_numpy(new_xyz),
                                       torch.from_numpy(feats), use_xyz=use_xyz)
            np.testing.assert_allclose(_np(got), want, **TOL)


def test_three_interpolate_matches_jax():
    known = _rand((2, 16, 3), 16)
    unknown = np.concatenate([known, _rand((2, 24, 3), 17)], axis=1)  # coincident points too
    feats = _rand((2, 16, 5), 18)
    want = np.asarray(jops.three_nn_interpolate(jnp.asarray(unknown), jnp.asarray(known), jnp.asarray(feats)))
    got = tpl.three_interpolate(torch.from_numpy(unknown), torch.from_numpy(known), torch.from_numpy(feats))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def test_point_transformer_ops_match_jax():
    rng = np.random.default_rng(19)
    a, b = _rand((2, 12, 8), 20), _rand((2, 12, 8), 21)
    idx = rng.integers(0, 12, size=(2, 12, 4))
    np.testing.assert_allclose(_np(tops.subtraction(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(idx))),
                               np.asarray(jops.subtraction(jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx))), **TOL)
    pos, w = _rand((2, 12, 4, 8), 22), _rand((2, 12, 4, 2), 23)
    want = np.asarray(jops.aggregation(jnp.asarray(a), jnp.asarray(pos), jnp.asarray(w), jnp.asarray(idx)))
    got = tops.aggregation(torch.from_numpy(a), torch.from_numpy(pos), torch.from_numpy(w), torch.from_numpy(idx))
    np.testing.assert_allclose(_np(got), want, **TOL)
    # unbatched leading dims, as JAX's take_along_axis takes them
    np.testing.assert_allclose(
        _np(tops.subtraction(torch.from_numpy(a[0]), torch.from_numpy(b[0]), torch.from_numpy(idx[0]))),
        np.asarray(jops.subtraction(jnp.asarray(a[0]), jnp.asarray(b[0]), jnp.asarray(idx[0]))), **TOL)
