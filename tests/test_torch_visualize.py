"""The port's generation visualization (utils/visualize.py) against the
JAX package's: for the same head outputs and targets (numpy, seeded) the
image panels decode to the same pixels (the port writes its PNG with zlib
and struct, JAX's with PIL; both decoded with PIL here), the point-cloud
NPZ and the tactile NPY hold the same arrays, and the files are the same.
Also the port's writer on outputs given as tensors."""

import numpy as np
import pytest
import torch
from PIL import Image

from mla_tpu.utils import visualize as jviz
from mla_tpu_torch.utils import visualize as tviz

B, S, P = 3, 84, 42  # 3 samples (2 written), 84 px frames of 2 x 2 patches of 42


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    outs = {
        "image_generation": rng.normal(size=(B, (S // P) ** 2, 3 * P * P)).astype(np.float32) * 1.5,
        "pointcloud_coord_generation": rng.normal(size=(B, 64, 3)).astype(np.float32),
        "tactile_generation": rng.normal(size=(B, 12)).astype(np.float32),
    }
    return outs, rng.normal(size=(B, 3, S, S)).astype(np.float32), rng.normal(size=(B, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_panels_match_jax(tmp_path, as_tensor):
    outs, nxt_img, nxt_pc = inputs()
    jviz.save_generation_visualization(outs, nxt_img, nxt_pc, tmp_path / "jax", step=7, image_patch_size=P)
    touts = {k: torch.from_numpy(v) for k, v in outs.items()} if as_tensor else outs
    tviz.save_generation_visualization(touts, nxt_img, nxt_pc, tmp_path / "port", step=7, image_patch_size=P)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["step000007_img0.png", "step000007_img1.png", "step000007_pc.npz", "step000007_tactile.npy"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for n in names[:2]:
        want = np.asarray(Image.open(tmp_path / "jax" / n))
        with Image.open(tmp_path / "port" / n) as im:
            assert im.mode == "RGB"
            got = np.asarray(im)
        assert got.shape == want.shape == (S, 2 * S, 3)
        assert np.array_equal(got, want), n
        assert 0 < want.mean() < 255
    jpc, tpc = np.load(tmp_path / "jax" / names[2]), np.load(tmp_path / "port" / names[2])
    assert sorted(tpc.files) == sorted(jpc.files) == ["gt", "pred"]
    for k in jpc.files:
        assert np.array_equal(tpc[k], jpc[k])
    assert np.array_equal(np.load(tmp_path / "port" / names[3]), np.load(tmp_path / "jax" / names[3]))


def test_write_png_refuses_other_arrays(tmp_path):
    with pytest.raises(ValueError):
        tviz.write_png(tmp_path / "x.png", np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError):
        tviz.write_png(tmp_path / "x.png", np.zeros((4, 4, 3), np.float32))
