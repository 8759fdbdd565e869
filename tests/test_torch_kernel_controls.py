"""The controls of chip_smoke.py: each is a copy of a kernel's source with a
fault its check on the card must catch. A redesign that moves the code a
mutation names would silently drop the control; these tests catch that on
the CPU, before a run on the card."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from mla_tpu_torch.ops import cuda  # noqa: E402


@pytest.mark.parametrize("name", sorted(chip_smoke.CONTROLS))
def test_control_mutations_match_once(name):
    src = (cuda.CSRC / f"{name}.cu").read_text()
    for old, new in chip_smoke.CONTROLS[name]:
        assert src.count(old) == 1, f"{name}.cu holds {old!r} {src.count(old)} times"
        assert old != new


@pytest.mark.parametrize("name", sorted(chip_smoke.CONTROLS))
def test_control_source_differs(name):
    src = (cuda.CSRC / f"{name}.cu").read_text()
    control = chip_smoke.control_source(cuda, name)
    assert control != src
    assert len(control.splitlines()) == len(src.splitlines())


def test_control_source_raises_on_a_stale_mutation(monkeypatch):
    monkeypatch.setitem(chip_smoke.CONTROLS, "flash_fwd", (("no such line;", "x"),))
    with pytest.raises(AssertionError, match="not once"):
        chip_smoke.control_source(cuda, "flash_fwd")


def test_every_flash_kernel_has_a_control():
    assert {"flash_fwd", "flash_bwd"} <= set(chip_smoke.CONTROLS)
    assert set(chip_smoke.CONTROLS) <= set(cuda.SIGNATURES)


def test_w8a8_has_a_control():
    """W8A8's exact check on the card must reject a copy with its last K
    tile dropped, on both paths: the one mutation sits in the split range
    that both kernels take their K tiles from."""
    assert "w8a8" in chip_smoke.CONTROLS
    src = (cuda.CSRC / "w8a8.cu").read_text()
    (old, _), = chip_smoke.CONTROLS["w8a8"]
    assert src.count("split_range(K, split, splits)") == 2
    assert old in src[src.index("int2 split_range("):src.index("bool reduce_splits(")]


def test_int8_mm_has_a_control():
    """int8_mm's column check on the card must reject a copy with its last K
    tile dropped, on both paths and both x dtypes: the one mutation sits in
    the split range that every kernel of the file takes its K tiles from."""
    src = (cuda.CSRC / "int8_mm.cu").read_text()
    (old, _), = chip_smoke.CONTROLS["int8_mm"]
    assert src.count("split_range(K, split, splits)") == 2  # the narrow and the wide kernel
    assert old in src[src.index("int2 split_range("):src.index("// Four int8")]


def test_fps_has_a_control():
    """FPS's exact check must reject a copy that leaves the last point out
    of the distance field (it is then never sampled)."""
    src = (cuda.CSRC / "fps.cu").read_text()
    (old, new), = chip_smoke.CONTROLS["fps"]
    assert "p < N" in old and "p < N - 1" in new
    assert old in src[src.index("fps_kernel("):src.index("int far = start[b];")]


def test_parent_int8_mm_abi_is_read_from_its_source():
    src = (cuda.CSRC / "int8_mm.cu").read_text()
    assert chip_smoke.int8_mm_abi(src) == "split"
    earlier = ('extern "C" int int8_mm(const void* x, int x_dtype, const int8_t* wq, const float* ws, void* y, '
               'int M, int K, int N,\n                       void* stream) {')
    assert chip_smoke.int8_mm_abi(earlier) == "plain"


def test_parent_w8a8_abi_is_read_from_its_source():
    src = (cuda.CSRC / "w8a8.cu").read_text()
    assert chip_smoke.w8a8_abi(src) == "k_major"
    earlier = ('extern "C" int w8a8_matmul(const void* x, int x_dtype, const int8_t* wq, const float* ws, void* y,\n'
               '                           int8_t* xq, float* sx, int32_t* acc_out, int M, int K, int N,\n'
               '                           void* stream) {')
    assert chip_smoke.w8a8_abi(earlier) == "kn"
