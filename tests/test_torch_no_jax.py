"""The port stands alone: no module of mla_tpu_torch/, and not chip_smoke.py,
imports jax or anything of the JAX package mla_tpu, nor TensorFlow,
tensorflow_datasets, protobuf or Pillow, which the machine with the card
does not have (the data pipeline reads TFRecords and PNG itself)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "mla_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "mla_tpu", "flax", "optax", "tensorflow", "tensorflow_datasets", "google.protobuf", "PIL")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_sees_the_imports():
    """The walk catches every import form it must refuse, nested ones too."""
    src = ("import jax.numpy as jnp\nfrom mla_tpu.ops import rope\ndef f():\n    import mla_tpu\nimport mla_tpu_torch\n"
           "def g():\n    from PIL import Image\nimport tensorflow_datasets as tfds\nimport google.protobuf\n"
           "import google\nimport PILlow\n")
    tmp = ROOT / "build" / "_import_probe.py"
    tmp.parent.mkdir(exist_ok=True)
    tmp.write_text(src)
    try:
        assert sorted(n for n in _imports(tmp) if _forbidden(n)) == sorted(
            ["jax.numpy", "mla_tpu.ops", "mla_tpu", "PIL", "tensorflow_datasets", "google.protobuf"])
    finally:
        tmp.unlink()
