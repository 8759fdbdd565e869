"""The build at first use of the host helpers' C++ sources.

Each helper (`rlds_host.cpp`, `jpeg_host.cpp` under `csrc/`) is built with
g++ into `build/native/` beside the package (a directory `.gitignore`
lists) at first use, and again when its source is newer than the library,
then loaded through ctypes. A failed build raises: nothing falls back to
the plain versions, which stand beside each function for the tests.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
# -ffp-contract=off: no multiply-add is fused, so each float sum rounds as
# TensorFlow's CPU kernel rounds it
COMPILE_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")


def _build(src: Path, lib: Path) -> None:
    """g++ into a temporary file, then an atomic rename: processes that build
    at once never leave a half-written library for another to load."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *COMPILE_FLAGS, str(src), "-o", tmp], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"the build of {src.name} failed:\n{proc.stdout}{proc.stderr}")
        os.rename(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library(name: str) -> ctypes.CDLL:
    """csrc/<name>.cpp as a loaded library, built first where the library
    is missing or older than its source. The caller serializes calls."""
    src, lib = CSRC / f"{name}.cpp", BUILD_DIR / f"lib{name}.so"
    if not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime:
        _build(src, lib)
    return ctypes.CDLL(str(lib))
