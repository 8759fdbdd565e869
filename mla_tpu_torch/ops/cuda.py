"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` file with a plain C interface. It is
compiled with `nvcc` for `sm_90a` into `build/kernels/lib<name>.so` beside
the package (a directory `.gitignore` lists) at first use and loaded with
ctypes. A library is rebuilt when its `.cu` file or any header in `csrc/`
is newer than it. `build()` starts one `nvcc` per source, all at once, and
raises if any of them fails; nothing falls back to a plain version.

`launches` counts kernel launches by wrapper name. A wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of each library's entry points: {symbol: argtypes}; the
# first entry point is the library's default
SIGNATURES = {
    "w8a8": {"w8a8_matmul": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]},
    "fps": {"fps": [_P, _P, _P, _I, _I, _I, _P]},
    "flash_fwd": {"flash_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P]},
    "flash_bwd": {
        "flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
        "flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    },
    "int8_mm": {"int8_mm": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
}
# extra nvcc flags per source: FPS must not contract its distance into FMAs
EXTRA_FLAGS = {"fps": ["-fmad=false"]}

launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """True when library `name` is missing or older than its source or any
    shared header it may include."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(built < src.stat().st_mtime for src in (CSRC / f"{name}.cu", *CSRC.glob("*.cuh")))


def compile_cmd(name: str, src: Path, out: Path) -> list:
    """The nvcc command that builds library `name` from `src` into `out`."""
    return [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        *EXTRA_FLAGS.get(name, []),
        "-o", str(out), str(src),
    ]


def build(names=tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every stale library of `names` in parallel; returns the
    compiler's register/shared-memory report (-Xptxas -v) per library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        cmd = compile_cmd(name, CSRC / f"{name}.cu", Path(str(_lib_path(name)) + ".tmp"))
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    reports, failed = {}, []
    for name, proc in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(str(_lib_path(name)) + ".tmp", _lib_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str, path: Path) -> ctypes.CDLL:
    """Load the library at `path` with the entry points of library `name`."""
    lib = ctypes.CDLL(str(path))
    for symbol, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        if name not in _loaded:
            if _stale(name):
                build((name,))
            _loaded[name] = load(name, _lib_path(name))
        return _loaded[name]


def call(name: str, *args, symbol: Optional[str] = None) -> None:
    """Launch entry point `symbol` (default: the first) of library `name` on
    the current stream (appended as the last argument) and raise on a
    non-zero cudaGetLastError()."""
    symbol = symbol or next(iter(SIGNATURES[name]))
    fn = getattr(library(name), symbol)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {symbol} failed to launch: cudaError {err}")


def check(t: torch.Tensor, what: str, dtype=None, ndim=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of the given type/rank."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
