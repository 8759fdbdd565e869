"""The safetensors format, read and written without the safetensors package.

The JAX package reads Hugging Face shards through the `safetensors`
package; the port reads and writes the format itself. A file is:
  * 8 bytes: N, the header's length, a little-endian unsigned 64-bit int;
  * N bytes: a JSON object {name: {"dtype": "F16", "shape": [...],
    "data_offsets": [begin, end]}, ...}, with an optional "__metadata__"
    {str: str};
  * the data: each tensor's bytes, little-endian and C-ordered, at
    [8 + N + begin, 8 + N + end) of the file.
The tensors' byte ranges must tile the data exactly: no overlap, no gap,
nothing past the end (a header that breaks this raises ValueError, as the
safetensors package refuses it).

Reading maps the file (copy-on-write, so the tensors are writable and the
file is never changed) and builds each tensor with torch.frombuffer over
its range: F16, BF16 and F32 come back in their own dtype, and nothing is
read from disk until a tensor's values are touched. `SafetensorsFile`
gives tensors one by one; `load_file` the ones asked for.
"""

from __future__ import annotations

import json
import math
import mmap
import struct
from pathlib import Path
from typing import Any, Dict, Iterable, Mapping, Optional

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# the safetensors package's dtype order (its Dtype enum), which lays out a
# file's tensors: wider types first, so each offset is a multiple of its
# tensor's element size
_RANK = {"BOOL": 0, "U8": 1, "I8": 2, "I16": 5, "F16": 7, "BF16": 8, "I32": 9, "F32": 11, "F64": 12, "I64": 13}
_METADATA = "__metadata__"
_MAX_HEADER = 100 << 20  # the safetensors package's own limit on N


def _parse_header(blob: bytes, file_size: int, where: str) -> Dict[str, Any]:
    """The header of a file of `file_size` bytes whose first bytes are
    `blob`, checked: known dtypes, sizes that match the shapes, byte ranges
    that tile the data."""
    if file_size < 8:
        raise ValueError(f"{where}: {file_size} bytes, too short for a safetensors file")
    (n,) = struct.unpack("<Q", blob[:8])
    if n > _MAX_HEADER or 8 + n > file_size:
        raise ValueError(f"{where}: header length {n} does not fit a file of {file_size} bytes")
    try:
        header = json.loads(blob[8:8 + n].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{where}: the header is not JSON ({e})") from e
    if not isinstance(header, dict):
        raise ValueError(f"{where}: the header is not a JSON object")
    meta = header.get(_METADATA, {})
    if not isinstance(meta, dict) or not all(isinstance(k, str) and isinstance(v, str) for k, v in meta.items()):
        raise ValueError(f"{where}: __metadata__ must map strings to strings")
    ranges = []
    for name, e in header.items():
        if name == _METADATA:
            continue
        if not isinstance(e, dict) or e.get("dtype") not in DTYPES:
            raise ValueError(f"{where}: tensor {name!r} has no known dtype ({e!r})")
        shape, offsets = e.get("shape"), e.get("data_offsets")
        if (not isinstance(shape, list) or not all(isinstance(d, int) and d >= 0 for d in shape)
                or not isinstance(offsets, list) or len(offsets) != 2
                or not all(isinstance(o, int) for o in offsets) or not 0 <= offsets[0] <= offsets[1]):
            raise ValueError(f"{where}: tensor {name!r} has a bad shape or data_offsets ({e!r})")
        size = math.prod(shape) * DTYPES[e["dtype"]].itemsize
        if offsets[1] - offsets[0] != size:
            raise ValueError(f"{where}: tensor {name!r} spans {offsets[1] - offsets[0]} bytes, its shape "
                             f"{shape} of {e['dtype']} needs {size}")
        ranges.append((offsets[0], offsets[1], name))
    end = 0
    for begin, stop, name in sorted(ranges):
        if begin != end:
            what = "overlaps the tensor before it" if begin < end else f"leaves a gap of {begin - end} bytes"
            raise ValueError(f"{where}: tensor {name!r} at byte {begin} {what}")
        end = stop
    if end != file_size - 8 - n:
        raise ValueError(f"{where}: the tensors cover {end} bytes of data, the file holds {file_size - 8 - n}")
    header["__data_start__"] = 8 + n
    return header


def read_header(path) -> Dict[str, Any]:
    """The checked header of a safetensors file: {name: {"dtype", "shape",
    "data_offsets"}} and "__metadata__" when the file has one. Raises
    ValueError for a header the format does not allow."""
    f = SafetensorsFile(path)
    return {**f.header, _METADATA: f.metadata} if f.metadata is not None else dict(f.header)


class SafetensorsFile:
    """One file, mapped: `header` ({name: entry}), `metadata` (or None),
    keys(), get_tensor(name) -> a CPU tensor over the mapping (its dtype and
    shape from the header). Opening reads the header only."""

    def __init__(self, path) -> None:
        self.path = Path(path)
        with open(self.path, "rb") as f:
            size = self.path.stat().st_size
            # copy-on-write: the tensors may be written to, the file is not
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else b""
        n = struct.unpack("<Q", self._map[:8])[0] if size >= 8 else 0
        self.header = _parse_header(self._map[:8 + min(n, _MAX_HEADER + 1)], size, str(self.path))
        self._start = self.header.pop("__data_start__")
        self.metadata: Optional[Dict[str, str]] = self.header.pop(_METADATA, None)

    def keys(self):
        return list(self.header)

    def get_tensor(self, name: str) -> torch.Tensor:
        e = self.header[name]
        dtype, shape = DTYPES[e["dtype"]], e["shape"]
        begin, end = (self._start + o for o in e["data_offsets"])
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        if begin % dtype.itemsize:  # unaligned: a copy (frombuffer would hand out a misaligned tensor)
            return torch.frombuffer(bytearray(self._map[begin:end]), dtype=dtype).reshape(shape)
        return torch.frombuffer(self._map, dtype=dtype, count=(end - begin) // dtype.itemsize,
                                offset=begin).reshape(shape)


def load_file(path, keys: Optional[Iterable[str]] = None, device="cpu") -> Dict[str, torch.Tensor]:
    """{name: tensor} of the file's tensors named in `keys` (all of them
    without), on `device`. On the CPU the tensors lie over the mapped file,
    so only what a caller touches is read."""
    f = SafetensorsFile(path)
    names = f.keys() if keys is None else list(keys)
    missing = [k for k in names if k not in f.header]
    if missing:
        raise KeyError(f"{path}: no tensor named {missing}")
    out = {k: f.get_tensor(k) for k in names}
    if torch.device(device).type != "cpu":
        out = {k: t.to(device) for k, t in out.items()}
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (any device, contiguous or not) as a safetensors
    file, byte for byte as the safetensors package writes it: the tensors
    laid out by its dtype order (wider first) and then by name, so every
    tensor's offset is a multiple of its element size, the header compact
    JSON padded with spaces to a multiple of 8 bytes."""
    if metadata is not None and not all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
        raise ValueError("metadata must map strings to strings")
    for name, t in tensors.items():
        if name == _METADATA or t.dtype not in _NAMES:
            raise ValueError(f"cannot write tensor {name!r} of dtype {t.dtype}")
    order = sorted(tensors, key=lambda k: (-_RANK[_NAMES[tensors[k].dtype]], k))
    header: Dict[str, Any] = {_METADATA: dict(metadata)} if metadata is not None else {}
    offset = 0
    for name in order:
        t = tensors[name]
        size = t.numel() * t.dtype.itemsize
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + size]}
        offset += size
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            if t.numel():
                f.write(memoryview(t.view(torch.uint8).numpy()))
