"""TFDS-layout RLDS directories, read and written without TensorFlow.

The port's copy of mla_tpu/vla/rlds/tfds_compat.py (writer and reader),
with the same on-disk layout: `data_dir/<name>/<version>/` holding
  * dataset_info.json   name, version and splits (with shardLengths);
  * features.json       the nested feature spec (dtype and per-step shape);
  * <name>-<split>.tfrecord-NNNNN-of-MMMMM shards, one tf.train.Example a
    record and an episode an Example.
Every step leaf is a '/'-joined key under "steps/", its values concatenated
across the episode (numbers as one float or int64 list, strings as a bytes
list of T entries); episode metadata sits under "episode_metadata/".

TFRecord framing is done here: each record is a little-endian u64 length,
the masked CRC-32C of those 8 bytes, the data, and the masked CRC-32C of
the data. A record whose CRC does not match raises `DataLossError`, as
TensorFlow's reader refuses it. tf.train.Example is encoded and decoded by
hand: Example.features is field 1, Features.feature a map (key 1, value 2),
Feature a BytesList (1), FloatList (2) or Int64List (3), each with its
values in field 1, read packed or unpacked; negative int64 values are
10-byte two's complement varints.

Episodes come out as nested dicts of numpy arrays, images still encoded
bytes (tfds.decode.SkipDecoding's semantics): the frame transforms decode
them. float64 leaves come back float32, uint8, int32 and bool ones from
their int64 lists, strings as object arrays of bytes. Directories written by
tensorflow_datasets itself (whose features.json is TFDS's own schema) are
not read.
"""

from __future__ import annotations

import json
import random
import re
import struct
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, List

import numpy as np

from mla_tpu_torch.native import rlds_host
from mla_tpu_torch.vla.rlds.stream import AUTOTUNE, Dataset

ROADMAP_TFDS = "ROADMAP.md queue 1, item 2 (frame formats: directories written by tensorflow_datasets)"


class DataLossError(OSError):
    """A TFRecord that fails its length or data CRC, or is cut short."""


# --------------------------------------------------------------------------- #
# feature-spec helpers
# --------------------------------------------------------------------------- #


def _flatten(prefix: str, tree: Dict[str, Any], out: Dict[str, Any]) -> None:
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            _flatten(path, v, out)
        else:
            out[path] = v


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _leaf_spec(arr) -> Dict[str, Any]:
    a = np.asarray(arr)
    if a.dtype.kind in ("S", "U", "O"):
        return {"dtype": "string", "shape": list(a.shape[1:])}
    return {"dtype": str(a.dtype), "shape": list(a.shape[1:])}


# --------------------------------------------------------------------------- #
# protocol-buffer wire format
# --------------------------------------------------------------------------- #


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _len_field(field: int, body: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(body)) + body


def _varints(vals: np.ndarray) -> bytes:
    """int64 values as concatenated varints (negatives in 10 bytes)."""
    u = np.asarray(vals, np.int64).reshape(-1).view(np.uint64)
    if not u.size:
        return b""
    groups = np.stack([(u >> np.uint64(7 * k)) & np.uint64(0x7F) for k in range(10)], axis=1).astype(np.uint8)
    nbytes = 1 + sum(((u >> np.uint64(7 * k)) > 0).astype(np.int64) for k in range(1, 10))
    k = np.arange(10)[None, :]
    groups |= ((k + 1 < nbytes[:, None]).astype(np.uint8) << 7)
    return groups[k < nbytes[:, None]].tobytes()


def _read_varint(buf, pos: int):
    shift = result = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result & ((1 << 64) - 1), pos
        shift += 7


def _read_varints(buf) -> np.ndarray:
    """Concatenated varints -> int64 values (two's complement)."""
    b = np.frombuffer(buf, np.uint8)
    if not b.size:
        return np.zeros(0, np.int64)
    ends = np.nonzero(b < 0x80)[0]
    if not ends.size or ends[-1] != b.size - 1:
        raise ValueError("truncated varint")
    starts = np.concatenate([[0], ends[:-1] + 1])
    owner = np.repeat(np.arange(ends.size), ends - starts + 1)
    shift = ((np.arange(b.size) - starts[owner]) * 7).astype(np.uint64)
    vals = np.zeros(ends.size, np.uint64)
    np.bitwise_or.at(vals, owner, (b & 0x7F).astype(np.uint64) << shift)
    return vals.view(np.int64)


def _fields(buf):
    """(field number, wire type, value) of a message: an int for varints, a
    memoryview for the other wire types."""
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            size, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + size], pos + size
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            val, pos = buf[pos:pos + size], pos + size
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        if pos > n:
            raise ValueError("protobuf field runs past its message")
        yield field, wire, val


def _feature_bytes(a) -> bytes:
    """One leaf as a serialized tf.train.Feature."""
    a = np.asarray(a)
    if a.dtype.kind in ("S", "U", "O"):
        vals = [v.encode() if isinstance(v, str) else bytes(v) for v in a.reshape(-1)]
        return _len_field(1, b"".join(_len_field(1, v) for v in vals))
    if a.dtype.kind == "f":
        packed = a.reshape(-1).astype("<f4").tobytes()
        return _len_field(2, _len_field(1, packed) if packed else b"")
    packed = _varints(a.reshape(-1).astype(np.int64))
    return _len_field(3, _len_field(1, packed) if packed else b"")


def encode_example(features: Dict[str, Any]) -> bytes:
    """{key: leaf} -> a serialized tf.train.Example (keys in sorted order)."""
    entries = b"".join(_len_field(1, _len_field(1, k.encode()) + _len_field(2, _feature_bytes(v)))
                       for k, v in sorted(features.items()))
    return _len_field(1, entries)


def _list_values(kind: int, body) -> Any:
    """A BytesList, FloatList or Int64List's values."""
    if kind == 1:
        return [bytes(v) for f, w, v in _fields(body) if f == 1 and w == 2]
    if kind == 2:
        parts = []
        for f, w, v in _fields(body):
            if f == 1:
                parts.append(np.frombuffer(v, "<f4"))
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)
    parts = []
    for f, w, v in _fields(body):
        if f == 1:
            parts.append(_read_varints(v) if w == 2 else np.array([v], np.uint64).view(np.int64))
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def decode_example(data) -> Dict[str, Any]:
    """A serialized tf.train.Example -> {key: (kind, values)}, kind 1 for
    bytes (a list of bytes), 2 for floats (float32), 3 for int64."""
    out: Dict[str, Any] = {}
    buf = memoryview(data)
    for f, w, features in _fields(buf):
        if f != 1 or w != 2:
            continue
        for fe, we, entry in _fields(features):
            if fe != 1 or we != 2:
                continue
            key, kind, values = None, 0, None
            for fk, wk, v in _fields(entry):
                if fk == 1:
                    key = bytes(v).decode()
                elif fk == 2:
                    for kind_, _, body in _fields(v):
                        if kind_ in (1, 2, 3):
                            kind, values = kind_, _list_values(kind_, body)
            out[key] = (kind, values)
    return out


# --------------------------------------------------------------------------- #
# TFRecord framing
# --------------------------------------------------------------------------- #


def write_records(path, records) -> None:
    with open(path, "wb") as f:
        for data in records:
            head = struct.pack("<Q", len(data))
            f.write(head + struct.pack("<I", rlds_host.masked_crc32c(head)))
            f.write(data)
            f.write(struct.pack("<I", rlds_host.masked_crc32c(data)))


def read_records(path):
    """The records of one TFRecord file, each checked against its CRCs."""
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise DataLossError(f"{path}: truncated record header")
            (n,), (crc,) = struct.unpack("<Q", head[:8]), struct.unpack("<I", head[8:])
            if rlds_host.masked_crc32c(head[:8]) != crc:
                raise DataLossError(f"{path}: corrupted record (length CRC mismatch)")
            data = f.read(n)
            tail = f.read(4)
            if len(data) < n or len(tail) < 4:
                raise DataLossError(f"{path}: truncated record")
            if rlds_host.masked_crc32c(data) != struct.unpack("<I", tail)[0]:
                raise DataLossError(f"{path}: corrupted record (data CRC mismatch)")
            yield data


# --------------------------------------------------------------------------- #
# writer
# --------------------------------------------------------------------------- #


def write_rlds_dataset(
    data_dir,
    name: str,
    episodes: List[Dict[str, Any]],
    *,
    version: str = "1.0.0",
    split: str = "train",
    num_shards: int = 1,
) -> Path:
    """Write episodes as a TFDS-layout RLDS dataset directory. Each episode
    is {"steps": <nested dict of [T, ...] arrays>, **metadata}. Returns the
    versioned dataset directory."""
    ds_dir = Path(data_dir) / name / version
    ds_dir.mkdir(parents=True, exist_ok=True)

    first = episodes[0]
    steps_flat: Dict[str, Any] = {}
    _flatten("", first["steps"], steps_flat)
    meta_keys = {k: v for k, v in first.items() if k != "steps"}
    features = {
        "steps": {path: _leaf_spec(v) for path, v in steps_flat.items()},
        "episode_metadata": {k: _leaf_spec(np.asarray(v)[None]) for k, v in meta_keys.items()},
    }
    (ds_dir / "features.json").write_text(json.dumps(features, indent=1))

    def episode_example(ep: Dict[str, Any]) -> bytes:
        flat: Dict[str, Any] = {}
        _flatten("steps", ep["steps"], flat)
        for k, v in ep.items():
            if k != "steps":
                flat[f"episode_metadata/{k}"] = v
        return encode_example(flat)

    per_shard = (len(episodes) + num_shards - 1) // num_shards
    shard_lengths = []
    for s in range(num_shards):
        chunk = episodes[s * per_shard:(s + 1) * per_shard]
        shard_lengths.append(len(chunk))
        write_records(ds_dir / f"{name}-{split}.tfrecord-{s:05d}-of-{num_shards:05d}",
                      (episode_example(ep) for ep in chunk))

    info_path = ds_dir / "dataset_info.json"
    info = json.loads(info_path.read_text()) if info_path.exists() else {"name": name, "version": version,
                                                                           "splits": []}
    info["splits"] = [s for s in info.get("splits", []) if s.get("name") != split]
    info["splits"].append({"name": split, "shardLengths": [str(n) for n in shard_lengths]})
    info_path.write_text(json.dumps(info, indent=1))
    return ds_dir


# --------------------------------------------------------------------------- #
# reader
# --------------------------------------------------------------------------- #


def _parse_split(spec: str):
    """'train' | 'train[:95%]' | 'train[95%:]' -> (name, lo_pct, hi_pct)."""
    m = re.match(r"^(\w+)$", spec)
    if m:
        return m.group(1), 0, 100
    m = re.match(r"^(\w+)\[:(\d+)%\]$", spec)
    if m:
        return m.group(1), 0, int(m.group(2))
    m = re.match(r"^(\w+)\[(\d+)%:\]$", spec)
    if m:
        return m.group(1), int(m.group(2)), 100
    raise ValueError(f"unsupported split spec {spec!r}")


class _BuilderInfo:
    """tfds builder .info stand-in; str() is stable for the statistics
    cache hash."""

    def __init__(self, name: str, version: str, splits: Dict[str, Any], repr_: str):
        self.name, self.version, self.splits = name, version, splits
        self._repr = repr_

    def __str__(self) -> str:
        return self._repr


_CASTS = {"float32": np.float32, "float64": np.float32, "int32": np.int32, "int64": np.int64, "uint8": np.uint8,
          "bool": np.bool_}


class MiniRLDSBuilder:
    """tfds.builder-shaped reader for the layout above."""

    def __init__(self, name: str, data_dir) -> None:
        base = Path(data_dir).expanduser() / name
        if not base.exists():
            raise FileNotFoundError(f"no dataset directory {base}")

        def version_key(d):
            # numeric ordering like real tfds: '1.10.0' > '1.9.0'
            try:
                return (1, tuple(int(p) for p in d.name.split(".")))
            except ValueError:
                return (0, (0,))

        versions = sorted((d for d in base.iterdir() if d.is_dir()), key=version_key)
        self.dir = versions[-1] if versions else base
        if not (self.dir / "dataset_info.json").exists():
            raise FileNotFoundError(f"{self.dir} has no dataset_info.json")
        self.name = name
        raw_info = json.loads((self.dir / "dataset_info.json").read_text())
        self.features = json.loads((self.dir / "features.json").read_text())
        if "steps" not in self.features:
            raise NotImplementedError(f"{self.dir}/features.json is not the compat schema (a directory written by "
                                      f"tensorflow_datasets itself?): not read ({ROADMAP_TFDS})")
        splits = {
            s["name"]: SimpleNamespace(
                name=s["name"],
                shard_lengths=[int(n) for n in s.get("shardLengths", [])],
                num_examples=sum(int(n) for n in s.get("shardLengths", [])),
            )
            for s in raw_info.get("splits", [])
        }
        # str(info) feeds the dataset-statistics cache hash; the feature spec
        # is in it, so a schema change invalidates cached statistics
        self.info = _BuilderInfo(
            name=name, version=raw_info.get("version", "1.0.0"), splits=splits,
            repr_=json.dumps({"info": raw_info, "features": self.features}, sort_keys=True),
        )

    def _parse(self, raw: bytes) -> Dict[str, Any]:
        ex = decode_example(raw)

        def leaf(key: str, feat: Dict[str, Any], per_step: bool):
            dt, shape = feat["dtype"], feat["shape"]
            kind, values = ex.get(key, (0, None))
            want = 1 if dt == "string" else (2 if dt in ("float32", "float64") else 3)
            if values is None:
                values = [] if want == 1 else np.zeros(0, np.float32 if want == 2 else np.int64)
            elif kind != want:
                raise ValueError(f"feature {key!r}: stored as list kind {kind}, its spec says {dt}")
            if want == 1:
                arr = np.empty(len(values), object)
                arr[:] = values
            else:
                arr = values
            out = arr.reshape(([-1] + shape) if per_step else (shape or [-1]))
            if not per_step and not shape:
                out = out[0]  # scalar episode metadata
            return out if dt == "string" else np.asarray(out).astype(_CASTS[dt])[()]

        out: Dict[str, Any] = {
            "steps": _unflatten({p: leaf(f"steps/{p}", f, True) for p, f in self.features["steps"].items()}),
        }
        meta = self.features.get("episode_metadata", {})
        if meta:
            out["episode_metadata"] = {k: leaf(f"episode_metadata/{k}", f, False) for k, f in meta.items()}
        return out

    def as_dataset(self, split: str = "train", shuffle_files: bool = False) -> Dataset:
        """Episodes as {"steps": <nested dict of [T, ...] arrays>,
        "episode_metadata": {...}}, parsed in a pool of threads in file
        order; images stay encoded bytes."""
        if split == "all":
            # tfds's union of all splits (the statistics pass reads it)
            parts = [self.as_dataset(split=s, shuffle_files=shuffle_files) for s in sorted(self.info.splits)]
            ds = parts[0]
            for p in parts[1:]:
                ds = ds.concatenate(p)
            return ds
        base, lo, hi = _parse_split(split)
        if base not in self.info.splits:
            raise ValueError(f"split {base!r} not in {list(self.info.splits)}")
        n = self.info.splits[base].num_examples
        files = sorted(str(p) for p in self.dir.glob(f"{self.name}-{base}.tfrecord-*"))
        start, stop = n * lo // 100, n * hi // 100
        shard_lengths = self.info.splits[base].shard_lengths
        if len(shard_lengths) == len(files) and sum(shard_lengths) == n:
            # the split resolved into per-shard (file, skip, take) read
            # instructions on the canonical sorted order (sub-split bounds
            # bind before any file shuffling, so train[:95%] / train[95%:]
            # always partition), then the instruction order shuffled with a
            # fresh OS-entropy seed per call, as tfds's shuffle_files does
            instructions, off = [], 0
            for f, ln in zip(files, shard_lengths):
                s, e = max(start, off), min(stop, off + ln)
                if e > s:
                    instructions.append((f, s - off, e - s))
                off += ln
            if shuffle_files:
                random.Random().shuffle(instructions)
            records = Dataset(lambda: (r for f, skip, take in instructions
                                       for r in Dataset(lambda f=f: read_records(f)).skip(skip).take(take)))
            carved = True
        else:
            # shard metadata absent or inconsistent: a stream-level skip/take
            # over the sorted concatenation (no file shuffling: order is the
            # carving contract here)
            records = Dataset(lambda: (r for f in files for r in read_records(f)))
            carved = False
        ds = records.map(self._parse, num_parallel_calls=AUTOTUNE)
        if not carved and (lo, hi) != (0, 100):
            ds = ds.skip(start).take(stop - start)
        return ds


def builder(name: str, data_dir) -> MiniRLDSBuilder:
    return MiniRLDSBuilder(name, data_dir)
