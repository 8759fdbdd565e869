"""Checkpoint save and load, and the reference-format export.

Counterpart of mla_tpu/training/checkpointing.py, with the same run-dir
layout and names:
    runs/<run_id>/
      config.json                  (train + model config dump)
      dataset_statistics.json      (q01/q99 norm stats)
      checkpoints/
        step-XXXXXX-epoch-XX-loss=Y.YYYY/   (state.pt)
        step-XXXXXX-epoch-XX-loss=Y.YYYY.pt (optional reference format)
        latest                              (names the latest checkpoint)

The format is the port's own: one torch.save file of host tensors,
{'params', 'opt_state' (the optimizer's state_dict), 'model_state', 'step',
and 'ema_params' with EMA}, loadable with weights_only=True. A save copies
the whole state to host memory before it returns (the parameters are
updated in place by the next step), writes into `<name>.tmp-<pid>` and
renames it to `<name>` when the file is complete, as orbax does. With
async_save only the write overlaps training, one write in flight at a time.
A load maps the file (mmap) and copies each leaf into the live state's
tensors, so the card never holds a second copy of the state.

The state may be sharded over a mesh (strategy.init_train_state): the
file is the same at every world size. Every rank takes part in gathering
the whole masters, optimizer state and EMA, and rank 0 writes; every rank
loads the whole file and keeps its own parts, so a save at any world size
resumes at any other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mla_tpu_torch.params import tree_items
from mla_tpu_torch.utils.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)

STATE_FILE = "state.pt"
_TMP = ".tmp-"


def _ckpt_name(step: int, epoch: int, loss: Optional[float]) -> str:
    if loss is None:
        return f"step-{step:06d}-epoch-{epoch:02d}-loss=inf"
    return f"step-{step:06d}-epoch-{epoch:02d}-loss={loss:.4f}"


def _config_to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _config_to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {k: _config_to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_config_to_jsonable(v) for v in obj]
    if isinstance(obj, torch.dtype):
        return str(obj).removeprefix("torch.")  # "float32", as the JAX package writes a dtype
    if isinstance(obj, (torch.Tensor, np.ndarray, np.generic)):
        # lists, the reference's format: the run dir's dataset statistics
        # must load back into numbers (load_vla -> unnormalize_actions)
        return obj.tolist()
    if isinstance(obj, type):
        return obj.__name__
    try:
        json.dumps(obj)
        return obj
    except TypeError:
        return str(obj)


def write_run_metadata(run_dir, train_cfg: Any, model_cfg: Any, dataset_statistics: Optional[Dict] = None) -> None:
    run_dir = Path(run_dir)
    if not overwatch.is_rank_zero():
        return
    run_dir.mkdir(parents=True, exist_ok=True)
    with open(run_dir / "config.json", "w") as f:
        json.dump({"train": _config_to_jsonable(train_cfg), "model": _config_to_jsonable(model_cfg)}, f, indent=2)
    if dataset_statistics is not None:
        with open(run_dir / "dataset_statistics.json", "w") as f:
            json.dump(_config_to_jsonable(dataset_statistics), f, indent=2)


class _AsyncWriter:
    """One checkpoint write in flight at a time, on a background thread; an
    exception of the write is raised by the next wait()."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, fn: Callable[[], None]) -> None:
        self.wait()

        def run() -> None:
            try:
                fn()
            except Exception as e:  # handed to the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=run, name="checkpoint-writer")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


_ASYNC = _AsyncWriter()


def wait_for_async_saves() -> None:
    """Block until the in-flight async write is complete (call before the
    process exits and before reading the checkpoint back)."""
    _ASYNC.wait()


def _write(path: Path, blob: Dict[str, Any]) -> None:
    tmp = path.with_name(f"{path.name}{_TMP}{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    with open(tmp / STATE_FILE, "wb") as f:
        torch.save(blob, f)
        f.flush()
        os.fsync(f.fileno())
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)


def save_checkpoint(
    run_dir,
    train_state: Dict[str, Any],
    *,
    step: int,
    epoch: int = 0,
    loss: Optional[float] = None,
    keep: int = 3,
    also_reference_format: bool = False,
    model_cfg: Any = None,
    async_save: bool = False,
) -> Path:
    """Save the full train state under run_dir/checkpoints/<name>, point
    `latest` at it and keep the newest `keep` complete checkpoints.
    async_save=True returns once the state is in host memory and writes on
    a background thread; call wait_for_async_saves() before exit."""
    ckpt_dir = Path(run_dir) / "checkpoints"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    name = _ckpt_name(step, epoch, loss)
    path = (ckpt_dir / name).absolute()
    _ASYNC.wait()
    # every rank takes part in the gathers; rank 0 gets the blob and writes
    blob = train_state["shards"].host_state(train_state)
    if blob is not None:
        if also_reference_format:
            export_reference_pt(path.with_suffix(".pt"), blob, model_cfg)
        if async_save:
            _ASYNC.submit(lambda: _write(path, blob))
        else:
            _write(path, blob)
        with open(ckpt_dir / "latest", "w") as f:
            f.write(name)
        _gc_old_checkpoints(ckpt_dir, keep)
    del blob
    return path


def _is_complete_ckpt(d: Path) -> bool:
    # a write goes to "<name>.tmp-<pid>" and is renamed when complete: a tmp
    # suffix means in flight or aborted, never a checkpoint
    return d.is_dir() and d.name.startswith("step-") and _TMP not in d.name


def _gc_old_checkpoints(ckpt_dir: Path, keep: int) -> None:
    dirs = sorted([d for d in ckpt_dir.iterdir() if _is_complete_ckpt(d)], key=lambda d: d.name)
    for d in dirs[:-keep] if keep > 0 else []:
        shutil.rmtree(d, ignore_errors=True)
        # the reference-format companion (also_reference_format=True)
        pt = d.with_suffix(".pt")
        if pt.exists():
            pt.unlink()


def _copy_tree(live: Any, saved: Any, what: str) -> None:
    got, want = tree_items(saved), tree_items(live)
    if [p for p, _ in got] != [p for p, _ in want]:
        raise ValueError(f"the checkpoint's {what} have other leaves than the live state's")
    for (path, s), (_, t) in zip(got, want):
        if s.shape != t.shape or s.dtype != t.dtype:
            raise ValueError(f"{what}/{path}: checkpoint {tuple(s.shape)} {s.dtype}, live {tuple(t.shape)} {t.dtype}")
        t.copy_(s)


def load_checkpoint(path, train_state: Dict[str, Any]) -> Dict[str, Any]:
    """Copy a checkpoint written by save_checkpoint into `train_state` (its
    tensors fix the structure, shapes, dtypes and devices; the optimizer
    allocates the moments it has not made yet) and return it with the saved
    step."""
    blob = torch.load(Path(path) / STATE_FILE, map_location="cpu", mmap=True, weights_only=True)
    train_state["shards"].load(blob, train_state)
    with torch.no_grad():
        _copy_tree(train_state["model_state"], blob["model_state"], "model_state")
    return {**train_state, "step": int(blob["step"])}


def latest_checkpoint(run_dir) -> Optional[Path]:
    """Newest complete checkpoint. The `latest` marker is written as soon as
    an async save is dispatched, so after a preemption mid-write it can name
    a checkpoint that was never completed: fall back to the newest complete
    step-* directory then."""
    ckpt_dir = Path(run_dir) / "checkpoints"
    marker = ckpt_dir / "latest"
    if marker.exists():
        named = ckpt_dir / marker.read_text().strip()
        if _is_complete_ckpt(named):
            return named
    dirs = sorted(d for d in ckpt_dir.glob("step-*") if _is_complete_ckpt(d))
    return dirs[-1] if dirs else None


def export_reference_pt(path, train_state: Dict[str, Any], model_cfg: Any, llm_dtype: Optional[torch.dtype] = None) -> None:
    """Write the reference-format module-keyed .pt, so tooling of the
    reference's ecosystem (and load_vla) can read our checkpoints: fp32, or
    the decoder's leaves in llm_dtype (a bf16 7B without an fp32 copy)."""
    from mla_tpu_torch.models.convert import export_reference_checkpoint

    blob = export_reference_checkpoint(train_state["params"], train_state.get("model_state", {}), model_cfg,
                                       llm_dtype=llm_dtype)
    torch.save({"model": {mod: {k: v if isinstance(v, torch.Tensor) else torch.tensor(v) for k, v in sd.items()}
                          for mod, sd in blob["model"].items()}}, path)


def parse_step_epoch(ckpt_path) -> Tuple[int, int]:
    m = re.search(r"step-(\d+)-epoch-(\d+)", str(ckpt_path))
    if not m:
        return 0, 0
    return int(m.group(1)), int(m.group(2))
