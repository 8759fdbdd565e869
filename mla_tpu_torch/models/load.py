"""Model loading: a run dir or a checkpoint -> a serving policy.

Counterpart of mla_tpu/models/load.py (`load_vla`, `_resolve_checkpoint`,
`_read_json`). `load_vla` reads three kinds of checkpoint:
  * the port's own run dir (training/checkpointing.py): config.json,
    dataset_statistics.json and checkpoints/step-*/state.pt, the one
    `latest` names (or a step dir given directly); use_ema=True serves the
    EMA weights a --use_ema run keeps;
  * a reference run dir (checkpoints/*.pt) or a bare reference-format .pt,
    as JAX's export_reference_checkpoint / export_reference_pt and the
    port's export_reference_pt write it (models/convert.py);
  * a JAX orbax run dir, which cannot be read without JAX: it raises,
    naming export_reference_pt as the way across.
The model is built from a seeded init on the target device, and the
checkpoint's module groups replace the init's; a reference checkpoint's
floating leaves then go to cfg.llama.param_dtype, as in JAX. The HF loaders
(`load_openvla`, `load_base_llm`) are not ported.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

from mla_tpu_torch import params as P
from mla_tpu_torch.conf.models import MODEL_REGISTRY, get_model_config
from mla_tpu_torch.models import convert
from mla_tpu_torch.models.mla import MLAPolicy, _resolve_device
from mla_tpu_torch.training.checkpointing import STATE_FILE, latest_checkpoint
from mla_tpu_torch.utils.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)

_MODEL_FLAG_KEYS = (
    "use_diff", "use_pointcloud", "use_tactile", "use_contrastive",
    "use_generation", "use_roi", "camera_name", "action_dim",
    "future_action_window_size", "class_dropout_prob",
)
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt", "d")


def _read_json(path: Path) -> Optional[Dict]:
    try:
        return json.loads(Path(path).read_text())
    except Exception:
        return None


def _resolve_checkpoint(path: Path) -> Optional[Path]:
    """The checkpoint a path names: a .pt file; a run dir's latest complete
    step dir, else its newest checkpoints/*.pt; or a checkpoint dir given
    directly (the port's, holding state.pt, or an orbax one)."""
    if path.is_file() and path.suffix == ".pt":
        return path
    if path.is_dir() and (path / "checkpoints").exists():
        latest = latest_checkpoint(path)
        if latest is not None and latest.exists():
            return latest
        pts = sorted((path / "checkpoints").glob("*.pt"))
        if pts:
            return pts[-1]
    if path.is_dir() and ((path / STATE_FILE).exists() or any((path / m).exists() for m in _ORBAX_MARKERS)):
        return path
    return None


def _load_port_checkpoint(ckpt_dir: Path, params: Dict[str, Any], state: Dict[str, Any], use_ema: bool):
    """Copy a port state.pt's params (or ema_params) and model state into the
    init's trees, leaf for leaf, each cast to the init leaf's dtype (as
    orbax restores into an abstract tree)."""
    blob = torch.load(ckpt_dir / STATE_FILE, map_location="cpu", mmap=True, weights_only=True)
    key = "ema_params" if use_ema else "params"
    if key not in blob:
        raise ValueError(f"use_ema=True but {ckpt_dir} holds no ema_params (was the run trained with --use_ema?)")
    for what, live, saved in (("params", params, blob[key]), ("model_state", state, blob["model_state"])):
        got, want = P.tree_items(saved), P.tree_items(live)
        if [p for p, _ in got] != [p for p, _ in want]:
            raise ValueError(f"{ckpt_dir}: the checkpoint's {what} have other leaves than the model's "
                             f"(pass the run's model_id?)")
        with torch.no_grad():
            for (name, s), (_, t) in zip(got, want):
                if s.shape != t.shape:
                    raise ValueError(f"{what}/{name}: checkpoint {tuple(s.shape)}, model {tuple(t.shape)}")
                t.copy_(s)


def load_vla(
    checkpoint_or_run_dir,
    *,
    model_id: Optional[str] = None,
    tokenizer=None,
    load_for_training: bool = False,
    use_ema: bool = False,
    device=None,
    **flag_overrides,
) -> Union[MLAPolicy, Tuple[Dict[str, Any], Dict[str, Any], Any, Dict]]:
    """Build an MLA policy on `device` (None: the card; raises without one
    unless device="cpu") from a run dir or a checkpoint path. The model is
    `model_id`, else the run's recorded base_vlm, else mla-7b (a bare .pt),
    with the run's recorded model flags and `flag_overrides`. With
    load_for_training=True returns (params, state, cfg, norm_stats) instead
    of a policy."""
    path = Path(checkpoint_or_run_dir)
    run_dir = path if path.is_dir() else path.parent.parent
    norm_stats = _read_json(run_dir / "dataset_statistics.json") or {}
    run_config = _read_json(run_dir / "config.json") or {}

    flags = {}
    cfg_src = run_config.get("train", run_config)
    for k in _MODEL_FLAG_KEYS:
        if isinstance(cfg_src, dict) and k in cfg_src:
            flags[k] = cfg_src[k]
    flags.update(flag_overrides)
    if model_id is None:
        # run dirs record the model under train.base_vlm (the trainer's
        # config dump); a bare reference .pt defaults to the 7B flagship
        recorded = cfg_src.get("base_vlm") if isinstance(cfg_src, dict) else None
        model_id = recorded if recorded in MODEL_REGISTRY else "mla-7b"
    cfg = get_model_config(model_id, **flags)
    device = _resolve_device(device)

    ckpt_path = _resolve_checkpoint(path)
    if use_ema and (ckpt_path is None or ckpt_path.suffix == ".pt"):
        raise ValueError(f"use_ema=True needs a full train-state checkpoint (the port's {STATE_FILE}) with "
                         f"ema_params; got {ckpt_path} (reference-format .pt checkpoints carry no EMA state)")
    if ckpt_path is not None and ckpt_path.suffix != ".pt" and not (ckpt_path / STATE_FILE).exists():
        raise ValueError(
            f"{ckpt_path} is a JAX orbax checkpoint, which the port cannot read without JAX; write it out with "
            f"the JAX package's mla_tpu.training.checkpointing.export_reference_pt and pass that .pt")
    params, state = P.init(cfg, seed=0, device=device)
    if ckpt_path is None:
        overwatch.warning(f"no checkpoint found under {path}; random init")
    elif ckpt_path.suffix == ".pt":
        overwatch.info(f"loading reference-format checkpoint {ckpt_path}")
        params, state = convert.load_reference_checkpoint(ckpt_path, cfg, base_params=params, base_state=state,
                                                          device=device)
        dt = cfg.llama.param_dtype
        params = P.tree_map(lambda x: x.to(dt) if x.is_floating_point() else x, params)
    else:
        overwatch.info(f"loading checkpoint {ckpt_path}")
        _load_port_checkpoint(ckpt_path, params, state, use_ema)

    if load_for_training:
        return params, state, cfg, norm_stats
    return MLAPolicy(params, state, cfg, tokenizer=tokenizer, norm_stats=norm_stats, device=device)
