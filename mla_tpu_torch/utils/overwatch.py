"""Overwatch: rank-gated logging.

Counterpart of mla_tpu/utils/overwatch.py. The rank comes from
torch.distributed when a process group is initialized, else it is 0 of 1.

Usage:
    overwatch = initialize_overwatch(__name__)
    overwatch.info("...")                 # INFO on rank 0, ERROR-only elsewhere
    if overwatch.is_rank_zero(): ...
"""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s >> %(message)s"
_DATEFMT = "%m/%d %H:%M:%S"
_ROOT = "mla_tpu_torch"


def _configure_root() -> None:
    root = logging.getLogger(_ROOT)
    if any(getattr(h, "overwatch", False) for h in root.handlers):
        return
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
    handler.overwatch = True
    root.addHandler(handler)
    root.propagate = False


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class Overwatch:
    """Rank-0-gated logger: INFO+ on rank 0, ERROR+ on the other ranks. The
    rank is read at the first log call, since modules make their logger when
    imported, before any process group exists."""

    def __init__(self, name: str) -> None:
        _configure_root()
        self.logger = logging.getLogger(name if name.startswith(_ROOT) else f"{_ROOT}.{name}")
        self._level_set = False

    def _ensure_level(self) -> None:
        if not self._level_set:
            self.logger.setLevel(logging.INFO if self.is_rank_zero() else logging.ERROR)
            self._level_set = True

    def is_rank_zero(self) -> bool:
        return process_index() == 0

    def info(self, msg: str, *args, **kwargs) -> None:
        self._ensure_level()
        self.logger.info(msg, *args, **kwargs)

    def warning(self, msg: str, *args, **kwargs) -> None:
        self._ensure_level()
        self.logger.warning(msg, *args, **kwargs)


def initialize_overwatch(name: str) -> Overwatch:
    return Overwatch(name)
