"""The process world and its mesh of process groups.

Counterpart of mla_tpu/parallel/mesh.py. One process drives one card (or,
with device cpu, one CPU process); torchrun or the JAX package's variables
say how many there are:

  * torchrun's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT;
  * MLA_COORDINATOR_ADDRESS (host:port), MLA_NUM_PROCESSES, MLA_PROCESS_ID.

`initialize_distributed` joins that world (NCCL on cuda:LOCAL_RANK, gloo for
device cpu). A partial set of either raises: a half-configured launch would
otherwise train N unsynchronized single-process replicas. `make_mesh`
splits the world as JAX's ('dp', 'fsdp', 'tp') mesh does: rank
(d * fsdp + f) * tp + t, tp innermost. The trainable leaves (weights,
gradients and optimizer state) are sharded over 'fsdp' and replicated
over 'dp' (a replica group: the dp ranks that share an fsdp and a tp
index); the global batch splits over both: the
dp * fsdp ranks that share a tp index form a data group (data rank
dp_rank * fsdp + fsdp_rank), and the ranks of one tp group, which are
consecutive, see the same rows. The port trains over such a mesh
(training/strategy.py) and serves over tp composed with fsdp
(`serving_mesh`: dp = 1; parallel/tensor.py, parallel/fsdp.py). The
trainers hand the data pipeline the mesh's data rank and data world, so
the ranks of a tp group read, shuffle and augment the same frames. A
serving host over a mesh is led by rank 0, which sends each call to the
others over a `Channel` (serving.lead, serving.follow).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_MLA = ("MLA_COORDINATOR_ADDRESS", "MLA_NUM_PROCESSES", "MLA_PROCESS_ID")


def _launch_env(env: Dict[str, str]) -> Optional[Dict[str, Any]]:
    """{'rank', 'world', 'local_rank', 'init_method'} from the environment,
    None when neither set of variables is there; a partial set raises."""
    for names in (_TORCHRUN, _MLA):
        have = [n for n in names if env.get(n)]
        if have and len(have) != len(names):
            missing = [n for n in names if n not in have]
            raise RuntimeError(f"partial distributed environment: {have} set but {missing} missing")
    if env.get("RANK"):
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        addr = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    elif env.get("MLA_PROCESS_ID"):
        rank, world = int(env["MLA_PROCESS_ID"]), int(env["MLA_NUM_PROCESSES"])
        addr = f"tcp://{env['MLA_COORDINATOR_ADDRESS']}"
    else:
        return None
    if not 0 <= rank < world:
        raise RuntimeError(f"rank {rank} outside a world of {world}")
    return {"rank": rank, "world": world, "local_rank": int(env.get("LOCAL_RANK", rank)), "init_method": addr}


def initialize_distributed(device: str = "cuda", env: Optional[Dict[str, str]] = None,
                           backend: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Join the launch's process group, once. Returns {'rank', 'world',
    'local_rank', 'device'}, or None for a plain single-process run (no
    variables set). With device cuda the process binds cuda:LOCAL_RANK;
    backend None means NCCL there and gloo with device cpu. Only a caller
    that names it gets gloo for CUDA tensors (ranks that share one card,
    which NCCL refuses; parallel/tensor.py stages their collectives through
    the host)."""
    import torch.distributed as dist

    launch = _launch_env(dict(os.environ) if env is None else env)
    if launch is None:
        return None
    if device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to train on the CPU")
        dev = torch.device("cuda", launch["local_rank"] % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    else:
        dev, backend = torch.device("cpu"), backend or "gloo"
    if not dist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=launch["init_method"], rank=launch["rank"],
                                world_size=launch["world"], **kw)
    return {**{k: launch[k] for k in ("rank", "world", "local_rank")}, "device": dev}


@dataclass
class Mesh:
    """The ('dp', 'fsdp', 'tp') split of the world and this rank's groups:
    `group` spans the world, `data_group` the dp * fsdp ranks that share
    this rank's tp index (the global batch; the world itself at tp 1),
    `fsdp_group` the ranks that share this rank's dp and tp indices (a
    part of every trainable leaf each, gathered layer by layer:
    parallel/fsdp.py), `replica_group` the dp ranks that share this
    rank's fsdp and tp indices (they hold the same parts; None at dp 1),
    `tp_group` the tp consecutive ranks that hold the parts of one
    tensor-parallel model. Groups are None without a process group (a
    one-process mesh)."""

    dp: int
    fsdp: int
    tp: int
    rank: int
    group: Any = None
    fsdp_group: Any = None
    tp_group: Any = None
    data_group: Any = None
    replica_group: Any = None

    @property
    def world(self) -> int:
        return self.dp * self.fsdp * self.tp

    @property
    def data_world(self) -> int:
        """The ranks the global batch splits over: dp * fsdp."""
        return self.dp * self.fsdp

    @property
    def data_rank(self) -> int:
        """This rank's block of the global batch, dp_rank * fsdp +
        fsdp_rank (the same for the ranks of a tp group)."""
        return self.dp_rank * self.fsdp + self.fsdp_rank

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def fsdp_rank(self) -> int:
        return (self.rank // self.tp) % self.fsdp

    @property
    def dp_rank(self) -> int:
        return self.rank // (self.fsdp * self.tp)

    def fsdp_peer(self, fsdp_rank: int) -> int:
        """The global rank of fsdp rank `fsdp_rank` of this rank's fsdp
        group."""
        return (self.dp_rank * self.fsdp + fsdp_rank) * self.tp + self.rank % self.tp


def fsdp_ranks(dp: int, fsdp: int, tp: int) -> List[List[int]]:
    """The ranks of each fsdp group (one per dp and tp index), in JAX's
    devices.reshape(dp, fsdp, tp) order."""
    return [[(d * fsdp + f) * tp + t for f in range(fsdp)] for d in range(dp) for t in range(tp)]


def tp_ranks(dp: int, fsdp: int, tp: int) -> List[List[int]]:
    """The ranks of each tp group: rank (d * fsdp + f) * tp + t, t = 0 ..
    tp - 1, consecutive."""
    return [[(d * fsdp + f) * tp + t for t in range(tp)] for d in range(dp) for f in range(fsdp)]


def replica_ranks(dp: int, fsdp: int, tp: int) -> List[List[int]]:
    """The ranks of each replica group (one per fsdp and tp index), in dp
    order."""
    return [[(d * fsdp + f) * tp + t for d in range(dp)] for f in range(fsdp) for t in range(tp)]


def data_ranks(dp: int, fsdp: int, tp: int) -> List[List[int]]:
    """The ranks of each data group (one per tp index), in data-rank
    order."""
    return [[(d * fsdp + f) * tp + t for d in range(dp) for f in range(fsdp)] for t in range(tp)]


def make_mesh(dp: int = 1, fsdp: Optional[int] = None, tp: int = 1, world: Optional[int] = None) -> Mesh:
    """JAX's make_mesh over the processes: all of them to fsdp by default
    (fsdp = world / (dp * tp)), dp * fsdp * tp must equal the world. With a
    process group every rank must call this, in the same order (it makes
    the groups: the fsdp groups, then, for tp > 1, the tp groups and the
    data groups, then, for dp > 1, the replica groups)."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    n = world if world is not None else (dist.get_world_size() if live else 1)
    if fsdp is None:
        if n % (dp * tp) != 0:
            raise ValueError(f"{n} processes not divisible by dp*tp={dp * tp}")
        fsdp = n // (dp * tp)
    if dp * fsdp * tp != n:
        raise ValueError(f"dp*fsdp*tp={dp * fsdp * tp} != {n} processes")
    if not live:
        return Mesh(dp, fsdp, tp, rank=0)
    rank = dist.get_rank()
    # tp 1: no tp groups, the world is the data group; dp 1: no replicas
    mine = {"tp": None, "data": dist.group.WORLD, "replica": None}
    split = tp > 1
    for kind, groups in (("fsdp", fsdp_ranks(dp, fsdp, tp)), ("tp", tp_ranks(dp, fsdp, tp) if split else []),
                         ("data", data_ranks(dp, fsdp, tp) if split else []),
                         ("replica", replica_ranks(dp, fsdp, tp) if dp > 1 else [])):
        for ranks in groups:
            g = dist.new_group(ranks)  # every rank makes every group, in order
            if rank in ranks:
                mine[kind] = g
    return Mesh(dp, fsdp, tp, rank=rank, group=dist.group.WORLD, fsdp_group=mine["fsdp"], tp_group=mine["tp"],
                data_group=mine["data"], replica_group=mine["replica"])


def distinct_cards(device: torch.device) -> int:
    """The cards the world's ranks run on, each counted once (ranks that
    share a card, as a tp group over gloo on one card does, count it
    once): (host, card UUID) gathered from every rank; 1 off the card or
    without a process group."""
    import socket

    import torch.distributed as dist

    if torch.device(device).type != "cuda" or not (dist.is_available() and dist.is_initialized()):
        return 1
    mine = (socket.gethostname(), str(torch.cuda.get_device_properties(device).uuid))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return len(set(every))


def serving_mesh(fsdp: int = 1) -> Mesh:
    """The mesh a policy serves over: dp = 1, `fsdp` ranks that each hold
    a part of every leaf (gathered per use, parallel/fsdp.py), and the
    world // fsdp consecutive ranks of each tp group (make_mesh's rank
    layout, as training's). fsdp 1 is the whole world as one tp group
    (a mesh with dp beside tp or fsdp is refused by the policy, citing
    ROADMAP item 16 (g)). Raises unless fsdp divides the world."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if fsdp < 1 or world % fsdp:
        raise ValueError(f"fsdp {fsdp} does not divide a world of {world} processes")
    return make_mesh(dp=1, fsdp=fsdp, tp=world // fsdp, world=world)


class Channel:
    """Rank 0 of a mesh to the other ranks, over the world group: rank 0
    `send`s each call (a picklable message: the call's name and its host
    rows, seed and step counts), in order; the others `recv` them in the
    same order and run them. `close` sends None, which releases them. A
    send after a failed call raises: a call that failed on rank 0 alone
    after its message went out may have left the ranks' collectives out
    of step."""

    def __init__(self, mesh: Mesh):
        self.group, self.rank = mesh.group, mesh.rank
        self.broken: Optional[BaseException] = None

    def _broadcast(self, msg: Any) -> Any:
        import torch.distributed as dist

        box = [msg]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def send(self, msg: Any) -> None:
        if self.rank != 0:
            raise RuntimeError(f"rank {self.rank} sends nothing: rank 0 leads the mesh")
        if self.broken is not None:
            raise RuntimeError("an earlier call failed after its message was sent; the mesh's ranks may be out "
                               f"of step: {self.broken!r}")
        self._broadcast(msg)

    def recv(self) -> Any:
        """The next message of rank 0 (None: closed)."""
        return self._broadcast(None)

    def close(self) -> None:
        if self.rank == 0 and self.broken is None:
            self._broadcast(None)
