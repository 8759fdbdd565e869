"""One rank of a tensor-parallel group for tests/test_torch_tp_serving.py,
and the scenarios both sides run.

    python tests/torch_tp_child.py WORKDIR

Each child joins a gloo group from the MLA_* variables (parallel/mesh.py),
serves every scenario of WORKDIR/inputs.pt that its world size takes
through an MLAPolicy over parallel/mesh.serving_mesh(), and writes
WORKDIR/out_w{world}_r{rank}.pt. A world of one is the one-process policy
(a mesh of tp 1), which runs every scenario but the controls. A world of
more than one also serves FSDP_SCENARIOS over serving_mesh(fsdp=2) (tp 1
x fsdp 2 at world 2, tp 2 x fsdp 2 at world 4): each call's outputs, its
layer gathers and most whole layers alive (parallel/fsdp.counts), and
each policy's layer-stack bytes, under 'fsdp'.

A scenario names a tree ('fp32', 'bf16', 'int8', 'wide_int8', 'gqa_int8'),
an int8_mode, a call ('diff' with a sampler, or 'ar': generate_ids of the
action tokens) and, for a control, the collective it disables:
'local_max' (W8A8's all-reduce MAX of the row scale: each rank quantizes
from its own slice's max) or 'skip_reduce' (the row-parallel all-reduce
SUM).
"""

from __future__ import annotations

import contextlib
import math
import sys
from pathlib import Path

import numpy as np
import torch

SCENARIOS = {
    # name: (tree, int8_mode, call, sampler, worlds, control)
    "fp32-ddim": ("fp32", "w8a8", "diff", "ddim", (2, 4), None),
    "fp32-dpm": ("fp32", "w8a8", "diff", "dpm", (2, 4), None),
    "bf16-ddim": ("bf16", "w8a8", "diff", "ddim", (2, 4), None),
    "w8a8-ddim": ("int8", "w8a8", "diff", "ddim", (2, 4), None),
    "w8a8-dpm": ("int8", "w8a8", "diff", "dpm", (2, 4), None),
    "weight_only-ddim": ("wide_int8", "weight_only", "diff", "ddim", (2, 4), None),
    "weight_only-ar": ("wide_int8", "weight_only", "ar", None, (2, 4), None),
    "gqa-w8a8-ddim": ("gqa_int8", "w8a8", "diff", "ddim", (2,), None),
    "control-local_max": ("int8", "w8a8", "diff", "ddim", (2, 4), "local_max"),
    "control-skip_reduce": ("int8", "w8a8", "diff", "ddim", (2, 4), "skip_reduce"),
    "control-wo-skip_reduce": ("wide_int8", "weight_only", "ar", None, (2, 4), "skip_reduce"),
}
AR_TOKENS = 7
# over serving_mesh(fsdp=2); the control's gather zeroes the other fsdp
# rank's segment on global rank 0
FSDP_SCENARIOS = {name: SCENARIOS[name][:4] + (None,) for name in ("fp32-ddim", "w8a8-ddim", "w8a8-dpm",
                                                                   "weight_only-ar")}
FSDP_SCENARIOS["control-fsdp-zero_peer"] = SCENARIOS["w8a8-ddim"][:4] + ("zero_peer",)


@contextlib.contextmanager
def control(name):
    """Disable one collective of parallel/tensor.py inside the block."""
    from mla_tpu_torch.parallel import tensor

    attr = {"local_max": "all_reduce_max", "skip_reduce": "reduce_from_tp", None: None}[name]
    if attr is None:
        yield
        return
    real = getattr(tensor, attr)
    setattr(tensor, attr, lambda x: x)
    try:
        yield
    finally:
        setattr(tensor, attr, real)


# the int8 trees: the port's quantize_model of these float trees
QUANTIZED = {"int8": "fp32", "wide_int8": "wide", "gqa_int8": "gqa"}


def trees(inputs):
    """{tree name: (params, state, cfg)} of the port: the float trees of
    inputs.pt and their int8 trees."""
    from mla_tpu_torch.ops import quantization as tq

    out = dict(inputs["trees"])
    for name, src in QUANTIZED.items():
        params, state, cfg = out[src]
        out[name] = (tq.quantize_model(params), state, cfg)
    return out


def run_scenarios(inputs, mesh, world: int):
    """{scenario: output} for the scenarios of this world size: a diffusion
    chunk [16, 7] (normalized), or the AR ids and max probabilities."""
    from mla_tpu_torch.models import mla

    req = inputs["request"]
    built = trees(inputs)
    policies, out = {}, {}
    for name, (tree, mode, call, sampler, worlds, ctrl) in SCENARIOS.items():
        if (world == 1 and ctrl is not None) or (world > 1 and world not in worlds):
            continue
        if (tree, mode) not in policies:
            params, state, cfg = built[tree]
            policies[(tree, mode)] = mla.MLAPolicy(params, state, cfg, norm_stats=inputs["stats"], device="cpu",
                                                   int8_mode=mode, mesh=mesh)
        pol = policies[(tree, mode)]
        with control(ctrl):
            if call == "diff":
                out[name] = pol.predict_action_diff(req["img"], req["pc"], "", input_ids=req["ids"],
                                                    noise=req["noise"], sampler=sampler, return_normalized=True)
            else:
                out[name] = pol.generate_ids(req["img"], req["pc"], req["ids"], AR_TOKENS)
    return out


@contextlib.contextmanager
def zero_peer(mesh, on: bool):
    """Inside the block (with `on`, on global rank 0) the fsdp gathers hand
    back the other fsdp rank's segment zeroed."""
    from mla_tpu_torch.parallel import fsdp

    real = fsdp.tp_mod.all_gather
    if not on or mesh.rank != 0:
        yield
        return

    def broken(t, g, dim=0):
        out = real(t, g, dim)
        if g is mesh.fsdp_group:
            n = out.shape[0] // mesh.fsdp
            peer = (mesh.fsdp_rank + 1) % mesh.fsdp
            out[peer * n:(peer + 1) * n] = 0
        return out

    fsdp.tp_mod.all_gather = broken
    try:
        yield
    finally:
        fsdp.tp_mod.all_gather = real


def one_process_stack(params, cfg, mode: str) -> int:
    """The bytes of the one-process policy's fused layer stack."""
    from mla_tpu_torch.models import llama
    from mla_tpu_torch.params import tree_items

    fused = llama.fuse_for_serving(params["llm_backbone"], k_major=mode == "w8a8")
    return sum(t.numel() * t.element_size() for _, t in tree_items(fused["layers"]))


def run_fsdp_scenarios(inputs, mesh) -> dict:
    """FSDP_SCENARIOS over `mesh` (fsdp > 1): {'mesh', 'outputs', 'counts',
    'layer_bytes'}; layer_bytes per tree and mode: this rank's parts, the
    rank's whole (tp-local, fused) stack, the largest stacked leaf owned
    whole, the bytes of the stack's leaves each tp rank holds whole
    ('tp_whole') and the one-process stack ('one_process')."""
    from mla_tpu_torch.models import mla
    from mla_tpu_torch.parallel import fsdp
    from mla_tpu_torch.parallel.sharding import serving_tp_dim

    req = inputs["request"]
    built = trees(inputs)
    policies, out = {}, {"mesh": {"tp": mesh.tp, "fsdp": mesh.fsdp, "tp_rank": mesh.tp_rank,
                                  "fsdp_rank": mesh.fsdp_rank}, "outputs": {}, "counts": {}, "layer_bytes": {}}
    for name, (tree, mode, call, sampler, ctrl) in FSDP_SCENARIOS.items():
        key = f"{tree}-{mode}"
        if key not in policies:
            params, state, cfg = built[tree]
            pol = policies[key] = mla.MLAPolicy(params, state, cfg, norm_stats=inputs["stats"], device="cpu",
                                                int8_mode=mode, mesh=mesh)
            held = pol.gatherer.layer_bytes()
            held["tp_whole"] = sum(math.prod(leaf.shape) * leaf.dtype.itemsize for leaf in pol.gatherer.leaves
                                   if leaf.path.startswith(fsdp.LAYERS)
                                   and serving_tp_dim(leaf.path, len(leaf.shape), pol.tp_split) is None)
            held["one_process"] = one_process_stack(params, cfg, mode)
            out["layer_bytes"][key] = held
        pol = policies[key]
        fsdp.reset_counts()
        with zero_peer(mesh, ctrl == "zero_peer"):
            if call == "diff":
                out["outputs"][name] = pol.predict_action_diff(req["img"], req["pc"], "", input_ids=req["ids"],
                                                               noise=req["noise"], sampler=sampler,
                                                               return_normalized=True)
            else:
                out["outputs"][name] = tuple(np.asarray(x) for x in pol.generate_ids(req["img"], req["pc"],
                                                                                      req["ids"], AR_TOKENS))
        out["counts"][name] = dict(fsdp.counts, num_layers=pol.cfg.llama.num_layers)
    return out


def tensor_ops(group, rank: int, world: int) -> dict:
    """parallel/tensor.py's operations over `group`, forward and backward,
    on inputs every rank draws alike (rank r's own: row r of them)."""
    from mla_tpu_torch.parallel import tensor

    g = torch.Generator().manual_seed(0)
    x = torch.randn(world, 3, 4, generator=g)
    up = torch.randn(world, 3, 4 * world, generator=g)  # each rank's upstream gradient
    table = torch.randn(8 * world, 5, generator=g)
    ids = torch.tensor([[0, 8 * world - 1, 3, 8], [5, 9, 8 * world - 2, 1]])
    out = {}
    with tensor.tp_group(group):
        for name, fn, width in (("reduce", tensor.reduce_from_tp, 4), ("copy", tensor.copy_to_tp, 4),
                                ("gather", tensor.gather_from_tp, 4 * world)):
            xr = x[rank].clone().requires_grad_()
            y = fn(xr)
            y.backward(up[rank][:, :width])
            out[name], out[f"{name}_grad"] = y.detach().numpy(), xr.grad.numpy()
        out["max"] = tensor.all_reduce_max(x[rank, 0]).numpy()
        n = table.shape[0] // world
        out["embed"] = tensor.vocab_parallel_embedding(table[rank * n:(rank + 1) * n], ids).numpy()
    return out


def main(workdir: Path) -> None:
    from mla_tpu_torch.parallel import mesh as tmesh

    torch.set_num_threads(1)
    launch = tmesh.initialize_distributed("cpu")
    mesh = tmesh.serving_mesh()
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    out = run_scenarios(inputs, mesh, launch["world"])
    if launch["world"] > 1:
        out["tensor_ops"] = tensor_ops(mesh.tp_group, launch["rank"], launch["world"])
        out["fsdp"] = run_fsdp_scenarios(inputs, tmesh.serving_mesh(fsdp=2))
    torch.save({k: v if isinstance(v, dict) else tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                else np.asarray(v) for k, v in out.items()}, workdir / f"out_w{launch['world']}_r{launch['rank']}.pt")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    main(Path(sys.argv[1]))
