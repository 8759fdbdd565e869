"""One rank of tests/test_torch_distributed.py: the port's sharded train step
over gloo on CPU processes.

    python tests/torch_distributed_child.py WORKDIR

The launch comes from the environment (torchrun's RANK / WORLD_SIZE /
MASTER_ADDR / MASTER_PORT or MLA_COORDINATOR_ADDRESS / MLA_NUM_PROCESSES /
MLA_PROCESS_ID), as `python -m mla_tpu_torch.train` reads it. WORKDIR holds
inputs.pt, written by the test: the mla-tiny weights and batch-norm state,
the global batch, and the scenarios (optimizer, accumulation, loss mode,
the global draws of every step and micro-batch, reductions kept local as
controls, checkpoint save / load). Each scenario trains from the same
weights over make_mesh(dp=...); rank 0 writes result-<world>.pt: per
scenario the metrics of every step, the whole masters after the last step
(gathered like a checkpoint), with keep_opt_state the optimizer state,
and every rank's optimizer bytes. A control
keeps its reductions rank-local by patching collectives.active in this
process; the reduce-scatter control keeps each rank's own gradient by
patching parallel/tensor.reduce_scatter. Per step it also records the gather counts
(parallel/fsdp.counts) and every rank's layer-stack bytes
(ShardedState.layer_bytes). At world size 2 each rank also reads its shard of the rlbench
fixture's episodes (`rlds_root`), and runs the train-time transforms on
the same trajectories (`draw_trajs`, train_time_draws).
"""

import copy
import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mla_tpu_torch.conf.models import get_model_config  # noqa: E402
from mla_tpu_torch.diffusion import gaussian as gd  # noqa: E402
from mla_tpu_torch.parallel import collectives, fsdp, sharding, tensor  # noqa: E402
from mla_tpu_torch.parallel.mesh import initialize_distributed, make_mesh  # noqa: E402
from mla_tpu_torch.params import tree_items, tree_map  # noqa: E402
from mla_tpu_torch.training import checkpointing, optim, strategy  # noqa: E402

DRAW_SEED, DRAW_IMAGE = 7, 32


def run_scenario(sc, inputs, mesh, rank, world, workdir):
    import torch.distributed as dist

    cfg = get_model_config("mla-tiny", use_diff=sc["use_diff"])
    params = tree_map(lambda t: t.clone(), inputs["params"])
    mstate = tree_map(lambda t: t.clone(), inputs["model_state"])
    opt, _, _ = optim.make_optimizer(params, **sc["opt"])
    tcfg = strategy.TrainConfig(grad_accumulation_steps=sc["accum"], repeated_diffusion_steps=sc["rep"],
                                enable_gradient_checkpointing=True, ema_decay=0.9)
    state = strategy.init_train_state(params, opt, mstate, use_ema=sc.get("ema", False), mesh=mesh)
    step = strategy.make_train_step(cfg, tcfg, gd.create_schedule("", diffusion_steps=100))
    if sc.get("load"):
        state = checkpointing.load_checkpoint(checkpointing.latest_checkpoint(workdir / sc["load"]), state)
    batch = sharding.shard_batch(inputs["batch_ar" if not sc["use_diff"] else "batch"], rank, world, sc["accum"])
    local, active, scatter = set(sc.get("local", ())), collectives.active, tensor.reduce_scatter
    collectives.active = lambda what: None if what in local else active(what)
    if "reduce_scatter" in local:  # each rank keeps its own gradient's segment
        tensor.reduce_scatter = lambda flat, g: flat.chunk(dist.get_world_size(g))[dist.get_rank(g)].clone()
    metrics, gathers = [], []
    try:
        for i, draws in enumerate(sc["draws"]):
            fsdp.reset_counts()
            state, m = step(state, batch, draws=draws)
            gathers.append(dict(fsdp.counts))
            metrics.append({k: float(v) for k, v in m.items()})
            if sc.get("save_after") == i + 1:
                checkpointing.save_checkpoint(workdir / sc["save"], state, step=i + 1,
                                              loss=metrics[-1]["total_loss"])
    finally:
        collectives.active, tensor.reduce_scatter = active, scatter
    blob = state["shards"].host_state(state)
    nbytes, layers = [None] * world, [None] * world
    dist.all_gather_object(nbytes, state["shards"].optimizer_bytes())
    dist.all_gather_object(layers, state["shards"].layer_bytes(state["params"]))
    if rank == 0:
        out = {"metrics": metrics, "params": dict(tree_items(blob["params"])), "opt_bytes": nbytes,
               "ema": dict(tree_items(blob.get("ema_params", {}))), "gathers": gathers, "layer_bytes": layers,
               "num_layers": cfg.llama.num_layers}
        if sc.get("keep_opt_state"):  # the moments only where a test reads them (the checkpoint's)
            out["opt_state"] = blob["opt_state"]
        return out
    return None


def read_shard(root):
    from mla_tpu_torch.vla.rlds.dataset import make_dataset_from_rlds

    ds, _ = make_dataset_from_rlds("rlbench", str(root), train=True, shuffle=True, load_pointcloud=True,
                                   stats_cache_dir=str(Path(root) / "stats"))
    return [traj["action"] for traj in ds]


def train_time_draws(trajs, stats):
    """The train-time transforms on the given trajectories (the same on
    every rank): goal relabelling, task augmentation and subsampling, then
    the frames' augmentation, all from DRAW_SEED. -> (each trajectory's
    subsampled actions and goal image, each frame's augmented image)."""
    from mla_tpu_torch.vla.rlds import dataset as rds
    from mla_tpu_torch.vla.rlds.stream import Dataset

    trajs = copy.deepcopy(trajs)  # the transforms extend the dicts they are given
    ds = rds.apply_trajectory_transforms(
        Dataset(lambda: iter(trajs)), train=True, goal_relabeling_strategy="uniform",
        task_augment_strategy="delete_task_conditioning", task_augment_kwargs={"keep_image_prob": 0.5},
        subsample_length=3, dataset_statistics=stats, num_parallel_calls=1, seed=DRAW_SEED)
    out = list(ds)
    frames = rds.apply_frame_transforms(rds.flatten_to_frames(Dataset(lambda: iter(out))), train=True, augment=True,
                                        image_size=DRAW_IMAGE, num_parallel_calls=1, seed=DRAW_SEED)
    goals = [{k: v for k, v in t["task"].items() if k.startswith("image_")} for t in out]
    return {"actions": [t["action"] for t in out], "goals": goals,
            "frames": [f["observation"]["image_primary"] for f in frames]}


def main():
    import torch.distributed as dist

    torch.set_num_threads(1)
    workdir = Path(sys.argv[1])
    launch = initialize_distributed("cpu")
    rank, world = launch["rank"], launch["world"]
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    out = {"scenarios": {}}
    for sc in inputs["scenarios"]:
        if world not in sc["worlds"]:
            continue
        mesh = make_mesh(dp=sc["dp"][world])
        res = run_scenario(sc, inputs, mesh, rank, world, workdir)
        if rank == 0:
            out["scenarios"][sc["name"]] = res
    if inputs.get("rlds_root") and world == 2:
        shards = [None] * world
        dist.all_gather_object(shards, read_shard(inputs["rlds_root"]))
        out["rlds_shards"] = shards
        by_rank = [None] * world
        dist.all_gather_object(by_rank, train_time_draws(inputs["draw_trajs"], inputs["draw_stats"]))
        out["draws_by_rank"] = by_rank
    if rank == 0:
        out["mesh"] = {"dp": mesh.dp, "fsdp": mesh.fsdp, "tp": mesh.tp}
        torch.save(out, workdir / f"result-{world}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
