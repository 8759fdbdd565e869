"""One rank of tests/test_torch_tp_train.py: the port's train step over a
mesh with a tp axis, over gloo on CPU processes; or, with --jax NAME, the
JAX package's one-device step of a scenario (SPEC: its JSON).

    python tests/torch_tp_train_child.py WORKDIR            # a rank
    python tests/torch_tp_train_child.py WORKDIR --jax SPEC  # JAX's step

A rank reads its launch from torchrun's variables, as `python -m
mla_tpu_torch.train` does. WORKDIR holds inputs.pt, written by the test:
the weights of each model variant (CONFIGS: mla-tiny, a GQA mla-tiny with
2 kv heads),
the global batches and the scenarios (variant, optimizer, accumulation,
loss mode, the global draws of every step and micro-batch, the meshes
(world, dp, tp) to run at, a checkpoint save at one of them or a load, a
control that skips copy_to_tp's backward all-reduce). Rank 0 writes
result-<world>.pt: per scenario and mesh the metrics of every step, the
shapes rank 0 computes with (its gathered leaves), every rank's
layer-stack bytes, and the whole masters after the last step (gathered like a checkpoint; the
EMA and the optimizer state too where a scenario keeps an EMA or loads a
checkpoint); Adafactor's two steps on the FACTORED leaves from seeded
gradients at each mesh of the world; each rank's data rank, data world
and data seeds at tp 2; at world 2 also the vocab-parallel cross-entropy
against causal_lm_loss with its gradient. The JAX mode writes
jax-<name>.pt: JAX's metrics and parameters after the scenario's steps on
the whole global batch, and with Adafactor its second moments.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

# model variants: LlamaConfig fields replaced on mla-tiny (4 layers, 4 heads
# of 16, hidden 64) in both packages
CONFIGS = {"tiny": {}, "gqa": {"num_kv_heads": 2}}
# leaves under JAX's tp rules whose Adafactor moments are factored, each
# tp-split dim one of the two factored dims: q and the embedding split on
# the larger (v_row reduces over the tp dim), o on the smaller (v_col and
# v_row's mean), down's local order of its two largest dims flipped at tp 2
FACTORED = {"llm_backbone/layers/attn/q/w": (2, 256, 256), "llm_backbone/layers/attn/o/w": (2, 256, 256),
            "llm_backbone/layers/mlp/down/w": (2, 384, 256), "llm_backbone/embed/table": (1024, 256),
            "llm_backbone/final_ln/scale": (256,)}
B, REP, SEED = 8, 2, 0


def variant(get_model_config, name: str, use_diff: bool = True):
    cfg = get_model_config("mla-tiny", use_diff=use_diff)
    return dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama, **CONFIGS[name]))


def jax_model(name: str):
    """JAX (params, state) of a variant, with a live head (as
    torch_policy_parity.model makes mla-tiny's)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mla_tpu.conf.models import get_model_config
    from mla_tpu.models import prismatic

    cfg = variant(get_model_config, name)
    params, state = prismatic.mla_model_init(jax.random.PRNGKey(SEED), cfg)
    rng = np.random.default_rng(SEED + 100)
    fc2 = params["final_layer"]["mlp"]["fc2"]
    fc2["w"] = jnp.asarray(rng.normal(size=fc2["w"].shape).astype(np.float32) * 0.05)
    params["z_embedder"]["uncondition"] = jnp.asarray(rng.normal(size=(1, cfg.token_size)).astype(np.float32))
    return params, state


def global_batch(use_diff: bool):
    """tests/test_torch_distributed.py's global batch of B rows: for the AR
    loss mode some rows' action labels are ignored, so the data ranks hold
    different counts."""
    from torch_train_parity import batch

    b = batch(B)
    if not use_diff:
        labels = b["labels"].copy()
        labels[: B // 2, 7:13] = -100
        b = {**b, "labels": labels}
    return b


def jax_reference(workdir: Path, spec: dict) -> None:
    """JAX's one-device step of a scenario, from its spec alone (so it
    starts before the test has written the inputs): variant, optimizer
    settings, accumulation, loss mode and the step keys' seeds."""
    import jax
    import jax.numpy as jnp

    from mla_tpu.conf.models import get_model_config
    from mla_tpu.diffusion import gaussian as jgd
    from mla_tpu.training import optim as joptim
    from mla_tpu.training import strategy as jstrategy
    from mla_tpu_torch.params import from_jax, tree_items

    params, mstate = jax_model(spec["config"])
    cfg = variant(get_model_config, spec["config"], spec["use_diff"])
    tx, _, _ = joptim.make_optimizer(params, **spec["opt"])
    tcfg = jstrategy.TrainConfig(grad_accumulation_steps=spec["accum"], repeated_diffusion_steps=REP,
                                 enable_gradient_checkpointing=True)
    step = jstrategy.make_train_step(cfg, tcfg, tx, jgd.create_schedule("", diffusion_steps=100))
    st = jstrategy.init_train_state(params, tx, mstate)
    jb = jax.tree_util.tree_map(jnp.asarray, global_batch(spec["use_diff"]))
    metrics = []
    for seed in spec["keys"]:
        st, m = step(st, jb, jax.random.PRNGKey(seed))
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "params": dict(tree_items(from_jax(jax.device_get(st["params"]))))}
    if spec["opt"].get("optimizer") == "adafactor":
        out["moments"] = jax_moments(st["opt_state"])
    torch.save(out, workdir / f"jax-{spec['name']}.pt")


def jax_moments(opt_state) -> dict:
    """{path: {'v_row', 'v_col'} of a factored leaf, or {'v'}} from the
    FactoredState in a JAX Adafactor chain's state (optax keeps a (1,)
    placeholder for the moments a leaf does not use)."""
    import jax
    from optax._src.factorized import FactoredState

    (fs,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, FactoredState))
             if isinstance(s, FactoredState)]
    out: dict = {}
    for name in ("v_row", "v_col", "v"):
        for keys, v in jax.tree_util.tree_flatten_with_path(getattr(fs, name))[0]:
            if getattr(v, "shape", (1,)) != (1,):
                path = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in keys)
                out.setdefault(path, {})[name] = torch.from_numpy(np.array(jax.device_get(v)))
    return out


def run_scenario(sc, inputs, mesh, workdir):
    import torch.distributed as dist

    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.diffusion import gaussian as gd
    from mla_tpu_torch.parallel import fsdp, sharding
    from mla_tpu_torch.parallel import tensor
    from mla_tpu_torch.params import tree_items, tree_map
    from mla_tpu_torch.training import checkpointing, optim, strategy

    cfg = variant(get_model_config, sc["config"], sc["use_diff"])
    params = tree_map(lambda t: t.clone(), inputs["params"][sc["config"]])
    mstate = tree_map(lambda t: t.clone(), inputs["model_state"][sc["config"]])
    opt, _, _ = optim.make_optimizer(params, **sc["opt"])
    tcfg = strategy.TrainConfig(grad_accumulation_steps=sc["accum"], repeated_diffusion_steps=REP,
                                enable_gradient_checkpointing=True, ema_decay=0.9)
    state = strategy.init_train_state(params, opt, mstate, use_ema=sc.get("ema", False), mesh=mesh)
    step = strategy.make_train_step(cfg, tcfg, gd.create_schedule("", diffusion_steps=100))
    draws = sc["draws"]
    if sc.get("load"):
        state = checkpointing.load_checkpoint(wait_for_checkpoint(workdir / sc["load"]), state)
        draws = draws[int(state["step"]):]
    batch = sharding.shard_batch(inputs["batch" if sc["use_diff"] else "batch_ar"], mesh.data_rank, mesh.data_world,
                                 sc["accum"])
    real = tensor.copy_to_tp
    if sc.get("control"):
        tensor.copy_to_tp = lambda x: x  # the column-parallel inputs' gradients left rank-local
    metrics = []
    try:
        for d in draws:
            state, m = step(state, batch, draws=d)
            metrics.append({k: float(v) for k, v in m.items()})
            save = sc.get("save")
            if save and tuple(save["mesh"]) == (mesh.world, mesh.dp, mesh.tp) and save["after"] == int(state["step"]):
                checkpointing.save_checkpoint(workdir / save["dir"], state, step=int(state["step"]),
                                              loss=metrics[-1]["total_loss"])
                dist.barrier()  # the file is whole before another scenario loads it
    finally:
        tensor.copy_to_tp = real
    blob = state["shards"].host_state(state)
    sh = state["shards"]
    with fsdp.gathering(sh.gatherer), torch.no_grad():  # the shapes a rank computes with: the gathered leaves
        tree = sh.gatherer.tree(state["params"])
        n, layer = fsdp.layer_gather(tree["llm_backbone"]["layers"])
        first = dict(tree_items(layer(0)))
    local = {p: (n, *first[p[len(fsdp.LAYERS):]].shape) if p.startswith(fsdp.LAYERS) else tuple(t.shape)
             for p, t in tree_items(tree)}
    layers = [None] * mesh.world
    dist.all_gather_object(layers, sh.layer_bytes(state["params"]))
    if mesh.rank != 0:
        return None
    out = {"metrics": metrics, "params": dict(tree_items(blob["params"])), "local_shapes": local,
           "layer_bytes": layers}
    if sc.get("ema") or sc.get("load"):  # what the checkpoint tests read
        out.update(ema=dict(tree_items(blob.get("ema_params", {}))), opt_state=blob["opt_state"])
    return out


def wait_for_checkpoint(run_dir: Path, timeout: float = 300.0) -> Path:
    """The newest complete checkpoint of run_dir, once another process has
    written it (a write is renamed into place when complete)."""
    import time

    from mla_tpu_torch.training import checkpointing

    deadline = time.monotonic() + timeout
    while (ckpt := checkpointing.latest_checkpoint(run_dir)) is None:
        if time.monotonic() > deadline:
            raise TimeoutError(f"no checkpoint in {run_dir} after {timeout} s")
        time.sleep(0.2)
    return ckpt


def factored_tree(seed: int = 11):
    gen = torch.Generator().manual_seed(seed)
    tree = {}
    for path, shape in FACTORED.items():
        node = tree
        *heads, last = path.split("/")
        for k in heads:
            node = node.setdefault(k, {})
        node[last] = torch.randn(shape, generator=gen) * 0.1
    return tree


def factored_grads(step: int):
    """The whole gradients of the FACTORED leaves at `step`, seeded."""
    gen = torch.Generator().manual_seed(100 + step)
    return {path: torch.randn(shape, generator=gen) * (1e-2 if path.endswith("scale") else 1.0)
            for path, shape in FACTORED.items()}


def adafactor_steps(mesh=None):
    """Two Adafactor steps (clipping at 1.0 by the global norm) on the
    FACTORED leaves over `mesh` (one process: None), each master part
    given its part of factored_grads; the whole masters after them
    (gathered like a checkpoint) and the two global norms."""
    from mla_tpu_torch.parallel import sharding
    from mla_tpu_torch.params import tree_items
    from mla_tpu_torch.training import optim, strategy

    tree = factored_tree()
    opt, _, _ = optim.make_optimizer(tree, optimizer="adafactor", learning_rate=1e-2, max_grad_norm=1.0)
    state = strategy.init_train_state(tree, opt, {}, mesh=mesh)
    sh, norms = state["shards"], []
    tp, tr = (mesh.tp, mesh.tp_rank) if mesh is not None else (1, 0)
    fr, fs = (mesh.fsdp_rank, mesh.fsdp) if mesh is not None else (0, 1)
    for step in range(2):
        grads = factored_grads(step)
        for path, master in zip(sh.paths, sh.masters):
            if master is not None:
                g = sharding.tp_part(grads[path], sh.tp_dims[path], tr, tp)
                master.grad = sharding.local_part(g, sh.specs[path], fr, fs).contiguous()
        norms.append(float(sh.optimizer.global_norm()))
        sh.optimizer.step(torch.tensor(norms[-1]))
    blob = sh.host_state(state)
    return None if blob is None else {"params": dict(tree_items(blob["params"])), "norms": norms,
                                      "opt_state": blob["opt_state"]}


def vocab_parallel_ce(mesh):
    """The vocab-parallel cross-entropy of this rank's slice of seeded
    logits against causal_lm_loss on the whole logits, with gradients."""
    from mla_tpu_torch.models import llama
    from mla_tpu_torch.parallel import tensor

    gen = torch.Generator().manual_seed(5)
    logits = torch.randn(3, 9, 64, generator=gen) * 4
    labels = torch.randint(0, 64, (3, 9), generator=gen)
    labels[0, 2:5] = -100
    whole = logits.clone().requires_grad_(True)
    want = llama.causal_lm_loss(whole, labels)
    want.backward()
    n = 64 // mesh.tp
    part = logits[..., mesh.tp_rank * n : (mesh.tp_rank + 1) * n].clone().requires_grad_(True)
    with tensor.tp_group(mesh.tp_group, {"lm_head/w"}):
        got = llama.causal_lm_loss(part, labels)
    got.backward()
    return {"loss": float(got), "want": float(want), "grad": part.grad,
            "want_grad": whole.grad[..., mesh.tp_rank * n : (mesh.tp_rank + 1) * n]}


def main():
    import torch.distributed as dist

    from mla_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    torch.set_num_threads(1)
    workdir = Path(sys.argv[1])
    if len(sys.argv) > 3 and sys.argv[2] == "--jax":
        import json

        jax_reference(workdir, json.loads(sys.argv[3]))
        return
    launch = initialize_distributed("cpu")
    rank, world = launch["rank"], launch["world"]
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    out = {"scenarios": {}}
    for sc in inputs["scenarios"]:
        for w, dp, tp in sc["meshes"]:
            if w != world:
                continue
            mesh = make_mesh(dp=dp, tp=tp)
            res = run_scenario(sc, inputs, mesh, workdir)
            if rank == 0:
                out["scenarios"][(sc["name"], dp, mesh.fsdp, tp)] = res
                out.setdefault("meshes", []).append({"dp": mesh.dp, "fsdp": mesh.fsdp, "tp": mesh.tp,
                                                     "data_world": mesh.data_world})
    for dp, tp in sorted({(dp, tp) for sc in inputs["scenarios"] for w, dp, tp in sc["meshes"] if w == world}):
        mesh = make_mesh(dp=dp, tp=tp)
        res = adafactor_steps(mesh)
        if rank == 0:
            out.setdefault("adafactor", {})[(dp, mesh.fsdp, tp)] = res
    # what the data pipeline keys on at tp 2 (x fsdp 2 at world 4): the
    # mesh's data rank and world, the train-time draw seed, the host seed
    from mla_tpu_torch.utils.seed import set_global_seed
    from mla_tpu_torch.vla.rlds.dataset import draw_seed

    mesh = make_mesh(tp=2)
    keys = [None] * world
    dist.all_gather_object(keys, (mesh.data_rank, mesh.data_world, draw_seed(7, mesh.data_rank),
                                  set_global_seed(7, mesh.data_rank)))
    out["data_keys"] = keys
    if world == 2:
        ce = [None] * world
        dist.all_gather_object(ce, vocab_parallel_ce(make_mesh(tp=2)))
        out["vocab_ce"] = ce
    if rank == 0:
        torch.save(out, workdir / f"result-{world}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
