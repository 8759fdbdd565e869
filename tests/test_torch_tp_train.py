"""Training over a tensor-parallel group: the port's train step with a tp
axis (tests/torch_tp_train_child.py over gloo on CPU processes, spawned on
free localhost ports under a timeout) against the JAX package's
one-device step on the whole global batch (computed in child processes of
the same script, beside the ranks).

mla-tiny in fp32 with the contrastive loss on and the point tokenizer's
batch norm in training mode, a global batch of 8 rows (repeated twice for
diffusion), JAX's noise, t and FPS starts injected, 2 steps. Scenarios:
AdamW at accumulation 1, Adafactor at accumulation 2, the AR loss mode
(the lm_head split on the vocabulary: vocab-parallel cross-entropy) and
GQA (2 kv heads) at accumulation 2; each at tp 2 (world 2) and at tp 2 x
fsdp 2 and tp 2 x dp 2 (world 4; GQA at tp 2 x fsdp 2).
The loss dict, grad_norm and every leaf within 1e-5 of JAX's (relative to
the leaf's largest magnitude, floored at 1e-3; AdamW's eps at 1e-2, as in
tests/test_torch_distributed.py). With Adafactor the entries whose
gradient is nonzero but under 1e-3 of their leaf's rms, by JAX's own
second moments (NOISE_V, ZERO_V), are left out: Adafactor divides them by
that tiny statistic, so their update is their gradient's rounding,
amplified (projector_3d/fc2's dead GELU rows, a leaf each rank holds
whole); the test records their count and readings (`left_out`).
mla-tiny's decoder is too narrow for Adafactor to factor its moments
(both dims must be >= 128), so its statistics across a tp-split leaf are
held apart: two steps on leaves of the tp rules' paths whose factored
dims include the tp dim, from seeded gradients, at each mesh against
JAX's Adafactor on the whole leaves (optax's chain, as GSPMD computes it
over the whole leaf). The control (copy_to_tp's backward all-reduce
skipped) misses the 1e-5 tolerance. A checkpoint saved at tp 2 x
fsdp 2 resumes at world 1 and at tp 1 x fsdp 4, one saved at world 1
resumes at tp 2 x fsdp 2, each equal to the uninterrupted run. The
vocab-parallel cross-entropy equals causal_lm_loss with its gradient;
`torchrun ... -m mla_tpu_torch.train --tp 2 --device cpu` trains 2 steps;
the ranks of a tp group key the data pipeline on one data rank; the fsdp
plan on tp-local shapes puts fsdp where JAX's _spec_for_leaf does; at tp
2 x fsdp 2 a rank holds only its part of the layer stack, which the step
gathers layer by layer.
"""

import os
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mla_tpu.parallel import sharding as jsharding
from mla_tpu_torch.conf.models import get_model_config as tconfig
from mla_tpu_torch.diffusion import gaussian as tgd
from mla_tpu_torch.parallel import mesh as tmesh
from mla_tpu_torch.parallel import sharding
from mla_tpu_torch.training import checkpointing
from mla_tpu_torch.training import optim as toptim
from mla_tpu_torch.training import strategy as tstrategy
from test_torch_distributed import NOISE, OPT, _free_port, _load_and_remove, _rel, _wait, shared_runs
from torch_tp_train_child import REP, global_batch, variant, wait_for_checkpoint
from torch_train_parity import from_jax, jax_draws, jconfig, tree_items

HERE = Path(__file__).resolve().parent
CHILD = HERE / "torch_tp_train_child.py"
B, RTOL = 8, 1e-5
# Adafactor: an entry is left out where JAX's second moment of it (v, or
# the factored estimate v_row * v_col / mean(v_row)) lies under NOISE_V of
# the leaf's mean (a gradient under 1e-3 of the leaf's rms) yet above
# 1e3 x Adafactor's epsilon of 1e-30 (a gradient of 0: no update, compared)
NOISE_V, ZERO_V = 1e-6, 1e-27
CHILD_TIMEOUT = 420  # a hang guard
W2, FSDP, DP = (2, 1, 2), (4, 1, 2), (4, 2, 2)  # (world, dp, tp)
# name -> (model variant, optimizer, accumulation, diffusion mode, meshes, steps)
SCENARIOS = {
    "adamw-acc1": ("tiny", "adamw", 1, True, (W2, FSDP, DP), 2),
    "adafactor-acc2": ("tiny", "adafactor", 2, True, (W2, FSDP, DP), 2),
    "ar-adamw": ("tiny", "adamw", 1, False, (W2, FSDP, DP), 2),
    "gqa-adamw-acc2": ("gqa", "adamw", 2, True, (W2, FSDP), 2),
}
CASES = [(name, m) for name, sc in SCENARIOS.items() for m in sc[4]]
MESH_ID = {W2: "tp2", FSDP: "tp2xfsdp2", DP: "tp2xdp2"}
TRAINER = ["--device", "cpu", "--vla.type", "mla-tiny-debug", "--run_id", "tp", "--save_interval", "2",
           "--per_device_batch_size", "2", "--global_batch_size", "8", "--tp", "2", "--max_steps", "2"]


def _draws(name):
    """JAX's step keys and the draws its step makes from them, per step and
    micro-batch, for the global batch."""
    cfg_name, _, accum, diff, _, steps = SCENARIOS[name]
    jcfg = variant(jconfig, cfg_name, diff)
    rows = B // accum * (REP if diff else 1)
    keys = [40 + s for s in range(steps)]
    return keys, [[jax_draws(k, jcfg, rows) for k in ([r] if accum == 1 else list(jax.random.split(r, accum)))]
                  for r in (jax.random.PRNGKey(s) for s in keys)]


def _env():
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "MLA_COORDINATOR_ADDRESS",
        "MLA_NUM_PROCESSES", "MLA_PROCESS_ID")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(HERE.parent))
    return env


def _launch_ranks(work: Path, world: int):
    port = _free_port()
    return [subprocess.Popen([sys.executable, str(CHILD), str(work)],
                             env={**_env(), "RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r),
                                  "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)},
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _launch_trainer(work: Path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
           "--master_port", str(_free_port()), "-m", "mla_tpu_torch.train", *TRAINER, "--run_root_dir",
           str(work / "runs")]
    return subprocess.Popen(cmd, env=_env(), cwd=str(work), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _port_state(inputs, name, use_ema=False):
    """The port's one-process state and step of scenario `name` from the
    inputs' weights."""
    from mla_tpu_torch.params import tree_map

    cfg_name, kind, accum, diff, _, _ = SCENARIOS[name]
    params = tree_map(lambda t: t.clone(), inputs["params"][cfg_name])
    opt, _, _ = toptim.make_optimizer(params, **OPT[kind])
    state = tstrategy.init_train_state(params, opt, tree_map(lambda t: t.clone(), inputs["model_state"][cfg_name]),
                                       use_ema=use_ema)
    step = tstrategy.make_train_step(variant(tconfig, cfg_name, diff), tstrategy.TrainConfig(
        grad_accumulation_steps=accum, repeated_diffusion_steps=REP, ema_decay=0.9),
        tgd.create_schedule("", diffusion_steps=100))
    return state, step


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """The children's and JAX's results, computed once a session and shared
    by the xdist workers (test_torch_distributed.shared_runs)."""
    return shared_runs(request, tmp_path_factory, "torch_tp_train", _compute_runs)


def _compute_runs(work: Path):
    """Start JAX's steps; write the inputs and save the world-1 checkpoint;
    then run the torchrun trainer and the ranks at world 2 and 4 beside
    them."""
    import json

    from torch_tp_train_child import jax_model

    t0 = time.monotonic()
    # XLA's constant folding of the steps' constant pooling windows takes
    # seconds a window and folds them to the same values
    jax_env = {**_env(), "XLA_FLAGS": (os.environ.get("XLA_FLAGS", "") + " --xla_disable_hlo_passes=constant_folding")}
    procs = [subprocess.Popen([sys.executable, str(CHILD), str(work), "--jax", json.dumps(
        {"name": name, "config": c, "opt": OPT[kind], "accum": accum, "use_diff": diff,
         "keys": [40 + i for i in range(steps)]})], env=jax_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, (c, kind, accum, diff, _, steps) in SCENARIOS.items()]
    procs.append(_launch_trainer(work))
    try:
        params, mstate = {}, {}
        for cfg_name in sorted({sc[0] for sc in SCENARIOS.values()}):
            p, s = jax_model(cfg_name)
            params[cfg_name], mstate[cfg_name] = from_jax(p), from_jax(s)
        scenarios = []
        for name, (cfg_name, kind, accum, diff, meshes, _) in SCENARIOS.items():
            keys, draws = _draws(name)
            scenarios.append({"name": name, "config": cfg_name, "opt": OPT[kind], "accum": accum, "use_diff": diff,
                              "meshes": meshes, "keys": keys, "draws": draws})
        # the checkpoints (after the scenarios, in the order the world-4 ranks
        # run them) and the control, all of adamw-acc1
        first = scenarios[0]
        first.update(ema=True, save={"mesh": FSDP, "dir": "ckpt_tp2xfsdp2", "after": 1})
        base = {k: v for k, v in first.items() if k != "save"}
        scenarios += [{**base, "name": "control", "meshes": (W2,), "control": True, "ema": False},
                      {**base, "name": "resume-tp1xfsdp4", "meshes": ((4, 1, 1),), "load": "ckpt_tp2xfsdp2"},
                      {**base, "name": "resume-from-world1", "meshes": (FSDP,), "load": "ckpt_w1"}]
        inputs = {"params": params, "model_state": mstate, "batch": global_batch(True),
                  "batch_ar": global_batch(False), "scenarios": scenarios}
        torch.save(inputs, work / "inputs.pt")
        procs += _launch_ranks(work, 2) + _launch_ranks(work, 4)
        # while the ranks run: the world-1 checkpoint that world 4 resumes at
        # tp 2 x fsdp 2 (its ranks wait for it), JAX's Adafactor on the
        # factored leaves, and the tp 2 x fsdp 2 checkpoint resumed by one
        # process once the ranks wrote it
        state, step = _port_state(inputs, "adamw-acc1", use_ema=True)
        state, m = step(state, global_batch(True), draws=first["draws"][0])
        checkpointing.save_checkpoint(work / "ckpt_w1", state, step=1, loss=float(m["total_loss"]))
        factored = _jax_adafactor()
        resumed = _resume_at_world_1(inputs, first["draws"][1], wait_for_checkpoint(work / "ckpt_tp2xfsdp2"))
    finally:
        outs = _wait(procs, CHILD_TIMEOUT)
    (work / "inputs.pt").unlink()
    return {"work": work, "jax_adafactor": factored, "resumed_world1": resumed,
            "jax": {name: _load_and_remove(work / f"jax-{name}.pt") for name in SCENARIOS},
            "w2": _load_and_remove(work / "result-2.pt"),
            "w4": _load_and_remove(work / "result-4.pt"), "trainer_out": outs[len(SCENARIOS)],
            "draws": {s["name"]: s["draws"] for s in scenarios}, "seconds": time.monotonic() - t0}


def _result(runs, name, mesh):
    world, dp, tp = mesh
    return runs[f"w{world}"]["scenarios"][(name, dp, world // (dp * tp), tp)]


def _compared(moments, params) -> dict:
    """{path: the entries of a trained leaf that are compared} by NOISE_V
    and ZERO_V (a factored leaf's v_row lacks the larger factored dim d0,
    its v_col the smaller d1)."""
    keep = {}
    for path, st in moments.items():
        if "v_row" in st:
            d1, d0 = toptim.factored_dims(tuple(params[path].shape))
            r, c = st["v_row"].double().unsqueeze(d0), st["v_col"].double().unsqueeze(d1)
            v = (r * c / r.mean(dim=d1, keepdim=True)).expand(params[path].shape)
        else:
            v = st["v"].double()
        keep[path] = (v >= NOISE_V * v.mean()) | (v <= ZERO_V)
    return keep


def _rel_kept(got, want, keep=None):
    """_rel over the entries `keep` marks (all of them without a mask)."""
    if keep is None:
        return _rel(got, want)
    return float((got.double() - want.double()).abs()[keep].max()) / max(float(want.abs().max()), 1e-3)


def _assert_step_matches(got, want, what, tol=RTOL, keep=None):
    for k, v in want["metrics"][-1].items():
        g = got["metrics"][-1][k]
        assert abs(g - v) <= tol * max(abs(v), 1e-12), f"{what}: {k} {g} vs {v}"
    keep = keep or {}
    worst = max(_rel_kept(got["params"][p], w, keep.get(p)) for p, w in want["params"].items() if not NOISE.match(p))
    assert worst <= tol, f"{what}: an updated leaf is {worst:.3g} off"
    return worst


@pytest.mark.parametrize("name,mesh", CASES, ids=[f"{n}-{MESH_ID[m]}" for n, m in CASES])
def test_tp_step_matches_jax(runs, name, mesh, record_property):
    got, want = _result(runs, name, mesh), runs["jax"][name]
    assert len(got["metrics"]) == SCENARIOS[name][5]
    keep = _compared(want["moments"], want["params"]) if "moments" in want else None
    worst = _assert_step_matches(got, want, f"{name} at {MESH_ID[mesh]} vs JAX", keep=keep)
    record_property("max_rel_leaf_err", worst)
    if keep:
        # the readings of the entries left out, for the record
        out = {p: (int((~k).sum()), _rel_kept(got["params"][p], want["params"][p], ~k)) for p, k in keep.items()
               if not k.all()}
        record_property("left_out", out)
        assert sum(n for n, _ in out.values()) < 1e-2 * sum(k.numel() for k in keep.values()), out
    assert want["metrics"][0]["grad_norm"] > 0


def test_ranks_hold_tp_local_trees(runs):
    """Each rank computes with its tp-local tree (the leaves its gathers
    hand out): q/k/v/gate/up halved on the output dim, o/down on the input
    dim, embedding and lm_head on the vocabulary; the norms whole; and the
    masters gathered back whole."""
    got = _result(runs, "gqa-adamw-acc2", FSDP)["local_shapes"]
    lay = "llm_backbone/layers/"
    assert got[lay + "attn/q/w"] == (4, 64, 32) and got[lay + "attn/k/w"] == (4, 64, 16)
    assert got[lay + "attn/o/w"] == (4, 32, 64) and got[lay + "mlp/down/w"] == (4, 64, 64)
    assert got[lay + "mlp/gate/w"] == (4, 64, 64) and got[lay + "input_ln/scale"] == (4, 64)
    assert got["llm_backbone/embed/table"] == (32064 // 2, 64) and got["llm_backbone/lm_head/w"] == (64, 32064 // 2)
    whole = _result(runs, "gqa-adamw-acc2", FSDP)["params"]
    assert tuple(whole[lay + "attn/k/w"].shape) == (4, 64, 32)
    assert {"dp": 1, "fsdp": 2, "tp": 2, "data_world": 2} in runs["w4"]["meshes"]
    assert {"dp": 2, "fsdp": 1, "tp": 2, "data_world": 2} in runs["w4"]["meshes"]


@pytest.mark.parametrize("name", ["adafactor-acc2", "gqa-adamw-acc2"])
def test_tp_fsdp_ranks_hold_parts_of_the_layer_stack(runs, name):
    """At tp 2 x fsdp 2 a rank keeps at most its tp-local stack / fsdp plus
    the largest stacked leaf a rank owns whole of the decoder's layers, and
    no whole copy of a cut leaf: the gather builds each layer per use."""
    per_rank = _result(runs, name, FSDP)["layer_bytes"]
    assert len(per_rank) == 4
    for b in per_rank:
        assert b["whole_copies"] == [] and b["held"] <= b["stack"] / 2 + b["unit"] and b["held"] < b["stack"], b


def test_control_without_copy_to_tp_allreduce_misses(runs):
    """copy_to_tp's backward all-reduce skipped: the gradients of every
    leaf before a column-parallel product keep one rank's heads only, and
    the step misses JAX's."""
    got, want = _result(runs, "control", W2), runs["jax"]["adamw-acc1"]
    g, v = got["metrics"][0]["grad_norm"], want["metrics"][0]["grad_norm"]
    assert abs(g - v) > 100 * RTOL * v, (g, v)
    with pytest.raises(AssertionError):
        _assert_step_matches(got, want, "control")


def _jax_adafactor():
    """JAX's make_optimizer(optimizer='adafactor') (optax's chain: clip by
    the global norm at 1, then Adafactor) on the whole FACTORED leaves, two
    steps of factored_grads: the masters, the two global norms and the
    second moments."""
    import jax.numpy as jnp
    import optax

    from mla_tpu.training import optim as joptim
    from mla_tpu_torch.params import tree_items
    from torch_tp_train_child import factored_grads, factored_tree, jax_moments

    def nest(flat):
        out = {}
        for path, v in flat.items():
            *heads, last = path.split("/")
            node = out
            for k in heads:
                node = node.setdefault(k, {})
            node[last] = jnp.asarray(v.numpy())
        return out

    params = nest(dict(tree_items(factored_tree())))
    tx, _, _ = joptim.make_optimizer(params, optimizer="adafactor", learning_rate=1e-2, max_grad_norm=1.0)
    st, norms = tx.init(params), []
    for step in range(2):
        grads = nest(factored_grads(step))
        norms.append(float(optax.global_norm(grads)))
        updates, st = tx.update(grads, st, params)
        params = optax.apply_updates(params, updates)
    return {"params": {p: torch.from_numpy(np.array(v)) for p, v in tree_items(params)}, "norms": norms,
            "moments": jax_moments(st)}


@pytest.mark.parametrize("mesh", [W2, FSDP, DP], ids=[MESH_ID[m] for m in (W2, FSDP, DP)])
def test_adafactor_statistics_across_a_tp_split_leaf(runs, mesh):
    """Adafactor over tp-split parts (factored dims of the whole leaf; row
    and column statistics and the update and parameter RMS summed over the
    tp group, and over fsdp) equals JAX's Adafactor on the whole leaves
    (GSPMD reduces over the whole leaf): the two global norms, every
    master and every second moment after two steps."""
    world, dp, tp = mesh
    got, want = runs[f"w{world}"]["adafactor"][(dp, world // (dp * tp), tp)], runs["jax_adafactor"]
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=RTOL)
    for path, w in want["params"].items():
        assert _rel(got["params"][path], w) <= RTOL, path
    assert sorted(got["opt_state"]["leaves"]) == sorted(want["moments"])
    for path, st in want["moments"].items():
        assert sorted(got["opt_state"]["leaves"][path]) == sorted(st), path
        for k, v in st.items():
            torch.testing.assert_close(got["opt_state"]["leaves"][path][k], v, rtol=RTOL, atol=1e-12)
    assert {"v_row", "v_col"} <= set(want["moments"]["llm_backbone/layers/mlp/down/w"])


@pytest.mark.parametrize("world", [2, 4])
def test_data_pipeline_keys_on_the_data_rank(runs, world):
    """At tp 2 the ranks of a tp group share a data rank, so they read the
    same episode shard and draw the same train-time and host seeds; the
    data ranks differ (tp 2 x fsdp 2 at world 4)."""
    keys = runs[f"w{world}"]["data_keys"]
    assert [k[:2] for k in keys] == [(r // 2, world // 2) for r in range(world)]
    assert all(keys[r][2:] == keys[r - r % 2][2:] for r in range(world))
    assert len({k[2:] for k in keys}) == world // 2
    assert keys[0][2:] == (7, 7)


def test_vocab_parallel_cross_entropy_matches_causal_lm_loss(runs):
    """Each rank's loss of its vocabulary slice equals causal_lm_loss of the
    whole logits, and its gradient the whole gradient's slice."""
    for r in runs["w2"]["vocab_ce"]:
        assert abs(r["loss"] / r["want"] - 1) < 1e-6, r
        torch.testing.assert_close(r["grad"], r["want_grad"], rtol=1e-5, atol=1e-8)


def _resume_at_world_1(inputs, draws, ckpt: Path):
    """One process resumes checkpoint `ckpt` and takes step 2."""
    state, step = _port_state(inputs, "adamw-acc1", use_ema=True)
    state = checkpointing.load_checkpoint(ckpt, state)
    assert state["step"] == 1
    state, m = step(state, global_batch(True), draws=draws)
    blob = state["shards"].host_state(state)
    return {"metrics": [{k: float(v) for k, v in m.items()}], "params": dict(tree_items(blob["params"])),
            "ema": dict(tree_items(blob["ema_params"])), "opt_state": blob["opt_state"]}


@pytest.mark.parametrize("where", ["world1", "tp1xfsdp4"])
def test_checkpoint_from_tp2_fsdp2_resumes(runs, where):
    """Saved at tp 2 x fsdp 2 after step 1: resumed at world 1 (one process)
    and at tp 1 x fsdp 4, step 2 equals the uninterrupted tp 2 x fsdp 2
    run's, EMA and optimizer moments included."""
    want = _result(runs, "adamw-acc1", FSDP)
    if where == "world1":
        got = runs["resumed_world1"]
    else:
        got = _result(runs, "resume-tp1xfsdp4", (4, 1, 1))
    _assert_step_matches(got, want, f"resume at {where}")
    for path, e in want["ema"].items():
        assert _rel(got["ema"][path], e) <= RTOL, path
    for path, st in want["opt_state"]["leaves"].items():
        for k, v in st.items():
            if v.dim():
                assert _rel(got["opt_state"]["leaves"][path][k], v) <= 1e-4, (path, k)


def test_checkpoint_from_world_1_resumes_at_tp2_fsdp2(runs):
    """Saved by one process after step 1, resumed at tp 2 x fsdp 2: step 2
    equals JAX's two steps and the uninterrupted tp 2 x fsdp 2 run's."""
    got = _result(runs, "resume-from-world1", FSDP)
    assert len(got["metrics"]) == 1
    _assert_step_matches(got, runs["jax"]["adamw-acc1"], "world-1 checkpoint resumed at tp 2 x fsdp 2 vs JAX")
    _assert_step_matches(got, _result(runs, "adamw-acc1", FSDP), "vs the uninterrupted run")


def test_trainer_over_torchrun_at_tp2(runs):
    """torchrun --nproc_per_node 2 -m mla_tpu_torch.train --tp 2 --device
    cpu: the strategy line names tp 2, two steps and a checkpoint of the
    whole tree."""
    out = runs["trainer_out"]
    line = [l for l in out.splitlines() if "strategy ::" in l]
    assert line and "mesh={'dp': 1, 'fsdp': 1, 'tp': 2}" in line[0], out[-3000:]
    ckpt = checkpointing.latest_checkpoint(runs["work"] / "runs" / "tp")
    blob = torch.load(ckpt / checkpointing.STATE_FILE, weights_only=True)
    assert blob["step"] == 2 and blob["opt_state"]["count"] == 2
    cfg = tconfig("mla-tiny")
    assert tuple(blob["params"]["llm_backbone"]["layers"]["attn"]["q"]["w"].shape) == (4, 64, 64)
    assert tuple(blob["params"]["llm_backbone"]["lm_head"]["w"].shape) == (64, cfg.llama.vocab_size)


# full-width llama leaves (mla-7b, and mla-mistral's GQA k / v) and a few of
# the rest of the tree, as (path, shape)
PLAN_LEAVES = [(f"llm_backbone/layers/{k}/w", s) for k, s in (
    ("attn/q", (32, 4096, 4096)), ("attn/k", (32, 4096, 1024)), ("attn/o", (32, 4096, 4096)),
    ("mlp/gate", (32, 4096, 11008)), ("mlp/up", (32, 4096, 14336)), ("mlp/down", (32, 11008, 4096)))] + [
    ("llm_backbone/layers/input_ln/scale", (32, 4096)), ("llm_backbone/final_ln/scale", (4096,)),
    ("llm_backbone/embed/table", (32064, 4096)), ("llm_backbone/lm_head/w", (4096, 32064)),
    ("projector/fc1/w", (2176, 4096)), ("x_embedder/fc1/b", (7,))]


@pytest.mark.parametrize("tp,fsdp", [(2, 2), (2, 4), (4, 2)])
def test_plan_on_tp_local_shapes_matches_spec_for_leaf(tp, fsdp):
    """JAX's _spec_for_leaf (use_tp) as the oracle: the port's tp dim
    (tp_split_dims) and the fsdp dim its plan picks on the tp-local shape
    with the tp dim kept whole are JAX's 'tp' and 'fsdp' dims; the largest
    local dim is the tp dim for gate/up at tp 2, and fsdp lands beside it."""
    mesh = types.SimpleNamespace(shape={"dp": 1, "fsdp": fsdp, "tp": tp})
    tp_dims = sharding.tp_split_dims(PLAN_LEAVES, tp)
    local = {p: tuple(n // tp if d == tp_dims[p] else n for d, n in enumerate(s)) for p, s in PLAN_LEAVES}
    specs = sharding.plan([(p, local[p], 4) for p, _ in PLAN_LEAVES], fsdp,
                          lambda p, shape: () if tp_dims[p] is None else (tp_dims[p],))
    for path, shape in PLAN_LEAVES:
        want = tuple(jsharding._spec_for_leaf(path, types.SimpleNamespace(ndim=len(shape), shape=shape), mesh, True))
        want = want + (None,) * (len(shape) - len(want))
        assert tp_dims[path] == (want.index("tp") if "tp" in want else None), path
        assert specs[path].dim == (want.index("fsdp") if "fsdp" in want else None), path
    gate = "llm_backbone/layers/mlp/gate/w"
    if tp == 2:
        assert max(range(3), key=lambda d: local[gate][d]) == 2 and specs[gate].dim == 1


def test_mesh_data_groups():
    """tp innermost, as JAX's reshape(dp, fsdp, tp): the data group of a tp
    index spans dp x fsdp ranks, the data rank is dp_rank * fsdp +
    fsdp_rank; ROADMAP_TP is gone."""
    assert tmesh.data_ranks(2, 2, 2) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert [tmesh.Mesh(2, 2, 2, rank=r).data_rank for r in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert tmesh.Mesh(2, 2, 2, rank=0).data_world == 4
    assert not hasattr(tmesh, "ROADMAP_TP")


@pytest.mark.parametrize("model,tp,match", [
    ("mla-phi", 2, r"item 16 \(c\): mla-phi"),
    ("mla-tiny", 8, r"item 16 \(e\): heads that T does not divide"),
], ids=["phi", "heads"])
def test_tp_training_refusals(model, tp, match):
    with pytest.raises(NotImplementedError, match=match):
        tstrategy.check_tp(tconfig(model), tp)
    tstrategy.check_tp(tconfig("mla-tiny"), 2)
