"""Training over processes: the port's sharded train step over gloo on CPU
processes (tests/torch_distributed_child.py, spawned on a free localhost
port, each under its own timeout) against the JAX package's one-device step
on the whole global batch.

mla-tiny in fp32 with the contrastive loss on and the point tokenizer's
batch norm in training mode, a global batch of 8 rows (repeated twice for
diffusion), the JAX step's noise, t and FPS starts injected. At world size 2
(dp 1 x fsdp 2, torchrun's variables) and 4 (dp 2 x fsdp 2, the JAX
package's MLA_* variables), for AdamW and Adafactor at accumulation 1 and 2
and for the AR loss mode: the loss dict, grad_norm and every updated leaf
within 1e-5 of JAX's (relative to each leaf's largest magnitude, floored at
1e-3; fp32: the two differ only in the order of their sums; AdamW's eps at
1e-2 in both); the same against the port's
own one-process step; and the step over a gloo group of one bit for bit
the one-process step. Controls: the batch-norm statistics, the contrastive
negatives or the count of valid labels kept rank-local, or the gathers'
gradients kept rank-local (no reduce-scatter), must miss that tolerance.
The step gathers the decoder layer by layer (parallel/fsdp.py): each rank
holds at most stack / fsdp plus the largest layer leaf owned whole of the
layer stack and no whole copy of a cut leaf, every step runs exactly
2 L x accumulation layer gathers and L x accumulation reduce-scatters
(remat), and at most 2 whole layers are alive at once; the gather is the
identity, forward and backward, over a gloo group of one. A checkpoint saved at world size 2 resumes at 1 and at 4 as the
world-2 run continues. Each rank's optimizer bytes are at most total /
fsdp plus the largest leaf held whole. The per-rank RLDS shards are
tf.data's shard(2, i) of the JAX builder's episodes; the two ranks'
train-time draws differ, rank 0's are a one-process run's. Mesh shapes, the
partial-environment refusals, and the VLM sampler at world size 2 against
JAX's.
"""

import contextlib
import os
import re
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu.training import optim as joptim
from mla_tpu.training import strategy as jstrategy
from mla_tpu_torch.parallel import fsdp
from mla_tpu_torch.parallel import mesh as tmesh
from mla_tpu_torch.parallel import sharding
from mla_tpu_torch.training import checkpointing
from mla_tpu_torch.training import optim as toptim
from mla_tpu_torch.training import strategy as tstrategy
from torch_train_parity import batch as tiny_batch
from torch_train_parity import from_jax, jax_draws, jconfig, jgd, model, tconfig, tgd, tree_items

HERE = Path(__file__).resolve().parent
CHILD = HERE / "torch_distributed_child.py"
B, REP, RTOL = 8, 2, 1e-5
# AdamW's eps at 1e-2 (in both packages) keeps its update continuous in the
# gradient: at eps 1e-8 the first step is lr * sign(g), and the sign of an
# element whose gradient is within the two frameworks' rounding of zero is
# a coin toss
OPT = {"adamw": dict(learning_rate=1e-4, weight_decay=0.1, max_grad_norm=1.0, num_training_steps=10, eps=1e-2),
       "adafactor": dict(learning_rate=1e-2, max_grad_norm=1.0, num_training_steps=10, optimizer="adafactor")}
# name -> (optimizer, accumulation, diffusion mode)
PARITY = {"adamw-acc1": ("adamw", 1, True), "adamw-acc2": ("adamw", 2, True),
          "adafactor-acc1": ("adafactor", 1, True), "adafactor-acc2": ("adafactor", 2, True),
          "ar-adamw": ("adamw", 1, False)}
CONTROLS = {"batch_norm": "adamw-acc1", "contrastive": "adamw-acc1", "label_count": "ar-adamw",
            "reduce_scatter": "adamw-acc1"}
DP = {2: 1, 4: 2}
CHILD_TIMEOUT = 420  # a hang guard: the children take ~40 s alone, more under a loaded box
# the biases of the point tokenizer's convs, each followed by a batch norm
# that subtracts their per-channel constant: their gradient is zero in exact
# arithmetic and rounding noise in fp32 (in JAX too), which AdamW and
# Adafactor turn into a full step of random sign. Their update is not
# compared; test_noise_leaves_are_the_biases_before_batch_norm pins them.
NOISE = re.compile(r"^vision_tower_3d/.*/conv/b$")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(workdir: Path, world: int, style: str):
    port = _free_port()
    base = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "MLA_COORDINATOR_ADDRESS",
        "MLA_NUM_PROCESSES", "MLA_PROCESS_ID")}
    base.update(OMP_NUM_THREADS="1", PYTHONPATH=str(HERE.parent))
    procs = []
    for r in range(world):
        env = dict(base)
        if style == "torchrun":
            env.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
        else:
            env.update(MLA_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", MLA_NUM_PROCESSES=str(world),
                       MLA_PROCESS_ID=str(r))
        procs.append(subprocess.Popen([sys.executable, str(CHILD), str(workdir)], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


TRAINER = ["--device", "cpu", "--vla.type", "mla-tiny-debug", "--run_id", "dist", "--save_interval", "2",
           "--per_device_batch_size", "2", "--global_batch_size", "8"]


def _launch_trainer(workdir: Path):
    """torchrun --nproc_per_node 2 -m mla_tpu_torch.train --dp 1: 2 steps
    and a checkpoint (accumulation 2: 8 rows a step over 2 ranks of 2)."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(HERE.parent))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
           "--master_port", str(_free_port()), "-m", "mla_tpu_torch.train", *TRAINER, "--dp", "1", "--max_steps", "2",
           "--run_root_dir", str(workdir / "runs")]
    return subprocess.Popen(cmd, env=env, cwd=str(workdir), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _launch_train_step(workdir: Path):
    """torchrun --nproc_per_node 2 -m mla_tpu_torch.train_step on mla-tiny
    with fp32 masters: 2 steps, 2 rows a rank; its JSON goes to
    workdir/train_step/chiprun_out."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(HERE.parent))
    cwd = workdir / "train_step"
    cwd.mkdir()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
           "--master_port", str(_free_port()), "-m", "mla_tpu_torch.train_step", "--model", "mla-tiny", "--device",
           "cpu", "--fp32_masters", "--batch", "2", "--steps", "2"]
    return subprocess.Popen(cmd, env=env, cwd=str(cwd), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(procs, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _rel(got: torch.Tensor, want: torch.Tensor, floor: float = 1e-3) -> float:
    """max |got - want| over the leaf's largest magnitude, floored at 1e-3
    (Adafactor's own parameter-scale floor) for leaves that start at zero:
    one step leaves them at ~lr * 1e-3, where an element whose gradient is
    exactly 0 in one package and 1e-22 in the other moves by 1e-10."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / max(float(want.abs().max()), floor))


def _scenario_draws(name, steps=1):
    """JAX's keys of each step and the draws its step makes from them, per
    micro-batch, for the global batch."""
    kind, accum, diff = PARITY[name]
    jcfg = jconfig("mla-tiny", use_diff=diff)
    rows = B // accum * (REP if diff else 1)
    keys = [jax.random.PRNGKey(40 + s) for s in range(steps)]
    draws = [[jax_draws(k, jcfg, rows) for k in ([r] if accum == 1 else list(jax.random.split(r, accum)))]
             for r in keys]
    return keys, draws


def _global_batch(use_diff: bool):
    """The tiny synthetic batch; for the AR loss mode some rows' action
    labels are ignored, so the ranks hold different counts of valid
    labels."""
    b = tiny_batch(B)
    if not use_diff:
        labels = b["labels"].copy()
        labels[: B // 2, 7:13] = -100
        b = {**b, "labels": labels}
    return b


def _jax_step(name, keys, steps=1):
    kind, accum, diff = PARITY[name]
    params, mstate = model(0)
    jcfg = jconfig("mla-tiny", use_diff=diff)
    tx, _, _ = joptim.make_optimizer(params, **OPT[kind])
    tcfg = jstrategy.TrainConfig(grad_accumulation_steps=accum, repeated_diffusion_steps=REP,
                                 enable_gradient_checkpointing=True)
    step = jstrategy.make_train_step(jcfg, tcfg, tx, jgd.create_schedule("", diffusion_steps=100))
    st = jstrategy.init_train_state(params, tx, mstate)
    jb = jax.tree_util.tree_map(jnp.asarray, _global_batch(diff))
    metrics = []
    for k in keys[:steps]:
        st, m = step(st, jb, k)
        metrics.append({k2: float(v) for k2, v in m.items()})
    return {"metrics": metrics, "params": dict(tree_items(from_jax(jax.device_get(st["params"]))))}


def _port_step(name, draws, mesh=None):
    """The port's step on the global batch, on one process (mesh None) or
    over `mesh`."""
    kind, accum, diff = PARITY[name]
    params, mstate = model(0)
    tparams, tstate = from_jax(params), from_jax(mstate)
    opt, _, _ = toptim.make_optimizer(tparams, **OPT[kind])
    tcfg = tstrategy.TrainConfig(grad_accumulation_steps=accum, repeated_diffusion_steps=REP,
                                 enable_gradient_checkpointing=True)
    state = tstrategy.init_train_state(tparams, opt, tstate, mesh=mesh)
    step = tstrategy.make_train_step(tconfig("mla-tiny", use_diff=diff), tcfg,
                                     tgd.create_schedule("", diffusion_steps=100))
    # the averaged gradients the optimizer steps on (the step frees them)
    opt, grads = state["optimizer"], {}
    update = opt.step

    def step_and_keep(norm=None):
        grads.update({p: t.grad.clone() for p, t in zip(opt.paths, opt.trainable) if t.grad is not None})
        update(norm)

    opt.step = step_and_keep
    metrics = []
    for d in draws:
        state, m = step(state, _global_batch(diff), draws=d)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": {p: t.detach().clone() for p, t in tree_items(state["params"])},
            "grads": grads}


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass
    return True


@contextlib.contextmanager
def _exclusive(lock: Path, timeout: float = 1200):
    """A lock file held for the block (O_EXCL, the holder's pid inside), for
    the workers of one pytest-xdist session; a dead holder's lock is
    taken over."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, str(os.getpid()).encode())
            break
        except FileExistsError:
            try:
                holder = int(lock.read_text() or 0)
            except (OSError, ValueError):
                holder = 0
            if holder and not _alive(holder):
                lock.unlink(missing_ok=True)
                continue
            if time.monotonic() > deadline:
                raise TimeoutError(f"{lock} held for {timeout} s")
            time.sleep(0.5)
    try:
        yield
    finally:
        os.close(fd)
        lock.unlink(missing_ok=True)


def shared_runs(request, tmp_path_factory, name: str, compute):
    """compute(workdir) once a session, shared by the xdist workers that run
    a file's tests through their session's temporary root: under a lock
    file the first computes into root/name and writes runs.pt (under a
    temporary name, renamed when whole); the others load it, mapped from
    the file rather than copied into each worker. A compute that raised
    leaves its traceback in root/name/failed.txt, which every later worker
    raises again instead of computing anew (each retry would start the
    same children beside the rest of the suite, at the same moment, and
    meet the same fault)."""
    import traceback

    base = tmp_path_factory.getbasetemp()
    root = base.parent if hasattr(request.config, "workerinput") else base
    work = root / name
    done, failed = work / "runs.pt", work / "failed.txt"
    with _exclusive(root / f"{name}.lock"):
        if failed.exists():
            raise RuntimeError(f"{name}: another worker's compute of the shared results failed:\n"
                               + failed.read_text())
        if not done.exists():
            shutil.rmtree(work, ignore_errors=True)
            work.mkdir(parents=True)
            try:
                partial = work / "runs.pt.partial"
                torch.save(compute(work), partial)
                partial.rename(done)
            except BaseException:
                with contextlib.suppress(OSError):
                    failed.write_text(traceback.format_exc())
                raise
    return torch.load(done, weights_only=False, mmap=True)


def _load_and_remove(path: Path):
    """A child's result file, loaded and then deleted: runs.pt holds it."""
    out = torch.load(path, weights_only=False)
    path.unlink()
    return out


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """The children's and the references' results, computed once a session
    (shared_runs)."""
    return shared_runs(request, tmp_path_factory, "torch_distributed", _compute_runs)


def _compute_runs(work: Path):
    """Launch world 2, compute JAX's and the one-process port's steps while
    it runs, then world 4 (which resumes world 2's checkpoint) beside the
    torchrun trainer."""
    from test_tfds_builder import write_rlbench_fixture
    from torch_distributed_child import train_time_draws

    from mla_tpu_torch.vla.rlds import dataset as tds

    rlds = work / "rlds"
    write_rlbench_fixture(rlds, n_episodes=5, lens=(4, 5, 6), num_shards=2)
    trajs, stats = tds.make_dataset_from_rlds("rlbench", str(rlds), train=True, shuffle=False, load_pointcloud=True,
                                              stats_cache_dir=str(work / "stats"))
    trajs = list(trajs)
    params, mstate = model(0)
    keys_draws = {name: _scenario_draws(name, steps=2 if name == "adamw-acc1" else 1) for name in PARITY}
    draws = {name: kd[1] for name, kd in keys_draws.items()}
    scenarios = []
    for name, (kind, accum, diff) in PARITY.items():
        sc = {"name": name, "opt": OPT[kind], "accum": accum, "rep": REP, "use_diff": diff, "worlds": (2, 4),
              "dp": DP, "draws": draws[name][:1]}
        scenarios.append(sc)
    for what, base in CONTROLS.items():
        kind, accum, diff = PARITY[base]
        scenarios.append({"name": f"control-{what}", "opt": OPT[kind], "accum": accum, "rep": REP, "use_diff": diff,
                          "worlds": (2,), "dp": DP, "draws": draws[base][:1], "local": (what,)})
    both = draws["adamw-acc1"]
    scenarios.append({"name": "ckpt", "opt": OPT["adamw"], "accum": 1, "rep": REP, "use_diff": True, "worlds": (2,),
                      "dp": DP, "draws": both, "save_after": 1, "save": "ckpt_run", "ema": True,
                      "keep_opt_state": True})
    scenarios.append({"name": "resume", "opt": OPT["adamw"], "accum": 1, "rep": REP, "use_diff": True,
                      "worlds": (4,), "dp": DP, "draws": both[1:], "load": "ckpt_run", "ema": True})
    torch.save({"params": from_jax(params), "model_state": from_jax(mstate), "batch": _global_batch(True),
                "batch_ar": _global_batch(False), "scenarios": scenarios, "rlds_root": str(rlds),
                "draw_trajs": trajs, "draw_stats": stats}, work / "inputs.pt")

    t0 = time.monotonic()
    procs = _launch(work, 2, "torchrun")
    try:
        jax_refs = {name: _jax_step(name, keys_draws[name][0]) for name in PARITY}
        port1 = {name: _port_step(name, draws[name][:1]) for name in PARITY}
        for name in PARITY:  # test_noise_leaves_are_the_biases_before_batch_norm reads one
            if name != "adamw-acc1":
                del port1[name]["grads"]
        draws1 = train_time_draws(trajs, stats)
    finally:
        _wait(procs, CHILD_TIMEOUT)
    procs = _launch(work, 4, "mla") + [_launch_trainer(work), _launch_train_step(work)]
    _wait(procs, CHILD_TIMEOUT)
    (work / "inputs.pt").unlink()
    return {"work": work, "rlds": rlds, "jax": jax_refs, "port1": port1, "draws": draws, "draws1": draws1,
            "w2": _load_and_remove(work / "result-2.pt"), "w4": _load_and_remove(work / "result-4.pt"),
            "seconds": time.monotonic() - t0}


def _assert_step_matches(got, want, what, tol=RTOL):
    for k, v in want["metrics"][-1].items():
        g = got["metrics"][-1][k]
        assert abs(g - v) <= tol * max(abs(v), 1e-12), f"{what}: {k} {g} vs {v}"
    worst = max(_rel(got["params"][p], w) for p, w in want["params"].items() if not NOISE.match(p))
    assert worst <= tol, f"{what}: an updated leaf is {worst:.3g} off"
    return worst


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(PARITY))
def test_sharded_step_matches_jax(runs, name, world, record_property):
    got = runs[f"w{world}"]["scenarios"][name]
    worst = _assert_step_matches(got, runs["jax"][name], f"{name} at world {world} vs JAX")
    record_property("max_rel_leaf_err", worst)
    assert runs["jax"][name]["metrics"][0]["grad_norm"] > 0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(PARITY))
def test_sharded_step_matches_one_process(runs, name, world):
    _assert_step_matches(runs[f"w{world}"]["scenarios"][name], runs["port1"][name], f"{name} at world {world}")


@contextlib.contextmanager
def _gloo_world_of_one():
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["adamw-acc2", "adafactor-acc1", "ar-adamw"])
def test_world_size_one_is_the_one_process_step(runs, name):
    """Over a gloo group of one (its mesh, the gradient all-reduce, the
    batch group set) the step equals the one-process step bit for bit."""
    with _gloo_world_of_one():
        mesh = tmesh.make_mesh(dp=1)
        assert mesh.group is not None
        got = _port_step(name, runs["draws"][name][:1], mesh=mesh)
    want = runs["port1"][name]
    assert got["metrics"] == want["metrics"]
    for p, t in want["params"].items():
        assert torch.equal(got["params"][p], t), p


def test_noise_leaves_are_the_biases_before_batch_norm(runs):
    """The leaves left out of the update comparison are exactly those whose
    gradient is rounding noise: at most 1e-6 of the largest gradient."""
    g = runs["port1"]["adamw-acc1"]["grads"]
    scale = max(float(t.abs().max()) for t in g.values())
    tiny = {p for p, t in g.items() if 0 < float(t.abs().max()) <= 1e-6 * scale}
    assert tiny == {p for p in g if NOISE.match(p)} and len(tiny) >= 6, sorted(tiny)


def test_world_size_one_with_bf16_compute_copies():
    """fp32 masters with a bf16-computing decoder: with compute_dtype the
    state keeps only the fp32 masters and the gather hands the decoder's
    layer matrices out as bf16 copies, and two steps (accumulation 2, EMA,
    the per-step generator's draws) still equal those of the state without
    copies (each use casting the fp32 masters) bit for bit."""
    from dataclasses import replace

    from mla_tpu_torch import params as P
    from mla_tpu_torch.utils import step_generator
    from mla_tpu_torch.vla.dummy import synthetic_batch

    base = tconfig("mla-tiny")
    cfg = replace(base, llama=replace(base.llama, param_dtype=torch.float32, compute_dtype=torch.bfloat16))
    params, state = P.init(cfg, seed=8, device="cpu")
    batch = synthetic_batch(cfg, B=4, L=16, seed=10)
    tcfg = tstrategy.TrainConfig(grad_accumulation_steps=2, repeated_diffusion_steps=2, learning_rate=1e-4,
                                 use_ema=True)
    out = {}
    for mode in ("plain", "copies"):
        p = P.tree_map(lambda t: t.detach().clone(), params)
        opt, _, _ = toptim.make_optimizer(p, **tcfg.optimizer_settings())
        st = tstrategy.init_train_state(p, opt, P.tree_map(lambda t: t.clone(), state), use_ema=True,
                                        compute_dtype=torch.bfloat16 if mode == "copies" else None)
        step = tstrategy.make_train_step(cfg, tcfg, tgd.create_schedule("", diffusion_steps=100))
        metrics = []
        for i in range(2):
            st, m = step(st, batch, step_generator(0, i, "cpu"))
            metrics.append({k: float(v) for k, v in m.items()})
        layers = st["params"]["llm_backbone"]["layers"]
        assert {t.dtype for _, t in tree_items(layers)} == {torch.float32}
        with fsdp.gathering(st["shards"].gatherer):
            n, layer = fsdp.layer_gather(layers)
            dtypes = {t.dtype for _, t in tree_items(layer(0))}
        assert n == cfg.llama.num_layers
        assert dtypes == ({torch.bfloat16, torch.float32} if mode == "copies" else {torch.float32})
        blob = st["shards"].host_state(st)
        out[mode] = (metrics, dict(tree_items(blob["params"])), dict(tree_items(blob["ema_params"])))
    assert out["copies"][0] == out["plain"][0]
    for i in (1, 2):
        for path, t in out["plain"][i].items():
            assert torch.equal(out["copies"][i][path], t), path


def test_global_norm_is_accurate_on_large_leaves():
    """The step's global norm sums squares with torch.sum (a cascade):
    within 1e-6 of float64 on a 4 M-element leaf, where the fp32
    torch.linalg.vector_norm of the CPU (the norm before this step's)
    loses 1e-4."""
    g = torch.randn(4096, 1024, generator=torch.Generator().manual_seed(0)) * 1e-2
    leaf = torch.zeros_like(g, requires_grad=True)
    leaf.grad = g
    opt, _, _ = toptim.make_optimizer({"w": leaf}, learning_rate=1e-3)
    exact = float(g.double().norm())
    assert abs(float(opt.global_norm()) / exact - 1) < 1e-6
    assert abs(float(torch.linalg.vector_norm(g, dtype=torch.float32)) / exact - 1) > 1e-5


@pytest.mark.parametrize("what", list(CONTROLS))
def test_controls_miss(runs, what):
    """Each global-batch reduction kept rank-local moves the step past the
    tolerance the real step meets."""
    base = CONTROLS[what]
    got, want = runs["w2"]["scenarios"][f"control-{what}"], runs["jax"][base]
    key = {"batch_norm": "total_loss", "contrastive": "img_pc_contrastive_loss", "label_count": "ar_loss",
           "reduce_scatter": "grad_norm"}[what]
    v = want["metrics"][0][key]
    assert abs(got["metrics"][0][key] - v) > RTOL * abs(v), (what, got["metrics"][0][key], v)
    with pytest.raises(AssertionError):
        _assert_step_matches(got, want, f"control {what}")


def test_checkpoint_resumes_across_world_sizes(runs):
    """Saved at world 2 after step 1: resumed at world 1 (one process, a
    sharded state) and at world 4 (dp 2 x fsdp 2), step 2 matches the
    world-2 run's step 2, EMA and optimizer moments included."""
    draws = runs["draws"]["adamw-acc1"]
    want = runs["w2"]["scenarios"]["ckpt"]
    _assert_step_matches(runs["w4"]["scenarios"]["resume"], want, "resume at world 4")

    params, mstate = model(0)
    tparams = from_jax(params)
    opt, _, _ = toptim.make_optimizer(tparams, **OPT["adamw"])
    state = tstrategy.init_train_state(tparams, opt, from_jax(mstate), use_ema=True)
    latest = checkpointing.latest_checkpoint(runs["work"] / "ckpt_run")
    assert latest.name.startswith("step-000001")
    state = checkpointing.load_checkpoint(latest, state)
    assert state["step"] == 1
    step = tstrategy.make_train_step(tconfig("mla-tiny"), tstrategy.TrainConfig(
        repeated_diffusion_steps=REP, ema_decay=0.9), tgd.create_schedule("", diffusion_steps=100))
    state, m = step(state, _global_batch(True), draws=draws[1])
    got = {"metrics": [{k: float(v) for k, v in m.items()}],
           "params": {p: t.detach() for p, t in tree_items(state["params"])}}
    _assert_step_matches(got, want, "resume at world 1")
    blob = state["shards"].host_state(state)
    for path, e in want["ema"].items():
        assert _rel(dict(tree_items(blob["ema_params"]))[path], e) <= RTOL, path
    for path, st in want["opt_state"]["leaves"].items():
        for k, v in st.items():
            if v.dim():
                assert _rel(blob["opt_state"]["leaves"][path][k], v) <= 1e-4, (path, k)


@pytest.mark.parametrize("world", [2, 4])
def test_optimizer_bytes_per_rank(runs, world):
    """Each rank holds at most total / fsdp plus the largest leaf it holds
    whole; the fsdp group together holds each leaf once."""
    fsdp = world // DP[world]
    for name in ("adamw-acc1", "adafactor-acc1"):
        per_rank = runs[f"w{world}"]["scenarios"][name]["opt_bytes"]
        total = sum(b["held"] for b in per_rank[:fsdp])
        assert total == sum(b["held"] for b in per_rank[fsdp:]) or world == fsdp
        for b in per_rank:
            assert b["held"] <= total / fsdp + b["unit"], (name, b, total)
            assert b["held"] < total


@pytest.mark.parametrize("world", [2, 4])
def test_layer_stack_held_in_parts(runs, world):
    """Each rank keeps at most stack / fsdp plus the largest stacked leaf a
    rank owns whole of the decoder's layer stack, and no whole copy of a
    leaf the plan cuts; the fsdp group together holds the stack once."""
    fsdp_size = world // DP[world]
    for name in ("adamw-acc1", "adafactor-acc1", "ar-adamw"):
        per_rank = runs[f"w{world}"]["scenarios"][name]["layer_bytes"]
        for b in per_rank:
            assert b["whole_copies"] == [], (name, b)
            assert b["held"] <= b["stack"] / fsdp_size + b["unit"], (name, b)
            assert b["held"] < b["stack"], (name, b)
        assert sum(b["held"] for b in per_rank[:fsdp_size]) == per_rank[0]["stack"], (name, per_rank)


@pytest.mark.parametrize("world", [2, 4])
def test_layer_gathers_per_step(runs, world):
    """Under remat every step gathers each layer twice per micro-batch (the
    forward and the backward's recomputation) and reduce-scatters it once,
    the other trainable leaves once each way per micro-batch; at most 2
    whole layers are alive at once, and none after the step."""
    for name, (kind, accum, diff) in PARITY.items():
        got = runs[f"w{world}"]["scenarios"][name]
        L = got["num_layers"]
        for counts in got["gathers"]:
            assert counts["layer_gathers"] == 2 * L * accum, (name, counts)
            assert counts["layer_reduce_scatters"] == L * accum, (name, counts)
            assert counts["gathers"] == counts["reduce_scatters"] == accum, (name, counts)
            assert 1 <= counts["max_live_layers"] <= 2 and counts["live_layers"] == 0, (name, counts)


@pytest.mark.parametrize("compute", [None, torch.bfloat16], ids=["same-dtype", "bf16"])
def test_gather_is_the_identity_on_a_world_of_one(compute):
    """Over a gloo group of one the gather hands out each layer and each
    other leaf as the masters hold them (cast to the compute dtype), and
    its backward adds exactly their gradients into the accumulators: those
    of the same loss on the masters (cast by hand) themselves."""
    import torch.distributed as dist

    gen = torch.Generator().manual_seed(3)
    tree = {"llm_backbone": {"layers": {"q": {"w": torch.randn(3, 4, 6, generator=gen)},
                                        "ln": {"scale": torch.randn(3, 4, generator=gen)}},
                             "embed": {"table": torch.randn(5, 4, generator=gen)}},
            "frozen": torch.randn(2, generator=gen)}
    x = torch.randn(2, 4, generator=gen)

    def loss(params, layer):
        h = params["llm_backbone"]["embed"]["table"][:2] + x
        for i in range(3):
            lp = layer(i)
            h = (h * lp["ln"]["scale"].float()) @ lp["q"]["w"].float()[:, :4]
        return (h * params["frozen"][:, None]).square().sum()

    with _gloo_world_of_one():
        paths = [p for p, _ in tree_items(tree) if p != "frozen"]
        masters = {p: t.clone().requires_grad_(True) for p, t in tree_items(tree) if p != "frozen"}
        specs = sharding.plan([(p, tuple(masters[p].shape), 4) for p in paths], 1)
        leaves = [fsdp.Leaf(p, specs[p], tuple(masters[p].shape), compute if p.endswith("/w") and compute else
                            torch.float32, masters[p], masters[p], k) for k, p in enumerate(paths)]
        g = fsdp.Gatherer(leaves, dist.group.WORLD, 0, 1, torch.device("cpu"))
        g.acc = [torch.zeros_like(masters[p]) for p in paths]
        held = {"llm_backbone": {"layers": {"q": {"w": masters[paths[0]]}, "ln": {"scale": masters[paths[1]]}},
                                 "embed": {"table": masters[paths[2]]}}, "frozen": tree["frozen"]}
        with fsdp.gathering(g):
            params = g.tree(held)
            n, layer = fsdp.layer_gather(params["llm_backbone"]["layers"])
            assert n == 3
            for i in range(3):
                lp = layer(i)
                assert lp["q"]["w"].dtype == (compute or torch.float32)
                assert torch.equal(lp["q"]["w"], masters[paths[0]][i].detach().to(compute or torch.float32))
                assert torch.equal(lp["ln"]["scale"], masters[paths[1]][i].detach())
            assert torch.equal(params["llm_backbone"]["embed"]["table"], masters[paths[2]].detach())
            loss(params, layer).backward()
    want = {p: t.detach().clone() for p, t in masters.items()}
    wl = {"llm_backbone": {"layers": {"q": {"w": (masters[paths[0]].to(compute) if compute else masters[paths[0]])},
                                      "ln": {"scale": masters[paths[1]]}},
                           "embed": {"table": masters[paths[2]]}}, "frozen": tree["frozen"]}
    loss(wl, lambda i: {"q": {"w": wl["llm_backbone"]["layers"]["q"]["w"][i]},
                        "ln": {"scale": wl["llm_backbone"]["layers"]["ln"]["scale"][i]}}).backward()
    for k, p in enumerate(paths):
        assert masters[p].grad is not None and torch.equal(g.acc[k], masters[p].grad), p
        assert not torch.equal(g.acc[k], torch.zeros_like(want[p])), p


@pytest.mark.parametrize("op", ["all_reduce", "all_gather_0", "all_gather_last", "reduce_scatter"])
def test_collectives_on_a_world_of_one(op):
    """parallel/tensor.py's collectives over a gloo group of one hand back
    their input (a CPU tensor: torch.distributed's own collective, no
    shared card)."""
    import torch.distributed as dist

    from mla_tpu_torch.parallel import tensor

    t = torch.randn(3, 4, generator=torch.Generator().manual_seed(5))
    with _gloo_world_of_one():
        g = dist.group.WORLD
        assert tensor.shared_card(t, g) is None
        if op == "all_reduce":
            x = t.clone()
            got = tensor.all_reduce(x, g)
            assert got is x
        elif op == "reduce_scatter":
            got = tensor.reduce_scatter(t.reshape(-1), g).view(t.shape)
        else:
            got = tensor.all_gather(t, g, 0 if op == "all_gather_0" else -1)
    assert torch.equal(got, t)


def test_rlds_shards_are_tf_datas(runs, tmp_path):
    """Each rank's episodes are shard(2, rank) of the JAX builder's
    canonical order: disjoint, and together the whole split."""
    import tensorflow as tf  # noqa: F401

    from mla_tpu.vla.rlds import dataset as jds

    jdset, _ = jds.make_dataset_from_rlds("rlbench", str(runs["rlds"]), train=True, shuffle=False,
                                          load_pointcloud=True, stats_cache_dir=str(tmp_path))
    everything = [t["action"] for t in jdset.as_numpy_iterator()]
    shards = runs["w2"]["rlds_shards"]
    for i, got in enumerate(shards):
        want = [t["action"] for t in jdset.shard(2, i).as_numpy_iterator()]
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert sorted(len(a) for s in shards for a in s) == sorted(len(a) for a in everything)
    assert sum(len(s) for s in shards) == len(everything)


def test_train_time_draws_differ_across_ranks(runs):
    """At world size 2 the two ranks run the train-time transforms on the
    same trajectories: their subsampled actions and augmented frames
    differ (each rank draws from its own seed), and rank 0's equal a
    one-process run's."""
    rank0, rank1 = runs["w2"]["draws_by_rank"]
    one = runs["draws1"]
    for key in ("actions", "frames"):
        assert len(rank0[key]) == len(rank1[key]) == len(one[key]) > 0
        assert all(np.array_equal(a, b) for a, b in zip(rank0[key], one[key])), key
        assert not all(np.array_equal(a, b) for a, b in zip(rank0[key], rank1[key])), key
    for a, b in zip(rank0["goals"], one["goals"]):
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_trainer_over_torchrun_resumes_on_one_process(runs, capsys):
    """The world-2 trainer wrote its run (rank 0 only) with the strategy line
    and tokens of both ranks; one process resumes its checkpoint."""
    from mla_tpu_torch import train

    run = runs["work"] / "runs" / "dist"
    ckpt = checkpointing.latest_checkpoint(run)
    assert ckpt is not None and ckpt.name.startswith("step-000002")
    blob = torch.load(ckpt / checkpointing.STATE_FILE, weights_only=True)
    assert blob["step"] == 2 and blob["opt_state"]["count"] == 2
    out = train.main([*TRAINER, "--max_steps", "3", "--run_root_dir", str(runs["work"] / "runs"), "--is_resume", "true"])
    assert int(out["state"]["step"]) == 3
    assert checkpointing.latest_checkpoint(run).name.startswith("step-000003")


def test_train_step_benchmark_over_torchrun(runs):
    """train_step under torchrun at world 2 (fp32 masters): the global
    batch's tokens, and each rank's optimizer bytes (its master parts and
    AdamW moments) about half of the two's, which together are one
    process's fp32 masters three times over."""
    import json

    from mla_tpu_torch import train_step as ts

    got = json.loads((runs["work"] / "train_step" / "chiprun_out" /
                      "train_step_mla-tiny_fp32_masters_w2.json").read_text())
    assert got["world"] == 2 and got["mesh"] == {"dp": 1, "fsdp": 2} and len(got["step_ms"]) == 2
    one = ts.build("mla-tiny", 4, 32, "cpu", fp32_masters=True)
    assert got["tokens_per_step"] == one["tokens_per_step"]
    masters = one["state"]["shards"].optimizer_bytes()["held"] / 2**30  # no moments before a step
    held = [r["optimizer_gib"] for r in got["ranks"]]
    assert abs(sum(held) / (3 * masters) - 1) < 1e-3, (held, masters)
    assert all(0.3 * sum(held) < h < 0.7 * sum(held) for h in held), held


def test_strategy_line_and_tokens():
    """The strategy line names the mesh as JAX's does; tokens/s and MFU
    count every rank (tokens = rows x world x reps x length, the peak x
    world)."""
    from mla_tpu_torch import train

    line = train._strategy_line(tmesh.Mesh(2, 4, 1, rank=0), torch.device("cuda", 0), 64, 2, 4, 10)
    assert line == ("distributed strategy :: mesh={'dp': 2, 'fsdp': 4, 'tp': 1} global_bsz=64 per-device=2 "
                    "grad_accum=4 steps=10")
    assert train._peak_flops(torch.device("cpu"), 8) is None


def test_mesh_shapes(runs):
    """As tests/test_training.py:101-106 checks JAX's: all ranks to fsdp by
    default, dp x fsdp otherwise; the children's meshes too."""
    m = tmesh.make_mesh(world=8)
    assert (m.dp, m.fsdp, m.tp) == (1, 8, 1)
    m2 = tmesh.make_mesh(dp=2, fsdp=4, world=8)
    assert (m2.dp, m2.fsdp, m2.tp) == (2, 4, 1)
    assert tmesh.fsdp_ranks(2, 4, 1) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert [m2.__class__(2, 4, 1, rank=r).fsdp_peer(0) for r in (1, 6)] == [0, 4]
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.make_mesh(dp=3, world=8)
    assert runs["w2"]["mesh"] == {"dp": 1, "fsdp": 2, "tp": 1}
    assert runs["w4"]["mesh"] == {"dp": 2, "fsdp": 2, "tp": 1}


@pytest.mark.parametrize("env,match", [
    ({"RANK": "0", "WORLD_SIZE": "2"}, r"MASTER_ADDR"),
    ({"MLA_COORDINATOR_ADDRESS": "127.0.0.1:1", "MLA_PROCESS_ID": "0"}, r"MLA_NUM_PROCESSES"),
    ({"RANK": "2", "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}, r"outside a world"),
], ids=["torchrun-partial", "mla-partial", "rank-out-of-range"])
def test_partial_environment_raises(env, match):
    with pytest.raises(RuntimeError, match=match):
        tmesh.initialize_distributed("cpu", env=env)
    assert tmesh.initialize_distributed("cpu", env={}) is None


def test_tp_raises_citing_the_roadmap_item():
    """A mesh takes a tp axis (the port serves over one, consecutive ranks
    a group, and trains over one: tests/test_torch_tp_train.py), so the
    item-15 refusal and its ROADMAP_TP are gone (a serving mesh with dp
    beside tp or fsdp cites item 16 (g): tests/test_torch_tp_serving.py)."""
    m = tmesh.make_mesh(tp=2, world=2)
    assert (m.dp, m.fsdp, m.tp, m.tp_rank) == (1, 1, 2, 0)
    assert tmesh.tp_ranks(1, 2, 2) == [[0, 1], [2, 3]] and tmesh.fsdp_ranks(1, 2, 2) == [[0, 2], [1, 3]]
    m = tmesh.serving_mesh()  # a world of one process
    assert (m.dp, m.fsdp, m.tp, m.world) == (1, 1, 1, 1)
    assert not hasattr(tmesh, "ROADMAP_TP")


def test_shard_plan_rules():
    """JAX's rule (the largest divisible dim, the first of equal ones), the
    [L] axis allowed; Adafactor's factored dims kept whole; leaves with no
    dim to cut owned whole, the bytes balanced."""
    assert sharding.shard_dim((4, 6, 6), 2) == 1
    assert sharding.shard_dim((4, 256, 512), 2, keep_whole=(1, 2)) == 0
    assert sharding.shard_dim((7, 3), 2) is None
    specs = sharding.plan([("a", (7,), 28), ("b", (5,), 20), ("c", (3,), 12), ("d", (4, 8), 128)], 2)
    assert specs["d"] == sharding.Spec(dim=1)
    assert (specs["a"].owner, specs["b"].owner, specs["c"].owner) == (0, 1, 1)
    x = np.arange(24).reshape(12, 2)
    np.testing.assert_array_equal(sharding.shard_batch(x, 1, 2, accum=2), x[[3, 4, 5, 9, 10, 11]])
    np.testing.assert_array_equal(sharding.shard_batch(x, 1, 2, blocks=2), x[[3, 4, 5, 9, 10, 11]])


def test_vlm_sampler_at_world_two_matches_jax():
    """The VLM stage's SplitModalitySampler gives each of 2 ranks the rows
    JAX's sampler gives that process."""
    from mla_tpu.vla.sampler import SplitModalitySampler as JSampler
    from mla_tpu_torch.vla.sampler import SplitModalitySampler as TSampler

    rng = np.random.default_rng(3)
    lengths = [(bool(m), int(n)) for m, n in zip(rng.integers(0, 2, 37), rng.integers(10, 200, 37))]
    for rank in range(2):
        j = JSampler(lengths, global_batch_size=8, num_replicas=2, rank=rank, seed=7, drop_last=False)
        t = TSampler(lengths, global_batch_size=8, num_replicas=2, rank=rank, seed=7, drop_last=False)
        for epoch in range(2):
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            assert list(iter(t)) == list(iter(j))

