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

Every world also runs the CALLS of ROADMAP item 16 (a) and (b) (run_calls:
the batched chunks at B = 2 and 4, beam search, greedy and sampled text,
predict_action_batch) over its tp mesh, and a world of more than one over
serving_mesh(fsdp=2) too ('calls' and 'fsdp_calls'), then the serving
host over each mesh: a BatchingServer on rank 0 whose policy leads the
others (serving.lead), requests from two threads, the other ranks in
serving.follow, each dispatch replayed through a one-process policy.

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


SEED = 11  # the batched calls' x_T seed
SAMPLED = dict(temperature=0.7, top_k=50, seed=5)
TEXT_TOKENS = 4
BEAM_TOKENS = 5
PROMPTS = ["close the box", "open the drawer", "open it"]  # two token lengths: two groups


class ToyTokenizer:
    """A callable word tokenizer: BOS, then one id per word."""

    def __call__(self, text, add_special_tokens=True):
        return {"input_ids": [1] + [100 + sum(map(ord, w)) % 900 for w in text.split()]}

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


def call_batch(cfg, n: int = 4):
    """n raw uint8 frames, clouds, diff-mode ids of one token length and
    proprio rows (the second one None), from a numpy seed."""
    rng = np.random.default_rng(4)
    size = cfg.vision.image_size
    imgs = rng.integers(0, 256, size=(n, 3, size, size), dtype=np.uint8)
    pcs = rng.uniform(-0.3, 0.7, size=(n, cfg.point.input_points, 3)).astype(np.float32)
    ids = np.array([[1, 500 + 37 * i, 600, 700, 800 + 11 * i, 29871] for i in range(n)], np.int32)
    states = [rng.uniform(-0.5, 0.5, size=7).astype(np.float32) if i != 1 else None for i in range(n)]
    return imgs, pcs, ids, states


def obs(req, n: int):
    """n preprocessed observations (the request's frame and cloud, shifted
    per row)."""
    imgs = []
    for i in range(n):
        img = req["img"].copy()
        img[:3] += 0.1 * i
        imgs.append(img)
    return imgs, [req["pc"] * np.float32(1 + 0.05 * i) for i in range(n)]


# (tree, int8_mode) of each kind of call; the batched chunks at B = 2 and 4
BATCHED = [(tree, B, sampler) for tree in ("fp32", "int8") for B in (2, 4) for sampler in ("ddim", "dpm")]
AR_TREES = {"fp32": "w8a8", "wide_int8": "weight_only"}


def run_calls(inputs, mesh) -> dict:
    """Item 16 (a) and (b)'s calls over `mesh` (None or a mesh of one: one
    process): {'batched': {(tree, B, sampler): [B, 16, 7] normalized},
    'beams': {(tree, K): (ids, scores)}, 'text': {tree: (batch strings,
    the third prompt alone)}, 'sampled': (ids, strings), 'dit': (the
    condition, the chunk)}."""
    from mla_tpu_torch.models import mla

    req, built = inputs["request"], trees(inputs)
    pols = {}

    def pol(tree, mode):
        if (tree, mode) not in pols:
            params, state, cfg = built[tree]
            pols[(tree, mode)] = mla.MLAPolicy(params, state, cfg, tokenizer=ToyTokenizer(), norm_stats=inputs["stats"],
                                               device="cpu", int8_mode=mode, mesh=mesh)
        return pols[(tree, mode)]

    out = {"batched": {}, "beams": {}, "text": {}}
    imgs, pcs, ids, states = call_batch(built["fp32"][2])
    for tree, B, sampler in BATCHED:
        out["batched"][(tree, B, sampler)] = pol(tree, "w8a8").predict_action_diff_batched(
            imgs[:B], pcs[:B], input_ids=ids[:B], cur_robot_states=states[:B], seed=SEED, sampler=sampler,
            return_normalized=True)
    oimgs, opcs = obs(req, 3)
    two = (np.stack(oimgs[:2]), np.stack(opcs[:2]), np.repeat(req["ids"], 2, 0))
    for tree, mode in AR_TREES.items():
        p = pol(tree, mode)
        for K in (2, 3):
            out["beams"][(tree, K)] = p.generate_ids(*two, BEAM_TOKENS, num_beams=K)
        out["text"][tree] = (p.generate_text_batch(oimgs, opcs, PROMPTS, max_new_tokens=TEXT_TOKENS),
                             p.generate_text(oimgs[2], opcs[2], PROMPTS[2], max_new_tokens=TEXT_TOKENS))
    p = pol("fp32", "w8a8")
    out["sampled"] = (p.generate_ids(*two, TEXT_TOKENS, **SAMPLED)[0],
                      p.generate_text_batch(oimgs, opcs, PROMPTS, max_new_tokens=TEXT_TOKENS, **SAMPLED))
    dit, dcfg = dit_head(p.cfg.token_size)
    with p.tp_scope() as params:
        ids_dit = np.stack([mla.build_prompt_ids(p.tokenizer, s, mode="ar")[0] for s in PROMPTS[:2]])
        z = mla.cognition_feature(params, p.state, p.cfg, torch.from_numpy(ids_dit).long(),
                                  {"front_image": torch.from_numpy(np.stack(oimgs[:2]))},
                                  torch.from_numpy(np.stack(opcs[:2])))
    out["dit"] = (z.numpy(), p.predict_action_batch(oimgs[:2], opcs[:2], PROMPTS[:2], action_model_params=dit,
                                                    action_model_cfg=dcfg, num_ddim_steps=3, seed=SEED))
    return out


def dit_head(token_size: int):
    """A seeded DiT-S head of the port (its final fc2 drawn: the init's
    zero fc2 would make eps 0) and its config."""
    from mla_tpu_torch.models import action_model as am

    cfg = am.dit_config("DiT-S", token_size=token_size, in_channels=7, future_action_window_size=15)
    params = am.dit_init(cfg, seed=9, device="cpu")
    fc2 = params["final_layer"]["mlp"]["fc2"]
    fc2["w"] = torch.from_numpy(np.random.default_rng(9).normal(size=tuple(fc2["w"].shape)).astype(np.float32)
                                * 0.05)
    return params, cfg


def run_host(inputs, mesh) -> dict:
    """The serving host over `mesh`: on rank 0 a BatchingServer (buckets
    1/2/4, DPM-4) on a W8A8 policy that leads the other ranks, 8 requests
    from two threads; each dispatch then replayed through a one-process
    policy of the same tree. The others follow until rank 0 closes the
    channel. {'dispatches', 'buckets', 'requests', 'errors', 'replay_equal',
    'replay_max_abs'} on rank 0, {'followed'} on the others."""
    import threading

    from mla_tpu_torch import serving
    from mla_tpu_torch.models import mla

    params, state, cfg = trees(inputs)["int8"]
    pol = mla.MLAPolicy(params, state, cfg, norm_stats=inputs["stats"], device="cpu", mesh=mesh)
    if mesh.rank != 0:
        return {"followed": serving.follow(pol)}
    channel = serving.lead(pol)
    log, real = [], pol.dispatch_action_diff_batched

    def recording(*a, **k):
        fin = real(*a, **k)

        def finalize():
            got = fin()
            log.append((a, k, got))
            return got
        return finalize

    pol.dispatch_action_diff_batched = recording
    imgs, pcs, ids, states = call_batch(cfg)
    results = []
    server = serving.BatchingServer(pol, max_wait_ms=40.0, sampler="dpm")
    try:
        def client(rows):
            futs = [server.submit(imgs[i], pcs[i], input_ids=ids[i:i + 1], cur_robot_state=states[i],
                                  unnorm_key="rlbench", seed=i) for i in rows]
            results.extend(f.result(timeout=120) for f in futs)

        threads = [threading.Thread(target=client, args=(rows,)) for rows in ([0, 1, 2, 3], [3, 2])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        client([1])
        client([0, 2])
        stats = server.stats()
    finally:
        server.close()
        channel.close()
    one = mla.MLAPolicy(params, state, cfg, norm_stats=inputs["stats"], device="cpu")
    again = [one.dispatch_action_diff_batched(*a, **k)() for a, k, _ in log]
    return {"dispatches": len(log), "buckets": stats["batch_size_hist"], "requests": len(results),
            "errors": stats["errors"], "replay_equal": all(np.array_equal(r, g) for r, (_, _, g) in zip(again, log)),
            "replay_max_abs": max(float(np.abs(r - g).max()) for r, (_, _, g) in zip(again, log))}


SERVE_FSDP = 2  # the HTTP host's --fsdp at world 2: tp 1 x fsdp 2
SERVE_REQUESTS = 6


def run_serve_cli(inputs, workdir: Path, rank: int) -> dict:
    """`python -m mla_tpu_torch.serve --fsdp 2`'s main on every rank, over
    the launch's world (the MLA_* variables, as torchrun's): rank 0 writes
    a run dir of the fp32 tree (config.json naming mla-tiny, the
    statistics, state.pt), the ranks load it, rank 0 binds HTTP on a free
    port and leads, the others follow. A thread of rank 0 posts
    SERVE_REQUESTS requests from two threads, reads /stats, then sends
    SIGINT to its own process, which closes the host and the channel;
    every rank's main returns. It ends the process group: the child's last
    scenario. {'answers': [status, shape] per request, 'stats'} on rank 0,
    {'returned': True} on every rank."""
    import io
    import json
    import os
    import signal
    import socket
    import threading
    import time
    import urllib.request

    import torch.distributed as dist

    from mla_tpu_torch import serve

    run = workdir / "serve_run"
    if rank == 0:
        params, state, _ = inputs["trees"]["fp32"]
        run.mkdir(exist_ok=True)
        (run / "config.json").write_text(json.dumps({"train": {"base_vlm": "mla-tiny"}}))
        (run / "dataset_statistics.json").write_text(json.dumps(inputs["stats"]))
        torch.save({"params": params, "model_state": state}, run / "state.pt")
    dist.barrier()
    out = {}
    if rank == 0:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        url = f"http://127.0.0.1:{port}"
        rng = np.random.default_rng(5)
        answers = []

        def post(i):
            buf = io.BytesIO()
            np.savez(buf, image=rng.integers(0, 256, (120, 90, 3), dtype=np.uint8), instruction=np.asarray(PROMPTS[0]),
                     pointcloud=inputs["request"]["pc"] * np.float32(1 + 0.05 * i), unnorm_key=np.asarray("rlbench"))
            req = urllib.request.Request(f"{url}/predict", data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                answers.append((r.status, np.asarray(json.load(r)["actions"]).shape))

        def drive():
            try:
                for _ in range(600):
                    try:
                        urllib.request.urlopen(f"{url}/healthz", timeout=5)
                        break
                    except OSError:
                        time.sleep(0.1)
                clients = [threading.Thread(target=lambda c=c: [post(2 * i + c) for i in range(SERVE_REQUESTS // 2)])
                           for c in range(2)]
                for t in clients:
                    t.start()
                for t in clients:
                    t.join()
                with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
                    out["stats"] = json.load(r)
            finally:
                os.kill(os.getpid(), signal.SIGINT)

        threading.Thread(target=drive, daemon=True).start()
        argv = ["--port", str(port)]
    else:
        argv = []
    scores = os.environ.get("MLA_PREFILL_SCORES")
    try:
        serve.main(["--checkpoint", str(run), "--device", "cpu", "--fsdp", str(SERVE_FSDP), "--max_wait_ms", "20"]
                   + argv)
    finally:  # main sets it for its policies; JAX's references read it too
        if scores is None:
            os.environ.pop("MLA_PREFILL_SCORES", None)
        else:
            os.environ["MLA_PREFILL_SCORES"] = scores
    if rank == 0:
        out["answers"] = answers
    return {**out, "returned": True}


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
    out["calls"] = run_calls(inputs, mesh)
    if launch["world"] > 1:
        out["tensor_ops"] = tensor_ops(mesh.tp_group, launch["rank"], launch["world"])
        out["host"] = run_host(inputs, mesh)
        fsdp_mesh = tmesh.serving_mesh(fsdp=2)
        out["fsdp"] = run_fsdp_scenarios(inputs, fsdp_mesh)
        out["fsdp_calls"] = run_calls(inputs, fsdp_mesh)
        out["fsdp_host"] = run_host(inputs, fsdp_mesh)
    if launch["world"] == 2:
        out["serve_cli"] = run_serve_cli(inputs, workdir, launch["rank"])  # ends the process group
    jobs = inputs["jax_jobs"].get((launch["world"], launch["rank"]))
    if jobs:
        # JAX's references of the parent's test, run here beside it
        import test_torch_tp_serving

        out["jax"] = test_torch_tp_serving.run_jax_jobs(jobs, inputs["request"], inputs["jax_trees"])
    torch.save({k: v if isinstance(v, dict) else tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                else np.asarray(v) for k, v in out.items()}, workdir / f"out_w{launch['world']}_r{launch['rank']}.pt")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    main(Path(sys.argv[1]))
