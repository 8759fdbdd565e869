"""Tensor-parallel serving of the port on the CPU, against the JAX package.

mla-tiny (4 heads) is served by MLAPolicy over gloo tp groups of 2 and 4
processes (tests/torch_tp_child.py; plain kernels on the CPU), each rank
holding its part of the decoder by JAX's _TP_RULES. The same weights, ids
and noise go through the JAX package unsharded (its MLAPolicy) and, for
DDIM, through tests/test_tp_serving.py's graph on a tp=4 x fsdp=2 mesh of
virtual devices, and through the port's one-process policies. Paths: fp32
(DDIM, DPM), bf16 (DDIM), W8A8 (DDIM, DPM), weight-only int8 on mla-tiny
widened to a 128-multiple decoder (DDIM and predict_action_ar's ids), and
a GQA 4:2 decoder in W8A8 at T = 2. Two controls must be caught: W8A8's
row max kept local, and the row-parallel all-reduce skipped. One spawn per
world size runs every scenario.

The same spawns serve over parallel/mesh.serving_mesh(fsdp=2) (the mesh of
tests/test_tp_serving.py: tp composed with fsdp), each rank keeping its
fsdp part of every leaf of the tree it serves and gathering it per use:
tp 1 x fsdp 2 at world 2, tp 2 x fsdp 2 at world 4. Their fp32 DDIM and
W8A8 DDIM / DPM chunks are bit-identical to the policy's over the same tp
without fsdp (the gather moves the leaves' bytes), the weight-only AR ids
and probabilities equal; each rank holds at most its tp-local stack /
fsdp plus the largest stacked leaf owned whole, gathers each layer once a
forward and holds at most 2 whole layers; a gather that zeroes the peer's
segment must be caught.

The same spawns run the calls of ROADMAP item 16 (a) and (b) over both
meshes (and in one process): the batched chunks (DDIM-8 and DPM-4 at B = 2
and 4, fp32 and W8A8) against JAX's serving graph fed the port's x_T,
unsharded and, for DDIM, on tp=4 x fsdp=2; beam search (K = 2 and 3) and
greedy text (generate_text, generate_text_batch) in fp32 and weight-only
int8 against JAX's _gen_fn and generate_text_batch; sampled text equal on
every rank and to one process; predict_action_batch's condition against
JAX's cognition feature, its chunk against one process; and the serving
host, rank 0's BatchingServer leading the others, each dispatch replayed
through one process.
"""

import contextlib
import dataclasses
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_policy_parity as tpp
import torch_tp_child as child
from test_torch_distributed import _load_and_remove, shared_runs
from mla_tpu.diffusion import gaussian as jgd
from mla_tpu.models import llama as jllama
from mla_tpu.models import mla as jmla
from mla_tpu.models import prismatic as jprismatic
from mla_tpu.ops import quantization as jq
from mla_tpu.parallel import make_mesh, sharding as jsharding
from mla_tpu_torch.models import mla as tmla
from mla_tpu_torch.params import from_jax, init
from mla_tpu_torch.parallel import mesh as tmesh

HERE = Path(__file__).resolve().parent
WORLDS = (2, 4)  # and a world of one: the one-process policies
CHILD_TIMEOUT = 300  # a hang guard: a world of 4 takes ~20 s alone
WIDE = dict(hidden_size=128, intermediate_size=384)  # JAX's weight-only kernel rule: K, N multiples of 128
JAX_INT8_MODE = {"w8a8": "w8a8", "weight_only": "pallas"}
# fp32 as tests/test_torch_policy_fp32.py, int8 as tests/test_torch_policy_int8.py;
# bf16: the decoder's activations round to bf16 (3 significant digits) at
# other places in XLA than in PyTorch
RTOL = {"fp32": 1e-4, "int8": 1e-3, "wide_int8": 1e-3, "gqa_int8": 1e-3, "bf16": 3e-2}
# (the GQA W8A8 chunk against JAX: 5e-3 of its scale, test_tp_chunk_matches_jax)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(workdir: Path, world: int):
    port = _free_port()
    base = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    base.update(OMP_NUM_THREADS="1", PYTHONPATH=str(HERE.parent))
    return [subprocess.Popen([sys.executable, str(HERE / "torch_tp_child.py"), str(workdir)],
                             env={**base, "MLA_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                                  "MLA_NUM_PROCESSES": str(world), "MLA_PROCESS_ID": str(r)},
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _wait(procs) -> None:
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


def _configs():
    """{tree: (JAX config, port config)}."""
    j, t = tpp.jconfig("mla-tiny"), tpp.tconfig("mla-tiny")

    def both(**fields):
        return (dataclasses.replace(j, llama=dataclasses.replace(j.llama, **fields)),
                dataclasses.replace(t, llama=dataclasses.replace(t.llama, **{
                    k: (torch.bfloat16 if v is jnp.bfloat16 else v) for k, v in fields.items()})))

    return {"fp32": (j, t), "bf16": both(compute_dtype=jnp.bfloat16), "wide": both(**WIDE),
            "gqa": both(num_kv_heads=2)}


def _gqa(params):
    """mla-tiny's tree with k and v cut to 2 of its 4 heads (GQA 4:2)."""
    hd = 16
    attn = params["llm_backbone"]["layers"]["attn"]
    cut = {k: {"w": attn[k]["w"][..., : 2 * hd]} for k in ("k", "v")}
    layers = {**params["llm_backbone"]["layers"], "attn": {**attn, **cut}}
    return {**params, "llm_backbone": {**params["llm_backbone"], "layers": layers}}


@contextlib.contextmanager
def _int8_mode(mode):
    prev = os.environ.get("MLA_INT8_MODE")
    os.environ["MLA_INT8_MODE"] = mode
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("MLA_INT8_MODE", None)
        else:
            os.environ["MLA_INT8_MODE"] = prev


def _jax_tp_ddim(params, state, cfg, ids, imgs, pcs, proprio, noise):
    """tests/test_tp_serving.py's graph (prefix embeds, prefill into a
    head-sharded cache, the read-only DDIM-8 suffix steps) jitted over a
    tp=4 x fsdp=2 mesh, for B rows (ids [B, L], frames, clouds, proprio [B,
    1, action_dim], noise [B, 16, 7])."""
    mesh = make_mesh(dp=1, fsdp=2, tp=4)
    p_sh = jax.tree_util.tree_map(jax.device_put, params, jsharding.param_shardings(params, mesh, use_tp=True))
    s_sh = jax.tree_util.tree_map(lambda x: jax.device_put(x, jsharding.replicate(mesh)), state)
    sched = jgd.create_schedule("ddim8", diffusion_steps=100)
    cache_max = ids.shape[1] - 1 + cfg.fused_len + 2 + cfg.action_horizon + 1 + 32

    @jax.jit
    def run(params, state, noise):
        prefix = jmla.build_prefix_embeds(params, state, cfg, jnp.asarray(ids[:, :-1]),
                                          {"front_image": jnp.asarray(imgs)}, jnp.asarray(pcs))
        kv, _ = jmla.prefill(params, cfg, prefix, cache_max, compute_logits=False)
        return jmla.ddim_denoise_actions(params, cfg, sched, kv, prefix.shape[1], jnp.asarray(proprio),
                                         jnp.asarray(ids[:, -1:]), noise)

    return np.asarray(run(p_sh, s_sh, jnp.asarray(noise)))


def _x_t(B):
    """The port's x_T of a batched call on the CPU (child.SEED)."""
    return torch.randn((B, 16, 7), generator=torch.Generator().manual_seed(child.SEED)).numpy()


def _proprio(jpol, states):
    pstats = jpol.get_proprio_stats(None)
    return np.stack([jmla.normalize_proprio(s, pstats) if s is not None else np.zeros(7, np.float32)
                     for s in states])[:, None, :]


def _jax_batched(tree):
    """JAX's serving graph (_diff_fn, unsharded) on child.BATCHED's rows of
    `tree`, fed the port's x_T: {'batched': {(tree, B, sampler): chunks}}."""

    def job(jtrees, req):
        params, state, cfg = jtrees[tree]
        imgs, pcs, ids, states = child.call_batch(cfg)
        out = {}
        with _int8_mode("w8a8"):
            jpol = jmla.MLAPolicy(params, state, cfg, tokenizer=None, norm_stats=tpp.STATS)
            for t, B, sampler in child.BATCHED:
                if t != tree:
                    continue
                fn = jpol._diff_fn(ids.shape[1] - 1, 1, use_ddpm=False, sampler=sampler)
                out[(tree, B, sampler)] = np.asarray(fn(
                    jpol.params, jpol.state, jnp.asarray(ids[:B, :-1]), jnp.asarray(ids[:B, -1:]),
                    {"front_image": jnp.asarray(imgs[:B])}, jnp.asarray(pcs[:B]),
                    jnp.asarray(_proprio(jpol, states[:B])), jnp.asarray(_x_t(B)), jax.random.PRNGKey(0)))
        return {"batched": out}

    return job


def _jax_batched_tp(B):
    """The DDIM rows of child.BATCHED at B through _jax_tp_ddim (tp=4 x
    fsdp=2): {'batched_tp': {(tree, B, 'ddim'): chunks}}."""

    def job(jtrees, req):
        out = {}
        for tree, b, sampler in child.BATCHED:
            if sampler != "ddim" or b != B:
                continue
            params, state, cfg = jtrees[tree]
            imgs, pcs, ids, states = child.call_batch(cfg)
            with _int8_mode("w8a8"):
                proprio = _proprio(jmla.MLAPolicy(params, state, cfg, tokenizer=None, norm_stats=tpp.STATS),
                                   states[:B])
                out[(tree, B, sampler)] = _jax_tp_ddim(params, state, cfg, ids[:B], imgs[:B], pcs[:B], proprio,
                                                       _x_t(B))
        return {"batched_tp": out}

    return job


def _jax_scenarios_tp(jtrees, req):
    """The request through _jax_tp_ddim (tp=4 x fsdp=2) on the fp32 and
    int8 trees: {'jax_tp': {scenario: chunk}} of fp32-ddim and w8a8-ddim."""
    out = {}
    for name, tree in (("fp32-ddim", "fp32"), ("w8a8-ddim", "int8")):
        params, state, cfg = jtrees[tree]
        with _int8_mode("w8a8"):
            out[name] = _jax_tp_ddim(params, state, cfg, req["ids"], req["img"][None], req["pc"][None],
                                     np.zeros((1, 1, cfg.action_dim), np.float32), req["noise"][None])[0]
    return {"jax_tp": out}


def _jax_ar(tree):
    """JAX's beam search (_gen_fn, K = 2 and 3 over two rows) and greedy
    generate_text_batch on `tree` of child.AR_TREES, unsharded: {'beams':
    {(tree, K): (ids, scores)}, 'text': {tree: strings}}; on the fp32 tree
    also the condition of predict_action_batch (the decoder's last hidden
    state of the DiT prompts): {'cognition': [2, 1, D]}."""

    def job(jtrees, req):
        out = {"beams": {}, "text": {}}
        oimgs, opcs = child.obs(req, 3)
        params, state, cfg = jtrees[tree]
        with _int8_mode(JAX_INT8_MODE[child.AR_TREES[tree]]):
            jpol = jmla.MLAPolicy(params, state, cfg, tokenizer=child.ToyTokenizer(), norm_stats=tpp.STATS)
            for K in (2, 3):
                fn = jpol._gen_fn(req["ids"].shape[1], child.BEAM_TOKENS, num_beams=K)
                toks, scores = fn(jpol.params, jpol.state, jnp.asarray(np.repeat(req["ids"], 2, 0)),
                                  {"front_image": jnp.asarray(np.stack(oimgs[:2]))}, jnp.asarray(np.stack(opcs[:2])),
                                  jax.random.PRNGKey(0))
                out["beams"][(tree, K)] = (np.asarray(toks), np.asarray(scores))
            out["text"][tree] = jpol.generate_text_batch(oimgs, opcs, child.PROMPTS, max_new_tokens=child.TEXT_TOKENS)
        if tree == "fp32":
            ids_dit = np.stack([jmla.build_prompt_ids(child.ToyTokenizer(), p, mode="ar")[0]
                                for p in child.PROMPTS[:2]])
            prefix = jmla.build_prefix_embeds(params, state, cfg, jnp.asarray(ids_dit),
                                              {"front_image": jnp.asarray(np.stack(oimgs[:2]))},
                                              jnp.asarray(np.stack(opcs[:2])))
            out["cognition"] = np.asarray(jllama.llama_forward(params["llm_backbone"], cfg.llama, prefix,
                                                               compute_logits=False)["last_hidden"][:, -1:])
        return out

    return job


# JAX's references of child.run_calls, each job run by the child named in
# JAX_JOB_RANKS ((world, rank)) once it is done with its own calls, beside
# this process's _jax_runs; JAX_JOB_TREES names the trees each job reads
JAX_JOBS = {"batched_fp32": _jax_batched("fp32"), "batched_int8": _jax_batched("int8"),
            "batched_tp_B2": _jax_batched_tp(2), "batched_tp_B4": _jax_batched_tp(4), "ar_fp32": _jax_ar("fp32"),
            "ar_int8": _jax_ar("wide_int8"), "scenarios_tp": _jax_scenarios_tp}
JAX_JOB_RANKS = {"ar_fp32": (1, 0), "batched_fp32": (1, 0), "ar_int8": (2, 0), "batched_int8": (2, 1),
                 "batched_tp_B4": (2, 1), "batched_tp_B2": (4, 1), "scenarios_tp": (4, 2)}
JAX_JOB_TREES = {"batched_fp32": ("fp32",), "batched_int8": ("int8",), "batched_tp_B2": ("fp32", "int8"),
                 "batched_tp_B4": ("fp32", "int8"), "ar_fp32": ("fp32",), "ar_int8": ("wide_int8",),
                 "scenarios_tp": ("fp32", "int8")}


def jax_float_trees():
    """{tree: (params, state, JAX config)}: the float trees of the
    scenarios, from their seeds."""
    params, state = tpp.model(seed=4)
    cfgs = _configs()
    wide_params, wide_state = jprismatic.mla_model_init(jax.random.PRNGKey(7), cfgs["wide"][0])
    jfloat = {"fp32": (params, state), "bf16": (params, state), "wide": (wide_params, wide_state),
              "gqa": (_gqa(params), state)}
    return {k: (*jfloat[k], cfgs[k][0]) for k in jfloat}


def with_int8(jtrees, names=tuple(child.QUANTIZED)) -> dict:
    """jtrees and child.QUANTIZED's int8 trees of `names` (JAX's
    quantize_model)."""
    out = dict(jtrees)
    for name in names:
        p, s, c = jtrees[child.QUANTIZED[name]]
        out[name] = (jq.quantize_model(p), s, c)
    return out


def run_jax_jobs(jobs, req, jtrees) -> dict:
    """JAX_JOBS' `jobs` on jtrees (JAX's trees, the float ones as numpy
    arrays in a child, and whatever int8 trees the jobs need), their
    results merged."""
    out: dict = {}
    jtrees = {k: (*jax.tree_util.tree_map(jnp.asarray, (p, s)), c) for k, (p, s, c) in jtrees.items()}
    jtrees = with_int8(jtrees, {t for j in jobs for t in JAX_JOB_TREES[j] if t in child.QUANTIZED})
    for job in jobs:
        for k, v in JAX_JOBS[job](jtrees, req).items():
            out.setdefault(k, {}).update(v) if isinstance(v, dict) else out.__setitem__(k, v)
    return out


def _jax_runs(jtrees, req):
    """{scenario: JAX's unsharded output} (the tp-sharded DDIM chunks are
    the scenarios_tp job's)."""
    unsharded = {}
    policies = {}
    for name, (tree, mode, call, sampler, _, ctrl) in child.SCENARIOS.items():
        if ctrl is not None:
            continue
        params, state, cfg = jtrees[tree]
        with _int8_mode(JAX_INT8_MODE[mode]):
            if (tree, mode) not in policies:
                policies[(tree, mode)] = jmla.MLAPolicy(params, state, cfg, tokenizer=None, norm_stats=tpp.STATS)
            pol = policies[(tree, mode)]
            if call == "diff":
                unsharded[name] = np.asarray(pol.predict_action_diff(
                    req["img"], req["pc"], "", input_ids=req["ids"], noise=req["noise"], sampler=sampler,
                    return_normalized=True))
            else:
                unsharded[name] = pol.predict_action_ar(req["img"], req["pc"], "", input_ids=req["ids"],
                                                        return_probs=True)
    return unsharded


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """Every scenario: each rank's output at worlds 2 and 4 (and over
    serving_mesh(fsdp=2)), the port's one-process output, JAX's unsharded
    and tp-sharded outputs, computed once a session and shared by the xdist
    workers (test_torch_distributed.shared_runs)."""
    return shared_runs(request, tmp_path_factory, "torch_tp_serving", _compute_runs)


def _compute_runs(work: Path):
    cfgs = _configs()
    jtrees = jax_float_trees()
    img, pc, ids, noise, _ = tpp.request()
    req = {"img": img, "pc": pc, "ids": ids, "noise": noise}
    jobs = {}
    for job, where in JAX_JOB_RANKS.items():
        jobs.setdefault(where, []).append(job)
    inputs = {"trees": {k: (from_jax(jtrees[k][0]), from_jax(jtrees[k][1]), cfgs[k][1]) for k in cfgs},
              "request": req, "stats": tpp.STATS, "jax_jobs": jobs,
              "jax_trees": {k: (*jax.tree_util.tree_map(np.asarray, jtrees[k][:2]), jtrees[k][2]) for k in ("fp32",
                                                                                                          "wide")}}
    torch.save(inputs, work / "inputs.pt")
    procs = {w: _launch(work, w) for w in (1, *WORLDS)}
    try:
        unsharded = _jax_runs(with_int8(jtrees), req)
    finally:
        for w in procs:
            _wait(procs[w])
    (work / "inputs.pt").unlink()
    ranks = {w: [_load_and_remove(work / f"out_w{w}_r{r}.pt") for r in range(w)] for w in procs}
    calls: dict = {}
    for w, r in jobs:
        for k, v in ranks[w][r].pop("jax").items():
            calls.setdefault(k, {}).update(v) if isinstance(v, dict) else calls.__setitem__(k, v)
    return {"ranks": ranks, "one": ranks.pop(1)[0], "jax": unsharded, "jax_tp": calls.pop("jax_tp"),
            "jax_calls": calls}


def _ar_actions(toks):
    tok = tmla.ActionTokenizer(None, vocab_size=32000)
    stats = tpp.STATS["rlbench"]["action"]
    return tmla.unnormalize_actions(tok.decode_token_ids_to_actions(np.asarray(toks)[0]), stats)


DIFF = [n for n, s in child.SCENARIOS.items() if s[2] == "diff" and s[5] is None]
CASES = [(w, n) for w in WORLDS for n in DIFF if w in child.SCENARIOS[n][4]]


@pytest.mark.parametrize("world,name", CASES, ids=[f"w{w}-{n}" for w, n in CASES])
def test_tp_chunk_matches_jax(runs, world, name, record_property):
    """The tp policy's chunk against JAX's unsharded run and, for DDIM in
    fp32 and W8A8, JAX's tp=4 x fsdp=2 run, at the slice's tolerances; and
    against the port's one-process chunk: the W8A8 chunk bit for bit (the
    row-parallel product's int32 sums are exact), the rest at the same
    tolerance."""
    tree = child.SCENARIOS[name][0]
    got = runs["ranks"][world][0][name]
    assert got.shape == (16, 7) and np.isfinite(got).all()
    rtol = RTOL[tree]
    record_property("max_abs_err_jax", float(np.abs(got - runs["jax"][name]).max()))
    if tree == "gqa_int8":
        # ROADMAP section 3, a known difference: a GQA W8A8 chunk of a
        # random model is held to 5e-3 of its scale against JAX, as in
        # tests/test_torch_mistral.py (a suffix row's quantization after an
        # ulp of difference in the DDIM update)
        assert float(np.abs(got - runs["jax"][name]).max()) <= 5e-3 * float(np.abs(runs["jax"][name]).max())
    else:
        np.testing.assert_allclose(got, runs["jax"][name], rtol=rtol, atol=rtol)
    if name in runs["jax_tp"]:
        np.testing.assert_allclose(got, runs["jax_tp"][name], rtol=rtol, atol=rtol)
    if child.SCENARIOS[name][1] == "w8a8" and "int8" in tree:
        np.testing.assert_array_equal(got, runs["one"][name])
    else:
        np.testing.assert_allclose(got, runs["one"][name], rtol=rtol, atol=rtol)


@pytest.mark.parametrize("world", WORLDS)
def test_tp_ar_matches_jax(runs, world):
    """predict_action_ar's ids over weight-only int8 (int8_mm's fp32
    partials on the row-parallel layers, the vocab-split lm_head's logits
    gathered): the one-process policy's ids and JAX's actions exactly, the
    per-token probabilities within the int8 tolerance."""
    toks, probs = runs["ranks"][world][0]["weight_only-ar"]
    one_toks, one_probs = runs["one"]["weight_only-ar"]
    np.testing.assert_array_equal(toks, np.asarray(one_toks))
    np.testing.assert_allclose(probs, np.asarray(one_probs), rtol=1e-5)
    jactions, jprobs = runs["jax"]["weight_only-ar"]
    np.testing.assert_array_equal(_ar_actions(toks), jactions)
    np.testing.assert_allclose(probs[0], jprobs, rtol=RTOL["int8"])


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same(runs, world):
    """Every scenario but the controls (which break the group's agreement)."""
    first = runs["ranks"][world][0]
    for other in runs["ranks"][world][1:]:
        assert set(other) == set(first)
        for name, out in first.items():
            if name.startswith("control-") or name in ("tensor_ops", "fsdp", "calls", "fsdp_calls", "host",
                                                       "fsdp_host", "serve_cli"):
                continue
            for a, b in zip(out if isinstance(out, tuple) else (out,), other[name] if isinstance(out, tuple)
                            else (other[name],)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", WORLDS)
def test_tensor_ops_forward_and_backward(runs, world):
    """parallel/tensor.py over gloo: reduce-from-tp sums forward and passes
    the gradient through, copy-to-tp passes forward and sums the ranks'
    gradients backward, gather-from-tp concatenates the last dim forward and
    keeps the rank's slice of the gradient backward, the all-reduce MAX, and
    the vocab-parallel lookup equal to the whole table's rows."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(world, 3, 4, generator=g).numpy()
    up = torch.randn(world, 3, 4 * world, generator=g).numpy()
    table = torch.randn(8 * world, 5, generator=g).numpy()
    ids = np.array([[0, 8 * world - 1, 3, 8], [5, 9, 8 * world - 2, 1]])
    for r in range(world):
        got = runs["ranks"][world][r]["tensor_ops"]
        np.testing.assert_allclose(got["reduce"], x.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(got["reduce_grad"], up[r][:, :4])
        np.testing.assert_array_equal(got["copy"], x[r])
        np.testing.assert_allclose(got["copy_grad"], up[:, :, :4].sum(0), rtol=1e-6)
        np.testing.assert_array_equal(got["gather"], np.concatenate(list(x), axis=-1))
        np.testing.assert_array_equal(got["gather_grad"], up[r][:, 4 * r:4 * r + 4])
        np.testing.assert_array_equal(got["max"], x[:, 0].max(0))
        np.testing.assert_array_equal(got["embed"], table[ids])


CONTROLS = [(w, n) for w in WORLDS for n in child.SCENARIOS if n.startswith("control-")]


@pytest.mark.parametrize("world,name", CONTROLS, ids=[f"w{w}-{n}" for w, n in CONTROLS])
def test_controls_are_caught(runs, world, name):
    """A tp group that quantizes each row from its own slice's max misses
    the bit-identity with the one-process chunk; one that skips the
    row-parallel all-reduce misses JAX's chunk (or ids and probabilities)."""
    got = runs["ranks"][world][0][name]
    if name == "control-wo-skip_reduce":
        toks, probs = got
        one_toks, one_probs = runs["one"]["weight_only-ar"]
        assert (toks != np.asarray(one_toks)).any() or not np.allclose(probs, one_probs, rtol=RTOL["int8"])
        return
    assert not np.array_equal(got, runs["one"]["w8a8-ddim"])
    if name == "control-skip_reduce":
        assert not np.allclose(got, runs["jax"]["w8a8-ddim"], rtol=RTOL["int8"], atol=RTOL["int8"])


# serving_mesh(fsdp=2): world -> (tp, the world whose tp-only policy it must equal: 1 is one process)
FSDP = {2: (1, 1), 4: (2, 2)}
FSDP_DIFF = [n for n, s in child.FSDP_SCENARIOS.items() if s[2] == "diff" and s[4] is None]
FSDP_CASES = [(w, n) for w in WORLDS for n in FSDP_DIFF]


def _tp_only(runs, world):
    """Rank 0's outputs of the policy over the same tp without fsdp."""
    want = FSDP[world][1]
    return runs["one"] if want == 1 else runs["ranks"][want][0]


@pytest.mark.parametrize("world,name", FSDP_CASES, ids=[f"w{w}-{n}" for w, n in FSDP_CASES])
def test_fsdp_chunk_equals_tp_alone(runs, world, name, record_property):
    """Over serving_mesh(fsdp=2) (tp 1 x fsdp 2 at world 2, tp 2 x fsdp 2 at
    world 4) every rank's chunk is bit for bit the chunk of the policy over
    the same tp without fsdp (one process at tp 1): the gather hands each
    leaf back byte for byte. The fp32 and W8A8 DDIM chunks are also within
    test_tp_chunk_matches_jax's tolerance of JAX's tp=4 x fsdp=2 graph."""
    tp, _ = FSDP[world]
    for r in range(world):
        got = runs["ranks"][world][r]["fsdp"]
        assert (got["mesh"]["tp"], got["mesh"]["fsdp"]) == (tp, 2)
        assert (got["mesh"]["tp_rank"], got["mesh"]["fsdp_rank"]) == (r % tp, r // tp)
        out = got["outputs"][name]
        assert out.shape == (16, 7) and np.isfinite(out).all()
        np.testing.assert_array_equal(out, _tp_only(runs, world)[name])
    if name in runs["jax_tp"]:
        rtol = RTOL[child.SCENARIOS[name][0]]
        out = runs["ranks"][world][0]["fsdp"]["outputs"][name]
        record_property("max_abs_err_jax_tp", float(np.abs(out - runs["jax_tp"][name]).max()))
        np.testing.assert_allclose(out, runs["jax_tp"][name], rtol=rtol, atol=rtol)


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_ar_ids_equal_tp_alone(runs, world):
    """predict_action_ar's core (weight-only int8, 7 greedy tokens) over
    serving_mesh(fsdp=2): the ids and the per-token probabilities of the
    policy over the same tp without fsdp, exactly, on every rank."""
    want = _tp_only(runs, world)["weight_only-ar"]
    for r in range(world):
        toks, probs = runs["ranks"][world][r]["fsdp"]["outputs"]["weight_only-ar"]
        np.testing.assert_array_equal(toks, np.asarray(want[0]))
        np.testing.assert_array_equal(probs, np.asarray(want[1]))


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_layer_stack_and_gathers(runs, world):
    """Each rank holds at most its tp-local fused stack / fsdp plus the
    largest stacked leaf one rank owns whole (the storages of its parts:
    no view into a whole leaf), the fsdp group together holds that stack
    once, and the tp-local stack is the one-process stack / T plus the
    leaves each tp rank keeps whole (norms, row-parallel scales). A call
    gathers each layer once a forward (L x (1 prefill + 8 suffix
    evaluations) for DDIM-8, L x (1 + 4) for DPM-4, L x (1 + 7 decode steps)
    for 7 AR tokens), the other leaves in at least one gather, and holds at
    most 2 whole layers, none after the call."""
    tp, _ = FSDP[world]
    forwards = {"fp32-ddim": 9, "w8a8-ddim": 9, "w8a8-dpm": 5, "weight_only-ar": 1 + child.AR_TOKENS}
    ranks = [runs["ranks"][world][r]["fsdp"] for r in range(world)]
    for key in ranks[0]["layer_bytes"]:
        for got in ranks:
            b = got["layer_bytes"][key]
            assert b["held"] <= b["stack"] / 2 + b["unit"], (key, b)
            assert b["held"] < b["stack"], (key, b)
            assert b["stack"] == (b["one_process"] - b["tp_whole"]) / tp + b["tp_whole"], (key, b)
        for t in range(tp):  # the fsdp group of tp rank t: global ranks t and tp + t
            group = [ranks[t]["layer_bytes"][key], ranks[tp + t]["layer_bytes"][key]]
            assert sum(b["held"] for b in group) == group[0]["stack"], (key, group)
    for got in ranks:
        for name, n in forwards.items():
            c = got["counts"][name]
            assert c["layer_gathers"] == c["num_layers"] * n, (name, c)
            assert c["gathers"] >= 1 and 1 <= c["max_live_layers"] <= 2 and c["live_layers"] == 0, (name, c)


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_control_is_caught(runs, world):
    """A gather on rank 0 that hands back the peer's segment zeroed (the
    leaves the other fsdp rank holds) misses the bit-identity with the
    policy over tp alone."""
    got = runs["ranks"][world][0]["fsdp"]["outputs"]["control-fsdp-zero_peer"]
    assert not np.array_equal(got, _tp_only(runs, world)["w8a8-ddim"])
    assert not np.allclose(got, runs["jax"]["w8a8-ddim"], rtol=RTOL["int8"], atol=RTOL["int8"])


# ROADMAP item 16 (a) and (b): every call over each world's two meshes, "tp"
# (serving_mesh(): a tp group of the world) and "fsdp" (serving_mesh(fsdp=2))
MESHES = [(w, m) for w in WORLDS for m in ("tp", "fsdp")]
MESH_IDS = [f"w{w}-{m}" for w, m in MESHES]


def _calls(runs, world, mesh, r=0):
    return runs["ranks"][world][r]["calls" if mesh == "tp" else "fsdp_calls"]


def _tp_alone_calls(runs, world):
    """The calls of the policy over the same tp as world's fsdp mesh,
    without fsdp (one process at tp 1)."""
    want = FSDP[world][1]
    return runs["one"]["calls"] if want == 1 else runs["ranks"][want][0]["calls"]


def _every_rank(runs, world, mesh, pick):
    """pick(calls) of every rank, asserted equal to rank 0's; returns it."""
    first = pick(_calls(runs, world, mesh))
    for r in range(1, world):
        other = pick(_calls(runs, world, mesh, r))
        for a, b in zip(first if isinstance(first, tuple) else (first,), other if isinstance(other, tuple)
                        else (other,)):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    return first


BATCHED_CASES = [(w, m, *c) for w, m in MESHES for c in child.BATCHED]


@pytest.mark.parametrize("world,mesh,tree,B,sampler", BATCHED_CASES,
                         ids=[f"w{w}-{m}-{t}-B{b}-{s}" for w, m, t, b, s in BATCHED_CASES])
def test_batched_chunks_over_the_mesh(runs, world, mesh, tree, B, sampler, record_property):
    """predict_action_diff_batched (through dispatch_action_diff_batched)
    at B rows over the mesh: every rank's chunks equal; against JAX's
    serving graph fed the port's x_T, unsharded and, for DDIM, on tp=4 x
    fsdp=2: fp32 at test_tp_chunk_matches_jax's tolerance, W8A8 within 5e-3
    of the chunk's scale, the GQA case's bound there (ROADMAP section 3: at
    B = 4 one row's W8A8 activation rounds to the next int8 step in one
    package and not the other, which the one-process port shows as well,
    ~1e-3 of the scale); against the one-process port, W8A8 bit for bit,
    fp32 at its tolerance; over fsdp bit for bit the chunks of the same tp
    without fsdp."""
    key = (tree, B, sampler)
    got = _every_rank(runs, world, mesh, lambda c: c["batched"][key])
    assert got.shape == (B, 16, 7) and np.isfinite(got).all()
    rtol = RTOL[tree]
    for name, ref in (("jax", runs["jax_calls"]["batched"][key]), ("jax_tp", runs["jax_calls"]["batched_tp"].get(key))):
        if ref is None:
            continue
        record_property(f"max_abs_err_{name}", float(np.abs(got - ref).max()))
        if tree == "int8":
            assert float(np.abs(got - ref).max()) <= 5e-3 * float(np.abs(ref).max())
        else:
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol)
    one = runs["one"]["calls"]["batched"][key]
    if tree == "int8":
        np.testing.assert_array_equal(got, one)
    else:
        np.testing.assert_allclose(got, one, rtol=rtol, atol=rtol)
    if mesh == "fsdp":
        np.testing.assert_array_equal(got, _tp_alone_calls(runs, world)["batched"][key])


AR_CASES = [(w, m, t) for w, m in MESHES for t in child.AR_TREES]


@pytest.mark.parametrize("world,mesh,tree", AR_CASES, ids=[f"w{w}-{m}-{t}" for w, m, t in AR_CASES])
def test_beams_and_text_over_the_mesh(runs, world, mesh, tree, record_property):
    """Beam search (K = 2 and 3 over two rows, 5 tokens) and greedy text
    (generate_text_batch over prompts of two token lengths, generate_text)
    over the mesh, fp32 and weight-only int8: every rank's ids, scores and
    strings equal; the ids and strings JAX's (_gen_fn, generate_text_batch,
    unsharded), the scores within the tree's tolerance; over fsdp the same
    as the tp without fsdp."""
    rtol = 1e-5 if tree == "fp32" else RTOL["int8"]
    for K in (2, 3):
        toks, scores = _every_rank(runs, world, mesh, lambda c: c["beams"][(tree, K)])
        jtoks, jscores = runs["jax_calls"]["beams"][(tree, K)]
        np.testing.assert_array_equal(toks, jtoks)
        record_property(f"max_rel_err_scores_K{K}", float(np.max(np.abs(scores - jscores) / np.abs(jscores))))
        np.testing.assert_allclose(scores, jscores, rtol=rtol)
        if mesh == "fsdp":
            want = _tp_alone_calls(runs, world)["beams"][(tree, K)]
            np.testing.assert_array_equal(toks, want[0])
            np.testing.assert_array_equal(scores, want[1])
    batch, alone = _every_rank(runs, world, mesh, lambda c: c["text"][tree])
    assert list(batch) == runs["jax_calls"]["text"][tree]
    assert alone == batch[2]


@pytest.mark.parametrize("world,mesh", MESHES, ids=MESH_IDS)
def test_sampled_text_over_the_mesh(runs, world, mesh):
    """generate_ids and generate_text_batch sampled (temperature 0.7, top-k
    50, seed 5) over the mesh in fp32: every rank's ids and strings equal,
    and equal to the one-process port's with the same seed."""
    ids, texts = _every_rank(runs, world, mesh, lambda c: c["sampled"])
    one_ids, one_texts = runs["one"]["calls"]["sampled"]
    np.testing.assert_array_equal(ids, one_ids)
    assert list(texts) == list(one_texts)
    greedy = _calls(runs, world, mesh)["text"]["fp32"][0]
    assert list(texts) != list(greedy)  # the draws are not the greedy ids


@pytest.mark.parametrize("world,mesh", MESHES, ids=MESH_IDS)
def test_predict_action_batch_over_the_mesh(runs, world, mesh, record_property):
    """predict_action_batch (cfg_scale 1.5, DDIM-3) over the mesh: the
    condition, cognition_feature on the tree tp_scope() yields, within 1e-5
    of JAX's; every rank's chunk equal, within the fp32 tolerance of the
    one-process port's with the same seed, over fsdp bit for bit the tp
    without fsdp's."""
    z, chunk = _every_rank(runs, world, mesh, lambda c: c["dit"])
    jz = runs["jax_calls"]["cognition"]
    record_property("max_abs_err_cognition", float(np.abs(z - jz).max()))
    np.testing.assert_allclose(z, jz, rtol=1e-5, atol=1e-5)
    assert chunk.shape == (2, 16, 7) and np.isfinite(chunk).all()
    np.testing.assert_allclose(chunk, runs["one"]["calls"]["dit"][1], rtol=RTOL["fp32"], atol=RTOL["fp32"])
    if mesh == "fsdp":
        np.testing.assert_array_equal(chunk, _tp_alone_calls(runs, world)["dit"][1])


@pytest.mark.parametrize("world,mesh", MESHES, ids=MESH_IDS)
def test_serving_host_over_the_mesh(runs, world, mesh):
    """A BatchingServer on rank 0 (DPM-4, buckets 1/2/4) over a W8A8
    policy leading the mesh's other ranks: 9 requests from two threads
    and the main one, no error, every dispatch run by every follower in
    order (the children exit 0 after rank 0 closes the channel), and each
    dispatch replayed through the one-process policy bit for bit."""
    key = "host" if mesh == "tp" else "fsdp_host"
    lead = runs["ranks"][world][0][key]
    assert lead["requests"] == 9 and lead["errors"] == 0, lead
    assert lead["dispatches"] == sum(lead["buckets"].values()) >= 3, lead
    assert set(lead["buckets"]) <= {1, 2, 4}, lead
    assert lead["replay_equal"] and lead["replay_max_abs"] == 0.0, lead
    for r in range(1, world):
        assert runs["ranks"][world][r][key] == {"followed": lead["dispatches"]}


def test_serve_cli_over_the_mesh(runs):
    """`python -m mla_tpu_torch.serve --fsdp 2`'s main under the launch's
    variables at world 2 (tp 1 x fsdp 2), a run dir of mla-tiny: rank 0
    answers every request over HTTP with a [16, 7] chunk, no error; the
    other rank follows, and every rank's main returns after rank 0's
    SIGINT (the children exit 0)."""
    lead, follower = (runs["ranks"][2][r]["serve_cli"] for r in range(2))
    assert sorted(lead["answers"]) == [(200, (16, 7))] * child.SERVE_REQUESTS
    assert lead["stats"]["errors"] == 0 and lead["stats"]["requests"] == child.SERVE_REQUESTS
    assert lead["returned"] and follower == {"returned": True}


@pytest.mark.parametrize("M,dtype", [(1, torch.bfloat16), (18, torch.float32), (70, torch.bfloat16)])
def test_rowpar_products_without_a_group_are_the_whole_row_products(M, dtype):
    """Without a group the row-parallel W8A8 (its three steps and its plain
    twin) is W8A8 bit for bit, int32 sums included, and the weight-only
    product's fp32 output is its product before the rounding to x's
    dtype."""
    from mla_tpu_torch.ops import quantization as tq

    g = torch.Generator().manual_seed(M)
    x = torch.randn(M, 128, generator=g).to(dtype)
    w_q = torch.randint(-127, 128, (128, 64), generator=g, dtype=torch.int8)
    ws = torch.rand(64, generator=g) * 1e-3 + 1e-4
    y, acc = tq.w8a8_matmul(x, w_q.t(), ws, return_acc=True)
    for fn in (tq.w8a8_matmul_rowpar, tq.w8a8_matmul_rowpar_plain):
        y2, acc2 = fn(x, w_q.t(), ws, return_acc=True)
        assert y2.dtype == dtype and torch.equal(acc2, acc) and torch.equal(y2, y)
    full = tq.int8_matmul(x, w_q, ws, out_dtype=torch.float32)
    assert full.dtype == torch.float32 and torch.equal(full.to(dtype), tq.int8_matmul(x, w_q, ws))
    assert torch.equal(tq.int8_matmul_rowpar(x, w_q, ws), tq.int8_matmul(x, w_q, ws))


# --------------------------------------------------------------------------- #
# Refusals
# --------------------------------------------------------------------------- #


def _tiny_port(num_kv_heads=4):
    """The port's own seeded mla-tiny (the refusals need no JAX weights)."""
    cfg = _configs()["gqa" if num_kv_heads == 2 else "fp32"][1]
    params, state = init(cfg, seed=0, device="cpu")
    return params, state, cfg


@pytest.mark.parametrize("tp,kv", [(4, 2), (8, 4)], ids=["kv-heads", "heads"])
def test_heads_that_tp_does_not_divide_raise(tp, kv):
    """JAX's GSPMD may split mid-head; the port's layer splits whole heads
    and refuses a T that does not divide the head counts."""
    params, state, cfg = _tiny_port(kv)
    with pytest.raises(NotImplementedError, match=r"item 16 \(tensor-parallel serving: heads that T does not divide"):
        tmla.MLAPolicy(params, state, cfg, device="cpu", mesh=tmesh.Mesh(1, 1, tp, rank=0))


def test_serving_world_larger_than_tp_raises():
    """The port serves over tp composed with fsdp (dp = 1, JAX's
    tests/test_tp_serving.py mesh; JAX's MLAPolicy takes no mesh): a
    serving mesh with dp beside tp or fsdp, or dp alone, is item 16 (g),
    and no mesh of more than one rank is ignored."""
    params, state, cfg = _tiny_port()
    for dp, fsdp, tp in ((2, 1, 2), (2, 2, 1), (2, 1, 1)):
        with pytest.raises(NotImplementedError,
                           match=r"item 16 \(tensor-parallel serving: \(g\) a serving mesh with dp beside tp or fsdp"):
            tmla.MLAPolicy(params, state, cfg, device="cpu", mesh=tmesh.Mesh(dp, fsdp, tp, rank=0))


@pytest.mark.parametrize("fsdp,tp", [(2, 1), (2, 2)], ids=["fsdp2", "tp2xfsdp2"])
def test_refusals_hold_over_an_fsdp_mesh(fsdp, tp):
    """Item 16's refusals (a phi decoder, int4, heads that T does not
    divide) apply to every serving mesh of more than one rank, fsdp alone
    included; the policy keeps its fsdp part of every leaf (an empty
    placeholder where the other rank owns one). The batched calls and text
    generation serve over the mesh (test_*_over_the_mesh)."""
    from mla_tpu_torch.ops import quantization as tq
    from mla_tpu_torch.params import tree_items

    params, state, cfg = _tiny_port()
    mesh = tmesh.Mesh(1, fsdp, tp, rank=0)
    with pytest.raises(NotImplementedError, match=r"item 16 \(tensor-parallel serving: mla-phi"):
        tmla.MLAPolicy(params, state, dataclasses.replace(cfg, llm_family="phi"), device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match=r"item 16 \(tensor-parallel serving: heads that T does not divide"):
        tmla.MLAPolicy(*_tiny_port(num_kv_heads=2), device="cpu", mesh=tmesh.Mesh(1, fsdp, 4, rank=0))
    with pytest.raises(NotImplementedError, match=r"item 16 \(tensor-parallel serving: int4"):
        tmla.MLAPolicy(tq.quantize_model_int4(params, group_size=0), state, cfg, device="cpu", mesh=mesh)
    pol = tmla.MLAPolicy(params, state, cfg, device="cpu", mesh=mesh, norm_stats=tpp.STATS)
    whole = dict(tree_items(tmla.MLAPolicy(params, state, cfg, device="cpu").params))
    held = dict(tree_items(pol.params))
    assert set(held) == set(whole) == {leaf.path for leaf in pol.gatherer.leaves}
    for leaf in pol.gatherer.leaves:
        if tp == 1:
            assert leaf.shape == tuple(whole[leaf.path].shape), leaf.path
        if leaf.spec.dim is not None:
            assert held[leaf.path].numel() * fsdp == math.prod(leaf.shape), leaf.path
            assert not (leaf.path.startswith("llm_backbone/layers/") and leaf.spec.dim == 0), leaf.path
        else:
            assert held[leaf.path].numel() == (math.prod(leaf.shape) if leaf.spec.owner == 0 else 0), leaf.path
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.serving_mesh(fsdp=2)  # a world of one process


def test_int4_and_other_entries_raise_under_tp():
    """An int4 tree raises over a tp group (item 16 (d)); the other entry
    points serve over it (test_*_over_the_mesh), on this rank's half of the
    decoder."""
    from mla_tpu_torch.ops import quantization as tq

    params, state, cfg = _tiny_port()
    mesh = tmesh.Mesh(1, 1, 2, rank=0)
    with pytest.raises(NotImplementedError, match=r"item 16 \(tensor-parallel serving: int4"):
        tmla.MLAPolicy(tq.quantize_model_int4(params, group_size=0), state, cfg, device="cpu", mesh=mesh)
    pol = tmla.MLAPolicy(params, state, cfg, device="cpu", mesh=mesh, norm_stats=tpp.STATS)
    # this rank's half of the decoder: q's output dim and o's input dim cut in two
    attn = pol.params["llm_backbone"]["layers"]["attn"]
    assert attn["qkv_fused"]["w"].shape[-1] == 3 * 64 // 2 and attn["o"]["w"].shape[-2] == 64 // 2
