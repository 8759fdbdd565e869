"""The port's dynamic-batching serving host (mla_tpu_torch/serving/) against
the JAX package's: every logic test of tests/test_serving.py on the port's
BatchingServer over a fake policy, one scripted submission sequence through
both servers in lockstep, and the real composed mla-tiny policy (CPU)
behind the port's server."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest

from mla_tpu.serving import BatchingServer as JaxBatchingServer
from mla_tpu_torch.models.mla import build_prompt_ids
from mla_tpu_torch.serving import BatchingServer, QueueFull
from mla_tpu_torch.vla.tokenizer import SimpleTokenizer


class FakePolicy:
    """Shape-faithful stand-in: row b of the output encodes (row index into
    the submitted batch, mean of that row's image), so a test can tell that
    each caller gets its own row back and that padding rows are dropped.
    Dispatch is cheap and records the call; finalize sleeps delay_s, the
    device's execution."""

    def __init__(self, action_dim=7, horizon=16, fail=False, delay_s=0.0):
        self.cfg = SimpleNamespace(action_dim=action_dim, action_horizon=horizon,
                                   vision=SimpleNamespace(image_size=32))
        self.tokenizer = SimpleTokenizer()
        self.calls = []
        self.fail = fail
        self.delay_s = delay_s

    def dispatch_action_diff_batched(self, images, pcs, instruction=None, *, input_ids=None, cur_robot_states=None,
                                     unnorm_key=None, seed=0, sampler="ddim", num_dpm_steps=4, num_ddim_steps=None):
        if self.fail:
            raise RuntimeError("device on fire")
        B = images.shape[0]
        call = {"B": B, "L": int(input_ids.shape[1]), "sampler": sampler, "unnorm_key": unnorm_key,
                "proprio": cur_robot_states, "seed": seed, "dispatch_t": time.monotonic()}
        self.calls.append(call)

        def finalize():
            if self.delay_s:
                time.sleep(self.delay_s)
            call["finalize_t"] = time.monotonic()
            out = np.zeros((B, self.cfg.action_horizon, self.cfg.action_dim), np.float32)
            out[:, 0, 0] = np.arange(B)
            out[:, 0, 1] = images.reshape(B, -1).mean(axis=1)
            return out

        return finalize


def _obs(v: float, size=32, pts=64):
    return np.full((4, size, size), v, np.float32), np.full((pts, 3), v, np.float32)


def test_concurrent_requests_coalesce_into_one_padded_call():
    policy = FakePolicy(delay_s=0.3)
    with BatchingServer(policy, buckets=(1, 2, 4), max_wait_ms=5) as srv:
        # the first request's window closes before the others arrive; its
        # slow call keeps the worker busy while three more queue up, and
        # they coalesce into one call padded to bucket 4
        futs = [srv.submit(*_obs(0.0), "close the box")]
        time.sleep(0.1)
        futs += [srv.submit(*_obs(float(i)), "close the box") for i in (1, 2, 3)]
        results = [f.result(timeout=10) for f in futs]
    assert [c["B"] for c in policy.calls] == [1, 4]
    for i, r in enumerate(results):
        assert r.shape == (16, 7)
        assert r[0, 1] == pytest.approx(float(i))
    s = srv.stats()
    assert s["requests"] == 4 and s["device_calls"] == 2
    assert s["padded_rows"] == 1 and s["errors"] == 0
    assert s["avg_batch_size"] == pytest.approx(2.5)


def test_requests_group_by_prompt_length_and_unnorm_key():
    policy = FakePolicy(delay_s=0.3)
    tok = SimpleTokenizer()
    short = build_prompt_ids(tok, "go", mode="diff")
    long = build_prompt_ids(tok, "carefully close the upper drawer", mode="diff")
    assert short.shape[1] != long.shape[1]
    with BatchingServer(policy, buckets=(1, 2, 4), max_wait_ms=5) as srv:
        warm = srv.submit(*_obs(9.0), input_ids=short)
        time.sleep(0.1)
        futs = [srv.submit(*_obs(1.0), input_ids=short), srv.submit(*_obs(2.0), input_ids=long),
                srv.submit(*_obs(3.0), input_ids=short), srv.submit(*_obs(4.0), input_ids=short, unnorm_key="b")]
        for f in [warm] + futs:
            f.result(timeout=10)
    assert sorted((c["B"], c["L"], str(c["unnorm_key"])) for c in policy.calls[1:]) == sorted(
        [(2, short.shape[1], "None"), (1, long.shape[1], "None"), (1, short.shape[1], "b")])


def test_depth2_pipelining_dispatches_next_batch_during_execution():
    """With more waiting requests than one bucket holds, batch 2 is
    dispatched before the worker blocks on batch 1's results."""
    policy = FakePolicy(delay_s=0.25)
    with BatchingServer(policy, buckets=(1, 2), max_wait_ms=5) as srv:
        warm = srv.submit(*_obs(9.0), "x")
        time.sleep(0.05)
        futs = [srv.submit(*_obs(float(i)), "x") for i in range(4)]
        for f in [warm] + futs:
            f.result(timeout=10)
    b1, b2 = policy.calls[1], policy.calls[2]
    assert (b1["B"], b2["B"]) == (2, 2)
    assert b2["dispatch_t"] < b1["finalize_t"], "the second batch was not dispatched while the first executed"


def test_dispatch_ahead_depth_is_capped_at_two():
    """Under sustained overload call i's dispatch waits for call i-2's
    results (at most two device calls in flight)."""
    policy = FakePolicy(delay_s=0.1)
    with BatchingServer(policy, buckets=(1,), max_wait_ms=1) as srv:
        futs = [srv.submit(*_obs(float(i)), "x") for i in range(6)]
        for f in futs:
            f.result(timeout=10)
    calls = policy.calls
    assert len(calls) == 6
    for i in range(2, len(calls)):
        assert calls[i]["dispatch_t"] >= calls[i - 2]["finalize_t"], f"call {i} dispatched before call {i - 2} ended"


def test_error_propagates_to_every_caller_and_server_survives():
    policy = FakePolicy(fail=True)
    with BatchingServer(policy, max_wait_ms=1) as srv:
        f1 = srv.submit(*_obs(0.0), "x")
        f2 = srv.submit(*_obs(1.0), "x")
        for f in (f1, f2):
            with pytest.raises(RuntimeError, match="device on fire"):
                f.result(timeout=10)
        policy.fail = False
        assert srv.submit(*_obs(2.0), "x").result(timeout=10).shape == (16, 7)
        assert srv.stats()["errors"] >= 1


def test_per_request_proprio_reaches_the_batch():
    policy = FakePolicy()
    with BatchingServer(policy, max_wait_ms=1) as srv:
        srv.submit(*_obs(0.0), "x", cur_robot_state=np.full(7, 0.5, np.float32)).result(timeout=10)
    assert policy.calls[-1]["proprio"] is not None
    np.testing.assert_allclose(policy.calls[-1]["proprio"][0], np.full(7, 0.5))


def test_proprio_less_rows_pass_none_through_mixed_batches():
    """A proprio-less request coalesced with proprio-bearing ones reaches the
    policy as a per-row None (normalized zero), not a raw zero vector."""
    policy = FakePolicy(delay_s=0.3)
    with BatchingServer(policy, buckets=(1, 2, 4), max_wait_ms=5) as srv:
        futs = [srv.submit(*_obs(0.0), "x")]
        time.sleep(0.1)
        futs.append(srv.submit(*_obs(1.0), "x"))
        futs.append(srv.submit(*_obs(2.0), "x", cur_robot_state=np.full(7, 0.5, np.float32)))
        for f in futs:
            f.result(timeout=10)
    mixed = next(c for c in policy.calls if c["B"] >= 2)
    assert mixed["proprio"] is not None and mixed["proprio"][0] is None
    np.testing.assert_allclose(np.asarray(mixed["proprio"][1]), np.full(7, 0.5))


def test_max_pending_sheds_load_and_recovers():
    policy = FakePolicy(delay_s=0.2)
    with BatchingServer(policy, buckets=(1,), max_wait_ms=1, max_pending=2) as srv:
        f1 = srv.submit(*_obs(0.0), "x")
        f2 = srv.submit(*_obs(1.0), "x")
        with pytest.raises(QueueFull):
            srv.submit(*_obs(2.0), "x")
        assert srv.stats()["rejected"] == 1
        f1.result(timeout=10)
        f2.result(timeout=10)
        assert srv.submit(*_obs(3.0), "x").result(timeout=10).shape == (16, 7)


def test_bucket_validation():
    with pytest.raises(ValueError, match="buckets"):
        BatchingServer(FakePolicy(), buckets=(4, 2))
    with pytest.raises(ValueError, match="buckets"):
        BatchingServer(FakePolicy(), buckets=())


def test_latency_stats_and_batch_histogram():
    policy = FakePolicy(delay_s=0.05)
    with BatchingServer(policy, buckets=(1, 2, 4), max_wait_ms=5) as srv:
        warm = srv.submit(*_obs(0.0), "close the box")
        time.sleep(0.1)
        futs = [srv.submit(*_obs(float(i)), "close the box") for i in (1, 2, 3)]
        for f in [warm] + futs:
            f.result(timeout=10)
        s = srv.stats()
    assert s["batch_size_hist"] == {1: 1, 4: 1}
    assert s["pending"] == 0
    for key in ("queue_wait_ms", "e2e_ms"):
        assert s[key]["window"] == 4
        assert 0.0 <= s[key]["p50"] <= s[key]["p95"] <= s[key]["max"]
    for key in ("assemble_dispatch_ms", "finalize_block_ms"):
        assert s[key]["window"] == 2
    assert s["e2e_ms"]["p50"] >= 50.0
    assert s["e2e_ms"]["max"] >= s["queue_wait_ms"]["max"]


def test_reset_latency_stats_clears_rings_keeps_counters():
    policy = FakePolicy(delay_s=0.01)
    with BatchingServer(policy, buckets=(1,), max_wait_ms=1) as srv:
        srv.submit(*_obs(0.0), "close the box").result(timeout=10)
        srv.reset_latency_stats()
        s = srv.stats()
        assert s["requests"] == 1 and s["device_calls"] == 1
        assert "e2e_ms" not in s and "queue_wait_ms" not in s
        srv.submit(*_obs(1.0), "close the box").result(timeout=10)
        s = srv.stats()
        assert s["e2e_ms"]["window"] == 1 and s["requests"] == 2


def test_close_drains_what_was_submitted_and_refuses_more():
    """close() puts its stop mark behind the queued requests: each of them
    is served, then submit() raises."""
    policy = FakePolicy(delay_s=0.1)
    srv = BatchingServer(policy, buckets=(1,), max_wait_ms=1)
    futs = [srv.submit(*_obs(float(i)), "x") for i in range(4)]
    time.sleep(0.05)
    srv.close()
    assert [float(f.result(timeout=10)[0, 1]) for f in futs] == [0.0, 1.0, 2.0, 3.0]
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(*_obs(0.0), "x")


def _scripted(server_cls):
    """One submission sequence with fixed gaps: a slow warm call, then, while
    it runs, five requests of two prompt lengths, two unnorm keys and one
    proprio, and a sixth refused by max_pending. Returns (the device calls,
    the stats counters)."""
    policy = FakePolicy(delay_s=0.6)
    tok = SimpleTokenizer()
    short = build_prompt_ids(tok, "go", mode="diff")
    long = build_prompt_ids(tok, "carefully close the upper drawer", mode="diff")
    rejected = 0
    with server_cls(policy, buckets=(1, 2, 4), max_wait_ms=5, max_pending=6, sampler="dpm") as srv:
        futs = [srv.submit(*_obs(9.0), input_ids=short)]
        time.sleep(0.25)
        futs += [srv.submit(*_obs(1.0), input_ids=short),
                 srv.submit(*_obs(2.0), input_ids=short, cur_robot_state=np.full(7, 0.5, np.float32)),
                 srv.submit(*_obs(3.0), input_ids=long),
                 srv.submit(*_obs(4.0), input_ids=short),
                 srv.submit(*_obs(5.0), input_ids=short, unnorm_key="other")]
        try:
            srv.submit(*_obs(6.0), input_ids=short)
        except Exception as e:  # each package's own QueueFull
            rejected += type(e).__name__ == "QueueFull"
        rows = [f.result(timeout=10) for f in futs]
        stats = srv.stats()
    calls = [(c["B"], c["L"], c["unnorm_key"], c["sampler"],
              None if c["proprio"] is None else [p is not None for p in c["proprio"]]) for c in policy.calls]
    counters = {k: stats[k] for k in ("requests", "device_calls", "padded_rows", "batch_size_sum", "errors",
                                      "rejected", "batch_size_hist", "pending", "avg_batch_size")}
    return calls, counters, [float(r[0, 1]) for r in rows], rejected


def test_lockstep_with_the_jax_server():
    """The same scripted sequence through JAX's and the port's server over
    the same fake: the same device calls (batch, prompt length, unnorm key,
    sampler, which rows carry proprio; padding repeats the last row) and the
    same stats() counters, and every caller its own row."""
    jax_calls, jax_counters, jax_rows, jax_rej = _scripted(JaxBatchingServer)
    calls, counters, rows, rej = _scripted(BatchingServer)
    assert calls == jax_calls
    assert counters == jax_counters
    assert rows == jax_rows == [9.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    assert rej == jax_rej == 1
    # the warm call, then short x3 padded to 4 (the proprio row's group),
    # long x1, and the other unnorm key's call
    assert [c[0] for c in calls] == [1, 4, 1, 1]
    assert calls[1][4] == [False, True, False, False]


# --------------------------------------------------------------------------- #
# the real composed mla-tiny policy (CPU) behind the server
# --------------------------------------------------------------------------- #


STATS = {"t": {"action": {"q01": [-1.0] * 7, "q99": [1.0] * 7}, "proprio": {"q01": [-1.0] * 7, "q99": [1.0] * 7}}}


@pytest.fixture(scope="module")
def tiny_policy():
    from torch_policy_parity import model

    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.models.mla import MLAPolicy
    from mla_tpu_torch.params import from_jax

    params, state = model()
    return MLAPolicy(from_jax(params), from_jax(state), get_model_config("mla-tiny"), tokenizer=SimpleTokenizer(),
                     norm_stats=STATS, device="cpu")


def _tiny_obs(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    imgs = [rng.integers(0, 256, size=(3, size, size), dtype=np.uint8) for _ in range(n)]
    pcs = [rng.normal(size=(cfg.point.input_points, 3)).astype(np.float32) for _ in range(n)]
    return imgs, pcs


def test_real_tiny_policy_through_server(tiny_policy):
    """Two concurrent requests with different proprio coalesce into one B=2
    call whose rows equal a direct predict_action_diff_batched of the same
    batch, seed and sampler (exact: the same function on the same inputs);
    a third, padded into the same bucket with the second's frame, gets the
    row of its own."""
    cfg = tiny_policy.cfg
    imgs, pcs = _tiny_obs(cfg, 3)
    proprios = [np.full(7, 0.25, np.float32), np.full(7, -0.5, np.float32)]
    with BatchingServer(tiny_policy, buckets=(1, 2, 4), max_wait_ms=500, sampler="dpm", num_dpm_steps=2) as srv:
        srv.submit(imgs[0], pcs[0], "warm", unnorm_key="t").result(timeout=120)
        futs = [srv.submit(imgs[i], pcs[i], "close the box", cur_robot_state=proprios[i], unnorm_key="t", seed=5)
                for i in range(2)]
        rows = [f.result(timeout=120) for f in futs]
        futs = [srv.submit(imgs[i], pcs[i], "close the box", unnorm_key="t", seed=5) for i in range(3)]
        padded = [f.result(timeout=120) for f in futs]
        s = srv.stats()
    assert s["device_calls"] == 3 and s["batch_size_hist"] == {1: 1, 2: 1, 4: 1} and s["padded_rows"] == 1
    ids = build_prompt_ids(tiny_policy.tokenizer, "close the box", mode="diff")
    kw = dict(input_ids=ids, unnorm_key="t", seed=5, sampler="dpm", num_dpm_steps=2)
    direct = tiny_policy.predict_action_diff_batched(np.stack(imgs[:2]), np.stack(pcs[:2]),
                                                     cur_robot_states=np.stack(proprios), **kw)
    np.testing.assert_array_equal(np.stack(rows), direct)
    direct4 = tiny_policy.predict_action_diff_batched(np.stack(imgs + imgs[2:]), np.stack(pcs + pcs[2:]), **kw)
    np.testing.assert_array_equal(np.stack(padded), direct4[:3])
    assert np.isfinite(direct).all()


def test_uint8_frames_match_host_normalized_frames(tiny_policy):
    """A raw uint8 CHW frame (CLIP-normalized on the device) and the same
    frame normalized on the host (fp32, mask channel) give the same chunk,
    rtol 1e-4 (fp32 rounding of the two normalizations)."""
    from mla_tpu_torch.models.mla import CLIP_MEAN, CLIP_STD

    cfg = tiny_policy.cfg
    imgs, pcs = _tiny_obs(cfg, 1, seed=3)
    f = imgs[0].astype(np.float32).transpose(1, 2, 0) / 255.0
    host = np.concatenate([((f - CLIP_MEAN) / CLIP_STD).transpose(2, 0, 1), np.ones((1,) + f.shape[:2], np.float32)])
    kw = dict(input_ids=build_prompt_ids(tiny_policy.tokenizer, "close the box"), unnorm_key="t", seed=5,
              sampler="dpm", num_dpm_steps=2, return_normalized=True)
    a_host = tiny_policy.predict_action_diff_batched(host[None], pcs[0][None], **kw)
    a_dev = tiny_policy.predict_action_diff_batched(imgs[0][None], pcs[0][None], **kw)
    np.testing.assert_allclose(a_dev, a_host, rtol=1e-4, atol=1e-5)
