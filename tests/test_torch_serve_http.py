"""The port's HTTP front-end (python -m mla_tpu_torch.serve) against
scripts/serve.py: _prep_image (with the numpy bicubic resize held
bit-exact against the JAX package's Pillow resize), render_prometheus and
the SimpleTokenizer ids equal to JAX's; the handler over a fake policy on
a live loopback port (round trip, /stats, /metrics, 400, 503 on overload,
warm_buckets); and the real entry point in a subprocess with --device cpu
on a tiny run dir, stopped with SIGINT."""

from __future__ import annotations

import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from mla_tpu.vla import datasets as jdatasets
from mla_tpu.vla.tokenizer import SimpleTokenizer as JaxSimpleTokenizer
from mla_tpu_torch import serve
from mla_tpu_torch.serving import BatchingServer
from mla_tpu_torch.vla.datasets import resize_center_crop
from mla_tpu_torch.vla.tokenizer import SimpleTokenizer
from test_torch_serving import FakePolicy, _obs

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import serve as jserve  # noqa: E402  (scripts/serve.py)


@pytest.mark.parametrize("h,w,size", [(480, 640, 672), (720, 1280, 672), (1344, 1344, 672), (600, 500, 672),
                                      (37, 53, 16), (101, 77, 64), (671, 673, 672), (672, 700, 672)],
                         ids=["640x480-up", "1280x720-down", "1344-down", "500x600-up", "odd-down", "odd-up",
                              "near-672", "crop-only"])
def test_resize_center_crop_matches_pillow(h, w, size):
    """Pixel for pixel the JAX package's Pillow-based resize_center_crop."""
    img = np.random.default_rng(h * w).integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    got = resize_center_crop(img, size)
    assert got.shape == (size, size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jdatasets.resize_center_crop(img, size))


@pytest.mark.parametrize("shape,dtype", [((672, 672, 3), np.uint8), ((480, 640, 3), np.uint8),
                                         ((4, 672, 672), np.float32)], ids=["raw", "resized", "preprocessed"])
def test_prep_image_matches_jax(shape, dtype):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=shape).astype(dtype) if dtype == np.uint8 else rng.normal(size=shape).astype(dtype)
    got, want = serve._prep_image(img, 672), jserve._prep_image(img, 672)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_render_prometheus_matches_jax():
    stats = {"requests": 12, "device_calls": 5, "padded_rows": 2, "batch_size_sum": 14, "errors": 0,
             "rejected": 1, "batch_size_hist": {1: 2, 4: 3}, "pending": 0, "avg_batch_size": 2.8,
             "queue_wait_ms": {"p50": 1.5, "p95": 20.25, "max": 31.0, "window": 12},
             "e2e_ms": {"p50": 180.0, "p95": 250.5, "max": 300.0, "window": 12},
             "assemble_dispatch_ms": {"p50": 90.0, "p95": 95.0, "max": 99.0, "window": 5}}
    assert serve.render_prometheus(stats) == jserve.render_prometheus(stats)


def test_simple_tokenizer_ids_match_jax():
    texts = ["In: What action should the robot take to close the box?\nOut:", "pick up the <BOD> red<EOD> cup",
             "<id:31800><id:31801> done", "a<b c>", ""]
    jtok, tok = JaxSimpleTokenizer(), SimpleTokenizer()
    for text in texts:
        for special in (True, False):
            assert tok(text, add_special_tokens=special) == jtok(text, add_special_tokens=special)
    assert tok.decode([31800, 31801]) == jtok.decode([31800, 31801])


def test_llama_tokenizer_needs_transformers(monkeypatch):
    """Without the transformers package (as on the card's machine) the HF
    tokenizer raises and says so."""
    from mla_tpu_torch.vla.tokenizer import load_llama_tokenizer

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="transformers"):
        load_llama_tokenizer("tokenizer-dir")


# --------------------------------------------------------------------------- #
# the handler over a fake policy
# --------------------------------------------------------------------------- #


class _Http:
    """A ThreadingHTTPServer on a free loopback port around make_handler."""

    def __init__(self, srv, cfg):
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(srv, cfg))
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.thread.join(timeout=10)
        self.httpd.server_close()


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _post(base, body, timeout=30):
    req = urllib.request.Request(f"{base}/predict", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def test_http_front_end_round_trip():
    policy = FakePolicy()
    with BatchingServer(policy, max_wait_ms=1) as srv, _Http(srv, policy.cfg) as http:
        with urllib.request.urlopen(f"{http.base}/healthz", timeout=10) as r:
            assert json.load(r) == {"ok": True}
        img, pc = _obs(2.0)
        actions = np.asarray(_post(http.base, _npz(image=img, pointcloud=pc, instruction=np.asarray("close the box"),
                                                   proprio=np.zeros(7, np.float32)))["actions"])
        assert actions.shape == (16, 7) and actions[0, 1] == pytest.approx(2.0)
        # a raw frame of another size is resized to the policy's 32 x 32
        raw = np.full((40, 48, 3), 7, np.uint8)
        actions = np.asarray(_post(http.base, _npz(image=raw, pointcloud=pc, instruction=np.asarray("x")))["actions"])
        assert actions[0, 1] == pytest.approx(7.0)
        assert policy.calls[-1]["proprio"] is None
        with urllib.request.urlopen(f"{http.base}/stats", timeout=10) as r:
            stats = json.load(r)
        assert stats["requests"] == 2 and stats["device_calls"] == 2
        with urllib.request.urlopen(f"{http.base}/metrics", timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            body = r.read().decode()
        assert "# TYPE mla_serve_requests counter" in body and "mla_serve_requests 2" in body
        assert 'mla_serve_batches{bucket="1"} 2' in body and 'mla_serve_e2e_ms{quantile="p50"}' in body
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(http.base, b"not an npz")
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{http.base}/nowhere", timeout=10)
        assert ei.value.code == 404


def test_http_503_on_overload():
    policy = FakePolicy(delay_s=1.0)
    with BatchingServer(policy, buckets=(1,), max_wait_ms=1, max_pending=1) as srv, _Http(srv, policy.cfg) as http:
        body = _npz(image=_obs(0.0)[0], pointcloud=_obs(0.0)[1], instruction=np.asarray("x"))
        slow = threading.Thread(target=lambda: _post(http.base, body), daemon=True)
        slow.start()
        time.sleep(0.3)  # the first request now holds the only slot
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(http.base, body, timeout=10)
        assert ei.value.code == 503
        slow.join(timeout=10)
        assert srv.stats()["rejected"] == 1


def test_warm_buckets_drives_every_bucket_before_traffic():
    policy = FakePolicy()
    with BatchingServer(policy, buckets=(1, 2, 4), max_wait_ms=1) as srv:
        serve.warm_buckets(srv, [22], log=False)
        s = srv.stats()
        assert s["batch_size_hist"] == {1: 1, 2: 1, 4: 1}
        assert s["device_calls"] == 3 and s["padded_rows"] == 0
        assert "e2e_ms" not in s
        assert all(c["L"] == 22 for c in policy.calls)
        assert srv.max_wait_s == pytest.approx(1e-3)
    with pytest.raises(ValueError, match="warm_len"):
        with BatchingServer(FakePolicy(), buckets=(1,)) as srv2:
            serve.warm_buckets(srv2, [1], log=False)


def test_main_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--checkpoint", str(ROOT / "no-such-run")])


# --------------------------------------------------------------------------- #
# the entry point in a subprocess, on the CPU
# --------------------------------------------------------------------------- #


def _tiny_run_dir(root: Path) -> Path:
    """A run dir of a seeded mla-tiny: config.json, dataset statistics and
    a reference-format .pt under checkpoints/."""
    from mla_tpu_torch import params as P
    from mla_tpu_torch.conf.models import get_model_config
    from mla_tpu_torch.training import checkpointing as ckpt

    cfg = get_model_config("mla-tiny")
    params, state = P.init(cfg, seed=4, device="cpu")
    params["final_layer"]["mlp"]["fc2"]["w"] = torch.randn(params["final_layer"]["mlp"]["fc2"]["w"].shape,
                                                           generator=torch.Generator().manual_seed(5)) * 0.05
    run = root / "tiny-run"
    stats = {"t": {"action": {"q01": [-1.0] * 6 + [0.0], "q99": [1.0] * 7},
                   "proprio": {"q01": [-1.0] * 7, "q99": [1.0] * 7}}}
    ckpt.write_run_metadata(run, {"base_vlm": "mla-tiny"}, cfg, stats)
    (run / "checkpoints").mkdir()
    ckpt.export_reference_pt(run / "checkpoints" / "tiny.pt", {"params": params, "model_state": state}, cfg)
    return run


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_entry_point_on_the_cpu(tmp_path):
    """python -m mla_tpu_torch.serve --device cpu on a live loopback port:
    /healthz once loaded and warmed, a raw frame of another size through the
    resize, an answer equal to an in-process load_vla's
    predict_action_diff_batched (B = 1, seed 0, DPM-4; rtol 1e-6, the same
    CPU arithmetic), /stats and /metrics; SIGINT stops it with exit 0 and
    no traceback."""
    from mla_tpu_torch.models.load import load_vla
    from mla_tpu_torch.models.mla import build_prompt_ids

    run = _tiny_run_dir(tmp_path)
    port = _free_port()
    log = tmp_path / "serve.log"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    with open(log, "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "mla_tpu_torch.serve", "--checkpoint", str(run), "--port",
                                 str(port), "--device", "cpu", "--warm_len", "9", "--max_wait_ms", "1"],
                                cwd=ROOT, env=env, stdout=err, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, log.read_text()
            try:
                with urllib.request.urlopen(f"{base}/healthz", timeout=2) as r:
                    assert json.load(r) == {"ok": True}
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.time() < deadline, log.read_text()
                time.sleep(0.2)
        rng = np.random.default_rng(7)
        frame = rng.integers(0, 256, size=(200, 150, 3), dtype=np.uint8)
        pc = rng.normal(size=(64, 3)).astype(np.float32)
        instruction = "put the cup on the plate"
        got = np.asarray(_post(base, _npz(image=frame, pointcloud=pc, instruction=np.asarray(instruction)))["actions"])
        with urllib.request.urlopen(f"{base}/stats", timeout=10) as r:
            stats = json.load(r)
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            metrics = r.read().decode()
    finally:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    text = log.read_text()
    assert rc == 0 and "Traceback" not in text, text
    assert "serving on" in text and "warm len=9 bucket=4" in text
    assert stats["requests"] == 8 and stats["device_calls"] == 4 and stats["e2e_ms"]["window"] == 1
    assert "mla_serve_device_calls 4" in metrics
    policy = load_vla(run, device="cpu", tokenizer=SimpleTokenizer())
    want = policy.predict_action_diff_batched(
        serve._prep_image(frame, 168)[None], pc[None], input_ids=build_prompt_ids(policy.tokenizer, instruction),
        seed=0, sampler="dpm", num_dpm_steps=4)[0]
    assert got.shape == (16, 7) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
