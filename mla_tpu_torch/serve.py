"""HTTP serving host: dynamic-batching action-chunk prediction.

    python -m mla_tpu_torch.serve --checkpoint runs/<id> --port 8700 \\
        [--sampler dpm|ddim] [--max_wait_ms 5] [--warm_len 22] [--device cuda|cpu]

Counterpart of scripts/serve.py: a stdlib HTTP front-end over
`mla_tpu_torch.serving.BatchingServer`, which coalesces concurrent requests
into one bucketed batched device call, over a policy from `load_vla`.
--device (default cuda) is the port's own; without a card the host raises
unless given --device cpu. Sets MLA_PREFILL_SCORES=bf16 unless it is set,
as scripts/serve.py does (it reaches only the plain attention: the flash
prefill never materializes scores).

Protocol (stdlib-only client, see tests/test_torch_serve_http.py):

  POST /predict   body = npz archive with
                    image       [H, W, 3] uint8 raw frame (preferred: it
                                stays uint8 up to the card, where the CLIP
                                normalization runs; a frame that is not
                                S x S is resized and center-cropped on the
                                host first), or [4, S, S] float32 already
                                preprocessed
                    pointcloud  [P, 3] float32
                    instruction scalar string
                    proprio     [action_dim] float32          (optional)
                    unnorm_key  scalar string                 (optional)
                  -> {"actions": [[...] x horizon]}; 503 when the pending
                     queue is full, 400 on a malformed request
  GET  /stats     -> batching counters + latency percentiles (JSON)
  GET  /metrics   -> the same in Prometheus text exposition format
  GET  /healthz   -> {"ok": true}
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from mla_tpu_torch.serving import QueueFull


def _prep_image(img: np.ndarray, size: int) -> np.ndarray:
    """Raw [H, W, 3] uint8 -> [3, S, S] uint8 CHW (the CLIP normalization and
    the mask channel run on the card, mla._device_clip_preprocess); an
    already-preprocessed [4, S, S] float frame passes through. The host
    only resizes and crops, and only when the frame is not size x size."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] == 4:
        return img.astype(np.float32)
    img = img.astype(np.uint8)
    if img.shape[:2] != (size, size):
        # the training transform's geometry, so serving sees what the model
        # was trained on
        from mla_tpu_torch.vla.datasets import resize_center_crop

        img = resize_center_crop(img, size)
    return img.transpose(2, 0, 1)  # [3, S, S] uint8


def render_prometheus(stats: dict) -> str:
    """BatchingServer.stats() -> Prometheus text exposition format."""
    lines = []

    def emit(name, value, labels="", mtype="gauge"):
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name}{labels} {value}")

    for key, mtype in (
        ("requests", "counter"), ("device_calls", "counter"),
        ("padded_rows", "counter"), ("errors", "counter"),
        ("rejected", "counter"), ("pending", "gauge"),
        ("avg_batch_size", "gauge"),
    ):
        if key in stats:
            emit(f"mla_serve_{key}", stats[key], mtype=mtype)
    for bucket, count in stats.get("batch_size_hist", {}).items():
        lines.append(f'mla_serve_batches{{bucket="{bucket}"}} {count}')
    for key in ("queue_wait_ms", "e2e_ms"):
        if key in stats:
            for q in ("p50", "p95", "max"):
                lines.append(f'mla_serve_{key}{{quantile="{q}"}} {stats[key][q]}')
    return "\n".join(lines) + "\n"


def warm_buckets(server, warm_lens, log=True) -> None:
    """Drive one synthetic batch per (prompt length, bucket) through the
    server before it takes traffic, so no live request pays a first call's
    allocations, kernel builds and one-time device copies. Raw uint8
    frames, the preferred protocol. Warm the prompt token lengths the
    deployment's prompts tokenize to."""
    cfg = server.policy.cfg
    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    img = rng.integers(0, 256, size=(3, size, size)).astype(np.uint8)
    n_pts = getattr(getattr(cfg, "point", None), "input_points", 1024)
    pc = rng.uniform(-0.5, 0.5, size=(n_pts, 3)).astype(np.float32)
    saved_wait, server.max_wait_s = server.max_wait_s, 0.25  # coalesce warm rows
    try:
        for L in warm_lens:
            if L < 2:
                raise ValueError(f"warm_len {L}: prompt needs >= 2 tokens")
            ids = np.concatenate([[1], np.full(max(L - 2, 0), 5, np.int64), [29871]]).astype(np.int32)[None, :]
            for b in server.buckets:
                t0 = time.time()
                futs = [server.submit(img, pc, input_ids=ids) for _ in range(b)]
                for f in futs:
                    f.result(timeout=3600)
                if log:
                    print(f"warm len={L} bucket={b}: {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    finally:
        server.max_wait_s = saved_wait
    server.reset_latency_stats()


def make_handler(server, cfg):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet access log
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/stats":
                self._json(200, server.stats())
            elif self.path == "/metrics":
                body = render_prometheus(server.stats()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                with np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False) as z:
                    image = _prep_image(z["image"], cfg.vision.image_size)
                    pc = np.asarray(z["pointcloud"], np.float32)
                    instruction = str(z["instruction"])
                    proprio = np.asarray(z["proprio"], np.float32) if "proprio" in z else None
                    unnorm_key = str(z["unnorm_key"]) if "unnorm_key" in z else None
                actions = server.predict(image, pc, instruction, cur_robot_state=proprio, unnorm_key=unnorm_key)
                self._json(200, {"actions": np.asarray(actions).tolist()})
            except QueueFull as e:  # shed load: tell the client to back off
                self._json(503, {"error": f"overloaded: {e}"[:400]})
            except Exception as e:  # noqa: BLE001 — report to the client
                self._json(400, {"error": f"{type(e).__name__}: {e}"[:400]})

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(description="MLA HTTP serving host (PyTorch port)")
    p.add_argument("--checkpoint", required=True, help="run dir / .pt for load_vla (use_ema via --use_ema)")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--tokenizer", default=None, help="HF tokenizer path (default: SimpleTokenizer)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8700)
    p.add_argument("--sampler", default="dpm", choices=["dpm", "ddim"])
    p.add_argument("--num_dpm_steps", type=int, default=4)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--max_pending", type=int, default=64,
                   help="pending-request cap; beyond it /predict sheds load with HTTP 503 (0 = unbounded)")
    p.add_argument("--warm_len", type=int, nargs="*", default=None,
                   help="drive every bucket at startup for these prompt token lengths (e.g. --warm_len 22), so "
                        "no live request pays a first call's set-up")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to serve on the CPU")
    os.environ.setdefault("MLA_PREFILL_SCORES", "bf16")  # read when the policy is built
    from mla_tpu_torch.models.load import load_vla
    from mla_tpu_torch.serving import BatchingServer
    from mla_tpu_torch.vla.tokenizer import SimpleTokenizer, load_llama_tokenizer

    tokenizer = load_llama_tokenizer(args.tokenizer) if args.tokenizer else SimpleTokenizer()
    t0 = time.perf_counter()
    policy = load_vla(args.checkpoint, use_ema=args.use_ema, tokenizer=tokenizer, device=args.device)
    print(f"loaded {args.checkpoint} on {policy.device} in {time.perf_counter() - t0:.1f}s", file=sys.stderr,
          flush=True)
    server = BatchingServer(
        policy, buckets=args.buckets, max_wait_ms=args.max_wait_ms,
        sampler=args.sampler, num_dpm_steps=args.num_dpm_steps,
        max_pending=args.max_pending or None,
    )
    if args.warm_len:
        warm_buckets(server, args.warm_len)

    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server, policy.cfg))
    print(f"serving on http://{args.host}:{args.port} (sampler={args.sampler}, buckets={args.buckets})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()


if __name__ == "__main__":
    main()
