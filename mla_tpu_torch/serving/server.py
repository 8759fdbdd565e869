"""Dynamic-batching serving host for MLAPolicy.

Counterpart of mla_tpu/serving/server.py. Every denoise evaluation of the
decoder reads all its weights whatever the batch, so a serving host should
coalesce concurrent requests into one device call. Batches are padded up to
a fixed set of bucket sizes (default 1/2/4; the padding rows repeat the last
real row and their outputs are dropped), and requests are grouped by prompt
token length (the splice layout of one call is shared), unnormalization
stats and input signature; the buckets are also the shapes a later captured
graph per bucket would take.

Threading model: callers submit from any thread; a single worker thread
makes every CUDA call (torch.inference_mode is thread-local, and the policy
enters it itself). MLAPolicy.dispatch_action_diff_batched enqueues a call's
copies and kernels on the stream without a host sync and returns its
finalize(), so the worker keeps up to TWO batches in flight: it dispatches
batch N+1 while batch N executes, then blocks on N; result order stays FIFO
per batch. One stream: the W8A8 and int8_mm split-K tickets are per device
and sound only for launches in stream order.

    server = BatchingServer(policy, sampler="dpm", max_wait_ms=5.0)
    fut = server.submit(image, pointcloud, "close the box", unnorm_key="rlbench")
    actions = fut.result()      # [horizon, action_dim]

`python -m mla_tpu_torch.serve` wraps this in a stdlib HTTP front-end.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np


@dataclass
class ServeRequest:
    image: np.ndarray          # [4, H, W] preprocessed (mask channel last)
    pointcloud: np.ndarray     # [P, 3]
    input_ids: np.ndarray      # [1, L] prompt ids (diff-mode surgery applied)
    proprio: Optional[np.ndarray]  # [action_dim] raw robot state or None
    unnorm_key: Optional[str]
    seed: int
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.monotonic)
    t_dispatch: float = 0.0

    def group_key(self) -> Tuple:
        # one device call per (prompt length, unnorm stats, image/pc
        # signature) group: rows of one call share the prompt length (the
        # splice layout) and the input shapes and dtypes (uint8 raw frames
        # and preprocessed float32 images do not stack), the stats fix the
        # un/normalization
        return (
            int(self.input_ids.shape[1]), self.unnorm_key,
            self.image.shape, str(self.image.dtype),
            self.pointcloud.shape,
        )


class QueueFull(RuntimeError):
    """Raised by submit() when the pending-request cap is reached — callers
    should shed load (HTTP 503) rather than queue unboundedly."""


class BatchingServer:
    """Coalesces concurrent predict requests into bucketed batched device
    calls on a single worker thread."""

    def __init__(
        self,
        policy,
        *,
        buckets: Sequence[int] = (1, 2, 4),
        max_wait_ms: float = 5.0,
        sampler: str = "dpm",
        num_dpm_steps: int = 4,
        num_ddim_steps: Optional[int] = None,
        max_pending: Optional[int] = None,
    ) -> None:
        if not buckets or list(buckets) != sorted(set(int(b) for b in buckets)):
            raise ValueError(f"buckets must be sorted unique sizes, got {buckets!r}")
        self.policy = policy
        self.buckets = [int(b) for b in buckets]
        self.max_batch = self.buckets[-1]
        self.max_wait_s = max_wait_ms / 1e3
        self.sampler = sampler
        self.num_dpm_steps = num_dpm_steps
        self.num_ddim_steps = num_ddim_steps
        self.max_pending = max_pending
        self._pending = 0
        self._q: "queue.Queue[Optional[ServeRequest]]" = queue.Queue()
        self._stats_lock = threading.Lock()
        self._stats: Dict[str, Any] = {
            "requests": 0, "device_calls": 0, "padded_rows": 0,
            "batch_size_sum": 0, "errors": 0, "rejected": 0,
        }
        # bounded rings of recent per-request latencies (seconds) + a batch
        # occupancy histogram — the observability surface behind stats() and
        # the HTTP front-end's /metrics endpoint
        self._lat_window = 512
        self._queue_wait_s: list = []
        self._e2e_s: list = []
        # per-device-call phase rings: assemble+dispatch = worker-thread time
        # spent building the batch and enqueuing the device call (host
        # copies, the host-to-device copies and every kernel launch of the
        # call: in eager PyTorch the part that can set the pace);
        # finalize_block = time the worker blocks on the oldest in-flight
        # batch (device execution not hidden by dispatch-ahead)
        self._assemble_dispatch_s: list = []
        self._finalize_block_s: list = []
        self._batch_hist: Dict[int, int] = {}
        self._closed = False
        self._worker = threading.Thread(target=self._run, name="mla-serve", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ API

    def submit(
        self,
        image: np.ndarray,
        pointcloud: np.ndarray,
        instruction: Optional[str] = None,
        *,
        cur_robot_state: Optional[np.ndarray] = None,
        unnorm_key: Optional[str] = None,
        seed: int = 0,
        input_ids: Optional[np.ndarray] = None,
    ) -> Future:
        """Enqueue one observation; returns a Future of [horizon, action_dim].

        Note: a coalesced batch draws its per-row denoise noise from the
        FIRST request's seed (one device call, one generator); rows still get
        independent draws, but a row's draw depends on the bucket it lands
        in."""
        if self._closed:
            raise RuntimeError("server is closed")
        if input_ids is None:
            if instruction is None:
                raise ValueError("pass either instruction or input_ids")
            from mla_tpu_torch.models.mla import build_prompt_ids

            input_ids = build_prompt_ids(self.policy.tokenizer, instruction, mode="diff")
        req = ServeRequest(
            image=np.asarray(image), pointcloud=np.asarray(pointcloud),
            input_ids=np.asarray(input_ids), proprio=cur_robot_state,
            unnorm_key=unnorm_key, seed=seed,
        )
        with self._stats_lock:
            if self.max_pending is not None and self._pending >= self.max_pending:
                self._stats["rejected"] += 1
                raise QueueFull(
                    f"{self._pending} requests pending (cap {self.max_pending})"
                )
            self._pending += 1
            self._stats["requests"] += 1
        req.future.add_done_callback(self._on_done)
        self._q.put(req)
        return req.future

    def _on_done(self, _fut) -> None:
        with self._stats_lock:
            self._pending -= 1

    def predict(self, *args, **kwargs) -> np.ndarray:
        """Blocking convenience wrapper around submit()."""
        return self.submit(*args, **kwargs).result()

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            s = dict(self._stats)
            qw, e2e = list(self._queue_wait_s), list(self._e2e_s)
            ad, fb = list(self._assemble_dispatch_s), list(self._finalize_block_s)
            s["batch_size_hist"] = dict(sorted(self._batch_hist.items()))
            s["pending"] = self._pending
        s["avg_batch_size"] = (
            s["batch_size_sum"] / s["device_calls"] if s["device_calls"] else 0.0
        )
        for name, window in (("queue_wait_ms", qw), ("e2e_ms", e2e),
                             ("assemble_dispatch_ms", ad),
                             ("finalize_block_ms", fb)):
            if window:
                arr = np.asarray(window) * 1e3
                s[name] = {
                    "p50": round(float(np.percentile(arr, 50)), 2),
                    "p95": round(float(np.percentile(arr, 95)), 2),
                    "max": round(float(arr.max()), 2),
                    "window": len(window),
                }
        return s

    def _record_latency(self, ring: list, value_s: float) -> None:
        # caller holds _stats_lock
        ring.append(value_s)
        if len(ring) > self._lat_window:
            del ring[: len(ring) - self._lat_window]

    def reset_latency_stats(self) -> None:
        """Clear the latency/phase rings (counters are left intact).

        Benchmarks call this after their warm-up so stats()'s percentile
        blocks describe only steady-state calls (a first call's allocations
        and kernel builds are outliers that would dominate p95/max).
        """
        with self._stats_lock:
            for ring in (self._queue_wait_s, self._e2e_s,
                         self._assemble_dispatch_s, self._finalize_block_s):
                ring.clear()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._worker.join(timeout=30)
            # fail any requests the worker never picked up
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not None and not item.future.done():
                    item.future.set_exception(RuntimeError("server closed"))

    def __enter__(self) -> "BatchingServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------------- loop

    def _drain(self, first: ServeRequest) -> list:
        """Collect up to max_batch requests within the batching window."""
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:           # shutdown sentinel: put it back, stop
                self._q.put(None)
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        # Depth-2 pipeline: after dispatching a batch (the policy enqueues
        # its kernels on the stream and returns without waiting), drain and
        # dispatch the NEXT batch before blocking on the first one's
        # results, so host-side batching, copies and kernel launches of
        # batch N+1 overlap the card's execution of batch N.
        in_flight: list = []      # [(reqs, n, finalize)]
        shutdown = False
        while True:
            if not in_flight:
                item = self._q.get()          # idle: block for work
                if item is None:
                    return
                batch = self._drain(item)
            elif len(in_flight) < 2:          # room to dispatch ahead
                batch = []
                try:
                    nxt = self._q.get_nowait()  # busy: only take ready work
                    if nxt is None:
                        shutdown = True
                    else:
                        batch = self._drain(nxt)
                except queue.Empty:
                    pass
            else:                             # depth cap reached: drain later
                batch = []
            groups: Dict[Tuple[int, Optional[str]], list] = {}
            for r in batch:
                groups.setdefault(r.group_key(), []).append(r)
            for reqs in groups.values():
                in_flight.append(self._dispatch(reqs))
            # keep at most one extra batch dispatched behind the executing
            # one; with nothing left to dispatch, block on the oldest
            if len(in_flight) > 1 or (in_flight and (shutdown or self._q.empty())):
                self._finish(*in_flight.pop(0))
            if shutdown:
                for entry in in_flight:
                    self._finish(*entry)
                return

    def _dispatch(self, reqs: list):
        """Assemble a bucketed batch and enqueue the device call; returns
        (reqs, n, finalize) where finalize blocks and yields [bucket, ...]
        actions (or None if dispatch itself failed — errors already set)."""
        n = len(reqs)
        bucket = next(b for b in self.buckets if b >= n) if n <= self.max_batch else n
        pad = bucket - n
        t_assemble = time.monotonic()
        try:
            rows = reqs + [reqs[-1]] * pad     # padding repeats the last row
            images = np.stack([r.image for r in rows])
            pcs = np.stack([r.pointcloud for r in rows])
            ids = np.concatenate([r.input_ids for r in rows], axis=0)
            # per-row None passes through: proprio-less requests get the
            # NORMALIZED-zero proprio of the solo predict path regardless of
            # which batch they coalesce into (batch-composition invariance)
            states = (
                [r.proprio for r in rows]
                if any(r.proprio is not None for r in reqs)
                else None
            )
            finalize = self.policy.dispatch_action_diff_batched(
                images, pcs,
                input_ids=ids,
                cur_robot_states=states,
                unnorm_key=reqs[0].unnorm_key,
                seed=reqs[0].seed,
                sampler=self.sampler,
                num_dpm_steps=self.num_dpm_steps,
                num_ddim_steps=self.num_ddim_steps,
            )
            now = time.monotonic()
            with self._stats_lock:
                self._stats["device_calls"] += 1
                self._stats["batch_size_sum"] += bucket
                self._stats["padded_rows"] += pad
                self._batch_hist[bucket] = self._batch_hist.get(bucket, 0) + 1
                self._record_latency(self._assemble_dispatch_s, now - t_assemble)
                for r in reqs:
                    r.t_dispatch = now
                    self._record_latency(self._queue_wait_s, now - r.t_submit)
            return reqs, n, finalize
        except Exception as e:  # noqa: BLE001 — propagate to every caller
            self._fail(reqs, e)
            return reqs, n, None

    def _finish(self, reqs: list, n: int, finalize) -> None:
        if finalize is None:
            return
        try:
            t_block = time.monotonic()
            out = finalize()
            now = time.monotonic()
            with self._stats_lock:
                self._record_latency(self._finalize_block_s, now - t_block)
                for r in reqs:
                    self._record_latency(self._e2e_s, now - r.t_submit)
            for r, a in zip(reqs, out[:n]):
                r.future.set_result(a)
        except Exception as e:  # noqa: BLE001
            self._fail(reqs, e)

    def _fail(self, reqs: list, e: Exception) -> None:
        with self._stats_lock:
            self._stats["errors"] += 1
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(e)
