"""A re-iterable element stream: the small part of tf.data the pipeline uses.

`Dataset` wraps a function that starts an iterator; each `iter()` runs the
pipeline anew from its source, as iterating a tf.data graph again does. Its
stages are map, filter, flat_map, repeat, take, skip, concatenate, cache
and shuffle, and `Dataset.sample_from_datasets` interleaves several by their
weights. A map given `num_parallel_calls` (a count, or AUTOTUNE for one
thread per core) runs in an order-preserving pool of threads: inputs are
pulled and submitted by a feeder thread, at most `lookahead` ahead of the
consumer, and results come out in input order, as tf.data's deterministic
parallel map gives them, so the feeder is also the stage's prefetch. Threads
fit the work: zlib, the host helper's ctypes calls and numpy's large
operations release the interpreter lock, and frames are handed over without
pickling. A parallel map mapped again in parallel fuses into one pool.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

AUTOTUNE = -1
_END = object()


def num_workers(num_parallel_calls: Optional[int]) -> int:
    """Threads for a map: None -> 1 (sequential), AUTOTUNE -> one per core."""
    if num_parallel_calls is None:
        return 1
    if num_parallel_calls == AUTOTUNE:
        return os.cpu_count() or 1
    return max(int(num_parallel_calls), 1)


class Dataset:
    def __init__(self, make_iter: Callable[[], Iterable]) -> None:
        self._make_iter = make_iter

    def __iter__(self) -> Iterator:
        return iter(self._make_iter())

    def map(self, fn: Callable, num_parallel_calls: Optional[int] = None) -> "Dataset":
        workers = num_workers(num_parallel_calls)
        if workers > 1:
            return ParallelMap(self, fn, workers)
        return Dataset(lambda: map(fn, self))

    def filter(self, predicate: Callable[[Any], bool]) -> "Dataset":
        return Dataset(lambda: filter(predicate, self))

    def flat_map(self, fn: Callable[[Any], Iterable]) -> "Dataset":
        return Dataset(lambda: (y for x in self for y in fn(x)))

    def take(self, n: int) -> "Dataset":
        return Dataset(lambda: itertools.islice(self, n))

    def shard(self, num_shards: int, index: int) -> "Dataset":
        """Every num_shards-th element from `index` (tf.data's shard)."""
        if not 0 <= index < num_shards:
            raise ValueError(f"shard {index} of {num_shards}")
        return Dataset(lambda: itertools.islice(iter(self), index, None, num_shards))

    def skip(self, n: int) -> "Dataset":
        return Dataset(lambda: itertools.islice(self, n, None))

    def concatenate(self, other: "Dataset") -> "Dataset":
        return Dataset(lambda: itertools.chain(self, other))

    def cache(self) -> "Dataset":
        """The elements of the first full pass, kept and replayed."""
        kept: list = []

        def run():
            if not kept:
                kept.append(list(self))
            return iter(kept[0])

        return Dataset(run)

    def repeat(self) -> "Dataset":
        """Forever, pass after pass; an empty stream stays empty."""

        def run():
            while True:
                empty = True
                for x in self:
                    empty = False
                    yield x
                if empty:
                    return

        return Dataset(run)

    def shuffle(self, buffer_size: int, seed: Optional[int] = None) -> "Dataset":
        """tf.data's shuffle: fill a buffer of `buffer_size` elements, then
        emit a uniformly drawn one and put the next input in its slot; drain
        in random order at the end. The draws come from numpy's generator
        seeded with `seed` (they cannot match TensorFlow's own)."""
        if buffer_size < 1:
            raise ValueError(f"shuffle buffer of {buffer_size}")

        def run():
            rng = np.random.default_rng(seed)
            buf = []
            for x in self:
                if len(buf) < buffer_size:
                    buf.append(x)
                    continue
                i = int(rng.integers(len(buf)))
                out, buf[i] = buf[i], x
                yield out
            while buf:
                i = int(rng.integers(len(buf)))
                buf[i], buf[-1] = buf[-1], buf[i]
                yield buf.pop()

        return Dataset(run)


    @staticmethod
    def sample_from_datasets(datasets: Sequence["Dataset"], weights: Sequence[float],
                             seed: Optional[int] = None) -> "Dataset":
        """tf.data's Dataset.sample_from_datasets with its default
        stop_on_empty_dataset=False: each element is drawn from one input,
        picked with probability proportional to its weight; an exhausted
        input leaves and the others' weights are renormalized. The picks
        come from numpy's generator seeded with `seed`: their distribution
        is TensorFlow's, their sequence cannot be."""
        n = len(datasets)
        w = np.asarray(weights, np.float64)
        if w.shape != (n,) or n == 0 or (w < 0).any() or w.sum() <= 0:
            raise ValueError(f"weights {weights} for {n} datasets")

        def run():
            rng = np.random.default_rng(seed)
            its = [iter(d) for d in datasets]
            live = np.ones(n, bool)
            try:
                while live.any():
                    cdf = np.cumsum(np.where(live, w, 0.0))
                    i = min(int(np.searchsorted(cdf, rng.random() * cdf[-1], side="right")), n - 1)
                    try:
                        x = next(its[i])
                    except StopIteration:
                        live[i] = False
                        continue
                    yield x
            finally:
                for it in its:  # stops each input's pool of threads
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()

        return Dataset(run)


class ParallelMap(Dataset):
    """fn over the parent's elements in a pool of `workers` threads, results
    in input order, at most `lookahead` (default 2 x workers) in flight."""

    def __init__(self, parent: Dataset, fn: Callable, workers: int, lookahead: Optional[int] = None) -> None:
        self.parent, self.fn, self.workers = parent, fn, workers
        self.lookahead = lookahead or 2 * workers
        super().__init__(self._run)

    def map(self, fn: Callable, num_parallel_calls: Optional[int] = None) -> Dataset:
        workers = num_workers(num_parallel_calls)
        if workers > 1:
            first = self.fn
            return ParallelMap(self.parent, lambda x: fn(first(x)), max(workers, self.workers))
        return super().map(fn)

    def _run(self):
        results: "queue.Queue" = queue.Queue(self.lookahead)
        stop = threading.Event()
        pool = ThreadPoolExecutor(self.workers, thread_name_prefix="rlds-map")

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    results.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def feed():
            try:
                for x in self.parent:
                    if not put(pool.submit(self.fn, x)):
                        return
                put(_END)
            except BaseException as e:  # handed to the consumer, which raises it
                put(e)

        feeder = threading.Thread(target=feed, name="rlds-feed", daemon=True)
        feeder.start()
        try:
            while True:
                item = results.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item.result()
        finally:
            stop.set()
            feeder.join()
            while not results.empty():
                item = results.get_nowait()
                if hasattr(item, "cancel"):
                    item.cancel()
            pool.shutdown(wait=True, cancel_futures=True)

