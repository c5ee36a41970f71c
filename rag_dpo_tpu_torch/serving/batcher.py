"""Server-side micro-batching: concurrent requests become one device batch.

Import-path copy of `rag_dpo_tpu/serving/batcher.py` (it imports only
numpy and the stdlib). `MicroBatcher` is the generic primitive: concurrent
callers hand in row-batches; a collector thread drains the queue, waiting
at most `max_wait_ms` for stragglers and never past `max_batch` rows,
stacks them, runs ONE `fn(stacked, key)` call, and scatters the result
rows back to their callers. Requests batch only with requests of the same
`key` (k, filter, engine...), since those change the call's semantics.

In the port, `fn` runs on the collector thread: whatever it puts on the
card names its device explicitly, and the kernels it launches must be
built before the first request (`DeviceIndex.warm`), or every waiting
caller stalls behind the build. An error in `fn`, a CUDA one included,
reaches every caller of that batch (after a solo retry of each caller's
rows when the batch held several).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

import numpy as np


@dataclasses.dataclass
class _Pending:
    rows: np.ndarray                 # [q, ...] this caller's rows
    key: Any
    event: threading.Event
    result: tuple | None = None
    error: BaseException | None = None


@dataclasses.dataclass
class BatcherStats:
    n_requests: int = 0
    n_device_calls: int = 0
    max_batch_seen: int = 0
    rows_total: int = 0
    n_fallbacks: int = 0             # stacked-call failures degraded
    #                                  to per-caller execution

    @property
    def mean_batch(self) -> float:
        return self.rows_total / max(self.n_device_calls, 1)


class MicroBatcher:
    """Aggregate concurrent row-batched calls into one `fn` invocation.

    fn(stacked_rows [B, ...], key) -> tuple of arrays, each [B, ...]
    (every returned array is split back by caller row counts).

    Thread-safe; callers block until their slice is ready. Errors from
    `fn` propagate to every caller of that batch.
    """

    def __init__(self, fn: Callable, *, max_batch: int = 256,
                 max_wait_ms: float = 3.0):
        self.fn = fn
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.stats = BatcherStats()
        self._lock = threading.Condition()
        self._queue: list[_Pending] = []
        self._closed = False
        self._worker = threading.Thread(
            target=self._loop, name="micro-batcher", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- caller
    def __call__(self, rows, key: Any = None):
        rows = np.asarray(rows)
        if rows.ndim < 1 or rows.shape[0] == 0:
            raise ValueError("rows must be a non-empty [q, ...] batch")
        slabs = [rows[i:i + self.max_batch]
                 for i in range(0, rows.shape[0], self.max_batch)]
        # enqueue EVERY slab before waiting on any, so an oversized
        # request's slabs batch/pipeline instead of serializing one
        # device call per slab
        pendings = [_Pending(rows=s, key=key, event=threading.Event())
                    for s in slabs]
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.extend(pendings)
            self.stats.n_requests += 1
            self._lock.notify_all()
        for p in pendings:
            p.event.wait()
        errs = [p.error for p in pendings if p.error is not None]
        if errs:
            # a batch error is shared by every caller of that batch;
            # raising the SAME exception object concurrently in several
            # threads mutates its __traceback__ mid-flight (advisor
            # round-2) — each caller raises its own wrapper instead
            err = errs[0]
            raise RuntimeError(
                f"micro-batched call failed: "
                f"{type(err).__name__}: {err}") from err
        if len(pendings) == 1:
            return pendings[0].result
        return tuple(np.concatenate([p.result[j] for p in pendings],
                                    axis=0)
                     for j in range(len(pendings[0].result)))

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._worker.join(timeout=5)

    # ------------------------------------------------------------- worker
    def _take_batch(self) -> list[_Pending]:
        """Wait for work, then collect same-key requests up to max_batch
        rows or until max_wait_ms after the first one arrived."""
        with self._lock:
            while not self._queue and not self._closed:
                self._lock.wait()
            if self._closed and not self._queue:
                return []
            key = self._queue[0].key
            deadline = time.monotonic() + self.max_wait_s

            def ready_rows():
                return sum(p.rows.shape[0] for p in self._queue
                           if p.key == key)

            while ready_rows() < self.max_batch and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._lock.wait(timeout=remaining)

            batch, rest, rows = [], [], 0
            for p in self._queue:
                if p.key == key and rows + p.rows.shape[0] \
                        <= self.max_batch:
                    batch.append(p)
                    rows += p.rows.shape[0]
                else:
                    rest.append(p)
            self._queue = rest
            if batch:
                self.stats.n_device_calls += 1
                self.stats.rows_total += rows
                self.stats.max_batch_seen = max(
                    self.stats.max_batch_seen, rows)
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                if self._closed:
                    return
                continue
            try:
                stacked = np.concatenate([p.rows for p in batch], axis=0)
                outs = self.fn(stacked, batch[0].key)
                outs = tuple(np.asarray(o) for o in outs)
                off = 0
                for p in batch:
                    q = p.rows.shape[0]
                    p.result = tuple(o[off:off + q] for o in outs)
                    off += q
            except BaseException as e:  # noqa: BLE001 — propagate to callers
                if len(batch) > 1:
                    # degrade before failing: a stacked batch can exhaust
                    # device memory where the individual requests fit
                    # (measured: 15/32 queries RESOURCE_EXHAUSTED when the
                    # coalesced encode programs landed on a chip already
                    # carrying the 12B pool — bench_e2e_concurrent.py
                    # batched arm, 2026-08-20). Rerun each caller's rows
                    # alone; only rows that fail solo fail their caller.
                    self.stats.n_fallbacks += 1
                    for p in batch:
                        try:
                            outs = tuple(np.asarray(o) for o in
                                         self.fn(p.rows, p.key))
                            p.result = outs
                        except BaseException as se:  # noqa: BLE001
                            p.error = se
                else:
                    for p in batch:
                        p.error = e
            finally:
                for p in batch:
                    p.event.set()


def batcher_stats(batcher) -> dict:
    """Counters of one MicroBatcher as a plain dict (stats surfaces)."""
    s = batcher.stats
    return {
        "n_requests": s.n_requests,
        "n_device_calls": s.n_device_calls,
        "max_batch_seen": s.max_batch_seen,
        "mean_batch": round(s.mean_batch, 2),
        "n_fallbacks": s.n_fallbacks,
    }


def find_choose_batcher(system: dict):
    """The choose MicroBatcher of whichever provider in the system dict
    carries one (llm first, stream_llm as fallback) — shared by the
    HTTP stats endpoints and the dashboard so the two surfaces can't
    diverge on discovery."""
    for cand in (system.get("llm"), system.get("stream_llm")):
        cb = getattr(getattr(cand, "generator", None),
                     "_choose_batcher", None)
        if cb is not None:
            return cb
    return None


def batched_dense_search(index, *, max_batch: int = 256,
                         max_wait_ms: float = 3.0) -> MicroBatcher:
    """MicroBatcher over `DeviceIndex.search_dense`: concurrent requests
    with the same (k, where) share one device sweep. Key =
    (k, canonical-JSON where).

    Collected batches are padded to the next power of two before the
    device call: aggregation produces ARBITRARY row counts (whatever
    arrived in the window), and every distinct count would otherwise
    compile its own XLA program — unbounded compile debt in production.
    Padding bounds the program count at log2(max_batch) per (k, where);
    pad rows are zero vectors whose results are sliced off."""
    import json

    def fn(stacked, key):
        k, where_json = key
        where = json.loads(where_json) if where_json else None
        q = stacked.shape[0]
        b = 1
        while b < q:
            b *= 2
        if b > q:
            pad = np.zeros((b - q,) + stacked.shape[1:], stacked.dtype)
            stacked = np.concatenate([stacked, pad], axis=0)
        s, i = index.search_dense(stacked, k, where=where)
        return np.asarray(s)[:q], np.asarray(i)[:q]

    batcher = MicroBatcher(fn, max_batch=max_batch,
                           max_wait_ms=max_wait_ms)

    def search(queries, k: int, where=None):
        key = (int(k), json.dumps(where, sort_keys=True,
                                  ensure_ascii=False) if where else "")
        return batcher(queries, key)

    search.batcher = batcher  # expose stats/close
    return search
