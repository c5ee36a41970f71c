"""Closed and open loops of client threads around one request function.

A closed loop's clients each send their next request when the last one
has come back (users who wait for their answer); an open loop sends on a
schedule drawn from the seed, and times each request from its scheduled
send. Requests are taken in order from the traffic, one index each.

The request function fills a `Record`: each delta's arrival (time, tokens),
the output, `done` when the request ended by itself. After the window's
end it may cut a request short (the loop says when: `Record.cut_after`).
"""

from __future__ import annotations

import dataclasses
import itertools
import sys
import threading
import time
import traceback
from typing import Any, Callable

clock = time.perf_counter


def note(stage: str, since: float) -> float:
    """A set-up or check stage's seconds on standard error; returns now."""
    now = clock()
    print(f"stage {stage}: {now - since:.3f} s", file=sys.stderr, flush=True)
    return now


@dataclasses.dataclass
class Record:
    index: int
    spec: dict
    submit: float = 0.0
    arrivals: list = dataclasses.field(default_factory=list)
    end: float | None = None
    output: Any = None
    done: bool = False
    error: str | None = None
    cut_after: float = float("inf")

    @property
    def first(self) -> float | None:
        return next((t for t, n in self.arrivals if n > 0), None)


def _run(call, rec: Record, spec: dict) -> None:
    try:
        call(spec, rec)
    except Exception:  # noqa: BLE001 — a failed request is counted, not fatal
        rec.error = traceback.format_exc(limit=4)
    rec.end = clock()


def closed_loop(clients: int, request: Callable[[int], dict],
                call: Callable[[dict, Record], None], t0: float,
                t1: float) -> list[Record]:
    """`clients` threads from t0 (perf_counter) until t1; returns every
    record, in index order, once all have come back."""
    records: list[Record] = []
    lock = threading.Lock()
    counter = itertools.count()

    def client():
        while clock() < t0:
            time.sleep(max(0.0, t0 - clock()))
        while clock() < t1:
            with lock:
                i = next(counter)
            rec = Record(index=i, spec=request(i), cut_after=t1)
            with lock:
                records.append(rec)
            rec.submit = clock()
            _run(call, rec, rec.spec)

    threads = [threading.Thread(target=client, name=f"client-{k}",
                                daemon=True) for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sorted(records, key=lambda r: r.index)


def open_loop(offsets: list[float], request: Callable[[int], dict],
              call: Callable[[dict, Record], None], t0: float,
              t1: float) -> list[Record]:
    """One thread a request, sent at t0 + offset; `submit` is the
    scheduled time, so a send the host delays counts in its latency."""
    records = []
    threads = []
    for i, off in enumerate(offsets):
        due = t0 + off
        while clock() < due:
            time.sleep(min(0.01, max(0.0, due - clock())))
        rec = Record(index=i, spec=request(i), submit=due, cut_after=t1)
        records.append(rec)
        th = threading.Thread(target=_run, args=(call, rec, rec.spec),
                              daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    return records
