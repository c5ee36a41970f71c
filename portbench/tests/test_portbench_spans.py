"""The readers of the port's spans and pool counters, on hand-built
observations: each gives the hand-computed value, and None where there
is nothing to read (a reply without spans, counters missing)."""

import types

import pytest

from portbench import readers, spans
from portbench.loop import Record

MS = 1_000_000


def reply(rows):
    return types.SimpleNamespace(spans=rows)


def rec(i, rows, end=5.0, done=True, error=None):
    r = Record(index=i, spec={})
    r.output, r.end, r.done, r.error = rows, end, done, error
    return r


def obs(records, trace=None, engine=None):
    return {"records": records, "t0": 0.0, "t1": 10.0, "window_s": 10.0,
            "trace": trace, "engine": engine}


def row(name, start_ms, dur_ms, parent=-1):
    return (name, start_ms * MS, dur_ms * MS, parent, 1)


QUERIES = [
    rec(0, reply([row("agent.query", 0, 100),
                  row("retrieval.encode", 1, 10, 0),
                  row("retrieval.prefilter", 11, 4, 0),
                  row("retrieval.dense", 15, 2, 0),
                  row("retrieval.sparse", 17, 3, 0),
                  row("retrieval.fuse", 20, 1, 0),
                  row("rerank", 30, 50, 0)])),
    # a re-retrieval: two encodes and two reranks in one query
    rec(1, reply([row("agent.query", 0, 300),
                  row("retrieval.encode", 1, 20, 0),
                  row("retrieval.encode", 100, 30, 0),
                  row("rerank", 40, 60, 0), row("rerank", 150, 70, 0)])),
    # left out: ended after the window, failed, not finished
    rec(2, reply([row("retrieval.encode", 1, 999)]), end=11.0),
    rec(3, reply([row("retrieval.encode", 1, 999)]), error="boom"),
    rec(4, reply([row("retrieval.encode", 1, 999)]), done=False),
]


@pytest.mark.parametrize("metric,want", [
    ("encode_ms.query", (10 + 20 + 30) / 2),
    ("prefilter_ms.query", 4 / 2),
    ("search_ms.query", (2 + 3 + 1) / 2),
    ("rerank_ms.query", (50 + 60 + 70) / 2),
])
def test_stage_readers_average_over_answered_queries(metric, want):
    assert readers.load(metric)(obs(QUERIES)) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["encode_ms.query", "prefilter_ms.query",
                                    "search_ms.query", "rerank_ms.query",
                                    "idle_in_host_stages.query"])
def test_stage_readers_without_spans_read_nothing(metric):
    """The parent's replies have no `spans`; a run with no answered query
    has nothing either."""
    bare = [rec(0, types.SimpleNamespace(answer="x")), rec(1, None)]
    trace = {"start_ns": 0, "end_ns": 10 * MS, "kernels": []}
    assert readers.load(metric)(obs(bare, trace)) is None
    assert readers.load(metric)(obs([], trace)) is None


def test_stage_reader_counts_a_query_without_the_stage_as_zero():
    qs = [rec(0, reply([row("rerank", 0, 40)])),
          rec(1, reply([row("agent.query", 0, 5)]))]
    assert readers.load("rerank_ms.query")(obs(qs)) == pytest.approx(20.0)


def test_idle_in_host_stages_on_a_built_timeline():
    """Window 0-100 ms. Host-only spans: 10-30 (prefilter, one thread),
    20-40 (fuse, another thread), 60-70 (rerank.tokenize), 95-120
    (sort, past the window's end); an encode at 0-10 is not host-only.
    Kernels: 25-35 and 62-64, one from before the window to 5. Host alone
    with no kernel: 10-25, 35-40, 60-62, 64-70, 95-100 = 15+5+2+6+5."""
    q = rec(0, reply([row("retrieval.encode", 0, 10),
                      row("retrieval.prefilter", 10, 20),
                      row("rerank.tokenize", 60, 10)]))
    q2 = rec(1, reply([row("retrieval.fuse", 20, 20),
                       row("retrieval.sparse.sort", 95, 25)]), end=12.0)
    trace = {"start_ns": 0, "end_ns": 100 * MS,
             "kernels": [("k", 25 * MS, 10 * MS), ("k", 62 * MS, 2 * MS),
                         ("k", -5 * MS, 10 * MS)]}
    got = readers.load("idle_in_host_stages.query")(obs([q, q2], trace))
    assert got == pytest.approx(15 + 5 + 2 + 6 + 5)


def test_idle_in_host_stages_needs_a_trace():
    assert readers.load("idle_in_host_stages.query")(obs(QUERIES)) is None


def test_union_merges_overlaps_and_drops_empty_intervals():
    assert spans.union([(5, 7), (0, 2), (1, 3), (4, 4), (6, 9)]) == \
        [[0, 3], [5, 9]]


ENGINE = {"admitted": 16, "queue_wait_ns": 16 * 250 * MS, "prefills": 16,
          "prefill_device_ns": 16 * 900 * MS, "prefill_rows": 8192 * 16,
          "prefill_tokens": 6144 * 16, "steps": 40}


@pytest.mark.parametrize("metric,want", [
    ("queue_ms.prefill", 250.0),
    ("prefill_ms.prefill", 900.0),
    ("pad_share.prefill", 25.0),
])
def test_pool_readers_divide_the_windows_deltas(metric, want):
    assert readers.load(metric)(obs([], engine=ENGINE)) == pytest.approx(
        want)


@pytest.mark.parametrize("metric", ["queue_ms.prefill", "prefill_ms.prefill",
                                    "pad_share.prefill"])
def test_pool_readers_without_counters_read_nothing(metric):
    """The parent's engine lacks the counters; a window with no admission
    or prefill has no denominator."""
    old = {"admitted": 16, "steps": 40, "tokens": 128}
    idle = dict.fromkeys(ENGINE, 0)
    for engine in (old, idle, None):
        assert readers.load(metric)(obs([], engine=engine)) is None
