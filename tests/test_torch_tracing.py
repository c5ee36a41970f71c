"""The port's spans and the decode pool's time counters (CPU).

`utils/profiling.py::span` times a stage on the monotonic clock, knows
its parent and thread, joins the request's list through a context
variable (and the threads started with a copy of the context), and
enters `torch.profiler.record_function` only while a profiler runs. The
agent returns a query's spans in `RAGResponse.spans`; the slot pool
counts its queue wait, its prefills' rows against their tokens, and the
prefill and decode time in `ContinuousEngine.stats`.
"""

import contextvars
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

from rag_dpo_tpu_torch.models.decoder import DecoderConfig
from rag_dpo_tpu_torch.models.generate import SamplingConfig, TextGenerator
from rag_dpo_tpu_torch.serving import ContinuousDriver, ContinuousEngine
from rag_dpo_tpu_torch.utils import profiling
from rag_dpo_tpu_torch.utils.profiling import (
    PhaseTimer,
    collect_spans,
    epoch_ns,
    profile_trace,
    span,
    span_rows,
)

SAMPLING = SamplingConfig(temperature=0.0, eos_id=2, pad_id=1)
STAGES = ("retrieval.prefilter", "retrieval.encode", "retrieval.dense",
          "retrieval.sparse", "retrieval.sparse.sort", "retrieval.fuse",
          "rerank", "rerank.tokenize", "rerank.score")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_spans_nest_with_their_parent():
    with collect_spans() as spans:
        with span("a") as a:
            with span("b") as b:
                with span("c"):
                    pass
            with span("d"):
                pass
        with span("e"):
            pass
    assert [s.name for s in spans] == list("abcde")
    rows = span_rows(spans)
    assert [r[3] for r in rows] == [-1, 0, 1, 0, -1]
    assert b.parent is a and a.parent is None
    assert all(r[4] == threading.get_ident() for r in rows)
    assert a.start_ns <= b.start_ns and b.dur_ns <= a.dur_ns
    assert rows[0][1] == epoch_ns(a.start_ns) and rows[0][2] == a.dur_ns


def test_spans_outside_a_sink_are_timed_and_kept_nowhere():
    with collect_spans() as outer:
        pass
    with span("alone") as sp:
        time.sleep(0.002)
    assert outer == [] and sp.dur_ns >= 2_000_000
    assert sp.seconds == sp.dur_ns / 1e9


def test_threads_with_a_copied_context_join_the_request():
    """Two requests at once, each fanning out to threads as
    `overlap_prepare` does: each request's list holds its own threads'
    spans, parented under the span that started them."""
    out = {}

    def stage(name):
        with span(name):
            time.sleep(0.001)

    def request(key):
        with collect_spans() as spans, span(f"{key}.root"):
            threads = [threading.Thread(
                target=contextvars.copy_context().run,
                args=(stage, f"{key}.{i}")) for i in range(3)]
            [t.start() for t in threads]
            [t.join(timeout=30) for t in threads]
            assert not any(t.is_alive() for t in threads)
        out[key] = span_rows(spans)

    reqs = [threading.Thread(target=request, args=(k,)) for k in "xy"]
    [t.start() for t in reqs]
    [t.join(timeout=30) for t in reqs]
    for key in "xy":
        rows = out[key]
        assert sorted(r[0] for r in rows) == [f"{key}.0", f"{key}.1",
                                              f"{key}.2", f"{key}.root"]
        root = next(i for i, r in enumerate(rows) if r[0] == f"{key}.root")
        children = [r for r in rows if r[0] != f"{key}.root"]
        assert all(r[3] == root for r in children)
        # a finished thread's ident may be reused, but never the root's,
        # which is alive while they run
        assert all(r[4] != rows[root][4] for r in children)


def test_no_profiler_no_record_function(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    assert not profiling._profiler_active()
    timer = PhaseTimer()
    with span("a"), span("b"), timer.phase("c"):
        pass
    assert entered == []


def _profile_from_another_thread(work, **kw):
    """Run `work()` here while a CPU profiler runs in another thread;
    returns its events."""
    started, finish, box = threading.Event(), threading.Event(), {}

    def profiler():
        with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
            started.set()
            finish.wait(timeout=60)
        box["events"] = prof.profiler.kineto_results.events()

    th = threading.Thread(target=profiler)
    th.start()
    assert started.wait(timeout=60)
    try:
        work()
    finally:
        finish.set()
        th.join(timeout=60)
    assert not th.is_alive()
    return box["events"]


def test_spans_enter_record_function_under_another_threads_profiler(
        monkeypatch):
    """The benchmark's profiler runs in its watcher thread: a span in a
    client thread sees it and enters `record_function`."""
    real = torch.profiler.record_function
    entered = []

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)

    def work():
        with span("client.stage"):
            torch.ones(8) + 1

    _profile_from_another_thread(work)
    assert entered == ["client.stage"]


def test_spans_lie_on_the_profilers_timeline():
    """Under a profiler of every thread, started in another one, each span
    is a user annotation that starts within 1 ms of its anchored start,
    covers the span's own interval (it is entered before the span's clock
    starts and left after it stops; how long after is the scheduler's
    business) and encloses the CPU operations run inside it. (A thread's first
    annotation under a profiler pays ~1 ms of the profiler's own set-up
    inside `record_function`, before the span's clock starts: one
    throwaway span takes it.)"""
    spans = []

    def work():
        with span("first"):
            pass
        with collect_spans() as got, span("outer"):
            with span("inner.mm"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            with span("inner.add"):
                torch.ones(64) + 1
        spans.extend(got)

    events = _profile_from_another_thread(
        work, experimental_config=_ExperimentalConfig(
            profile_all_threads=True))
    notes = {e.name(): e for e in events if e.is_user_annotation()}
    ops = [e for e in events if not e.is_user_annotation()]
    for sp in spans:
        note = notes[sp.name]
        assert abs(note.start_ns() - epoch_ns(sp.start_ns)) < 1_000_000
        assert note.start_ns() + note.duration_ns() \
            >= epoch_ns(sp.start_ns + sp.dur_ns) - 1_000_000
    for name, op_name in (("inner.mm", "aten::mm"),
                          ("inner.add", "aten::add")):
        note = notes[name]
        inside = [e for e in ops if e.name() == op_name]
        assert inside and all(
            note.start_ns() <= e.start_ns()
            and e.start_ns() + e.duration_ns()
            <= note.start_ns() + note.duration_ns() for e in inside)


@pytest.fixture(scope="module")
def agent():
    from rag_dpo_tpu_torch.app.demo import build_demo_stack

    pipe, _ = build_demo_stack(agent=True, device="cpu")
    return pipe


@pytest.mark.parametrize("question", [
    "Quel est le délai de notification d'une violation de données ?",
    "Faut-il une AIPD pour un registre des traitements ?",
])
def test_agent_returns_its_stages_spans(agent, question):
    resp = agent.query(question)
    assert resp.error is None
    rows = resp.spans
    names = [r[0] for r in rows]
    for stage in STAGES:
        assert stage in names, stage
    assert names[0] == "agent.query" and rows[0][3] == -1
    # the prefetch thread's retrieval hangs under agent.prefetch, itself
    # under overlap_prepare, in the query's own list
    prefetch = names.index("agent.prefetch")
    assert rows[prefetch][3] == names.index("agent.overlap_prepare")
    enc = names.index("retrieval.encode")
    assert rows[enc][3] == prefetch and rows[enc][4] != rows[0][4]
    rerank = sum(r[2] for r in rows if r[0] == "rerank") / 1e9
    retrieve = sum(r[2] for r in rows if r[0] == "agent.retrieve") / 1e9
    assert resp.rerank_time == rerank
    assert 0 < resp.rerank_time <= resp.retrieval_time
    assert resp.retrieval_time == retrieve
    assert resp.total_time == rows[0][2] / 1e9
    for r in rows:
        assert r[3] < names.index(r[0]) and r[2] >= 0
        if r[3] >= 0:
            parent = rows[r[3]]
            assert parent[1] <= r[1] <= r[1] + r[2] <= parent[1] + parent[2]
    assert "spans" not in resp.extras


def _tiny_engine(slots, **kw):
    gen = TextGenerator(DecoderConfig.tiny(num_heads=4, num_kv_heads=2,
                                           dtype=torch.float32),
                        device="cpu")
    return ContinuousEngine(gen, slots=slots, sampling=SAMPLING, chunk=2,
                            **kw)


def test_pool_counts_prefills_padding_and_queue_wait():
    eng = _tiny_engine(slots=2)
    rng = np.random.default_rng(3)
    lengths = [5, 9, 17, 30, 12]
    for n in lengths:
        eng.submit(rng.integers(3, 200, size=n).astype(np.int32), n, 4)
    eng.run()
    st = eng.stats
    assert st["prefills"] == st["admitted"] == len(lengths)
    assert st["prefill_tokens"] == sum(lengths) <= st["prefill_rows"]
    assert st["prefill_rows"] == sum(len(r.ids)
                                     for r in eng._requests.values())
    assert st["queue_wait_ns"] > 0
    assert st["prefill_device_ns"] > 0 and st["decode_device_ns"] > 0
    assert not eng._timing


def test_pool_queue_wait_counts_from_the_callers_submit():
    """Through the driver, a request's wait starts at the caller's submit:
    with one slot, the later requests wait out the earlier ones."""
    eng = _tiny_engine(slots=1)
    drv = ContinuousDriver(eng)
    try:
        t0 = time.perf_counter_ns()
        handles = [drv.submit(np.arange(3, 3 + n, dtype=np.int32), n, 6)
                   for n in (8, 8, 8)]
        for h in handles:
            h.result()
        elapsed = time.perf_counter_ns() - t0
    finally:
        drv.close()
    st = eng.stats
    assert st["admitted"] == st["prefills"] == 3
    assert 0 < st["queue_wait_ns"] < 3 * elapsed


def test_pool_counts_a_chunked_prompt_as_one_prefill():
    """With `prefill_chunk`, a long prompt's segments make one prefill:
    its rows and tokens are every segment's, its device time their sum."""
    eng = _tiny_engine(slots=2, prefill_chunk=8)
    lengths = [5, 30, 19]
    for n in lengths:
        eng.submit(np.arange(3, 3 + n, dtype=np.int32), n, 4)
    eng.run()
    st = eng.stats
    assert st["prefill_segments"] == 4 + 3
    assert st["prefills"] == st["admitted"] == len(lengths)
    assert st["prefill_tokens"] == sum(lengths) <= st["prefill_rows"]
    assert st["prefill_device_ns"] > 0


def test_profile_trace_shows_the_pool_drivers_spans(tmp_path):
    """`profile_trace` records every thread: the driver thread's step
    spans reach the trace, though the caller never steps the engine."""
    eng = _tiny_engine(slots=2)
    drv = ContinuousDriver(eng)
    try:
        with profile_trace(str(tmp_path)):
            handles = [drv.submit(np.arange(3, 3 + n, dtype=np.int32), n, 4)
                       for n in (6, 11, 9)]
            for h in handles:
                h.result()
    finally:
        drv.close()
    (trace,) = tmp_path.glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert {"pool.admit", "pool.prefill", "pool.decode"} <= names
