"""Profiling: spans on the monotonic clock, phase timers over them, and
torch.profiler traces.

`span(name)` times a stage of the port: its start and length on
`time.perf_counter_ns`, the span that encloses it (its parent) and its
thread. `epoch_ns` maps a span's start onto the epoch nanoseconds of the
torch profiler's events through one (wall, monotonic) anchor taken at
import, so a span and the kernels it launched lie on one timeline. While
a torch profiler is active in any thread of the process, a span also
enters `torch.profiler.record_function(name)`: a profiler that records
the span's thread (its own thread, or any with `profile_all_threads`,
as `profile_trace` starts it) shows it as a user annotation around the
operations run inside it. The
profiler's own state is the switch; there is no flag.

A request collects its spans into one list: `collect_spans()` sets that
list as the sink of the current context at the request's entry, and
every span opened in that context (and in threads started with a copy of
it, `contextvars.copy_context().run`) is appended to it. Spans stay in
memory; nothing is written to disk.

Port of `rag_dpo_tpu/utils/profiling.py`: `PhaseTimer` keeps its
interface over spans; `profile_trace` wraps `torch.profiler` where the
JAX one wraps `jax.profiler`, and writes a Chrome trace (viewable in
Perfetto or chrome://tracing) under `log_dir`.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import sys
import threading
import time

# the (wall, monotonic) anchor of every span's epoch time
_ANCHOR_WALL_NS = time.time_ns()
_ANCHOR_MONO_NS = time.perf_counter_ns()

_SINK: contextvars.ContextVar = contextvars.ContextVar("ragdpo_span_sink",
                                                       default=None)
_PARENT: contextvars.ContextVar = contextvars.ContextVar(
    "ragdpo_span_parent", default=None)


def epoch_ns(mono_ns: int) -> int:
    """A `time.perf_counter_ns` reading as epoch nanoseconds (the clock of
    the torch profiler's events)."""
    return mono_ns - _ANCHOR_MONO_NS + _ANCHOR_WALL_NS


def _profiler_active() -> bool:
    """Whether a torch profiler is running in any thread (the process-wide
    flag `torch.profiler.profile` sets; no import when torch's profiler
    was never loaded)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class span:
    """`with span(name) as sp:` times the block; `sp.start_ns` (monotonic)
    and `sp.dur_ns` once it ends, `sp.parent` the enclosing span (None at
    the top), `sp.thread` the thread's ident."""

    __slots__ = ("name", "start_ns", "dur_ns", "parent", "thread",
                 "_token", "_annotation")

    def __init__(self, name: str):
        self.name = name
        self.start_ns = self.dur_ns = 0
        self.parent = None

    def __enter__(self) -> "span":
        self._annotation = None
        if _profiler_active():
            from torch.profiler import record_function

            self._annotation = record_function(self.name)
            self._annotation.__enter__()
        self.parent = _PARENT.get()
        self.thread = threading.get_ident()
        self._token = _PARENT.set(self)
        sink = _SINK.get()
        if sink is not None:
            sink.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.dur_ns = time.perf_counter_ns() - self.start_ns
        _PARENT.reset(self._token)
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None

    @property
    def seconds(self) -> float:
        return self.dur_ns / 1e9


@contextlib.contextmanager
def collect_spans():
    """The spans opened in this context until the block ends, in the order
    they started, as a list (the request's sink)."""
    spans: list[span] = []
    token = _SINK.set(spans)
    try:
        yield spans
    finally:
        _SINK.reset(token)


def span_seconds(spans, name: str) -> float:
    """The summed seconds of the finished spans called `name`."""
    return sum(s.dur_ns for s in spans if s.name == name) / 1e9


def span_rows(spans) -> list[tuple]:
    """(name, start epoch ns, duration ns, parent's index in `spans` or
    -1, thread) for each span: the plain form a response carries."""
    index = {id(s): i for i, s in enumerate(spans)}
    return [(s.name, epoch_ns(s.start_ns), s.dur_ns,
             index.get(id(s.parent), -1), s.thread) for s in spans]


class PhaseTimer:
    """Accumulates named phase durations; nested phases allowed. Each
    phase is a span."""

    def __init__(self):
        self.durations: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        sp = span(name)
        try:
            with sp:
                yield
        finally:
            self.durations[name] = self.durations.get(name, 0.0) + sp.seconds

    def as_dict(self) -> dict[str, float]:
        return {k: round(v, 4) for k, v in self.durations.items()}


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None, enabled: bool = True):
    """Host and device trace via torch.profiler (no-op when disabled): the
    CPU's activity of every thread (the pool's driver, the clients' and
    the agent's threads, with their spans), and the card's when there is
    one, written on exit as `log_dir/trace_<pid>_<ns>.json` (default
    `log_dir`: `ragdpo_trace` under the temporary directory)."""
    if not enabled:
        yield
        return
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "ragdpo_trace")
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, experimental_config=
                 _ExperimentalConfig(profile_all_threads=True)) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
