"""The device trace of a `--trace 1` run: torch.profiler (CUPTI) over a
span of the measured window, read from its raw events.

What it gives the metric readers: the span's length, the seconds in which
any device operation ran (the union of their intervals), the device
operations that took most time, the longest idle gaps labelled by the
innermost host operation running at their middle, and every device
event of the span (name, start, duration) for per-kernel readers. The
profiler's events stay in memory; nothing is written to disk.
"""

from __future__ import annotations

import time

TOP = 10


def _is_device(event) -> bool:
    return str(event.device_type()).endswith("CUDA") \
        and not event.is_user_annotation()


def warm_profiler() -> None:
    """One short profile, so CUPTI's first start is paid in set-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class DeviceTrace:
    def __init__(self):
        self._prof = None
        self.start_ns = self.end_ns = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.start_ns = time.time_ns()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.end_ns = time.time_ns()
        self._prof.__exit__(None, None, None)

    def summary(self) -> dict:
        """{start_ns, end_ns, window_s, busy_s, device_ops, idle_gaps,
        kernels}."""
        t0, t1 = self.start_ns, self.end_ns
        kernels, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            s, d = e.start_ns(), e.duration_ns()
            if s + d < t0 or s > t1:
                continue
            if _is_device(e):
                kernels.append((e.name(), s, d))
            elif not e.is_user_annotation():
                host.append((e.name(), s, s + d))
        self._prof = None
        return summarize(kernels, host, t0, t1)


def summarize(kernels: list, host: list, t0: int, t1: int) -> dict:
    """The summary of device events `kernels` [(name, start_ns, dur_ns)]
    and host events `host` [(name, start_ns, end_ns)] over [t0, t1]."""
    spans = sorted((max(s, t0), min(s + d, t1)) for _, s, d in kernels)
    merged: list[list[int]] = []
    for s, e in spans:
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    by_name: dict[str, int] = {}
    for name, s, d in kernels:
        by_name[name] = by_name.get(name, 0) + min(s + d, t1) - max(s, t0)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    edges = [t0] + [x for s, e in merged for x in (s, e)] + [t1]
    gaps = sorted(((edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]),
                  key=lambda g: g[0] - g[1])[:TOP]
    labels = _label(gaps, host)
    return {
        "start_ns": t0, "end_ns": t1,
        "window_s": (t1 - t0) / 1e9,
        "busy_s": busy / 1e9,
        "device_ops": [[short(n), v / 1e9] for n, v in ops],
        "idle_gaps": [[labels[i], (e - s) / 1e9]
                      for i, (s, e) in enumerate(gaps)],
        "kernels": kernels,
    }


def _label(gaps: list, host: list) -> list[str]:
    """Each gap's innermost host event at its middle."""
    mids = [(s + e) // 2 for s, e in gaps]
    best: list = [None] * len(gaps)
    for name, s, e in host:
        for i, m in enumerate(mids):
            if s <= m <= e and (best[i] is None or e - s < best[i][1]):
                best[i] = (name, e - s)
    return [short(b[0]) if b else "host: no traced operation"
            for b in best]


def short(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."
