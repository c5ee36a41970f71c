"""What the port's own spans and counters give the metric readers.

The agent's replies carry each query's spans (`RAGResponse.spans`: name,
start in epoch ns, duration ns, the parent's index or -1, the thread),
on the clock of the device trace's events; the slot pool's counters of
its own time reach `obs["engine"]` as the window's deltas of
`ContinuousEngine.stats`. A program without them (a reply with no
`spans`, counters missing) gives nothing to read: every function here
then returns None.
"""

from __future__ import annotations

# spans in which the query's thread works on the host alone: the summary
# prefilter, the fusion and its materialization, the sparse arm's mask and
# sort, and the reranker's pair encoding
HOST_STAGES = ("retrieval.prefilter", "retrieval.fuse",
               "retrieval.sparse.sort", "rerank.tokenize")


def _spans(record):
    return getattr(record.output, "spans", None)


def answered(obs) -> list:
    """The span lists of the queries answered inside the window (ended in
    it, without error)."""
    return [_spans(r) for r in obs["records"]
            if r.done and r.error is None and r.end is not None
            and obs["t0"] <= r.end <= obs["t1"] and _spans(r) is not None]


def stage_ms(obs, names: tuple) -> float | None:
    """The mean over the window's answered queries of the summed
    milliseconds of their spans named in `names`; None where no query
    carries such a span."""
    per = [[d for name, _, d, _, _ in spans if name in names]
           for spans in answered(obs)]
    if not any(per):
        return None
    return sum(sum(x) for x in per) / len(per) / 1e6


def union(intervals) -> list[list[int]]:
    """The union of [start, end) intervals, sorted and merged."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a: list, b: list) -> int:
    """Length of the intersection of two merged interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_idle_share(obs, names: tuple = HOST_STAGES) -> float | None:
    """Share of the traced window, in %, in which no device operation ran
    while some thread was inside a span named in `names` (every reply's
    spans, clipped to the window): an upper bound on the idle time those
    host stages explain. None without a trace or without such spans."""
    tr = obs.get("trace")
    if not tr or tr["end_ns"] <= tr["start_ns"]:
        return None
    t0, t1 = tr["start_ns"], tr["end_ns"]
    host = union((max(s, t0), min(s + d, t1))
                 for r in obs["records"] for name, s, d, _, _
                 in (_spans(r) or ()) if name in names)
    if not host:
        return None
    device = union((max(s, t0), min(s + d, t1))
                   for _, s, d in tr["kernels"])
    alone = sum(e - s for s, e in host) - _overlap(host, device)
    return 100.0 * alone / (t1 - t0)


def engine_ratio(obs, num: str, den: str) -> float | None:
    """Δ`num` / Δ`den` of the pool's counters over the window; None where
    either is missing or the denominator did not move."""
    eng = obs.get("engine") or {}
    if num not in eng or den not in eng or eng[den] <= 0:
        return None
    return eng[num] / eng[den]
