"""Rates and percentiles are taken over every request of a window, never
as medians of pieces."""

import statistics

from portbench import readers, stats
from portbench.loop import Record


def rec(i, submit, arrivals, done=True, end=None, error=None):
    r = Record(index=i, spec={"prompt_tokens": 10})
    r.submit, r.arrivals, r.done, r.error = submit, arrivals, done, error
    r.end = end if end is not None else (arrivals[-1][0] if arrivals
                                         else submit)
    return r


def obs(records, t0=0.0, t1=10.0):
    return {"records": records, "t0": t0, "t1": t1, "window_s": t1 - t0}


def test_percentile_pools_all_samples():
    a = [1.0] * 99 + [100.0]
    b = [1.0] * 10
    pooled = stats.percentile(a + b, 99)
    per_piece = statistics.median([stats.percentile(a, 99),
                                   stats.percentile(b, 99)])
    assert pooled == stats.percentile(sorted(a + b), 99)
    assert pooled != per_piece
    assert stats.percentile([], 50) is None
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_ttft_median_over_requests_sent_in_the_window():
    rs = [rec(i, float(i), [(float(i) + 0.1 * (i + 1), 1)])
          for i in range(5)]
    rs.append(rec(9, -2.0, [(0.5, 1)]))            # sent before the window
    rs.append(rec(10, 9.5, [(12.0, 1)]))           # its token after it
    got = readers.load("ttft_p50_ms")(obs(rs))
    assert abs(got - 350.0) < 1e-6                 # median of 6, not of 5


def test_queries_per_s_counts_answers_ending_in_the_window():
    rs = [rec(i, 0.0, [], end=i + 0.5) for i in range(12)]
    rs[3].error = "boom"
    assert readers.load("queries_per_s")(obs(rs)) == 9 / 10.0


def test_mfu_is_the_window_s_products_at_the_bf16_peak():
    o = obs([])
    o["model_flops"] = 989e12 * 2.5
    assert abs(readers.load("mfu.prefill")(o) - 25.0) < 1e-9
    o["model_flops"] = 0
    assert readers.load("mfu.prefill")(o) is None
