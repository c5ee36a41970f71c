"""Share of the rows the window's prefills computed that were padding:
100 × (1 − Δ`prefill_tokens` / Δ`prefill_rows`) of the engine's
counters."""

from portbench import spans


def read(obs):
    r = spans.engine_ratio(obs, "prefill_tokens", "prefill_rows")
    return None if r is None else 100.0 * (1.0 - r)
