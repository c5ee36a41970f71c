"""Mean wait of an admission into the slot pool, from the caller's submit
to its slot (Δ`queue_wait_ns` / Δ`admitted` of the engine's counters over
the window), in ms."""

from portbench import spans


def read(obs):
    r = spans.engine_ratio(obs, "queue_wait_ns", "admitted")
    return None if r is None else r / 1e6
