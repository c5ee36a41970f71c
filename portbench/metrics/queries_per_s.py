"""Queries answered (ended inside the window, without error) over the
window's seconds."""


def read(obs):
    n = sum(1 for r in obs["records"] if r.error is None and r.done
            and obs["t0"] <= r.end <= obs["t1"])
    return n / obs["window_s"] or None
