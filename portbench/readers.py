"""Helpers the metric readers in `metrics/` share. A reader is a file
`metrics/<metric name>.py` with `read(obs) -> float | None`; `obs` holds
the window (`t0`, `t1`, `window_s`, host seconds), the `records` of every
request, `setup_s`, the system adapter's `observe` output and, in a
`--trace 1` run, the device `trace` summary (`trace.summarize`). A reader
that finds nothing to read returns None and its metric is left out."""

from __future__ import annotations

import importlib.util

from . import spec


def load(name: str):
    path = spec.HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def ttfts(obs) -> list[float]:
    """Submit to first token of every request sent inside the window."""
    return [r.first - r.submit for r in obs["records"]
            if obs["t0"] <= r.submit <= obs["t1"] and r.first is not None]


def idle_share(obs) -> float | None:
    tr = obs.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def share(work: float, rate: float, seconds: float) -> float | None:
    """Work over what the card's peak rate does in `seconds`, in %."""
    if not work or not seconds or seconds <= 0:
        return None
    return 100.0 * work / rate / seconds
