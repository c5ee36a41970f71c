"""The benchmark's description: `BENCHMARK.json` and the files it names.

Nothing here imports torch or the port, so the tests and the harness's
first checks run anywhere.
"""

from __future__ import annotations

import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
BENCHMARK = REPO / "BENCHMARK.json"

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TEXT_LIMIT = 200
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer")
CONFIG_KEYS = ("name", "source", "file", "reduced", "why")
WORKLOAD_KEYS = ("name", "config", "traffic", "chips", "why")
END_TO_END_KEYS = ("name", "unit", "better", "bound", "source")
PER_LAYER_KEYS = ("name", "unit", "better", "source", "layer", "moves")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load_benchmark(path: pathlib.Path = BENCHMARK) -> dict:
    return json.loads(path.read_text(encoding="utf-8"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str) -> dict:
    """The configuration's file, as it is run."""
    return json.loads((REPO / config_entry(bench, name)["file"])
                      .read_text(encoding="utf-8"))


def load_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json")
                      .read_text(encoding="utf-8"))


def applies(metric: dict, cell: str) -> bool:
    """Whether a metric is reported in a cell: listed there, or listed
    nowhere (then every cell reports it)."""
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer ones (on)."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if applies(m, cell)]


def _text_ok(s) -> bool:
    return (isinstance(s, str) and 1 <= len(s) <= TEXT_LIMIT
            and "\n" not in s and "\t" not in s)


def problems(bench: dict) -> list[str]:
    """What in `bench` breaks the benchmark's contract (empty: nothing)."""
    out = []
    if tuple(bench) != TOP_KEYS:
        out.append(f"top-level keys {list(bench)}")
    names = set()
    for group, keys in (("configs", CONFIG_KEYS),
                        ("workloads", WORKLOAD_KEYS),
                        ("end_to_end", END_TO_END_KEYS),
                        ("per_layer", PER_LAYER_KEYS)):
        seen = set()
        for e in bench.get(group, []):
            extra = set(e) - set(keys) - ({"workloads"} if group in (
                "end_to_end", "per_layer") else set())
            if set(keys) - set(e) or extra:
                out.append(f"{group} entry {e.get('name')} keys {list(e)}")
            name = e.get("name", "")
            if not NAME_RE.fullmatch(name):
                out.append(f"{group} name {name!r}")
            if name in seen:
                out.append(f"{group} name {name!r} twice")
            seen.add(name)
            if group in ("end_to_end", "per_layer"):
                if name in names:
                    out.append(f"metric {name!r} twice")
                names.add(name)
                if not UNIT_RE.fullmatch(e.get("unit", "")):
                    out.append(f"unit {e.get('unit')!r} of {name}")
                if e.get("better") not in ("lower", "higher"):
                    out.append(f"better of {name}")
                if e.get("source") not in SOURCES:
                    out.append(f"source of {name}")
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end" and \
                        key != "source" and not _text_ok(e[key]):
                    out.append(f"{key} of {name}")
    for c in bench.get("configs", []):
        if not _text_ok(c.get("source")):
            out.append(f"source of config {c.get('name')}")
        for key in c.get("reduced", []):
            if not NAME_RE.fullmatch(key):
                out.append(f"reduced key {key!r}")
        if len(c.get("reduced", [])) > 16:
            out.append(f"reduced of {c['name']} has over 16 keys")
    configs = {c["name"] for c in bench.get("configs", [])}
    pairs = set()
    for w in bench.get("workloads", []):
        if w.get("config") not in configs:
            out.append(f"workload {w['name']} config {w.get('config')}")
        for key in ("config", "traffic"):
            if not NAME_RE.fullmatch(w.get(key, "")):
                out.append(f"workload {w['name']} {key}")
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w['name']} chips")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            out.append(f"config and traffic {pair} twice")
        pairs.add(pair)
    used = {w.get("config") for w in bench.get("workloads", [])}
    for c in configs - used:
        out.append(f"config {c} has no cell")
    cells = {w["name"] for w in bench.get("workloads", [])}
    e2e = {m["name"]: m for m in bench.get("end_to_end", [])}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in bench.get("end_to_end", []):
        if not 0 < m.get("bound", 0) <= 0.25:
            out.append(f"bound of {m['name']}")
        if m.get("source") not in ("host_clock", "device_trace"):
            out.append(f"end-to-end source of {m['name']}")
    for m in bench.get("per_layer", []):
        if m.get("moves") not in e2e:
            out.append(f"{m['name']} moves {m.get('moves')}")
        for cell in m.get("workloads", []):
            if cell not in cells:
                out.append(f"{m['name']} lists unknown cell {cell}")
            elif not applies(e2e.get(m.get("moves"), {}), cell):
                out.append(f"{m['name']} in {cell}, which lacks "
                           f"{m.get('moves')}")
    for cell in cells:
        if len(metrics_for(bench, cell, False)) < 2:
            out.append(f"{cell} reports no end-to-end metric but setup_s")
        if not metrics_for(bench, cell, True):
            out.append(f"{cell} reports no per-layer metric")
    rs = bench.get("run_seconds")
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        out.append(f"run_seconds {rs}")
    cmd = bench.get("command", [])
    if not (1 <= len(cmd) <= 32 and all(_text_ok(w) for w in cmd)):
        out.append("command")
    paths = bench.get("paths", [])
    if not 1 <= len(paths) <= 16 or not all(
            re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
            and not p.startswith("/") and ".." not in p for p in paths):
        out.append(f"paths {paths}")
    return out
