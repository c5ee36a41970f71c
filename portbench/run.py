"""Run one cell of `BENCHMARK.json`:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. Set-up builds the cell's system from the
seed and warms its shapes; the window then runs the traffic for
`--seconds`; afterwards the program's state is freed and the plain
reference judges a sample of what the window produced. The last line of
standard output is the result (JSON); everything else goes to standard
error, the compared numbers beside their limits last.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

from . import readers, spec, systems  # noqa: E402
from .loop import clock, closed_loop, note, open_loop  # noqa: E402
from .traffic import Traffic  # noqa: E402

# what the window may not have loaded, top-level names compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "rag_dpo_tpu")
CACHE = spec.HERE / ".cache"
# the window starts this long after set-up, once the clients are waiting
LEAD_S = 0.2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def pin_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    and libraries that would load JAX by themselves kept from it."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among `names` (default: the loaded
    modules), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out


def execute(bench: dict, cell: str, seed: int, seconds: float,
            trace: bool, device: str = "cuda", config: dict | None = None,
            traffic: dict | None = None, system_hook=None,
            controls: tuple = ()) -> dict:
    """One run of `cell`; returns the result object. `config` / `traffic`
    replace the cell's files and `system_hook(system)` runs after set-up
    (the tests' tiny sizes and planted faults). Each precision in
    `controls` puts the reference at that precision in the program's
    place over the same sample, after the check: its numbers go under
    `readings` with the program's (the limits' upper and lower readings;
    the benchmark's own runs take none)."""
    import torch

    note("imports", T_START)
    wl = spec.workload(bench, cell)
    config = config or spec.load_config(bench, wl["config"])
    traffic = Traffic(traffic or spec.load_traffic(wl["traffic"]), seed)
    on_card = torch.device(device).type == "cuda"
    if trace:
        from .trace import warm_profiler

        warm_profiler()
    system = systems.load(config["system"])(config, traffic, seed, device,
                                            trace)
    if system_hook is not None:
        system_hook(system)

    t0 = clock() + LEAD_S
    t1 = t0 + seconds
    window = {}
    tracer = None
    if trace:
        from .trace import DeviceTrace

        tracer = DeviceTrace()

    def watch():
        while clock() < t0:
            time.sleep(max(0.0, t0 - clock()))
        window["before"] = system.counters()
        if tracer is not None:
            tracer.start()
        while clock() < t1:
            time.sleep(max(0.0, min(0.05, t1 - clock())))
        if tracer is not None:
            tracer.stop()
        window["after"] = system.counters()

    watcher = threading.Thread(target=watch, name="window", daemon=True)
    watcher.start()
    if traffic.loop == "closed":
        records = closed_loop(int(traffic.p["clients"]), traffic.request,
                              system.request, t0, t1)
    else:
        records = open_loop(traffic.arrivals(seconds), traffic.request,
                            system.request, t0, t1)
    watcher.join()
    setup_s = t0 - T_START
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    tr = tracer.summary() if tracer is not None else None
    obs = {"t0": t0, "t1": t1, "window_s": seconds, "records": records,
           "setup_s": setup_s, "trace": tr}
    obs.update(system.observe(records, t0, t1, window["before"],
                              window["after"]))
    metrics = {}
    for m in spec.metrics_for(bench, cell, trace):
        value = readers.load(m["name"])(obs)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    sent = [r for r in records if t0 <= r.submit <= t1]
    failed = [r for r in sent if r.error is not None]
    for r in failed[:3]:
        log(f"request {r.index} failed:\n{r.error}")
    firsts = sorted(r.first - r.submit for r in sent if r.first is not None)
    if firsts:
        log("first tokens, s after submit: "
            + " ".join(f"{x:.3f}" for x in firsts))

    if on_card:
        log(f"card: {card()}")
    system.release()
    del obs
    gc.collect()
    checks = system.check(records)
    readings = {"program": {name: v for name, v, _ in checks}}
    for precision in controls:
        readings[precision] = system.control(records, precision)
    correct = bool(sent) and not failed and all(
        v <= limit for _, v, limit in checks)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(sent),
              "failed": len(failed), "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    if controls:
        result["readings"] = readings
    result["checks"] = {name: {"value": v, "limit": limit}
                        for name, v, limit in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches()
    bench = spec.load_benchmark()
    wl = spec.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        log(f"{args.workload} needs {wl['chips']} CUDA card(s); "
            f"this machine has {torch.cuda.device_count()}")
        return 2
    result = execute(bench, args.workload, args.seed, args.seconds,
                     bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: the port's benchmark may load none of "
            f"{list(FORBIDDEN)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
