"""The readings a cell's correctness limits are set from, on the card:

    python3 -m portbench.limits --workload <cell> --seeds 1,2,3
        --seconds 51 [--control fp8,int4]

For each seed, one run of the cell's timed path (set-up, a window of
`--seconds`, the program freed), then the plain reference over the sample
a run compares: one JSON line a seed with the numbers each check compares
(`program`, the lower reading's source) and, for each precision of
`--control`, the same numbers of the reference computed at that
precision in the program's place (the upper reading's). All seeds run in
one process, one after the other. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)
    run.pin_caches()
    bench = spec.load_benchmark()
    controls = tuple(c for c in (args.control or "").split(",") if c)
    for seed in (int(s) for s in args.seeds.split(",")):
        result = run.execute(bench, args.workload, seed, args.seconds,
                             False, controls=controls)
        readings = result.get("readings") or {
            "program": {n: c["value"] for n, c in result["checks"].items()}}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "metrics": {k: v["value"] for k, v in
                                      result["metrics"].items()},
                          **readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
