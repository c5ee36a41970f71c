"""The 1M-chunk int8 + postings index's hybrid search under torch.profiler,
in a process of its own, on one NVIDIA card: the card's busy share at
batches 1 and 256 and the int8 product's (`torch._int_mm`, the GEMM
events) device time in it.

    python rag_dpo_tpu_torch/evals/profile_scale.py [--no-reload]

Builds the index of `chip_smoke.py`'s scale phase (bench.py:44-58's
recipe): 1,000,000 unit Gaussian rows × 1024 made on the card from seed 1,
ELL 24 over 50,000 terms, `IndexConfig(quantize_int8=True, ell_width=24,
postings_cap=256, postings_candidates=64)`, saved to a temporary directory
and loaded again (unless `--no-reload`). Each batch (unit queries, 16
terms) runs the hybrid search (`search_dense(40)`, `search_sparse(40)`,
`rrf_fuse` to 10) twice unprofiled, then 5 times unprofiled for the wall
p50, then twice under the profiler; the busy share is the profiled call's
device time over the unprofiled p50. Prints the card's name and power
limit, a line a profile (the device events by name) and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

N, DIM, ELL, VOCAB, TERMS = 1_000_000, 1024, 24, 50_000, 16


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-reload", action="store_true",
                    help="search the index as built, without save and load")
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    root = pathlib.Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    from rag_dpo_tpu_torch.index import DeviceIndex, IndexConfig
    from rag_dpo_tpu_torch.ops import rrf_fuse

    if not torch.cuda.is_available():
        print("profile_scale: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = torch.randn((N, DIM), generator=gen, device=dev)
    rows /= rows.norm(dim=1, keepdim=True)
    dense = rows.to(torch.float16).cpu().numpy()
    del rows
    terms = torch.randint(0, VOCAB, (N, ELL), generator=gen, device=dev,
                          dtype=torch.int32).cpu().numpy()
    impacts = torch.randn((N, ELL), generator=gen, device=dev).abs()
    impacts = impacts.cpu().numpy()
    cfg = IndexConfig(dim=DIM, ell_width=ELL, quantize_int8=True,
                      postings_cap=256, postings_candidates=64)
    index = DeviceIndex(cfg, device=dev)
    index.add([f"s{i}" for i in range(N)], dense, terms=terms,
              impacts=impacts)
    del dense, terms, impacts
    if not args.no_reload:
        with tempfile.TemporaryDirectory(prefix="ragdpo_profile_") as tmp:
            index.save(tmp)
            del index
            index = DeviceIndex.load(tmp, device=dev)
    index.device_image()
    weights = torch.tensor([2.0, 1.5], device=dev)
    rng = np.random.default_rng(2)

    def hybrid(q, qt, qw):
        _, di = index.search_dense(q, 40)
        _, si = index.search_sparse(qt, qw, 40)
        rrf_fuse(torch.from_numpy(np.stack([di, si])).to(dev), weights,
                 topk=10)
        torch.cuda.synchronize()

    result = {"card": card.strip(), "reloaded": not args.no_reload}
    for nq in (1, 256):
        q = rng.standard_normal((nq, DIM)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        qt = rng.integers(0, VOCAB, (nq, TERMS)).astype(np.int32)
        qw = np.abs(rng.standard_normal((nq, TERMS))).astype(np.float32)
        for _ in range(2):
            hybrid(q, qt, qw)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            hybrid(q, qt, qw)
            walls.append(time.perf_counter() - t0)
        p50 = float(np.median(walls))
        for run in range(2):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                hybrid(q, qt, qw)
            ranges = {e.key for e in prof.events() if e.is_user_annotation}
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.key not in ranges]
            busy_ms = sum(e.self_device_time_total for e in events) / 1e3
            gemm_ms = sum(e.self_device_time_total for e in events
                          if "gemm" in e.key.lower()) / 1e3
            share = busy_ms / (p50 * 1e3)
            result[f"batch{nq}_run{run}"] = {
                "p50_ms": p50 * 1e3, "device_busy_ms": busy_ms,
                "busy_share": share, "int8_product_ms": gemm_ms}
            print(f"batch {nq}, profile {run}: p50 {p50 * 1e3:.2f} ms, "
                  f"device busy {busy_ms:.3f} ms = {share:.1%}, int8 "
                  f"product {gemm_ms:.3f} ms; " + ", ".join(
                      f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f}"
                      for e in sorted(events, key=lambda e:
                                      -e.self_device_time_total)[:5]),
                  flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
