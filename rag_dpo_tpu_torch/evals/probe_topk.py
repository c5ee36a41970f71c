"""Where a block of K4's bf16 kernel (`csrc/fused_topk.cu::topk_tiles_tc`)
spends its cycles, on one NVIDIA card.

    python rag_dpo_tpu_torch/evals/probe_topk.py

Builds `csrc/fused_topk.cu` once more with `-DTMA_PROBE`, which compiles in
the phase counters of `csrc/tma_product.cuh` (clock64 spans, one atomic add
a span from lane 0 of each warp), and runs `ops.topk.fused_topk` through
that build on `chip_smoke.py`'s scale corpus: 1,000,448 unit Gaussian bf16
rows of 1024 dims from seed 5, −1e4 on the 448 padding rows, k 40, at
Q 1, 64 and 256 with the launch plan the wrapper picks. For each batch it
prints the plan, the ms of a call of the regular build and of the probe
build (CUDA events, 5 calls after a warm-up; the gap is what the counters
cost), and the shares of a consumer warp's cycles spent in its products
(of which waiting for a full ring slot), the epilogue and barriers, and
its selection, and of the producer's cycles spent waiting for an empty
slot. Prints the card's name and power limit first and one JSON line
last.
"""

from __future__ import annotations

import ctypes
import json
import os
import pathlib
import subprocess
import sys

SLOTS = ("warp", "main", "full", "epilogue", "select", "producer", "empty")


def build_probe(kernels) -> pathlib.Path:
    out = kernels.BUILD_DIR / "libfused_topk_probe.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-DTMA_PROBE", "-o", str(tmp),
         str(kernels.CSRC_DIR / "fused_topk.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def main() -> int:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        print("probe_topk: needs an NVIDIA card", file=sys.stderr)
        return 1
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.topk import _sms, fused_topk, topk_plan

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    n, d, k, calls = 1_000_448, 1024, 40, 5
    e = torch.zeros((n, d), dtype=torch.bfloat16, device=dev)
    for lo in range(0, 1_000_000, 1 << 17):
        hi = min(1_000_000, lo + (1 << 17))
        x = torch.randn((hi - lo, d), generator=gen, device=dev)
        e[lo:hi] = (x / x.norm(dim=1, keepdim=True)).bfloat16()
    pen = torch.zeros(n, device=dev)
    pen[1_000_000:] = -1e4
    queries = {}
    for nq in (1, 64, 256):
        q = torch.randn((nq, d), generator=gen, device=dev)
        queries[nq] = (q / q.norm(dim=1, keepdim=True)).bfloat16()

    def ms(q):
        fused_topk(q, e, k, penalty=pen)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fused_topk(q, e, k, penalty=pen)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / calls

    regular = {nq: ms(q) for nq, q in queries.items()}
    lib = ctypes.CDLL(str(build_probe(_kernels)))
    lib.kernel_error_string.restype = ctypes.c_char_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.fused_topk_probe.restype = ctypes.c_int
    lib.fused_topk_probe.argtypes = [ctypes.c_void_p]
    # the wrapper loads its library by source name: hand it this build,
    # which `load` binds again
    _kernels._libs["fused_topk"] = lib
    _kernels._bound.discard("fused_topk")
    counters = (ctypes.c_ulonglong * len(SLOTS))()

    def read():
        _kernels.check(lib, lib.fused_topk_probe(counters), "probe")
        return dict(zip(SLOTS, (int(c) for c in counters)))

    out = {}
    for nq, q in queries.items():
        plan = topk_plan(nq, n, k, torch.bfloat16, _sms(dev))
        fused_topk(q, e, k, penalty=pen)
        read()
        probed = ms(q)
        c = read()
        blocks = plan["q_tiles"] * plan["n_chunks"]
        share = {s: c[s] / c["warp"] for s in ("main", "full", "epilogue",
                                                "select")}
        share["producer_empty"] = c["empty"] / c["producer"]
        out[f"q{nq}"] = {
            "tile_q": plan["tile_q"], "stages": plan["stages"],
            "n_chunks": plan["n_chunks"], "q_tiles": plan["q_tiles"],
            "ms": regular[nq], "probed_ms": probed,
            "warp_cycles": c["warp"] / ((calls + 1) * blocks * 8), **share}
        r = out[f"q{nq}"]
        print(f"Q={nq} tile {r['tile_q']} stages {r['stages']} chunks "
              f"{r['n_chunks']}: {r['ms']:.3f} ms, {r['probed_ms']:.3f} ms "
              f"probed; a consumer warp's {r['warp_cycles']:.0f} cycles: "
              f"products {r['main']:.2f} (of it waiting full "
              f"{r['full']:.2f}), epilogue {r['epilogue']:.2f}, select "
              f"{r['select']:.2f}; producer waiting empty "
              f"{r['producer_empty']:.2f}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
