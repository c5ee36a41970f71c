"""The int8 sweep floor on the card: K10, K11 and the library int8 product.

    python -m rag_dpo_tpu_torch.evals.bench_int8_matmul [--device cpu]
        [--n N] [--d D] [--q Q] [--block B] [--iters I] [--seed S]

Counterpart of `benchmarks/bench_pallas_int8_matmul.py`'s `main`. Uniform
int8 rows and queries in [−127, 127] are made on the device from `--seed`
(N 1,000,000 × D 1024, Q 64, blocks of 2048 rows by default); then each of
these is timed with CUDA events over `--iters` calls after one warm-up:
* the library int8 product: `torch._int_mm` of the whole sweep, then the
  strided max (`amax`) to the same strip, the counterpart of the JAX
  file's XLA dot chain (`xla_int8_dot_ms`);
* K10, `int8_block_max(upcast="bf16")`, and K11, `upcast="int8"`
  (`ops/int8_matmul.py`, the kernels of `csrc/int8_block_max.cu`).
GB/s is N·D over the time, as the JAX file reckons it. Both kernels' strips
must equal the library's bit for bit. One JSON line is printed, with the
card's name and power limit as `nvidia-smi` reads them. A kernel that fails
to build or launch ends the run with a non-zero exit, and nothing is
appended to any results file.

With `--device cpu` the plain twins run instead, at a small default size
(N 32,768, D 256, Q 16), timed on the host clock: no device metric.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from ..ops import default_device
from ..ops.int8_matmul import LANES, UPCASTS, int8_block_max
from ..ops.quantize import _int8_product

RECIPE = {"n": 1_000_000, "d": 1024, "q": 64, "block": 2048, "iters": 10}
CPU_RECIPE = {"n": 32_768, "d": 256, "q": 16, "block": 2048, "iters": 3}
KERNELS = {name: upcast for upcast, name in UPCASTS.items()}


def make_inputs(n: int, d: int, q: int, seed: int, device):
    """(q_i8 [Q, D], e_i8 [N, D]): uniform int8 in [−127, 127], made on
    `device` from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def uniform(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device,
                             dtype=torch.int8)

    return uniform((q, d)), uniform((n, d))


def library_block_max(q_i8, e_i8, block: int):
    """The same strip through the library: the int32 product of the whole
    blocks (`torch._int_mm` on CUDA), then the strided max."""
    q, nb = q_i8.shape[0], e_i8.shape[0] // block
    s = _int8_product(q_i8, e_i8[: nb * block])
    s = s.view(q, nb, block // LANES, LANES).amax(dim=2)
    return s.reshape(q, nb * LANES).float()


def card() -> str:
    """The card's name and power limit as `nvidia-smi` reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def run(n: int | None = None, d: int | None = None, q: int | None = None,
        block: int | None = None, iters: int | None = None, seed: int = 0,
        device=None) -> dict:
    """Make the inputs, check both kernels against the library strip, time
    the three; returns the JSON line's fields."""
    dev = default_device(device)
    recipe = RECIPE if dev.type == "cuda" else CPU_RECIPE
    shape = {key: recipe[key] if value is None else value
             for key, value in (("n", n), ("d", d), ("q", q),
                                ("block", block), ("iters", iters))}
    q_i8, e_i8 = make_inputs(shape["n"], shape["d"], shape["q"], seed, dev)
    block, iters = shape["block"], shape["iters"]
    calls = {"library_int8_mm": lambda: library_block_max(q_i8, e_i8, block)}
    for name, upcast in KERNELS.items():
        calls[name] = (lambda up=upcast: int8_block_max(
            q_i8, e_i8, block=block, upcast=up))
    want = calls["library_int8_mm"]()
    for name in KERNELS:
        got = calls[name]()
        if not torch.equal(got, want):
            raise RuntimeError(f"{name}: the strip differs from the library "
                               f"product's by {float((got - want).abs().max())}")
    out = {"bench": "int8_matmul_floor", **shape, "seed": seed,
           "strip": list(want.shape)}
    if dev.type == "cuda":
        out["device"] = {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(dev),
                         "count": torch.cuda.device_count()}
        out["card"] = card()
        for name, fn in calls.items():
            ms = cuda_ms(fn, iters)
            out[f"{name}_ms"] = ms
            out[f"{name}_gbps"] = shape["n"] * shape["d"] / ms / 1e6
    else:
        out["device"] = {"platform": "cpu"}
        for name, fn in calls.items():
            out[f"{name}_host_ms"] = host_ms(fn, iters)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for key in ("n", "d", "q", "block", "iters"):
        ap.add_argument(f"--{key}", type=int, default=None,
                        help=f"default {RECIPE[key]} (on the CPU "
                             f"{CPU_RECIPE[key]})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the first CUDA card; 'cpu' for the twins")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, args.d, args.q, args.block, args.iters,
                         args.seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
