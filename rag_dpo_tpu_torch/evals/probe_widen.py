"""Where K6's time goes on the int8-widening product
(`csrc/widen_product.cuh`), on one NVIDIA card.

    python rag_dpo_tpu_torch/evals/probe_widen.py

Builds variants of `csrc/pooled.cu`, each with a patched copy of the
product's header, under `rag_dpo_tpu_torch/build/probe_widen/`:

- `as_built`: the header as it is (its bits are checked against the
  wrapper's);
- `other_accs`: one accumulator at 16 queries, two at 64 (the build has
  four and one);
- `no_mma`: no wgmma is issued (the fold reads zero sums);
- `no_widen`: the A fragments take the int8 words as they are (no
  widening; wrong products);
- `no_fold`: the tiles' epilogue folds nothing;
- `loads_only`: no widening and no wgmma: the ring, the A loads, the fold;
- `clocks`: the source with clock64 phase counters (see CLOCKS).

Each variant does less work than the kernel and gives wrong results; the
gap of its time to `as_built` is what that part of the loop costs beyond
what the rest hides. Times `pooled_max` of each through its C entry point
over 1,000,000 × 1024 int8 rows (unit Gaussian rows quantized as the store
quantizes them, seed 0) at Q 1, 64 and 256 with the store's block_n 8192
and group 64, `ops/widen_product.py`'s plan: CUDA events over 20 calls
after 3 warm-up calls, the variants in turns, two rounds. Prints the
card's name and power limit, each variant's registers and times, and one
JSON line.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROWS, DIM, BLOCK_N, GROUP, BATCHES = 1_000_000, 1024, 8192, 64, (1, 64, 256)
MMA = [("      WgmmaRS<NQ>::mma(acc[k % NACC], af[k], db0 + 2 * k);\n",
        "      (void)db0;\n", 1),
       ("        WgmmaRS<NQ>::mma(acc[k % NACC], af[k], db1 + 2 * (k - 4));\n",
        "        (void)db1;\n", 1)]
WIDEN = [("        af[4 * h + k][0] = bf16_pair(w0, 0);\n"
          "        af[4 * h + k][1] = bf16_pair(w1, 0);\n"
          "        af[4 * h + k][2] = bf16_pair(w0, 1);\n"
          "        af[4 * h + k][3] = bf16_pair(w1, 1);\n",
          "        af[4 * h + k][0] = w0;\n        af[4 * h + k][1] = w1;\n"
          "        af[4 * h + k][2] = w0 >> 8;\n"
          "        af[4 * h + k][3] = w1 >> 8;\n", 1)]
FOLD = [("      epi.fold(acc[0], cur.a);\n", "", 1)]
ACCS = [("  constexpr int NACC = NQ == 16 ? 4 : 1;\n",
         "  constexpr int NACC = NQ == 16 ? 1 : 2;\n", 1)]
# clock64 phase counters (tma_product.cuh's PROBE_* macros, compiled in with
# -DTMA_PROBE), summed over the consumer warps, per iteration: 1 the wait
# for the stage's bytes, 2 the A bytes' loads and their widening, 3 the
# products (issue and wait), 4 the slot's release, the fold and the output;
# 0 the whole loop
CLOCKS = [
    ("  float acc[NACC][NQ / 2];\n  epi.reset();\n",
     "  float acc[NACC][NQ / 2];\n  epi.reset();\n"
     "  PROBE_CLOCK(t_loop);\n", 1),
    ("    mbar_wait(full + s, (it / w.stages) & 1);\n"
     "    const uint8_t* rows",
     "    PROBE_CLOCK(t_1);\n    mbar_wait(full + s, (it / w.stages) & 1);\n"
     "    PROBE_ADD(1, t_1);\n    PROBE_CLOCK(t_2);\n"
     "    const uint8_t* rows", 1),
    ("    const uint8_t* qs = kResident ?",
     "    PROBE_ADD(2, t_2);\n    PROBE_CLOCK(t_3);\n"
     "    const uint8_t* qs = kResident ?", 1),
    ("    if (lane == 0) mbar_arrive(empty + s);",
     "    PROBE_ADD(3, t_3);\n    PROBE_CLOCK(t_4);\n"
     "    if (lane == 0) mbar_arrive(empty + s);", 1),
    ("    cur.advance(w, walker, chunks);\n  }\n}\n",
     "    PROBE_ADD(4, t_4);\n    cur.advance(w, walker, chunks);\n  }\n"
     "  PROBE_ADD(0, t_loop);\n}\n", 1),
]
READER = """
#ifdef TMA_PROBE
extern "C" int widen_probe(unsigned long long* out) {
  static unsigned long long rows[kProbeRows][kProbeSlots];
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(rows, g_probe, sizeof(rows));
  if (err != cudaSuccess) return err;
  for (int s = 0; s < kProbeSlots; ++s) {
    out[s] = 0;
    for (int r = 0; r < kProbeRows; ++r) out[s] += rows[r][s];
  }
  static unsigned long long zero[kProbeRows][kProbeSlots];
  return cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
}
#endif
"""
SLOTS = ("loop", "wait", "widen", "products", "fold")
VARIANTS = {"as_built": [], "other_accs": ACCS, "no_mma": MMA,
            "no_widen": WIDEN, "no_fold": FOLD, "loads_only": MMA + WIDEN,
            "clocks": CLOCKS}


def build(kernels, name: str, patches: list) -> tuple:
    """The variant's library and ptxas's lines for its kernels."""
    text = (kernels.CSRC_DIR / "widen_product.cuh").read_text()
    for old, new, count in patches:
        if text.count(old) != count:
            raise RuntimeError(f"{name}: {old!r} found {text.count(old)} "
                               f"times, not {count}")
        text = text.replace(old, new)
    out_dir = kernels.BUILD_DIR / "probe_widen" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "widen_product.cuh").write_text(text)
    source = (kernels.CSRC_DIR / "pooled.cu").read_text()
    flags = list(kernels.NVCC_FLAGS)
    if patches is CLOCKS:
        source += READER
        flags.append("-DTMA_PROBE")
    (out_dir / "pooled.cu").write_text(source)
    lib = out_dir / "libpooled.so"
    proc = subprocess.run(
        [kernels._nvcc(), *flags, "-I", str(kernels.CSRC_DIR),
         "-o", str(lib), str(out_dir / "pooled.cu")], capture_output=True,
        text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    regs = [line.split("info    :")[-1].strip()
            for line in (proc.stdout + proc.stderr).splitlines()
            if re.search(r"Used \d+ registers", line)]
    return lib, regs


def main() -> int:
    import torch

    root = pathlib.Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.pooled import pooled_group_max
    from rag_dpo_tpu_torch.ops.quantize import quantize_rows
    from rag_dpo_tpu_torch.ops.widen_product import (
        permute_columns,
        widen_plan,
    )

    if not torch.cuda.is_available():
        print("probe_widen: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda kv: build(_kernels, *kv), VARIANTS.items())))
    libs = {}
    for name, (path, regs) in built.items():
        lib = ctypes.CDLL(str(path))
        lib.pooled_max.restype = ctypes.c_int
        lib.pooled_max.argtypes = _kernels.SIGNATURES["pooled_max"]
        libs[name] = lib
        print(f"{name}: {'; '.join(regs)}", flush=True)

    clocks = libs.pop("clocks")
    clocks.widen_probe.restype = ctypes.c_int
    clocks.widen_probe.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = torch.randn((ROWS, DIM), generator=gen, device=dev)
    rows /= rows.norm(dim=1, keepdim=True)
    e_i8, scale = quantize_rows(rows)
    del rows
    pen = torch.zeros(ROWS, device=dev)
    n_pool = -(-ROWS // BLOCK_N) * (BLOCK_N // GROUP)
    result = {"card": card.strip(), "ms": {}}
    for nq in BATCHES:
        q = torch.randn((nq, DIM), generator=gen, device=dev)
        q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        plan = widen_plan(nq, DIM)
        out_v = torch.empty((nq, n_pool), dtype=torch.bfloat16, device=dev)
        out_i = torch.empty((nq, n_pool), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def call(lib):
            err = lib.pooled_max(
                q.data_ptr(), e_i8.data_ptr(), scale.data_ptr(),
                pen.data_ptr(), ROWS, nq, ROWS, DIM, BLOCK_N, GROUP,
                plan.nq, plan.stages, out_v.data_ptr(),
                out_i.data_ptr(), stream)
            if err:
                raise RuntimeError(f"pooled_max: CUDA error {err}")

        want = pooled_group_max(q, e_i8, scale, pen)
        q = permute_columns(q)  # as the wrapper hands them to the kernel
        call(libs["as_built"])
        torch.cuda.synchronize()
        if not (torch.equal(out_v, want[0]) and torch.equal(out_i, want[1])):
            raise RuntimeError(f"as_built differs from the wrapper at Q {nq}")

        def ms(lib, iters=20):
            for _ in range(3):
                call(lib)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                call(lib)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters

        # the clock build: one call's phase cycles, a warp's iteration
        counters = (ctypes.c_ulonglong * 7)()
        call(clocks)
        clocks.widen_probe(counters)
        call(clocks)
        if clocks.widen_probe(counters):
            raise RuntimeError("widen_probe failed")
        n_items = -(-ROWS // BLOCK_N) * -(-(BLOCK_N // GROUP) // 128)
        qtiles = -(-nq // plan.nq)
        blocks = min(n_items, -(-132 // qtiles)) * qtiles
        warps = blocks * 8  # the consumer warps
        iters = n_items * qtiles * GROUP * plan.chunks / blocks
        per_iter = {slot: counters[i] / warps / iters
                    for i, slot in enumerate(SLOTS)}
        result.setdefault("cycles_per_iteration", {})[f"q{nq}"] = per_iter
        print(f"Q {nq}: a warp's cycles an iteration: " + ", ".join(
            f"{k} {v:.0f}" for k, v in per_iter.items()), flush=True)

        times = {name: [] for name in libs}
        for order in (list(times), list(times)[::-1]):
            for name in order:
                times[name].append(ms(libs[name]))
        result["ms"][f"q{nq}"] = times
        print(f"Q {nq} ({plan}): " + ", ".join(
            f"{name} {min(t):.4f}" for name, t in times.items()), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
