"""Where K7's time goes on one NVIDIA card: patched builds of
`csrc/maxsim.cu` timed at the rerank and hermetic shapes.

    python rag_dpo_tpu_torch/evals/probe_maxsim.py

Builds, under `rag_dpo_tpu_torch/build/probe_maxsim/`, copies of the
source with parts cut out (the cut copies compute wrong scores and are
only timed):
* `as_built`: the source as it is (also timed with rings of 2 and 4
  stages at the rerank, through the C entry's `stages`, as are `skeleton`
  and `phases` with 2);
* `one_product`: the small half of the split query dropped (one TF32
  product a flop, as a kernel without the split would run);
* `no_mma`: the products replaced by an integer fold of the fragments
  (the loads, widening and split stay);
* `no_compute`: no fragment is read nor multiplied (the ring and the
  epilogue stay);
* `no_query_load` / `no_doc_load` / `no_loads`: the query tile's, the doc
  rows', or both copies into the ring skipped;
* `skeleton`: neither loads nor compute: the launch, the ring's waits and
  barriers, the epilogue, the atomics and the last block's sum;
* `phases`: as built, with clock64 spans of each block that holds a valid
  row: consumer thread 0's waits for a full stage, products and
  epilogues, the producer lane 0's waits for an empty stage and its
  boxes issued; and every block's ticket and the last block's sum;
  summed over blocks and the largest, in cycles of one call; and by the
  globaltimer, the spread of the blocks' starts and the first start to
  the last end, in µs.
Each runs through its C entry point on a preallocated output and its own
zeroed workspace, by CUDA events over 200 calls after 3 warm-up calls and
by the profiler's device time a call, at `chip_smoke.py::check_maxsim`'s
rerank ([1, 32] x [40, 256], D 1024, f16 rows valid to a random length)
and hermetic ([1, 27] x [40, 96], D 32) inputs, seed 0. Prints the card's
name and power limit, a line a shape and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))  # run as a script
from rag_dpo_tpu_torch.evals import turns  # noqa: E402

SHAPES = {"rerank": (1, 32, 40, 256, 1024), "hermetic": (1, 27, 40, 96, 32)}
MMA_PAIR = ("                mma_tf32(acc[mt][nt], af[mt], b0, b1);\n"
            "                mma_tf32(acc[mt][nt], af[mt], s0, s1);\n")
VARIANTS = {
    "as_built": (),
    "one_product": ((MMA_PAIR, "                mma_tf32(acc[mt][nt], "
                                "af[mt], b0, b1);\n"),),
    "no_mma": ((MMA_PAIR, "                acc[mt][nt][0] += "
                          "__uint_as_float((af[mt][0] ^ b0) & 0x3f000000u);"
                          "\n                acc[mt][nt][1] += "
                          "__uint_as_float((af[mt][2] ^ s1) & 0x3f000000u);"
                          "\n"),),
    "no_compute": (("        compute(s);\n", ""),),
    # a box skipped must leave the stage's byte count too, or the
    # consumers wait for bytes that never come
    "no_query_load": (("(a.tma_q ? S::kQBoxes * S::kQBoxBytes : 0)", "0"),
                      ("          if (a.tma_q)\n            for (int j = 0;",
                       "          if (false)\n            for (int j = 0;")),
    "no_doc_load": (("(a.tma_d ? S::kDocBytes : 0)", "0"),
                    ("          if (a.tma_d)\n            tma_load(st,",
                     "          if (false)\n            tma_load(st,")),
}
VARIANTS["no_loads"] = VARIANTS["no_query_load"] + VARIANTS["no_doc_load"]
VARIANTS["skeleton"] = VARIANTS["no_loads"] + VARIANTS["no_compute"]
# clock64 spans of consumer thread 0 and producer lane 0 of every block that
# holds a valid row (and of every block for the ticket), summed over blocks
# (sums) and the largest (max), in cycles; and the globaltimer (ns) of the
# first block's start, the last block's start and the last block's end
PHASES = ("consumer_full_waits", "products", "epilogue",
          "producer_empty_waits", "producer_issue", "ticket",
          "last_block_sum")


def _span(i: int, var: str, who: str = "tid == 0") -> str:
    return (f"    if ({who}) {{ atomicAdd(g_phase + {i}, "
            f"(unsigned long long)({var})); atomicMax(g_phase + 8 + {i}, "
            f"(unsigned long long)({var})); }}\n")


VARIANTS["phases"] = (
    ("namespace {\n", "namespace {\n__device__ unsigned long long "
                       "g_phase[32];\n__device__ __forceinline__ unsigned "
                       "long long gtime() {\n  unsigned long long t;\n  asm "
                       "volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));"
                       "\n  return t;\n}\n"),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  if (tid == 0) { const unsigned long long t0 = gtime();\n"
     "    atomicMin(g_phase + 16, t0); atomicMax(g_phase + 17, t0); }\n"),
    ("      for (long long i = 0; i < items; ++i) {\n"
     "        mbar_wait(empty + s, phase ^ 1);\n",
     "      long long pe_wait = 0, p_issue = 0;\n"
     "      for (long long i = 0; i < items; ++i) {\n"
     "        const long long pp = clock64();\n"
     "        mbar_wait(empty + s, phase ^ 1);\n"
     "        const long long pq = clock64();\n"
     "        pe_wait += pq - pp;\n"),
    ("        if (++s == stages) {\n          s = 0;\n          phase ^= 1;\n"
     "        }\n        if (++sl == n_slices) {\n          sl = 0;",
     "        p_issue += clock64() - pq;\n"
     "        if (++s == stages) {\n          s = 0;\n          phase ^= 1;\n"
     "        }\n        if (++sl == n_slices) {\n          sl = 0;"),
    ("    } else {\n      // The consumer warps.",
     _span(3, "pe_wait", "lane == 0") + _span(4, "p_issue", "lane == 0")
     + "    } else {\n      // The consumer warps."),
    ("      for (long long i = 0; i < items; ++i) {\n"
     "        mbar_wait(full + s, phase);\n        compute(s);\n",
     "      long long c_wait = 0, c_comp = 0, c_epi = 0;\n"
     "      for (long long i = 0; i < items; ++i) {\n"
     "        const long long pc = clock64();\n"
     "        mbar_wait(full + s, phase);\n"
     "        const long long pn = clock64();\n"
     "        c_wait += pn - pc;\n        compute(s);\n"
     "        c_comp += clock64() - pn;\n"),
    ("          epilogue(qt);\n",
     "          const long long pe = clock64();\n          epilogue(qt);\n"
     "          c_epi += clock64() - pe;\n"),
    ("          sl = 0;\n          ++qt;\n        }\n      }\n    }\n  }\n",
     "          sl = 0;\n          ++qt;\n        }\n      }\n"
     + _span(0, "c_wait") + _span(1, "c_comp") + _span(2, "c_epi")
     + "    }\n  }\n"),
    ("  // the last block of candidate c adds each query's maxima\n",
     "  // the last block of candidate c adds each query's maxima\n"
     "  const long long pt = clock64();\n"),
    ("  if (!is_last) return;\n",
     "  if (tid == 0) { const unsigned long long t1 = gtime();\n"
     "    atomicMax(g_phase + 18, t1); }\n"
     + _span(5, "clock64() - pt") + "  if (!is_last) return;\n"
     "  const long long ps = clock64();\n"),
    ("  if (tid == 0) a.tickets[c] = 0;\n",
     "  if (tid == 0) a.tickets[c] = 0;\n" + _span(6, "clock64() - ps")
     + "  if (tid == 0) atomicMax(g_phase + 18, gtime());\n"),
    ("const char* kernel_error_string(int err) {",
     "int probe_phases(unsigned long long* out) {\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, 256);\n"
     "  unsigned long long z[32] = {0};\n  z[16] = ~0ull;\n"
     "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, z, 256);\n"
     "  return e;\n}\n\nconst char* kernel_error_string(int err) {"),
)


def build_variants(kernels) -> dict:
    out = kernels.BUILD_DIR / "probe_maxsim"
    out.mkdir(parents=True, exist_ok=True)
    source = (kernels.CSRC_DIR / "maxsim.cu").read_text()
    procs = {}
    for name, patches in VARIANTS.items():
        text = source
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"probe_maxsim {name}: {old!r} not found")
            text = text.replace(old, new)
        src = out / f"maxsim_{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
             str(kernels.CSRC_DIR), "-o", str(out / f"lib{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.maxsim.argtypes = kernels.SIGNATURES["maxsim"]
        lib.maxsim.restype = ctypes.c_int
        if name == "phases":
            lib.probe_phases.argtypes = [ctypes.c_void_p]
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.maxsim import maxsim, maxsim_plan

    if not torch.cuda.is_available():
        print("probe_maxsim: no CUDA device", file=sys.stderr)
        return 1
    card = turns.card()
    print(card, flush=True)
    libs = build_variants(_kernels)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    result = {"card": card}
    for label, (q, lq, c, ld, d) in SHAPES.items():
        qv = torch.randn((q, lq, d), generator=gen, device=dev)
        qv /= qv.norm(dim=-1, keepdim=True)
        dv = torch.randn((c, ld, d), generator=gen, device=dev)
        dv = (dv / dv.norm(dim=-1, keepdim=True)).half()
        dlen = torch.randint(1, ld + 1, (c, 1), generator=gen, device=dev)
        d_mask = torch.arange(ld, device=dev)[None, :] < dlen
        q_mask = torch.ones((q, lq), dtype=torch.bool, device=dev)
        plan = maxsim_plan(torch.float16, q, lq, c, ld, d)
        out = torch.empty((q, c), device=dev)
        r = {"valid_rows": int(d_mask.sum()), "plan_stages": plan.stages,
             "wrapper_ms": turns.event_ms(
                 lambda: maxsim(qv, q_mask, dv, d_mask), 200),
             "wrapper_device_ms": turns.device_ms(
                 lambda: maxsim(qv, q_mask, dv, d_mask))}
        runs = [(name, plan.stages) for name in libs]
        if label == "rerank":
            runs += [("as_built", 2), ("as_built", 4), ("skeleton", 2),
                     ("phases", 2)]
        for name, stages in runs:
            lib = libs[name]
            ws = torch.zeros(c * q * lq + c, dtype=torch.int32, device=dev)

            def call(lib=lib, ws=ws, stages=stages, name=name):
                err = lib.maxsim(
                    1, qv.data_ptr(), q_mask.data_ptr(), dv.data_ptr(),
                    d_mask.data_ptr(), q, lq, c, ld, d, plan.row_tile,
                    plan.query_tile, stages, ws.data_ptr(),
                    ws.data_ptr() + 4 * c * q * lq, out.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            key = name if stages == plan.stages else f"{name}_{stages}"
            r[key] = {"ms": turns.event_ms(call, 200),
                      "device_ms": turns.device_ms(call)}
            if name == "phases":
                raw = (ctypes.c_ulonglong * 32)()
                lib.probe_phases(raw)  # clears what the timing left
                call()
                torch.cuda.synchronize()
                lib.probe_phases(raw)
                r[key].update(
                    sum_cycles=dict(zip(PHASES, list(raw[:7]))),
                    max_cycles=dict(zip(PHASES, list(raw[8:15]))),
                    blocks_start_spread_us=(raw[17] - raw[16]) / 1e3,
                    first_start_to_last_end_us=(raw[18] - raw[16]) / 1e3)
        result[label] = r
        print(f"{label} [{q},{lq}]x[{c},{ld}] D {d} f16: " + json.dumps(r),
              flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
