"""Where K3's time goes on one NVIDIA card: patched builds of
`csrc/ell_topk.cu` timed in turns at the serve and hermetic shapes.

    python rag_dpo_tpu_torch/evals/probe_ell.py

Builds, under `rag_dpo_tpu_torch/build/probe_ell/`, copies of the source
with parts of pass 1 cut out (the cut copies compute wrong answers and are
only timed):
* `as_built`: the source as it is;
* `no_score`: the t loop skipped (no slot is read; a row's score is a hash
  of its position);
* `no_sort`: both bitonic phases skipped (the keys are written unsorted);
* `neither`: both cut: the launch, the key and the writes;
* `carveout`: both kernels ask for the largest shared-memory carveout;
* `merge_nop`: the merge pass launched with an empty body;
* `no_atomics`: a match's adds as plain stores (racy; timed only);
* `no_match`: no slot matches (the reads and the lookups alone);
* `loads_only`: the slots read and nothing looked up;
* `phases`: as built, with clock64 spans of pass 1's parts (the chunks'
  table set-up, the slot loops, the scoring as a whole, the two sort
  phases), the largest of the block's threads, in cycles of one call.
Each runs through its C entry point on preallocated outputs and scratch,
by CUDA events over 200 calls after 5 warm-up calls and by the profiler's
device time a call, at `chip_smoke.py::check_ell`'s serve shape (17,408 ×
32, Q 4, T 32, k 40: two launches) and hermetic shape (1,024 × 48, Q 1,
k 40: one launch). The wrapper `ops.sparse.ell_topk` is timed beside them
at both shapes, with its host time a call and its parts' (`host_us`: the
input checks, the three allocations, the device context, the stream, the
ctypes launch; host clock over 200 calls), and an empty kernel's
launch-to-launch time (C loop and one call through ctypes). Prints the card's name and power limit, a line a
measurement and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

VARIANTS = {
    "as_built": (),
    "no_score": (("for (int t0 = 0; t0 < T; t0 += kTC) {",
                  "for (int t0 = 0; t0 < 0; t0 += kTC) {"),
                 ("const float score = live ? acc : kNegInf;",
                  "const float score = live ? static_cast<float>("
                  "(tid * 2654435761u) % 977u) : kNegInf;")),
    "no_sort": (("bitonic_levels(2, kSeg, key, kbuf, buf);", ""),
                ("bitonic_levels(2 * kSeg, kBlockN, key, kbuf, buf);",
                 "__syncthreads();")),
}
VARIANTS["neither"] = VARIANTS["no_score"] + VARIANTS["no_sort"]
# both kernels asking for the SM's largest shared-memory carveout, so that
# the SM needs no other split between the two passes
VARIANTS["carveout"] = (
    ("    sized = true;",
     "    cudaFuncSetAttribute(ell_block_sort, "
     "cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n"
     "    cudaFuncSetAttribute(ell_merge, "
     "cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n"
     "    sized = true;"),)
# the merge launched with an empty body: what its launch alone costs
VARIANTS["merge_nop"] = (
    ("  const int q = blockIdx.x, m = nb * kb;",
     "  if (nb > 0) return;\n  const int q = blockIdx.x, m = nb * kb;"),)
# a match's adds as plain stores (racy where two slots of a row share a
# term; timed only): the cost of the shared atomics
VARIANTS["no_atomics"] = (
    ("        atomicAdd(hits + t * kBlockN + row, imp);",
     "        hits[t * kBlockN + row] = imp;"),
    ("        atomicOr(masks + row, 1u << t);",
     "        masks[row] |= 1u << t;"))
# the slots read and nothing looked up (a test the loaded values never
# fail): the loads alone
VARIANTS["loads_only"] = (
    ("  if (term < 0) return;  // -1 padding matches nothing",
     "  if (term != -12345 && imp != -1.f) return;"),)
# no slot matches: the reads and the table lookups alone
VARIANTS["no_match"] = (("    if (e == term) {", "    if (e == term && e < -5) {"),)
# clock64 spans of pass 1, each thread's, the largest kept (atomicMax): the
# chunks' table set-up, the slot loops, the scoring as a whole, the two
# sort phases; read and cleared by `probe_phases`
PHASES = ("setup", "slots", "scoring", "sort_segments", "sort_block")
VARIANTS["phases"] = (
    ("namespace {\n", "namespace {\n__device__ unsigned long long "
                       "g_phase[8];\n"),
    ("  for (int t0 = 0; t0 < T; t0 += kTC) {",
     "  const long long p_start = clock64();\n  long long p_setup = 0, "
     "p_slots = 0, p_in = 0;\n  for (int t0 = 0; t0 < T; t0 += kTC) {\n"
     "    const long long p_chunk = clock64();"),
    ("    if (vec) {  // 16-byte loads",
     "    p_in = clock64();\n    p_setup += p_in - p_chunk;\n"
     "    if (vec) {  // 16-byte loads"),
    ("    // the t-order chain of row tid",
     "    p_slots += clock64() - p_in;\n"
     "    // the t-order chain of row tid"),
    ("  const float score = live ? acc : kNegInf;",
     "  const long long p_scored = clock64();\n"
     "  const float score = live ? acc : kNegInf;"),
    ("  bitonic_levels(2, kSeg, key, kbuf, buf);",
     "  bitonic_levels(2, kSeg, key, kbuf, buf);\n"
     "  const long long p_sorted1 = clock64();"),
    ("  bitonic_levels(2 * kSeg, kBlockN, key, kbuf, buf);",
     "  bitonic_levels(2 * kSeg, kBlockN, key, kbuf, buf);\n"
     "  const long long p_sorted2 = clock64();\n"
     "  atomicMax(g_phase + 0, (unsigned long long)p_setup);\n"
     "  atomicMax(g_phase + 1, (unsigned long long)p_slots);\n"
     "  atomicMax(g_phase + 2, (unsigned long long)(p_scored - p_start));\n"
     "  atomicMax(g_phase + 3, (unsigned long long)(p_sorted1 - p_scored));"
     "\n  atomicMax(g_phase + 4, (unsigned long long)(p_sorted2 - "
     "p_sorted1));"),
    ("const char* kernel_error_string(int err) {",
     "int probe_phases(unsigned long long* out) {\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, 64);\n"
     "  unsigned long long z[8] = {0};\n"
     "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, z, 64);\n"
     "  return e;\n}\n\nconst char* kernel_error_string(int err) {"),
)


def build_variants(kernels) -> dict:
    out = kernels.BUILD_DIR / "probe_ell"
    out.mkdir(parents=True, exist_ok=True)
    source = (kernels.CSRC_DIR / "ell_topk.cu").read_text()
    procs = {}
    for name, patches in VARIANTS.items():
        text = source
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"probe_ell {name}: {old!r} not found")
            text = text.replace(old, new)
        src = out / f"ell_{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
             str(kernels.CSRC_DIR), "-o", str(out / f"lib{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.ell_topk.argtypes = kernels.SIGNATURES["ell_topk"]
        lib.ell_topk.restype = ctypes.c_int
        lib.empty_launches.argtypes = [i, p]
        if name == "phases":
            lib.probe_phases.argtypes = [p]
        libs[name] = lib
    return libs


def host_parts(torch, kernels, terms, imps, qt, qw, k, iters=200) -> dict:
    """The wrapper's host time a call, µs, and its parts (each repeated
    `iters` times on the host clock, fewer launches than the queue holds,
    so that the card never holds the host back)."""
    import time

    from rag_dpo_tpu_torch.ops.sparse import _ell_inputs, ell_topk

    dev = terms.device
    nb = -(-terms.shape[0] // 1024)
    q = qt.shape[0]
    lib = kernels.load("ell_topk")
    args = _ell_inputs(terms, imps, qt, qw, k, 1024)
    scratch = torch.empty(12 * q * nb * k, dtype=torch.uint8, device=dev)
    out_s = torch.empty((q, k), device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    stream = kernels.stream_of(terms)

    def launch():
        return lib.ell_topk(*(x.data_ptr() for x in args), *terms.shape, q,
                            qt.shape[1], k, scratch.data_ptr(),
                            out_s.data_ptr(), out_i.data_ptr(), stream)

    def device_ctx():
        with torch.cuda.device(dev):
            pass

    parts = {
        "wrapper": lambda: ell_topk(terms, imps, qt, qw, k=k),
        "inputs": lambda: _ell_inputs(terms, imps, qt, qw, k, 1024),
        "three_empty": lambda: (
            torch.empty(12 * q * nb * k, dtype=torch.uint8, device=dev),
            torch.empty((q, k), device=dev),
            torch.empty((q, k), dtype=torch.int32, device=dev)),
        "device_context": device_ctx,
        "stream": lambda: kernels.stream_of(terms),
        "ctypes_launch": launch,
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        out[name] = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
    return out


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    root = pathlib.Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    from rag_dpo_tpu_torch.evals.turns_k3_k11 import ell_inputs
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.sparse import ell_topk

    if not torch.cuda.is_available():
        print("probe_ell: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    libs = build_variants(_kernels)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def ms(fn, iters=200):
        for _ in range(5):
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

    def device_ms(fn, iters=50):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return {e.key[:40]: e.self_device_time_total / iters / 1e3
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}

    lib = libs["as_built"]
    floor = {"c_loop_ms": ms(lambda: lib.empty_launches(1000, stream),
                             iters=3) / 1000,
             "ctypes_ms": ms(lambda: lib.empty_launches(1, stream),
                             iters=2000)}
    print(f"empty kernel: {floor}", flush=True)
    result = {"card": card.strip(), "launch_floor": floor}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for label, shape in (("serve", (17_408, 16_919, 32, 4_000, 4, 32, 20)),
                         ("hermetic", (1024, 212, 48, 1_500, 1, 32, 14))):
        terms, imps, qt, qw = ell_inputs(torch, dev, gen, *shape)
        (n, width), (q, t), k = terms.shape, qt.shape, 40
        nb = -(-n // 1024)
        scratch = torch.empty(12 * q * nb * k, dtype=torch.uint8, device=dev)
        out_s = torch.empty((q, k), device=dev)
        out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
        r = {"wrapper_ms": ms(lambda: ell_topk(terms, imps, qt, qw, k=k)),
             "wrapper_device_ms": device_ms(
                 lambda: ell_topk(terms, imps, qt, qw, k=k))}
        for name, vlib in libs.items():
            def call(vlib=vlib):
                err = vlib.ell_topk(
                    terms.data_ptr(), imps.data_ptr(), qt.data_ptr(),
                    qw.data_ptr(), n, width, q, t, k, scratch.data_ptr(),
                    out_s.data_ptr(), out_i.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            r[name] = {"ms": ms(call), "device_ms": device_ms(call)}
            if name == "phases":
                cycles = (ctypes.c_ulonglong * 8)()
                vlib.probe_phases(cycles)  # clears what the timing left
                call()
                torch.cuda.synchronize()
                vlib.probe_phases(cycles)
                r[name]["max_cycles"] = dict(zip(PHASES, list(cycles)))
        r["host_us"] = host_parts(torch, _kernels, terms, imps, qt, qw, k)
        result[label] = r
        print(f"{label} [{n}x{width}] Q {q} T {t} k {k}: "
              + json.dumps(r), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
