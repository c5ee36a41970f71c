"""What the per-warp operand split and the blocks an SM cost K8 and K9
(`csrc/flash_bwd.cu`) at the training shape, on one NVIDIA card.

    python rag_dpo_tpu_torch/evals/probe_flash_bwd.py

Each warp of K8 and K9 splits every f32 fragment it reads from shared
memory into big + small (three ALU operations an element); splitting each
tile once a block into shared planes would need about twice the shared
memory, one block an SM in place of two at head width 64. This builds
four variants of `csrc/flash_bwd.cu`, patched copies of the source with
only the width-64 instances, under `rag_dpo_tpu_torch/build/probe_flash_bwd/`:

- `as_built`: the source as it is (its bits are checked against the
  wrappers');
- `no_split`: the fragments read from shared memory go to the tensor cores
  as they are (big = small = x): the same loads and products without the
  split (wrong results; the split of P and dS, in registers, stays). Its
  gap to `as_built` is what the per-warp split costs, the most that planes
  could save;
- `one_block`: each block asks for 227 KB of shared memory, one block an
  SM, as planes would need (the same bits as `as_built`);
- `no_split_one_block`: both, an optimistic plane design (the split free,
  no second shared read a plane costs).

Times `flash_bwd_dq` and `flash_bwd_dkv` of each through its C entry point
at [16,16,192,64] f32, unit Gaussian q, k, v and upstream gradient from
seed 5 with ragged lengths (random in 1 ... S, the first S), as
`bench_selectors.py` makes them: CUDA events over 100 calls after 3
warm-up calls, the variants in turns, three rounds. Prints the card's
name and power limit, each variant's registers and times, and one JSON
line.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

SHAPE = (16, 16, 192, 64)
WIDTHS = ("#define K89_WIDTHS(X) X(16) X(32) X(64) X(128) X(256) X(512)",
          "#define K89_WIDTHS(X) X(64)", 1)
INCLUDE = '#include "mma_sync.cuh"\n'
NO_SPLIT = [
    (INCLUDE, INCLUDE + "\n__device__ __forceinline__ void nosplit("
     "float x, uint32_t& big, uint32_t& small) {\n"
     "  big = small = __float_as_uint(x);\n}\n", 1),
    ("split(af[", "nosplit(af[", 4),   # the own rows' A fragments
    ("split(row[", "nosplit(row[", 2),  # the walked tile by rows
    ("split(b0r[", "nosplit(b0r[", 2)]  # the walked tile by columns
ONE_BLOCK = [("static constexpr size_t kSmem = smem_bytes<T, DH, DKV>(kW);",
              "static constexpr size_t kSmem = kMaxSmem;", 1)]
VARIANTS = {"as_built": [], "no_split": NO_SPLIT, "one_block": ONE_BLOCK,
            "no_split_one_block": NO_SPLIT + ONE_BLOCK}


def build(kernels, name: str, patches: list) -> tuple:
    """The variant's library and its ptxas registers of the f32 kernels."""
    text = (kernels.CSRC_DIR / "flash_bwd.cu").read_text()
    for old, new, count in [WIDTHS, *patches]:
        if text.count(old) != count:
            raise RuntimeError(f"{name}: {old!r} found {text.count(old)} "
                               f"times, not {count}")
        text = text.replace(old, new)
    out_dir = kernels.BUILD_DIR / "probe_flash_bwd" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "flash_bwd.cu", out_dir / "libflash_bwd.so"
    src.write_text(text)
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC_DIR),
         "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    regs, kernel = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel and "IfLi64E" in kernel:
            regs["dq" if "dq_kernel" in kernel else "dkv"] = int(m.group(1))
    return lib, regs


def main() -> int:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        print("probe_flash_bwd: needs an NVIDIA card", file=sys.stderr)
        return 1
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.flash_attention import flash_attention
    from rag_dpo_tpu_torch.ops.flash_attention_bwd import (
        _row_delta,
        flash_bwd_dkv,
        flash_bwd_dq,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda kv: build(_kernels, *kv), VARIANTS.items())))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    b, h, s, dh = SHAPE
    q, k, v = (torch.randn(SHAPE, generator=gen, device=dev)
               for _ in range(3))
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0] = s
    g = torch.randn(SHAPE, generator=gen, device=dev)
    out, lse = flash_attention(q, k, v, lengths, return_lse=True)
    dd = _row_delta(out, g)
    lse, dd = lse.contiguous(), dd.contiguous()
    want = (flash_bwd_dq(q, k, v, lengths, lse, dd, g, dh ** -0.5),
            *flash_bwd_dkv(q, k, v, lengths, lse, dd, g, dh ** -0.5))
    grads = [torch.empty_like(q) for _ in range(3)]
    ins = [x.data_ptr() for x in (q, k, v, g, lengths, lse, dd)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    tail = (b, h, s, dh, dh ** -0.5, stream)

    calls = {}
    for name, (path, _) in built.items():
        lib = ctypes.CDLL(str(path))
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        for entry in ("flash_bwd_dq", "flash_bwd_dkv"):
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = _kernels.SIGNATURES[entry]
        outs = ([grads[0].data_ptr()],
                [grads[1].data_ptr(), grads[2].data_ptr()])

        def dq(lib=lib, outs=outs):
            _kernels.check(lib, lib.flash_bwd_dq(0, *ins, *outs[0], *tail),
                           "flash_bwd_dq")

        def dkv(lib=lib, outs=outs):
            _kernels.check(lib, lib.flash_bwd_dkv(0, *ins, *outs[1], *tail),
                           "flash_bwd_dkv")

        calls[name] = {"dq": dq, "dkv": dkv}
        if "no_split" not in name:
            dq()
            dkv()
            torch.cuda.synchronize()
            same = all(torch.equal(a, w) for a, w in zip(grads, want))
            if not same:
                raise RuntimeError(f"{name} gave other bits than the "
                                   f"wrappers' kernels")

    def ms(fn, iters=100, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return a.elapsed_time(e) / iters

    times = {name: {"dq": [], "dkv": []} for name in built}
    for _ in range(3):
        for name, fns in calls.items():
            for kind, fn in fns.items():
                times[name][kind].append(ms(fn))
    report = {}
    for name, (_, regs) in built.items():
        report[name] = {"registers": regs,
                        "dq_ms": times[name]["dq"],
                        "dkv_ms": times[name]["dkv"]}
        print(f"{name}: registers {regs}; dq "
              + " / ".join(f"{t:.4f}" for t in times[name]["dq"])
              + " ms; dkv "
              + " / ".join(f"{t:.4f}" for t in times[name]["dkv"])
              + " ms", flush=True)
    print(json.dumps({"shape": list(SHAPE), "dtype": "float32",
                      "lengths": lengths.tolist(), "variants": report}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
