"""K6 and K10 of this checkout against a parent checkout's, in turns on one
NVIDIA card, with K11 and the library strip beside them.

    git archive <parent> | tar -x -C logs/parent
    python rag_dpo_tpu_torch/evals/turns_int8_sweeps.py --parent logs/parent

Builds the parent's `csrc/pooled.cu` and `csrc/int8_block_max.cu` (with its
own headers) into `rag_dpo_tpu_torch/build/turns_parent/`; the parent's C
entry points are those of commit 08858f2: `pooled_max(q, e, scale,
penalty, P, Q, N, D, block_n, group, out_v, out_i, stream)` and
`int8_block_max_{bf16,i8}(q, e, Q, N, D, block, out, stream)`. This
checkout's kernels run through their wrappers. Over 1,000,000 × 1024 rows
(unit Gaussian rows quantized as the store quantizes them, seed 0) it
times K6 at Q 1, 64 and 256 (block_n 8192, group 64, a zero penalty) and,
over uniform int8 rows and queries, K10 and K11 at the int8 floor's recipe
(Q 64, block 2048): CUDA events over 20 calls after 3 warm-up calls, in
the order parent, new, new, parent. Checks that both give the same K10
strip, and counts K6's values and ids that differ between the two (the
sums' order differs, so values may move by a bf16 ulp and ids at
near-ties). Then K10, K11 and the library strip (`torch._int_mm` + strided
`amax`, `evals/bench_int8_matmul.py`) at Q 1 and 256. Prints the card's
name and power limit, one line a measurement and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))  # run as a script
from rag_dpo_tpu_torch.evals import turns  # noqa: E402

ROWS, DIM = 1_000_000, 1024


def build_parent(kernels, parent: pathlib.Path) -> dict:
    """The parent's two libraries, built together, with 08858f2's C
    signatures."""
    libs = turns.build_parent(kernels, parent, ("pooled", "int8_block_max"),
                              "turns_parent")
    p, i = ctypes.c_void_p, ctypes.c_int
    libs["pooled"].pooled_max.argtypes = [p, p, p, p, *[i] * 6, p, p, p]
    for fn in ("int8_block_max_bf16", "int8_block_max_i8"):
        getattr(libs["int8_block_max"], fn).argtypes = [p, p, *[i] * 4, p, p]
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=pathlib.Path,
                    help="root of the parent checkout")
    args = ap.parse_args()
    import torch

    from rag_dpo_tpu_torch.evals.bench_int8_matmul import library_block_max
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.int8_matmul import int8_block_max
    from rag_dpo_tpu_torch.ops.pooled import pooled_group_max
    from rag_dpo_tpu_torch.ops.quantize import quantize_rows

    if not torch.cuda.is_available():
        print("turns_int8_sweeps: no CUDA device", file=sys.stderr)
        return 1
    card = turns.card()
    print(card, flush=True)
    parent = build_parent(_kernels, args.parent.resolve())
    _kernels.build_all()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

    result = {"card": card}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = torch.randn((ROWS, DIM), generator=gen, device=dev)
    rows /= rows.norm(dim=1, keepdim=True)
    e_i8, scale = quantize_rows(rows)
    del rows
    pen = torch.zeros(ROWS, device=dev)
    n_pool = -(-ROWS // 8192) * 128
    for nq in (1, 64, 256):
        q = torch.randn((nq, DIM), generator=gen, device=dev)
        q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        out_v = torch.empty((nq, n_pool), dtype=torch.bfloat16, device=dev)
        out_i = torch.empty((nq, n_pool), dtype=torch.int32, device=dev)

        def old(q=q, out_v=out_v, out_i=out_i, nq=nq):
            err = parent["pooled"].pooled_max(
                q.data_ptr(), e_i8.data_ptr(), scale.data_ptr(),
                pen.data_ptr(), ROWS, nq, ROWS, DIM, 8192, 64,
                out_v.data_ptr(), out_i.data_ptr(), stream)
            if err:
                raise RuntimeError(f"parent pooled_max: CUDA error {err}")

        def new(q=q):
            return pooled_group_max(q, e_i8, scale, pen)

        old()
        v, i = new()
        torch.cuda.synchronize()
        r = turns.turns(old, new, device=False)
        r["values_differ"] = int((v != out_v).sum())
        r["ids_differ"] = int((i != out_i).sum())
        result[f"k6_q{nq}"] = r
        print(f"K6 Q {nq}: parent {r['parent_ms'][0]:.4f} / "
              f"{r['parent_ms'][1]:.4f} ms, new {r['new_ms'][0]:.4f} / "
              f"{r['new_ms'][1]:.4f} ms; {r['values_differ']} values, "
              f"{r['ids_differ']} ids differ", flush=True)
    del e_i8, scale, pen

    def uniform(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    e8 = uniform((ROWS, DIM))
    nb = ROWS // 2048
    for nq in (64, 1, 256):
        q8 = uniform((nq, DIM))
        strip = torch.empty((nq, nb * 128), device=dev)
        for name, upcast in (("int8_block_max_bf16", "bf16"),
                             ("int8_block_max_i8", "int8")):
            def old(q8=q8, strip=strip, name=name, nq=nq):
                err = getattr(parent["int8_block_max"], name)(
                    q8.data_ptr(), e8.data_ptr(), nq, ROWS, DIM, 2048,
                    strip.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"parent {name}: CUDA error {err}")

            def new(q8=q8, upcast=upcast):
                return int8_block_max(q8, e8, block=2048, upcast=upcast)

            old()
            same = bool(torch.equal(new(), strip))
            r = (turns.turns(old, new, device=False) if nq == 64
                 else {"new_ms": [turns.event_ms(new)]})
            r["same_strip"] = same
            result[f"{name}_q{nq}"] = r
            print(f"{name} Q {nq}: " + ", ".join(
                f"{k} {v}" for k, v in r.items()), flush=True)
        lib = turns.event_ms(
            lambda q8=q8: library_block_max(q8, e8, 2048))
        result[f"library_q{nq}"] = lib
        print(f"library strip Q {nq}: {lib:.4f} ms", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
