"""K3 (`ell_topk`) and K11 (`int8_block_max(upcast="int8")`) of this
checkout against a parent checkout's, in turns on one NVIDIA card.

    git archive <parent> | tar -x -C logs/parent
    python rag_dpo_tpu_torch/evals/turns_k3_k11.py --parent logs/parent

Builds the parent's `csrc/ell_topk.cu` and `csrc/int8_block_max.cu` (with
its own headers) into `rag_dpo_tpu_torch/build/turns_k3_k11/`; the parent's
C entry points are those of commit c9cb2fc: `ell_topk(terms, impacts,
q_terms, q_weights, N, L, Q, T, k, cand_s, cand_i, out_s, out_i, stream)`
with a [Q, blocks, min(k, 1024)] candidate scratch, and
`int8_block_max_i8(q, e, Q, N, D, block, out, stream)`. The parent's calls
allocate what its wrapper allocated; this checkout's kernels run through
their wrappers.

* K3 at the serve path's sparse shape (17,408 × 32 ELL rows, 16,919 of
  them live, Zipf terms over 4,000, Q 4, T 32 with 20 live, k 40) and the
  hermetic replay's (1,024 × 48, 212 live rows, Q 1, T 32 with 14 live,
  k 40), as `chip_smoke.py::check_ell` makes them;
* K11 over 1,000,000 × 1024 uniform int8 rows at Q 1, 64 and 256, block
  2048, with the library strip (`torch._int_mm` + strided `amax`) at each Q.

Each is timed by CUDA events over 20 calls (200 for K3) after 3 warm-up
calls, in the order parent, new, new, parent, and once more by the
profiler's device time a call; the two must give the same ids and scores
(K3) or the same strip (K11). Prints the card's name and power limit, one
line a measurement and one JSON line.
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

ROWS, DIM, BLOCK = 1_000_000, 1024, 2048


def build_parent(kernels, parent: pathlib.Path) -> dict:
    """The parent's two libraries, built together, with c9cb2fc's C
    signatures."""
    libs = turns.build_parent(kernels, parent, ("ell_topk", "int8_block_max"),
                              "turns_k3_k11")
    p, i = ctypes.c_void_p, ctypes.c_int
    libs["ell_topk"].ell_topk.argtypes = [p, p, p, p, *[i] * 5, p, p, p, p, p]
    libs["int8_block_max"].int8_block_max_i8.argtypes = [p, p, *[i] * 4, p,
                                                         p]
    return libs


def ell_inputs(torch, dev, gen, n_pad, n_live, width, vocab, q, t, t_live):
    """`check_ell`'s ELL rows (Zipf terms, a random count of slots a row,
    rows past n_live empty) and queries (t_live Zipf terms of t)."""
    zipf = 1.0 / torch.arange(1, vocab + 1, device=dev, dtype=torch.float32)
    terms = torch.full((n_pad, width), -1, dtype=torch.int32, device=dev)
    terms[:n_live] = torch.multinomial(zipf.expand(n_live, vocab), width,
                                       replacement=False,
                                       generator=gen).to(torch.int32)
    used = torch.randint(1, width + 1, (n_live, 1), generator=gen,
                         device=dev)
    slot = torch.arange(width, device=dev)[None, :]
    terms[:n_live] = torch.where(slot < used, terms[:n_live], -1)
    imps = torch.where(terms >= 0, torch.rand((n_pad, width), generator=gen,
                                              device=dev) * 2.4 + 0.1, 0.0)
    qt = torch.multinomial(zipf.expand(q, vocab), t, replacement=False,
                           generator=gen).to(torch.int32)
    qt[:, t_live:] = -2
    qw = torch.where(qt >= 0, torch.rand((q, t), generator=gen, device=dev)
                     * 5.0, 0.0)
    return terms, imps, qt, qw


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=pathlib.Path,
                    help="root of the parent checkout")
    args = ap.parse_args()
    import torch

    from rag_dpo_tpu_torch.evals.bench_int8_matmul import library_block_max
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.int8_matmul import int8_block_max
    from rag_dpo_tpu_torch.ops.sparse import ell_topk

    if not torch.cuda.is_available():
        print("turns_k3_k11: no CUDA device", file=sys.stderr)
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
    for label, shape in (("serve", (17_408, 16_919, 32, 4_000, 4, 32, 20)),
                         ("hermetic", (1024, 212, 48, 1_500, 1, 32, 14))):
        terms, imps, qt, qw = ell_inputs(torch, dev, gen, *shape)
        n, width = terms.shape
        q, t = qt.shape
        nb, k = -(-n // 1024), 40

        def old(terms=terms, imps=imps, qt=qt, qw=qw, n=n, width=width, q=q,
                t=t, nb=nb):
            cand_s = torch.empty((q, nb, k), device=dev)
            cand_i = torch.empty((q, nb, k), dtype=torch.int32, device=dev)
            out_s = torch.empty((q, k), device=dev)
            out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
            err = parent["ell_topk"].ell_topk(
                terms.data_ptr(), imps.data_ptr(), qt.data_ptr(),
                qw.data_ptr(), n, width, q, t, k, cand_s.data_ptr(),
                cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                stream)
            if err:
                raise RuntimeError(f"parent ell_topk: CUDA error {err}")
            return out_s, out_i

        def new(terms=terms, imps=imps, qt=qt, qw=qw):
            return ell_topk(terms, imps, qt, qw, k=k)

        (ps, pi), (ns, ni) = old(), new()
        torch.cuda.synchronize()
        r = turns.turns(old, new, 200)
        r["same_ids_and_scores"] = bool(torch.equal(pi, ni)
                                        and torch.equal(ps, ns))
        result[f"k3_{label}"] = r
        print(f"K3 {label} [{n}x{width}] Q {q} T {t} k {k}: " + ", ".join(
            f"{key} {val}" for key, val in r.items()), flush=True)
        del terms, imps, qt, qw

    e8 = torch.randint(-127, 128, (ROWS, DIM), generator=gen, device=dev,
                       dtype=torch.int8)
    nb = ROWS // BLOCK
    for nq in (1, 64, 256):
        q8 = torch.randint(-127, 128, (nq, DIM), generator=gen, device=dev,
                           dtype=torch.int8)

        def old(q8=q8, nq=nq):
            strip = torch.empty((nq, nb * 128), device=dev)
            err = parent["int8_block_max"].int8_block_max_i8(
                q8.data_ptr(), e8.data_ptr(), nq, ROWS, DIM, BLOCK,
                strip.data_ptr(), stream)
            if err:
                raise RuntimeError(f"parent int8_block_max_i8: CUDA error "
                                   f"{err}")
            return strip

        def new(q8=q8):
            return int8_block_max(q8, e8, block=BLOCK, upcast="int8")

        same = bool(torch.equal(old(), new()))
        r = turns.turns(old, new, 20)
        r["same_strip"] = same
        r["library_ms"] = turns.event_ms(
            lambda q8=q8: library_block_max(q8, e8, BLOCK))
        result[f"k11_q{nq}"] = r
        print(f"K11 Q {nq}: " + ", ".join(f"{key} {val}"
                                          for key, val in r.items()),
              flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
