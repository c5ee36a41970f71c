"""Time the top-k selectors K4 (`ops.topk.fused_topk`), K5
(`ops.topk.seg_candidates`) and K3 (`ops.sparse.ell_topk`), the flash
forward K1 (`ops.flash_attention.flash_attention`) and the flash backward
K8 and K9 (`ops.flash_attention_bwd`), of one checkout on one NVIDIA card.

    python rag_dpo_tpu_torch/evals/bench_selectors.py [--root DIR] [--label L]

`--root` is the checkout whose `rag_dpo_tpu_torch` is imported (default
the one holding this file), so two trees can be timed in turns on one
card, each in its own process. The dense rows are `chip_smoke.py`'s scale
corpus: 1,000,448 unit Gaussian bf16 rows of 1024 dims from seed 5, −1e4
on the 448 padding rows; k 40; K5 at block_n 2048, seg 128, per_seg 2.
K4 and K5 are timed at Q 1, 64 and 256 and at the serve shape (4 queries
× the first 17,408 rows), each beside `torch.topk(torch.addmm(pen, q,
e.T), 40)` on the same inputs. K3 is timed at the serve path's sparse
shape as `chip_smoke.py` builds it: 17,408 ELL rows of 32 Zipf terms over
a 4,000-term vocabulary, 4 queries of 20 terms padded to 32, k 40. K1 is
timed at the training shape [16,16,192,64] and at the ingest batch
[64,16,512,64], f32 unit Gaussian q, k, v from seed 5 with ragged lengths
(random in 1 ... S, the first S, as `chip_smoke.py` times them), beside
`scaled_dot_product_attention` with the same key mask, and the flash
backward K8 (`flash_bwd_dq`) and K9 (`flash_bwd_dkv`) on the same inputs
(with a unit Gaussian upstream gradient) beside the backward of that SDPA
call (dq, dk and dv in one call). Each time is CUDA events over 20 calls
after 3 warm-up calls. Prints the card's name and power limit, then one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

BATCHES = (1, 64, 256)
FLASH_SHAPES = ((16, 16, 192, 64), (64, 16, 512, 64))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = pathlib.Path(__file__).resolve().parents[2]
    ap.add_argument("--root", default=str(here))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("bench_selectors: needs an NVIDIA card", file=sys.stderr)
        return 1
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.flash_attention import flash_attention
    from rag_dpo_tpu_torch.ops.flash_attention_bwd import (
        _row_delta,
        flash_bwd_dkv,
        flash_bwd_dq,
    )
    from rag_dpo_tpu_torch.ops.sparse import ell_topk
    from rag_dpo_tpu_torch.ops.topk import fused_topk, seg_candidates

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _kernels.build_all()
    dev = torch.device("cuda")

    def ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    n, d = 1_000_448, 1024
    e = torch.zeros((n, d), dtype=torch.bfloat16, device=dev)
    for lo in range(0, 1_000_000, 1 << 17):
        hi = min(1_000_000, lo + (1 << 17))
        x = torch.randn((hi - lo, d), generator=gen, device=dev)
        e[lo:hi] = (x / x.norm(dim=1, keepdim=True)).bfloat16()
    pen = torch.zeros(n, device=dev)
    pen[1_000_000:] = -1e4
    kw = dict(penalty=pen, block_n=2048, seg=128, per_seg=2)
    out = {"label": args.label, "root": args.root}
    for nq in BATCHES:
        q = torch.randn((nq, d), generator=gen, device=dev)
        q = (q / q.norm(dim=1, keepdim=True)).bfloat16()
        pen16 = pen.bfloat16()
        out[f"q{nq}"] = {
            "k4_ms": ms(lambda: fused_topk(q, e, 40, penalty=pen)),
            "k5_ms": ms(lambda: seg_candidates(q, e, **kw)),
            "library_ms": ms(lambda: torch.topk(torch.addmm(pen16, q, e.T),
                                                40))}
    es, ps = e[:17_408], pen[:17_408].clone()
    q = torch.randn((4, d), generator=gen, device=dev)
    q = (q / q.norm(dim=1, keepdim=True)).bfloat16()
    ps16 = ps.bfloat16()
    out["serve"] = {
        "k4_ms": ms(lambda: fused_topk(q, es, 40, penalty=ps)),
        "k5_ms": ms(lambda: seg_candidates(q, es, **{**kw, "penalty": ps})),
        "library_ms": ms(lambda: torch.topk(torch.addmm(ps16, q, es.T), 40))}

    n_pad, width, vocab, live = 17_408, 32, 4_000, 16_919
    zipf = 1.0 / torch.arange(1, vocab + 1, device=dev, dtype=torch.float32)
    terms = torch.multinomial(zipf.expand(n_pad, vocab), width,
                              replacement=False, generator=gen).to(torch.int32)
    used = torch.randint(0, width + 1, (n_pad, 1), generator=gen, device=dev)
    terms = torch.where(torch.arange(width, device=dev)[None, :] < used,
                        terms, -1)
    terms[live:] = -1
    imps = torch.where(terms >= 0, torch.rand((n_pad, width), generator=gen,
                                              device=dev) * 2.4 + 0.1, 0.0)
    qt = torch.multinomial(zipf.expand(4, vocab), 32, replacement=False,
                           generator=gen).to(torch.int32)
    qt[:, 20:] = -2
    qw = torch.where(qt >= 0, torch.rand((4, 32), generator=gen,
                                         device=dev) * 5.0, 0.0)
    out["serve"]["k3_ms"] = ms(lambda: ell_topk(terms, imps, qt, qw, k=40))

    import torch.nn.functional as F

    for b, h, s, dh in FLASH_SHAPES:
        q, k, v = (torch.randn((b, h, s, dh), generator=gen, device=dev)
                   for _ in range(3))
        lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                                dtype=torch.int32)
        lengths[0] = s
        mask = (torch.arange(s, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        g = torch.randn((b, h, s, dh), generator=gen, device=dev)
        o, lse = flash_attention(q, k, v, lengths, return_lse=True)
        args = (q, k, v, lengths, lse, _row_delta(o, g), g, dh ** -0.5)
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        out[f"flash_{b}x{h}x{s}x{dh}"] = {
            "k1_ms": ms(lambda: flash_attention(q, k, v, lengths)),
            "library_ms": ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask)),
            "k8_ms": ms(lambda: flash_bwd_dq(*args)),
            "k9_ms": ms(lambda: flash_bwd_dkv(*args)),
            "library_bwd_ms": ms(lambda: torch.autograd.grad(
                sdpa, (qg, kg, vg), g, retain_graph=True))}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
