#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`rag_dpo_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero before the result lines:

1. device — needs `torch.cuda.is_available()`; prints the card's name and
   power limit as `nvidia-smi` reports them;
2. build — compiles the CUDA kernels in `rag_dpo_tpu_torch/csrc/` with nvcc
   for sm_90a (seconds printed);
3. kernels — each kernel against its plain PyTorch twin on the same CUDA
   tensors, at the shapes the query path gives it (and the flash forward
   at the training shape too), timed with CUDA events;
4. ingest — 16,919 chunk texts over 1,829 doc keys, made from `--seed` by
   recombining sentences of the synthetic corpus, encoded by a full-width
   BGE-M3 (24 layers, 1024 hidden, random weights) through the port's
   `CorpusIndexer`, then saved as an index checkpoint;
5. serve — `build_stack` reloads the checkpoint and answers 8 questions of
   the QA dataset through `pipeline.query` with a full-width cross-encoder
   reranking 40 candidates to 10; the kernels' launch counters must rise
   and no plain twin may run on the card;
6. backward kernels — flash attention's dq and dk/dv kernels against their
   plain twin on the same CUDA tensors, at the training shape and others;
7. train — contrastive training of a full-width BGE-M3 (f32, flash on) on
   16 pairs x 192 tokens with one mined hard negative each, through
   `train_retriever`: 2 steps and a checkpoint, then a resume to step 4;
   then 1 warm-up and 8 timed steps on one repeated batch, whose losses
   must be finite and fall. The flash forward and both backward kernels
   must launch, and no plain twin may run on the card.

The second-to-last line is a JSON object with each kernel's launches in
the phase of the main path that runs it (serve for the ELL kernel, train
for the flash kernels), its max abs error against the twin and both
times; the last line is `{"ok": true, "device": {...}}`. There is no CPU
path.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
QA_DATASET = ROOT / "rag_dpo_tpu" / "evals" / "data" / "qa_dataset.json"
N_CHUNKS, N_DOCS, N_QUESTIONS = 16_919, 1_829, 8
# f32 flash: the kernel streams 64-key blocks with an online softmax and
# sums in another order than the twin's single block; both keep f32
# accumulators, so they agree far inside 1e-4. bf16 rounds the output.
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SERVE_KERNELS = ("flash_fwd", "ell_topk")
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
TRAIN_PAIRS, TRAIN_SEQ, TIMED_STEPS = 16, 192, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    """A failed phase check: raises (and so exits non-zero), even under -O."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
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


def device_ms(fn, iters: int = 10) -> float:
    """Device time per call: the kernels' own time as torch.profiler sees
    it, without the host-side gaps that CUDA events around a loop keep."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters / 1e3


# ------------------------------------------------------------ kernels
def check_flash(dev, gen) -> dict:
    import torch

    from rag_dpo_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    # (batch, heads, seq, head_dim, dtype, lengths): the query-encode
    # buckets, the rerank/ingest batch, a ragged batch with an empty row,
    # bf16, and the training shape (random ragged lengths, as a batch of
    # pairs gives them)
    cases = [(4, 16, s, 64, torch.float32, None)
             for s in (32, 64, 128, 256, 512)]
    cases.append((64, 16, 512, 64, torch.float32, None))
    cases.append((8, 16, 300, 64, torch.float32,
                  [300, 0, 1, 17, 64, 65, 299, 128]))
    cases.append((4, 16, 256, 64, torch.bfloat16, [256, 100, 0, 3]))
    cases.append((TRAIN_PAIRS, 16, TRAIN_SEQ, 64, torch.float32, None))
    worst, timed = 0.0, {}
    for b, h, s, dh, dtype, lens in cases:
        q, k, v = (torch.randn((b, h, s, dh), generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        if lens is None:
            lengths = torch.randint(1, s + 1, (b,), generator=gen,
                                    device=dev, dtype=torch.int32)
            lengths[0] = s
        else:
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        out, lse = flash_attention(q, k, v, lengths, return_lse=True)
        ref, ref_lse = flash_attention_plain(q, k, v, lengths,
                                             return_lse=True)
        torch.cuda.synchronize()
        tol = FLASH_TOL[str(dtype).split(".")[1]]
        err = float((out.float() - ref.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
        if lens is not None and 0 in lens:
            check(bool((out[lens.index(0)] == 0).all()),
                  "a row with no keys is not 0")
        ms = cuda_ms(lambda: flash_attention(q, k, v, lengths))
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, lengths))
        log(f"flash_fwd [{b},{h},{s},{dh}] {str(dtype)[6:]} "
            f"max_abs_err={err:.3g} lse_err={lse_err:.3g} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
        if dtype == torch.float32:
            worst = max(worst, err)
        key = {(TRAIN_PAIRS, TRAIN_SEQ): "", (64, 512): "serve_"}.get((b, s))
        if key is not None:
            dms = device_ms(lambda: flash_attention(q, k, v, lengths))
            plain_dms = device_ms(lambda: flash_attention_plain(q, k, v,
                                                                lengths))
            timed.update({f"{key}max_abs_err": err,
                          f"{key}lse_max_abs_err": lse_err,
                          f"{key}ms": ms, f"{key}plain_ms": plain_ms,
                          f"{key}device_ms": dms,
                          f"{key}plain_device_ms": plain_dms,
                          f"{key}shape": f"[{b},{h},{s},{dh}] f32"})
            log(f"  device only: kernel {dms:.4f} ms, plain "
                f"{plain_dms:.4f} ms")
    # the unprefixed numbers are the training shape's, where the main
    # path's launches are counted; serve_ keys hold the ingest batch's
    return {**timed, "all_f32_cases_max_abs_err": worst}


def check_ell(dev, gen) -> dict:
    import torch

    from rag_dpo_tpu_torch.ops.sparse import ell_topk, ell_topk_plain

    def compare(terms, imps, qt, qw, k, label):
        s, i = ell_topk(terms, imps, qt, qw, k=k)
        ps, pi = ell_topk_plain(terms, imps, qt, qw, k)
        torch.cuda.synchronize()
        check(torch.equal(i, pi), f"ell_topk ids differ ({label})")
        err = float((s - ps).abs().max())
        check(err == 0.0, f"ell_topk scores differ by {err} ({label})")
        return i, err

    # the sparse arm's shape: the index's padded image of 16,919 chunks
    # (17,408 rows, 32 terms each), 4 query variants of 32 terms, k=40
    n_pad, width, vocab = 17_408, 32, 4_000
    zipf = 1.0 / torch.arange(1, vocab + 1, device=dev, dtype=torch.float32)
    terms = torch.multinomial(zipf.expand(n_pad, vocab), width,
                              replacement=False, generator=gen).to(torch.int32)
    used = torch.randint(0, width + 1, (n_pad, 1), generator=gen, device=dev)
    slot = torch.arange(width, device=dev)[None, :]
    terms = torch.where(slot < used, terms, -1)
    terms[N_CHUNKS:] = -1
    imps = torch.where(terms >= 0, torch.rand((n_pad, width), generator=gen,
                                              device=dev) * 2.4 + 0.1, 0.0)
    qt = torch.multinomial(zipf.expand(4, vocab), 32, replacement=False,
                           generator=gen).to(torch.int32)
    qt[:, 20:] = -2
    qw = torch.where(qt >= 0, torch.rand((4, 32), generator=gen,
                                         device=dev) * 5.0, 0.0)
    _, worst = compare(terms, imps, qt, qw, 40, "sparse arm")
    ms = cuda_ms(lambda: ell_topk(terms, imps, qt, qw, k=40))
    plain_ms = cuda_ms(lambda: ell_topk_plain(terms, imps, qt, qw, 40))
    dms = device_ms(lambda: ell_topk(terms, imps, qt, qw, k=40))
    plain_dms = device_ms(lambda: ell_topk_plain(terms, imps, qt, qw, 40))
    log(f"ell_topk [{n_pad}x{width}] Q=4 T=32 k=40 ids exact "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} (device only: "
        f"kernel {dms:.4f} ms, plain {plain_dms:.4f} ms)")

    # tie probes (ROADMAP C-1): 12 hits among 212 rows; 300 zero rows
    t212 = torch.full((212, 4), -1, dtype=torch.int32, device=dev)
    i212 = torch.zeros((212, 4), device=dev)
    for r in (1, 2, 5, 9, 40, 77, 100, 127, 130, 150, 190, 211):
        t212[r, 0], i212[r, 0] = 7, 1.0 + r % 3
    q1 = torch.tensor([[7, -2]], dtype=torch.int32, device=dev)
    w1 = torch.tensor([[1.5, 0.0]], device=dev)
    compare(t212, i212, q1, w1, 40, "212-row probe")
    ids, _ = compare(torch.full((300, 4), -1, dtype=torch.int32, device=dev),
                     torch.zeros((300, 4), device=dev), q1, w1, 40,
                     "300 zero rows")
    check(ids[0, :6].tolist() == [0, 128, 256, 1, 129, 257],
          f"zero rows came out as {ids[0, :6].tolist()}")
    log("ell_topk tie probes: ids exact, zero rows in (block, round, "
        "segment) order")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dms, "plain_device_ms": plain_dms,
            "shape": f"[{n_pad}x{width}] Q=4 T=32 k=40"}


def check_flash_bwd(dev, gen) -> dict:
    import torch

    from rag_dpo_tpu_torch.ops.flash_attention import flash_attention
    from rag_dpo_tpu_torch.ops.flash_attention_bwd import (
        _row_delta,
        flash_bwd_dkv,
        flash_bwd_dkv_plain,
        flash_bwd_dq,
        flash_bwd_dq_plain,
    )

    # (batch, heads, seq, head_dim, dtype, lengths): the training shape,
    # the ingest batch, a ragged batch with an empty row, bf16, Dh 16/128
    cases = [(16, 16, TRAIN_SEQ, 64, torch.float32, None),
             (64, 16, 512, 64, torch.float32, None),
             (8, 16, 300, 64, torch.float32,
              [300, 0, 1, 17, 64, 65, 299, 128]),
             (4, 16, 256, 64, torch.bfloat16, [256, 100, 0, 3]),
             (4, 8, 200, 16, torch.float32, [200, 0, 64, 199]),
             (4, 8, 130, 128, torch.float32, [130, 64, 0, 1])]
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    main = {}
    for b, h, s, dh, dtype, lens in cases:
        q, k, v, g = (torch.randn((b, h, s, dh), generator=gen, device=dev)
                      .to(dtype) for _ in range(4))
        if lens is None:
            lengths = torch.randint(1, s + 1, (b,), generator=gen,
                                    device=dev, dtype=torch.int32)
            lengths[0] = s
        else:
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = dh ** -0.5
        out, lse = flash_attention(q, k, v, lengths, return_lse=True)
        dd = _row_delta(out, g)
        args = (q, k, v, lengths, lse, dd, g, scale)
        dq, (dk, dv) = flash_bwd_dq(*args), flash_bwd_dkv(*args)
        rq, (rk, rv) = flash_bwd_dq_plain(*args), flash_bwd_dkv_plain(*args)
        torch.cuda.synchronize()
        # dq sums keys, dk/dv queries, in 64-row tiles; the twin in one
        # cuBLAS product; both in f32, and bf16 rounds the outputs
        tol = FLASH_TOL[str(dtype).split(".")[1]]
        errs, sizes = {}, {}
        for name, got, ref in (("dq", dq, rq), ("dk", dk, rk),
                               ("dv", dv, rv)):
            check(got.dtype == dtype, f"{name} came out as {got.dtype}")
            errs[name] = float((got.float() - ref.float()).abs().max())
            sizes[name] = float(ref.float().abs().max())
            check(sizes[name] > 0, f"{name} of the twin is all 0")
            torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                       rtol=tol, msg=lambda m: f"{name}: {m}")
        if lens is not None and 0 in lens:
            z = lens.index(0)
            check(all(bool((x[z] == 0).all()) for x in (dq, dk, dv)),
                  "a row with no keys has a non-zero gradient")
        ms = {"flash_bwd_dq": cuda_ms(lambda: flash_bwd_dq(*args)),
              "flash_bwd_dkv": cuda_ms(lambda: flash_bwd_dkv(*args))}
        plain = {"flash_bwd_dq": cuda_ms(lambda: flash_bwd_dq_plain(*args)),
                 "flash_bwd_dkv": cuda_ms(
                     lambda: flash_bwd_dkv_plain(*args))}
        log(f"flash_bwd [{b},{h},{s},{dh}] {str(dtype)[6:]} max_abs_err "
            + " ".join(f"{n}={e:.3g} (of max |{n}| {sizes[n]:.3g})"
                       for n, e in errs.items())
            + f" dq kernel_ms={ms['flash_bwd_dq']:.4f} plain_ms="
              f"{plain['flash_bwd_dq']:.4f} dkv kernel_ms="
              f"{ms['flash_bwd_dkv']:.4f} plain_ms="
              f"{plain['flash_bwd_dkv']:.4f}")
        if dtype == torch.float32:
            worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs["dq"])
            worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], errs["dk"],
                                         errs["dv"])
        if (b, s) == (16, TRAIN_SEQ):
            dev_ms = {
                "flash_bwd_dq": (
                    device_ms(lambda: flash_bwd_dq(*args)),
                    device_ms(lambda: flash_bwd_dq_plain(*args))),
                "flash_bwd_dkv": (
                    device_ms(lambda: flash_bwd_dkv(*args)),
                    device_ms(lambda: flash_bwd_dkv_plain(*args)))}
            for name, (kd, pd) in dev_ms.items():
                main[name] = {"ms": ms[name], "plain_ms": plain[name],
                              "device_ms": kd, "plain_device_ms": pd}
                log(f"  {name} device only: kernel {kd:.4f} ms, plain "
                    f"{pd:.4f} ms")
    shape = f"[16,16,{TRAIN_SEQ},64] f32"
    return {name: {"max_abs_err": worst[name], **main[name], "shape": shape}
            for name in worst}


# ------------------------------------------------------------- corpus
def build_corpus(seed: int, n_chunks: int, n_docs: int) -> tuple:
    """The synthetic corpus's 212 chunks, then chunks whose text is 2-4
    sentences drawn (seeded) from all of its sentences, spread over
    `n_docs` doc keys."""
    import numpy as np

    from rag_dpo_tpu_torch.evals.synthetic import build_synthetic_corpus

    dataset = json.loads(QA_DATASET.read_text(encoding="utf-8"))
    base = build_synthetic_corpus(dataset)
    sentences = [s for c in base
                 for s in re.split(r"(?<=[.!?])\s+", c["text"]) if s]
    rng = np.random.default_rng(seed)
    chunks = list(base)
    for i in range(len(base), n_chunks):
        doc = i % n_docs
        src = base[doc % len(base)]
        pick = rng.choice(len(sentences), size=int(rng.integers(2, 5)),
                          replace=False)
        chunks.append({
            "chunk_id": f"gen_{i}",
            "text": " ".join(sentences[j] for j in pick),
            "heading": src["heading"],
            "title": src["title"],
            "doc_key": f"cnil.fr/doc/{doc}",
            "source_url": f"https://cnil.fr/fr/doc/{doc}",
            "source": "CNIL",
            "nature": src["nature"],
        })
    return dataset, chunks


# ------------------------------------------------------- ingest, serve
def run_path(seed: int, dev) -> dict:
    import numpy as np
    import torch

    from rag_dpo_tpu_torch.bootstrap import build_stack
    from rag_dpo_tpu_torch.evals.synthetic import ExtractiveFakeLLM
    from rag_dpo_tpu_torch.ingest import CorpusIndexer
    from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.providers import Embedder, EmbedderConfig
    from rag_dpo_tpu_torch.retrieval.reranker import CrossEncoderReranker
    from rag_dpo_tpu_torch.utils.paths import default_paths

    encoder_cfg = EncoderConfig.bge_m3()
    dataset, chunks = build_corpus(seed, N_CHUNKS, N_DOCS)
    embedder = Embedder(
        EmbedderConfig(model=BgeM3Config(encoder=encoder_cfg)),
        rng_seed=seed, device=dev)
    embedder.load()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index, stats, report = CorpusIndexer(embedder).build(chunks)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    dense = index._dense.astype(np.float32)
    check(len(index) == N_CHUNKS, f"index holds {len(index)} rows")
    check(np.isfinite(dense).all(), "non-finite dense vectors")
    norms = np.linalg.norm(dense, axis=1)
    check(np.allclose(norms, 1.0, atol=1e-2),
          f"dense norms in [{norms.min()}, {norms.max()}]")
    check(report.verification["self_retrieval_ok"], report.verification)
    log(f"ingest: {N_CHUNKS} chunks / {N_DOCS} docs in {ingest_s:.2f} s "
        f"= {N_CHUNKS / ingest_s:.1f} chunks/s")

    class RecordingReranker(CrossEncoderReranker):
        """Keeps every rerank output, to show none fell back."""

        calls: list = []

        def rerank(self, *a, **kw):
            out = super().rerank(*a, **kw)
            self.calls.append(out)
            return out

    with tempfile.TemporaryDirectory(prefix="ragdpo_smoke_") as tmp:
        paths = default_paths(tmp)
        index.save(paths.index_dir)   # no document_summaries: no prefilter
        del index
        reranker = RecordingReranker(model_config=encoder_cfg, device=dev)
        reranker.load()
        _kernels.reset_counts()
        stack = build_stack(paths=paths, llm=ExtractiveFakeLLM(),
                            embedder=embedder, reranker=reranker,
                            device=dev)
        check(stack.config.retrieval.hybrid and stack.summary_index is None,
              "the stack is not hybrid without a prefilter")
        check((stack.pipeline.n_candidates, stack.pipeline.rerank_top_k)
              == (40, 10), "the pipeline does not rerank 40 to 10")
        questions = [d["question"] for d in dataset[: N_QUESTIONS + 1]]
        times = []
        for i, question in enumerate(questions):
            t0 = time.perf_counter()
            resp = stack.pipeline.query(question)
            torch.cuda.synchronize()
            if i:  # the first query warms up
                times.append(time.perf_counter() - t0)
            check(resp.error is None, resp.error)
            check(resp.sources, f"no sources for {question!r}")
            check(resp.answer.strip(), f"empty answer for {question!r}")
        launches = dict(_kernels.LAUNCHES)
        plain = dict(_kernels.PLAIN_ON_CUDA)
        busy = profile_once(lambda: stack.pipeline.query(questions[1]),
                            "one query", float(np.median(times)))
    check(reranker.calls and all(c.rerank_score is not None
                                 for out in reranker.calls for c in out),
          "a rerank fell back to the incoming order")
    log(f"serve: {N_QUESTIONS} queries after 1 warm-up: p50 "
        f"{np.median(times) * 1e3:.1f} ms, max {max(times) * 1e3:.1f} ms; "
        f"launches {launches}, plain twins on the card {plain}")
    return {"launches": launches, "plain_on_cuda": plain,
            "ingest_chunks_per_s": N_CHUNKS / ingest_s,
            "query_p50_ms": float(np.median(times) * 1e3),
            "query_max_ms": float(max(times) * 1e3),
            "query_device_busy_share": busy}


def profile_once(fn, what: str, unprofiled_s: float,
                 top: int = 8) -> float | None:
    """`fn()` once more under torch.profiler: device time by kernel, and
    the card's busy share, taken of `unprofiled_s` (the same call's time
    without the profiler, which about doubles a train step's wall time).
    User annotations (such as the optimizer's `record_function` range)
    are not kernels and are left out of the sum."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    ranges = {e.key for e in prof.events() if e.is_user_annotation}
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in ranges]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        log("profile: the profiler saw no device time")
        return None
    share = busy_us / (unprofiled_s * 1e6)
    log(f"profile: {what}, wall {wall_us / 1e3:.1f} ms under the "
        f"profiler, device busy {busy_us / 1e3:.1f} ms = {share:.1%} of "
        f"the unprofiled {unprofiled_s * 1e3:.1f} ms")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    gemm_us = sum(e.self_device_time_total for e in ranked
                  if "gemm" in e.key.lower())
    flash_us = sum(e.self_device_time_total for e in ranked
                   if "flash_" in e.key)
    log(f"  GEMMs {gemm_us / 1e3:.1f} ms ({gemm_us / busy_us:.1%}), flash "
        f"kernels {flash_us / 1e3:.1f} ms ({flash_us / busy_us:.1%})")
    for i, e in enumerate(ranked):
        if i < top or "flash_" in e.key:
            log(f"  {e.self_device_time_total / 1e3:8.2f} ms {e.count:5d}x "
                f"{e.key[:90]}")
    return share


def run_train(seed: int, dev) -> dict:
    """Train phase: the full-width BGE-M3 through `train_retriever`, a
    resume from its checkpoint, then timed steps on one repeated batch."""
    import numpy as np
    import torch

    from rag_dpo_tpu_torch.evals.synthetic import build_synthetic_corpus
    from rag_dpo_tpu_torch.evals.train_encoder import (
        build_training_pairs,
        mine_hard_negatives,
    )
    from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.tokenize import HashedTokenizer
    from rag_dpo_tpu_torch.train import TrainConfig, make_train_step
    from rag_dpo_tpu_torch.train.contrastive import contrastive_loss
    from rag_dpo_tpu_torch.train.loop import (
        LoopConfig,
        PairBatcher,
        train_retriever,
    )

    chunks = build_synthetic_corpus(
        json.loads(QA_DATASET.read_text(encoding="utf-8")))
    pairs, groups = build_training_pairs(chunks, return_groups=True)
    negatives = mine_hard_negatives(pairs, groups, chunks)
    cfg = TrainConfig(model=BgeM3Config(encoder=EncoderConfig.bge_m3()),
                      warmup_steps=10)
    check(cfg.model.encoder.use_flash_attention, "flash is off")
    loop = LoopConfig(batch_size=TRAIN_PAIRS, seq_len=TRAIN_SEQ,
                      max_steps=2, checkpoint_every=2, log_every=1,
                      shuffle_seed=seed)
    batcher = PairBatcher(pairs, HashedTokenizer(
        cfg.model.encoder.vocab_size), TRAIN_PAIRS, TRAIN_SEQ, seed,
        negatives=negatives)
    log(f"train: {len(pairs)} pairs, {sum(n is not None for n in negatives)}"
        f" with a mined hard negative; {TRAIN_PAIRS} pairs x {TRAIN_SEQ} "
        "tokens a step, 3 forwards")

    _kernels.reset_counts()
    with tempfile.TemporaryDirectory(prefix="ragdpo_train_") as tmp:
        ckpt_dir = pathlib.Path(tmp) / "ckpt"
        metrics = pathlib.Path(tmp) / "metrics.jsonl"
        t0 = time.perf_counter()
        state = train_retriever(pairs, cfg, dev, ckpt_dir, loop,
                                metrics_path=metrics, negatives=negatives)
        first_s = time.perf_counter() - t0
        check(state.step == 2, f"first run stopped at {state.step}")
        with torch.no_grad():  # what step 3 logs when nothing resumes
            loss3 = float(contrastive_loss(state.model, batcher.batch_at(2),
                                           cfg.temperature)[0])
        del state
        gc.collect()
        t0 = time.perf_counter()
        state = train_retriever(pairs, cfg, dev, ckpt_dir,
                                dataclasses.replace(loop, max_steps=4),
                                metrics_path=metrics, negatives=negatives)
        resume_s = time.perf_counter() - t0
        entries = [json.loads(x) for x in metrics.read_text().splitlines()]
        ckpt_mb = sum(f.stat().st_size for f in ckpt_dir.iterdir()) / 2**20
    check(state.step == 4, f"resumed run stopped at {state.step}")
    check([e["step"] for e in entries] == [1, 2, 3, 4],
          f"logged steps {[e['step'] for e in entries]}")
    check(all(np.isfinite(e["loss"]) for e in entries), entries)
    check(abs(entries[2]["loss"] - loss3) <= 1e-4,
          f"resumed step 3 loss {entries[2]['loss']} vs {loss3}")
    log(f"train_retriever: steps 1-2 + checkpoint {first_s:.1f} s, resume "
        f"+ steps 3-4 {resume_s:.1f} s, checkpoints {ckpt_mb:.0f} MiB; "
        "losses " + ", ".join(f"{e['loss']:.5f}" for e in entries)
        + f"; step 3 without a resume {loss3:.5f}")

    step_fn = make_train_step(cfg, state)
    batch = batcher.batch_at(4)
    real_tokens = sum(int(batch[f"{n}_lengths"].sum())
                      for n in ("query", "passage", "negative"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, _ = step_fn(state, batch)  # warm-up
    torch.cuda.synchronize()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, m = step_fn(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    launches = {n: _kernels.LAUNCHES[n] for n in TRAIN_KERNELS}
    plain = {n: _kernels.PLAIN_ON_CUDA[n] for n in TRAIN_KERNELS}
    check(np.isfinite(losses).all(), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    busy = profile_once(lambda: step_fn(state, batch), "one train step",
                        step_s, top=10)
    padded = 3 * TRAIN_PAIRS * TRAIN_SEQ
    log(f"train: {TIMED_STEPS} steps after 1 warm-up: {step_s * 1e3:.1f} "
        f"ms/step, {TRAIN_PAIRS / step_s:.2f} pairs/s, "
        f"{padded / step_s:.0f} padded tokens/s ({real_tokens} real of "
        f"{padded} a step), peak memory {peak_gb:.2f} GB; losses "
        + ", ".join(f"{x:.5f}" for x in losses)
        + f"; launches {launches}, plain twins on the card {plain}")
    return {"launches": launches, "plain_on_cuda": plain,
            "train_ms_per_step": step_s * 1e3,
            "train_pairs_per_s": TRAIN_PAIRS / step_s,
            "train_padded_tokens_per_s": padded / step_s,
            "train_real_tokens_per_step": real_tokens,
            "train_peak_memory_gb": peak_gb,
            "train_losses": losses,
            "train_device_busy_share": busy}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not (ROOT / "rag_dpo_tpu_torch" / "csrc").is_dir() \
            or not QA_DATASET.is_file():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    log(smi.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    from rag_dpo_tpu_torch.ops import _kernels

    build_s = _kernels.build_all()
    log(f"build: {build_s:.2f} s for {', '.join(_kernels.KERNELS)}; nvcc "
        + (", ".join(f"{src} {s:.2f} s" for src, s in
                     _kernels.BUILD_SECONDS.items())
           or "not run (libraries already built)"))
    for name, text in _kernels.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    flash = check_flash(dev, gen)
    ell = check_ell(dev, gen)

    path = run_path(args.seed, dev)
    for name in SERVE_KERNELS:
        check(path["launches"][name] > 0, f"{name} never launched")
        check(path["plain_on_cuda"][name] == 0, f"{name} ran plain")
    gc.collect()  # the serve phase's models
    torch.cuda.empty_cache()

    flash_bwd = check_flash_bwd(dev, gen)
    gc.collect()
    torch.cuda.empty_cache()
    train = run_train(args.seed, dev)
    for name in TRAIN_KERNELS:
        check(train["launches"][name] > 0, f"{name} never launched")
        check(train["plain_on_cuda"][name] == 0, f"{name} ran plain")

    bwd_src = "rag_dpo_tpu_torch/csrc/flash_bwd.cu"
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "rag_dpo_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "rag_dpo_tpu/ops/flash_attention_bwd.py:33",
         "launches": train["launches"]["flash_fwd"],
         "serve_launches": path["launches"]["flash_fwd"],
         **flash},
        {"name": "ell_topk", "route": "cuda",
         "source": "rag_dpo_tpu_torch/csrc/ell_topk.cu",
         "replaces": "rag_dpo_tpu/ops/sparse.py:71",
         "launches": path["launches"]["ell_topk"],
         **ell},
        {"name": "flash_bwd_dq", "route": "cuda", "source": bwd_src,
         "replaces": "rag_dpo_tpu/ops/flash_attention_bwd.py:81",
         "launches": train["launches"]["flash_bwd_dq"],
         **flash_bwd["flash_bwd_dq"]},
        {"name": "flash_bwd_dkv", "route": "cuda", "source": bwd_src,
         "replaces": "rag_dpo_tpu/ops/flash_attention_bwd.py:123",
         "launches": train["launches"]["flash_bwd_dkv"],
         **flash_bwd["flash_bwd_dkv"]},
    ]
    log(json.dumps({"kernels": kernels, "build_s": build_s,
                    "ingest_chunks_per_s": path["ingest_chunks_per_s"],
                    "query_p50_ms": path["query_p50_ms"],
                    "query_max_ms": path["query_max_ms"],
                    "query_device_busy_share":
                        path["query_device_busy_share"],
                    **{k: v for k, v in train.items()
                       if k.startswith("train_")}}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
