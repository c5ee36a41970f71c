#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`rag_dpo_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero before the result lines:

1. device — needs `torch.cuda.is_available()`; prints the card's name and
   power limit as `nvidia-smi` reports them;
2. build — compiles the CUDA kernels in `rag_dpo_tpu_torch/csrc/` with nvcc
   for sm_90a (seconds printed);
3. kernels — each kernel against its plain PyTorch twin on the same CUDA
   tensors, at the shapes the query path gives it, timed with CUDA events;
4. ingest — 16,919 chunk texts over 1,829 doc keys, made from `--seed` by
   recombining sentences of the synthetic corpus, encoded by a full-width
   BGE-M3 (24 layers, 1024 hidden, random weights) through the port's
   `CorpusIndexer`, then saved as an index checkpoint;
5. serve — `build_stack` reloads the checkpoint and answers 8 questions of
   the QA dataset through `pipeline.query` with a full-width cross-encoder
   reranking 40 candidates to 10; the kernels' launch counters must rise
   and no plain twin may run on the card.

The second-to-last line is a JSON object with each kernel's launches in
the serve phase, its max abs error against the twin and both times; the
last line is `{"ok": true, "device": {...}}`. There is no CPU path.
"""

from __future__ import annotations

import argparse
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
    # buckets, the rerank/ingest batch, a ragged batch with an empty row
    cases = [(4, 16, s, 64, torch.float32, None)
             for s in (32, 64, 128, 256, 512)]
    cases.append((64, 16, 512, 64, torch.float32, None))
    cases.append((8, 16, 300, 64, torch.float32,
                  [300, 0, 1, 17, 64, 65, 299, 128]))
    cases.append((4, 16, 256, 64, torch.bfloat16, [256, 100, 0, 3]))
    worst, main = 0.0, None
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
        if (b, s) == (64, 512):
            main = (ms, plain_ms,
                    device_ms(lambda: flash_attention(q, k, v, lengths)),
                    device_ms(lambda: flash_attention_plain(q, k, v,
                                                            lengths)))
            log(f"  device only: kernel {main[2]:.4f} ms, plain "
                f"{main[3]:.4f} ms")
    return {"max_abs_err": worst, "ms": main[0], "plain_ms": main[1],
            "device_ms": main[2], "plain_device_ms": main[3],
            "shape": "[64,16,512,64] f32"}


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
        busy = profile_query(stack.pipeline, questions[1])
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


def profile_query(pipeline, question: str) -> float | None:
    """One more query under torch.profiler: device time by kernel, and the
    share of the query's wall time the card was busy (the profiler's own
    overhead lengthens this query's wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipeline.query(question)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        log("profile: the profiler saw no device time")
        return None
    log(f"profile: one query, wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({busy_us / wall_us:.1%})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:8.2f} ms {e.count:5d}x "
            f"{e.key[:90]}")
    return busy_us / wall_us


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
    log(f"build: {build_s:.2f} s for {', '.join(_kernels.KERNELS)}")
    for name, text in _kernels.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    flash = check_flash(dev, gen)
    ell = check_ell(dev, gen)

    path = run_path(args.seed, dev)
    for name in _kernels.KERNELS:
        check(path["launches"][name] > 0, f"{name} never launched")
        check(path["plain_on_cuda"][name] == 0, f"{name} ran plain")

    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "rag_dpo_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "rag_dpo_tpu/ops/flash_attention_bwd.py:33",
         "launches": path["launches"]["flash_fwd"],
         **flash},
        {"name": "ell_topk", "route": "cuda",
         "source": "rag_dpo_tpu_torch/csrc/ell_topk.cu",
         "replaces": "rag_dpo_tpu/ops/sparse.py:71",
         "launches": path["launches"]["ell_topk"],
         **ell},
    ]
    log(json.dumps({"kernels": kernels, "build_s": build_s,
                    "ingest_chunks_per_s": path["ingest_chunks_per_s"],
                    "query_p50_ms": path["query_p50_ms"],
                    "query_max_ms": path["query_max_ms"],
                    "query_device_busy_share":
                        path["query_device_busy_share"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
