#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`rag_dpo_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero before the result lines:

1. device — needs `torch.cuda.is_available()`; prints the card's name and
   power limit as `nvidia-smi` reports them;
2. build — compiles the CUDA kernels in `rag_dpo_tpu_torch/csrc/` with nvcc
   for sm_90a, one nvcc per source, all started together (seconds
   printed);
3. kernels — each kernel against its plain PyTorch twin on the same CUDA
   tensors, at the shapes the query path gives it (the flash forward at
   the training shape too, f32 and bf16, the same bits twice, and at head
   widths 8 ... 320 and S of 1, 63, 65 and 513; ELL at the hermetic
   replay's shape too, timed there (one launch) beside an empty kernel's
   launch-to-launch time, the practical floor of a launch;
   MaxSim at the rerank's full width and the replay's (the wrapper's host
   time too), at D 16,384 and with masks that are no prefix; the fused dense
   top-k at the serve shape, the replay's and over 1M rows, the pooled int8
   sweep over 1M rows, at batches 1, 64 and 256), the per-segment
   candidates (K5)
   through their own path, `ops.fused_candidates_topk` at
   bench_fused_cand.py's recipe over 1M bf16 rows at batches 1, 64 and
   256 (per_seg 2, and 1 at 64), held to the twin, to the same bits twice
   and by recall@40 against K4 (≥ 0.99 at per_seg 2); K4 and K5 each get
   one line a shape with their ratio to `torch.topk(addmm)` and their
   share of the bound; then the shapes past the kernels' former limits
   (ROADMAP C-17: K4 and K5 at Q 7 and 300, D 1000 and 1536, k 512 and
   1024, bf16 and f32; K6 at D 1536; K3 with 100 query terms and at k
   2048; C-19: K5 at seg 8, 80, 1000 and 1024), each held
   to its twin; the int8 sweep floor (K10 and K11) first through its own
   path, `evals/bench_int8_matmul.run` at
   benchmarks/bench_pallas_int8_matmul.py's recipe (1,000,000 × 1024
   uniform int8 rows, Q 64, 2048-row blocks), then at Q 64, 1 and 256 bit
   for bit against its twin, the same bits twice, beside the library strip
   (`torch._int_mm` + strided `amax`), and with K6 at Q 64 on the scale
   rows; then flash attention's dq and dk/dv kernels at the
   training shape and others (Dh 80 and 320 too); timed with CUDA events
   and the profiler, beside each kernel's bound and, where one PyTorch
   call computes the same function, that call's time and device time;
3b. store limits — a 50,000-row index at dim 1536, bf16 and int8, through
   `search_dense(k=512)` and `search_sparse` with 100 terms: K4 (bf16)
   and K3 must launch and no twin may run; the int8 ids must be the CPU
   store's;
4. scale — bench.py's 1M-chunk recipe made from `--seed` on the card:
   1,000,000 unit rows of 1024 dims, ELL width 24 over 50,000 terms,
   `IndexConfig(quantize_int8=True, postings_cap=256,
   postings_candidates=64)`, built with `DeviceIndex.add`, saved to
   `TMPDIR` and reloaded; `search_dense(k=40)` (int8 × int8 by
   `torch._int_mm`, the best 160 re-scored on the host, as the JAX store
   ranks) + `search_sparse(k=40)` (the postings engine) + `rrf_fuse` to 10
   at batches 1, 64 and 256; dense recall@10 of the head of the int8
   top-40 against an exact f32 index over the same rows (K4) must be ≥
   0.99; K6's own path, `ops.pooled.pooled_topk_int8`, runs once on the
   same image at batch 256 with the counts from 0, its recall@10
   recorded; postings recall@40 against K3 over the same ELL image is
   printed; then
   the same checkpoint loaded again with `device_refine` (the on-card
   int8 × int8 search of `ops.quantize`): `search_dense(k=40)` at the
   same batches with `sweep_block_rows` 0 and 131,072, its dense recall@10
   (recorded), peak device memory ≤ 40 GB, no twin; its ids at batch 64
   on 50,000 of the rows must equal the CPU's;
5. ingest — 16,919 chunk texts over 1,829 doc keys, made from `--seed` by
   recombining sentences of the synthetic corpus, encoded by a full-width
   BGE-M3 (24 layers, 1024 hidden, random weights) through the port's
   `CorpusIndexer` with ColBERT storage (Dc 1024, `colbert_len` the
   power-of-two bucket of the longest chunk), then saved as an index
   checkpoint;
5b. ingest pipeline (run after phase 7, with phase 5's embedder once its
   index is freed) — the same 16,919 chunks written as 1,829 French pages
   (`evals/fake_site.py`: chunk i on page i % 1,829, one `<h2>` and `<p>`
   a chunk) on a loopback site whose site map links them all; the port's
   `Scraper` crawls it with its own `default_fetch`, then
   `IngestPipeline(...).run()` runs the nine steps (filter ... tag) with
   the fake LLM and the full-width BGE-M3 on the card: the reports must
   list `STEP_ORDER`, index every chunk the chunker made, pass the
   self-retrieval check, take the C++ runtime for BM25 (its calls
   counted), launch K1 and K4 and run no twin; the native BM25 build is
   timed beside the Python path on the same texts (the same impacts within
   1e-6 relative, the same terms above each row's cut); then an
   `IncrementalUpdater` pass in which 8 pages changed (a later date, new
   text, 3 sections fewer or 2 more) and the rest answer 304: every new
   chunk must retrieve itself top-1 and the live rows must be the old
   ones less the purged stale rows plus the new ones;
6. serve — `build_stack` reloads the checkpoint and answers 8 questions of
   the QA dataset through `pipeline.query` with a full-width cross-encoder
   reranking 40 candidates to 10; the kernels' launch counters must rise
   and no plain twin may run on the card; the flash forward and SDPA are
   then timed at the attention shapes these queries called most (the
   query encode at batch 1, the cross-encoder's batch);
6b. serve, agent — the shipped default config (`load_config()` with only
   `llm.base_url` set: `llm.mode="local"`, the agent on) through
   `build_stack`, with the serve phase's loaded index and full-width
   encoders injected, against a loopback Ollama-protocol endpoint in this
   process that answers as the fake LLM (`evals/fake_ollama.py`):
   `stack.active()` must be the agent graph, which answers the 8 questions
   after 1 warm-up (p50, max, one question's node trace); K1, K3 and K4
   must launch and no plain twin may run;
6c. serve, concurrent — `DeviceIndex.warm((1, 64, 256))`, timed; then 16
   threads each ask the 8 questions through the default config's agent,
   with batching off, then with `embedding.query_batch` and
   `retrieval.rerank_batch` at 64 (queries/s, p50, max, the batchers'
   stats): every coalesced query vector must lie within 1e-5 of its
   direct one, query encodes must coalesce (mean batch > 1), every
   question's fused ids must equal the run without batching, no batch may
   fail (an error in a batcher's thread reaches its callers and fails the
   phase), no rerank may fall back, K1, K3 and K4 must launch and no twin
   may run;
7. serve, MaxSim — `create_pipeline(use_maxsim=True)` over the same loaded
   index answers 8 questions, reranking 40 candidates to 10 by MaxSim over
   the stored ColBERT rows; K7 must launch and no twin may run;
8. hermetic — the port's hermetic replay with the committed trained
   encoder must pass the gate against the committed trained records; then
   its MaxSim arm, where K3, K4 and K7 must launch and no twin may run. (The
   random-init record needs Flax's initialisation, which only jax makes:
   it is gated by a CPU test.)
9. train — contrastive training of a full-width BGE-M3 (f32, flash on) on
   16 pairs x 192 tokens with one mined hard negative each, through
   `train_retriever`: 2 steps and a checkpoint, then a resume to step 4;
   then 1 warm-up and 8 timed steps on one repeated batch, whose losses
   must be finite and fall. The flash forward and both backward kernels
   must launch, and no plain twin may run on the card.

The second-to-last line is a JSON object with each kernel's launches in
the phase of the main path that runs it (serve for the ELL kernel, MaxSim
serve for K7, train for the flash kernels, scale for K4, and for K5, K6,
K10 and K11 their own paths: no store path calls them, as in the JAX
package; K1, K3 and K4 also with the agent's and the concurrent phase's
counts, and with the ingest pipeline's and its update's), its max abs
error against the twin, its times, its bound
and the library call's time; the last line is `{"ok": true, "device":
{...}}`. There is no CPU path.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import pathlib
import re
import resource
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
QA_DATASET = ROOT / "rag_dpo_tpu" / "evals" / "data" / "qa_dataset.json"
N_CHUNKS, N_DOCS, N_QUESTIONS = 16_919, 1_829, 8
# f32 flash forward: the kernel streams key tiles with an online softmax,
# its products on the tensor cores as 3xTF32 (~2^-21 a product), and sums
# in another order than the twin's single block: they agree within 1e-5 on
# unit Gaussian inputs, where one TF32 product (~1e-3) would not. bf16
# rounds the output.
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the backward kernels: f32 as 3xTF32 on the tensor cores (~2^-21 a
# product) in tiles of 8 to 64 rows against the twins' single block; one
# TF32 product would err ~1e-3 (tests/test_torch_flash_bwd_tf32.py)
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# K7: the kernel's products keep f32 accuracy on the TF32 tensor cores (the
# query split in two, f32 rows 3xTF32: ~2^-21 a product) and sum in mma
# order, the twin in cuBLAS's, both in f32; maxima are exact, so scores
# agree to f32 rounding; one TF32 product would err about the whole of
# this tolerance (tests/test_torch_maxsim_tf32.py)
MAXSIM_TOL = dict(rtol=1e-5, atol=1e-4)
SERVE_KERNELS = ("flash_fwd", "ell_topk", "fused_topk")
MAXSIM_KERNELS = ("flash_fwd", "ell_topk", "fused_topk", "maxsim")
# the scale phase's: K4 (the recall gate's f32 oracle); its int8 arm's
# product is `torch._int_mm`, as JAX leaves it to XLA, and its sparse arm
# the postings engine (plain)
SCALE_KERNELS = ("fused_topk",)
# bench.py:44-58: the 1M-chunk index and its queries
SCALE_N, SCALE_DIM, SCALE_ELL, SCALE_VOCAB, SCALE_TERMS = (
    1_000_000, 1024, 24, 50_000, 16)
SCALE_BATCHES = (1, 64, 256)
SCALE_MIN_RECALL = 0.99
# bench_fused_cand.py:62-65: K5's recipe (and per_seg 2 or 1) over such rows
CAND_RECIPE, CAND_K = {"block_n": 2048, "seg": 128}, 40
# K4 and K6 sum each dot on the tensor cores in their order, their twins in
# cuBLAS's, both in f32 (every product exact): scores agree within 1e-5,
# and ids but where two rows (K6: the two best of a group) lie within 1e-5
# of each other
NEAR_TIE = 1e-5
# phase 6c: the concurrent serve's threads, the batchers' max_batch, and
# how far a coalesced query vector may lie from its direct one (the
# coalesced GEMMs have other shapes; tests/test_torch_serving.py)
CONCURRENT_THREADS, CONCURRENT_BATCH, COALESCED_TOL = 16, 64, 1e-5
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
TRAIN_PAIRS, TRAIN_SEQ, TIMED_STEPS = 16, 192, 8
# H100 SXM data sheet, at 700 W: f32 FLOP/s outside the tensor cores, the
# TF32 tensor cores' dense rate (f32 attention at f32 accuracy takes three
# TF32 products, 3xTF32, as the bound's basis), the bf16 tensor cores' rate
# (the peak for bf16 inputs; bf16 × bf16 and bf16 × int8 products are
# exact in f32), the int8 tensor cores' rate, and HBM3 bytes/s
F32_FLOPS, TF32_FLOPS, BF16_FLOPS, INT8_OPS, HBM_BYTES_PER_S = (
    67e12, 495e12, 989e12, 1979e12, 3.35e12)
# the store's device_refine at scale: sweep_block_rows 0 (one sweep, or
# blocks past the 512 Mi score budget) and forced 131,072-row blocks; the
# ids are held to the CPU's on a slice of the rows, with blocks small enough
# to scan there
REFINE_BLOCKS, REFINE_SLICE, REFINE_SLICE_BLOCK = (0, 131_072), 50_000, 16_384
# the special-function units: 16 exponentials a clock on each SM (Hopper's
# SFU rate), at the card's maximum SM clock (`sm_clock_hz`)
SFU_PER_CLOCK, H100_SMS = 16, 132


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


def device_events(fn, iters: int) -> list:
    """The device events (kernels, copies, fills) of `iters` calls of `fn`
    under torch.profiler, user annotations left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ranges = {e.key for e in prof.events() if e.is_user_annotation}
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in ranges]


def device_ms(fn, iters: int = 10, launches: int | None = None
              ) -> float | None:
    """Device time per call: the kernels' own time as torch.profiler sees
    it, without the host-side gaps that CUDA events around a loop keep.
    One profiled call gives each device event's count per call (which must
    be `launches` in all, where the caller knows it); a window of `iters`
    calls that does not hold `iters` times each count lost events, and
    then the time is None (not measured)."""
    fn()
    once = {e.key: e.count for e in device_events(fn, 1)}
    if not once or (launches is not None
                    and sum(once.values()) != launches):
        return None
    events = device_events(fn, iters)
    if {e.key: e.count for e in events} != {k: iters * n
                                            for k, n in once.items()}:
        return None
    return sum(e.self_device_time_total for e in events) / iters / 1e3


def device_ms_tries(fn, tries: int = 3) -> float | None:
    """`device_ms`, taken again where a window lost events (after the serve
    phases the profiler sometimes does); None if every try lost some."""
    for _ in range(tries):
        got = device_ms(fn)
        if got is not None:
            return got
    return None


def fmt_ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The card's maximum SM clock as nvidia-smi reads it; an H100 SXM's
    1,980 MHz where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True).stdout.split()
    except FileNotFoundError:
        return 1.98e9
    return float(out[0]) * 1e6 if out and out[0].isdigit() else 1.98e9


def bound(flops: float, nbytes: float, flops_rate: float = F32_FLOPS,
          exps: float = 0.0) -> dict:
    """The least time the card could take for the work: the largest of the
    operations over the peak for their type (f32 unless given), the
    exponentials over the special-function units' rate, and the bytes
    (each input read once, each output written once) over the memory
    rate."""
    ops_ms = flops / flops_rate * 1e3
    exp_ms = exps / (SFU_PER_CLOCK * H100_SMS * sm_clock_hz()) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"bound_ms": max(ops_ms, exp_ms, bytes_ms),
           "bound_by": ("bytes" if bytes_ms > max(ops_ms, exp_ms)
                        else "operations")}
    if exps:
        out["bound_terms_ms"] = {"products": ops_ms, "exp": exp_ms,
                                 "bytes": bytes_ms}
    return out


def attention_rate(q) -> tuple:
    """(operations per flop, peak) of attention's products for q's type on
    the tensor cores: f32 at f32 accuracy is three TF32 products (3xTF32,
    as K1 runs it), bf16 one bf16 product."""
    import torch

    return (3.0, TF32_FLOPS) if q.dtype == torch.float32 else (1.0,
                                                               BF16_FLOPS)


def valid_kv_bytes(q, lengths) -> float:
    """The bytes of k and v over each batch row's valid keys: those past
    its length are never needed."""
    _, h, s, dh = q.shape
    return 2.0 * h * dh * float(lengths.clamp(0, s).sum()) * q.element_size()


def flash_fwd_bound(q, lengths) -> dict:
    """A forward without lse: q·kᵀ and p·v for every query row against the
    valid keys, one exponential a valid score; q read, k and v read over
    the valid keys, out written."""
    _, h, s, dh = q.shape
    scores = h * s * float(lengths.clamp(0, s).sum())
    per_flop, rate = attention_rate(q)
    return bound(per_flop * 4.0 * dh * scores,
                 2.0 * q.numel() * q.element_size()
                 + valid_kv_bytes(q, lengths), rate, exps=scores)


def flash_bwd_bounds(q, lengths) -> dict:
    """dq recomputes s and dp and forms dq (3 products), dk/dv recomputes
    s and dp and forms dv and dk (4), each over valid query rows × valid
    keys, each with one exponential a pair (P again); both read q, dO,
    lse and D over the valid query rows and k and v over the valid keys
    (nothing past a row's length is needed), and write all of dq, or of
    dk and dv."""
    _, h, s, dh = q.shape
    pairs = h * float((lengths.clamp(0, s).double() ** 2).sum())
    rows = h * float(lengths.clamp(0, s).sum())
    t = q.numel() * q.element_size()
    reads = rows * (4 * dh * q.element_size() + 2 * 4)
    per_flop, rate = attention_rate(q)
    return {"flash_bwd_dq": bound(per_flop * 6.0 * dh * pairs,
                                  reads + t, rate, exps=pairs),
            "flash_bwd_dkv": bound(per_flop * 8.0 * dh * pairs,
                                   reads + 2 * t, rate, exps=pairs)}


def key_mask(q, lengths):
    import torch

    s = q.shape[2]
    return (torch.arange(s, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]


def library_times(fn) -> dict:
    """A library call's CUDA-event time, its device time and the name of
    its longest device kernel (what PyTorch dispatched it to)."""
    ms = cuda_ms(fn)
    fn()
    events = device_events(fn, 1)
    top = max(events, key=lambda e: e.self_device_time_total, default=None)
    return {"library_ms": ms, "library_device_ms": device_ms_tries(fn),
            "library_kernel": None if top is None else top.key}


def sdpa_times(q, k, v, lengths) -> dict:
    """`scaled_dot_product_attention` with a boolean key-length mask on the
    same inputs: the yardstick for K1. The port never calls it."""
    import torch.nn.functional as F

    mask = key_mask(q, lengths)
    return library_times(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask))


def sdpa_bwd_times(q, k, v, lengths, g) -> dict:
    """The backward of that call (dq, dk and dv together): the yardstick
    for K8 + K9."""
    import torch
    import torch.nn.functional as F

    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg,
                                         attn_mask=key_mask(q, lengths))
    return library_times(lambda: torch.autograd.grad(
        out, (qg, kg, vg), g, retain_graph=True))


# ------------------------------------------------------------ kernels
def flash_inputs(dev, gen, b, h, s, dh, dtype, lens=None) -> tuple:
    """Unit Gaussian q, k, v and lengths (random in 1 … S with the first S,
    as a batch of pairs gives them, where `lens` is None)."""
    import torch

    q, k, v = (torch.randn((b, h, s, dh), generator=gen, device=dev)
               .to(dtype) for _ in range(3))
    if lens is None:
        lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                                dtype=torch.int32)
        lengths[0] = s
    else:
        lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, lengths


def time_flash(q, k, v, lengths, key: str) -> dict:
    """K1 at one shape: its CUDA-event and device times, its twin's, SDPA's
    with the same key mask, and the bound; keys prefixed by `key`."""
    from rag_dpo_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    b, h, s, dh = q.shape
    got = {"ms": cuda_ms(lambda: flash_attention(q, k, v, lengths)),
           "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v,
                                                             lengths)),
           "device_ms": device_ms_tries(lambda: flash_attention(q, k, v,
                                                               lengths)),
           "plain_device_ms": device_ms_tries(lambda: flash_attention_plain(
               q, k, v, lengths)),
           **sdpa_times(q, k, v, lengths), **flash_fwd_bound(q, lengths),
           "shape": f"[{b},{h},{s},{dh}] {str(q.dtype)[6:]}"}
    log(f"  {got['shape']}: kernel {got['ms']:.4f} ms (device "
        f"{fmt_ms(got['device_ms'])}), plain {got['plain_ms']:.4f} ms "
        f"(device {fmt_ms(got['plain_device_ms'])}); sdpa with a key mask "
        f"{got['library_ms']:.4f} ms (device "
        f"{fmt_ms(got['library_device_ms'])}, {got['library_kernel']}); "
        f"bound {got['bound_ms']:.4f} ms ({got['bound_by']})")
    return {f"{key}{n}": x for n, x in got.items()}


def check_flash(dev, gen) -> dict:
    import ctypes

    import torch

    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    f32, bf16 = torch.float32, torch.bfloat16
    # (batch, heads, seq, head_dim, dtype, lengths, timing key): the
    # query-encode buckets, the ingest batch, a ragged batch with an empty
    # row, bf16, and the training shape (random ragged lengths, as a batch
    # of pairs gives them), each timed shape in f32 and bf16; then head
    # widths other than 16/32/64/128 (C-20) and S off the 64-row tiles
    cases = [(4, 16, s, 64, f32, None, None) for s in (32, 64, 128, 256,
                                                       512)]
    cases += [(64, 16, 512, 64, f32, None, "ingest_"),
              (8, 16, 300, 64, f32, [300, 0, 1, 17, 64, 65, 299, 128], None),
              (4, 16, 256, 64, bf16, [256, 100, 0, 3], None),
              (TRAIN_PAIRS, 16, TRAIN_SEQ, 64, f32, None, ""),
              (TRAIN_PAIRS, 16, TRAIN_SEQ, 64, bf16, None, "bf16_"),
              (64, 16, 512, 64, bf16, None, "bf16_ingest_")]
    cases += [(3, 4, 65, dh, f32, [65, 0, 1], None)
              for dh in (8, 40, 80, 96, 200, 256, 320)]
    cases += [(3, 4, 65, 80, bf16, [65, 0, 1], None)]
    cases += [(2, 4, s, dh, f32, [s, 1], None) for s in (1, 63, 65, 513)
              for dh in (64, 80)]
    worst, timed = 0.0, {}
    for b, h, s, dh, dtype, lens, key in cases:
        q, k, v, lengths = flash_inputs(dev, gen, b, h, s, dh, dtype, lens)
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
            z = lens.index(0)
            check(bool((out[z] == 0).all()) and bool((lse[z] == -1e20).all()),
                  "a row with no keys is not 0 with lse -1e20")
        again = flash_attention(q, k, v, lengths, return_lse=True)
        check(torch.equal(again[0], out) and torch.equal(again[1], lse),
              f"flash_fwd gave other bits the second time at {q.shape}")
        log(f"flash_fwd [{b},{h},{s},{dh}] {str(dtype)[6:]} "
            f"max_abs_err={err:.3g} lse_err={lse_err:.3g}")
        if dtype == f32:
            worst = max(worst, err)
        if key is not None:
            timed.update({f"{key}max_abs_err": err,
                          f"{key}lse_max_abs_err": lse_err,
                          **time_flash(q, k, v, lengths, key)})
    lib = _kernels.load("flash_fwd")
    lib.flash_fwd_smem.restype = ctypes.c_longlong
    lib.flash_fwd_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem = {"f32": lib.flash_fwd_smem(0, 64), "bf16": lib.flash_fwd_smem(1,
                                                                         64)}
    log(f"flash_fwd shared memory a block at Dh 64: {smem}")
    # the unprefixed numbers are the training shape's, where the main
    # path's launches are counted; ingest_ and bf16_ keys hold the others
    return {**timed, "all_f32_cases_max_abs_err": worst,
            "smem_bytes_dh64": smem}


def time_serve_flash(dev, gen, shapes: dict) -> dict:
    """K1 and SDPA at the serve phase's own shapes: of the smallest batch
    (the query encode, its variants padded to a batch bucket) and of the
    largest (the cross-encoder over 40 candidates, padded likewise) the
    shape called most in one query, with its first call's lengths. After the serve phase the
    profiler may lose events: device times there can read not measured."""
    import torch

    out = {}
    batches = sorted({shape[0] for shape in shapes})
    for key, batch in (("serve_query_", batches[0]),
                       ("serve_rerank_", batches[-1])):
        shape, (count, lengths) = max(
            ((sh, v) for sh, v in shapes.items() if sh[0] == batch),
            key=lambda item: item[1][0])
        b, h, s, dh = shape
        q, k, v, _ = flash_inputs(dev, gen, b, h, s, dh, torch.float32)
        log(f"flash_fwd at the serve phase's shape {list(shape)} ({count} "
            f"calls a query), lengths {lengths.tolist()}")
        out.update({f"{key}calls": count,
                    **time_flash(q, k, v, lengths.to(dev), key)})
    return out


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
    # two launches: the block sort and the merge
    dms = device_ms(lambda: ell_topk(terms, imps, qt, qw, k=40), launches=2)
    plain_dms = device_ms(lambda: ell_topk_plain(terms, imps, qt, qw, 40))
    passes = {e.key: e.self_device_time_total / 20 / 1e3 for e in
              device_events(lambda: ell_topk(terms, imps, qt, qw, k=40), 20)}
    log(f"ell_topk [{n_pad}x{width}] Q=4 T=32 k=40 ids exact "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} (device only: "
        f"kernel {fmt_ms(dms)}, plain {fmt_ms(plain_dms)}); by pass: "
        + ", ".join(f"{kernel_name(k)} {v:.5f} ms" for k, v in passes.items()))

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

    # the hermetic replay's shape: 212 chunks padded to one 1,024-row
    # block, ELL width 48, one query of up to 32 terms
    h_vocab = 1_500
    hz = 1.0 / torch.arange(1, h_vocab + 1, device=dev, dtype=torch.float32)
    th = torch.full((1024, 48), -1, dtype=torch.int32, device=dev)
    th[:212] = torch.multinomial(hz.expand(212, h_vocab), 48,
                                 replacement=False,
                                 generator=gen).to(torch.int32)
    used = torch.randint(1, 49, (212, 1), generator=gen, device=dev)
    th[:212] = torch.where(torch.arange(48, device=dev)[None, :] < used,
                           th[:212], -1)
    ih = torch.where(th >= 0, torch.rand((1024, 48), generator=gen,
                                         device=dev) * 2.4 + 0.1, 0.0)
    qh = torch.multinomial(hz[None], 32, replacement=False,
                           generator=gen).to(torch.int32)
    qh[:, 14:] = -2
    wh = torch.where(qh >= 0, torch.rand((1, 32), generator=gen,
                                        device=dev) * 5.0, 0.0)
    compare(th, ih, qh, wh, 40, "hermetic shape")
    h = {"ms": cuda_ms(lambda: ell_topk(th, ih, qh, wh, k=40), iters=200),
         "plain_ms": cuda_ms(lambda: ell_topk_plain(th, ih, qh, wh, 40)),
         # one launch: a single block needs no merge pass
         "device_ms": device_ms(lambda: ell_topk(th, ih, qh, wh, k=40),
                                launches=1),
         **ell_bound(th, qh, 40)}
    log(f"ell_topk hermetic shape [1024x48] (212 live rows) Q=1 T=32 k=40: "
        f"ids exact; kernel_ms={h['ms']:.4f} (device {fmt_ms(h['device_ms'])})"
        f" plain_ms={h['plain_ms']:.4f}; bound {h['bound_ms']:.6f} ms "
        f"({h['bound_by']})")
    bnd = ell_bound(terms, qt, 40)
    floor = launch_floor(dev)
    log(f"  serve shape bound {bnd['bound_ms']:.5f} ms ({bnd['bound_by']}); "
        f"an empty kernel's launch-to-launch time {floor['c_loop_ms']:.5f} "
        f"ms from C, {floor['ctypes_ms']:.5f} ms through ctypes (the "
        f"practical floor of a launch)")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dms, "plain_device_ms": plain_dms, **bnd,
            "library_ms": None, "shape": f"[{n_pad}x{width}] Q=4 T=32 k=40",
            "device_ms_by_pass": {kernel_name(k): v
                                  for k, v in passes.items()},
            **{f"hermetic_{k}": v for k, v in h.items()},
            "hermetic_shape": "[1024x48] (212 live rows) Q=1 T=32 k=40",
            "launch_floor": floor}


def ell_bound(terms, qt, k: int) -> dict:
    """K3: the slots' terms and impacts read once, the query terms and
    weights, the [Q, k] scores and ids written once; a multiply-add per
    (query, row, term)."""
    nbytes = 8.0 * (terms.numel() + qt.numel() + qt.shape[0] * k)
    return bound(2.0 * qt.numel() * terms.shape[0], nbytes)


def launch_floor(dev) -> dict:
    """An empty kernel's launch-to-launch time on the card (the library
    of csrc/ell_topk.cu holds one): 2,000 launches from a C loop, and one
    launch a call through ctypes as the wrappers make them, each by CUDA
    events."""
    import ctypes

    import torch

    from rag_dpo_tpu_torch.ops import _kernels

    lib = _kernels.load("ell_topk")
    lib.empty_launches.restype = ctypes.c_int
    lib.empty_launches.argtypes = [ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.empty_launches(10, stream) == 0, "empty kernel launch")
    c_ms = cuda_ms(lambda: lib.empty_launches(2000, stream), iters=3) / 2000
    py_ms = cuda_ms(lambda: lib.empty_launches(1, stream), iters=2000)
    return {"c_loop_ms": c_ms, "ctypes_ms": py_ms}


def maxsim_bound(qv, q_mask, dv, d_mask) -> dict:
    """2·D flops for every (valid query token, valid doc token) pair: every
    query meets every candidate, so Σ_(q,c) nq_q·nd_c = Σ nq_q · Σ nd_c.
    K7 runs them on the TF32 tensor cores at f32 accuracy: two TF32
    products a flop for f16 / bf16 rows (the query split in two, the rows
    exact in TF32), three for f32 rows (3xTF32). Bytes: the valid query and
    doc rows and both masks read once (masked rows are never read, nor
    needed), the scores written once."""
    import torch

    d = qv.shape[2]
    nq, nd = float(q_mask.sum()), float(d_mask.sum())
    products = 3.0 if dv.dtype == torch.float32 else 2.0
    flops = products * 2.0 * d * nq * nd
    nbytes = (nq * d * qv.element_size() + nd * d * dv.element_size()
              + q_mask.numel() + d_mask.numel()
              + 4 * qv.shape[0] * dv.shape[0])
    return {**bound(flops, nbytes, TF32_FLOPS),
            "bound_terms_ms": {"products": flops / TF32_FLOPS * 1e3,
                               "bytes": nbytes / HBM_BYTES_PER_S * 1e3}}


def check_maxsim(dev, gen, colbert_len: int) -> dict:
    import ctypes

    import torch

    from rag_dpo_tpu_torch.evals.turns import host_us
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.maxsim import maxsim, maxsim_plain, maxsim_plan

    lib = _kernels.load("maxsim")
    lib.maxsim_launches.restype = ctypes.c_int
    launches = lib.maxsim_launches()  # kernels a call: 1

    def unit(x):  # the ColBERT head's vectors are unit length
        return x / x.norm(dim=-1, keepdim=True)

    # (label, Q, LQ, C, LD, D, dv dtype, masks): the rerank of 40
    # candidates at full width (a question of 32 tokens, all valid, against
    # stored rows valid up to each chunk's length), the hermetic replay's,
    # and edge cases: masked query tokens, a query with none, a candidate
    # with no valid token, odd sizes, Q > 1, f32 and bf16 rows; D 16,384,
    # which K7 refused before it streamed D (C-22); valid rows that are no
    # prefix, none in a candidate's first 64-row blocks
    cases = [("rerank", 1, 32, 40, colbert_len, 1024, torch.float16,
              "prefix"),
             ("hermetic", 1, 27, 40, 96, 32, torch.float16, "prefix"),
             ("edges", 3, 13, 37, 50, 96, torch.float32, "edges"),
             ("edges", 2, 40, 41, colbert_len, 1024, torch.bfloat16,
              "edges"),
             ("D 16,384", 1, 4, 3, 8, 16_384, torch.float16, "edges"),
             ("no prefix", 2, 32, 40, colbert_len, 1024, torch.float16,
              "scattered")]
    out = {}
    for label, q, lq, c, ld, d, dtype, masks in cases:
        qv = unit(torch.randn((q, lq, d), generator=gen, device=dev))
        dv = unit(torch.randn((c, ld, d), generator=gen,
                              device=dev)).to(dtype)
        dlen = torch.randint(1, ld + 1, (c, 1), generator=gen, device=dev)
        d_mask = torch.arange(ld, device=dev)[None, :] < dlen
        q_mask = torch.ones((q, lq), dtype=torch.bool, device=dev)
        if masks == "scattered":
            d_mask = torch.rand((c, ld), generator=gen, device=dev) > 0.6
            d_mask[::3, : ld // 2] = False
        if masks == "edges":
            q_mask = torch.rand((q, lq), generator=gen, device=dev) > 0.3
            q_mask[:, 0] = True
            if q > 1:
                q_mask[-1] = False
            d_mask[c // 2] = False
        args = (qv, q_mask, dv, d_mask)
        got, ref = maxsim(*args), maxsim_plain(*args)
        torch.cuda.synchronize()
        check(got.shape == (q, c) and bool(torch.isfinite(got).all()),
              f"maxsim {label}: shape {tuple(got.shape)} or not finite")
        torch.testing.assert_close(got, ref, **MAXSIM_TOL)
        dead = ~d_mask.any(dim=1)
        want = -1e30 * q_mask.sum(dim=1, dtype=torch.float32)
        torch.testing.assert_close(got[:, dead],
                                   want[:, None].expand(q, int(dead.sum())),
                                   rtol=1e-6, atol=0)
        check(torch.equal(maxsim(*args), got),
              f"maxsim {label}: two runs differ")
        err = float((got - ref).abs().max())
        shape = f"[{q},{lq}]x[{c},{ld}] D={d} {str(dtype)[6:]}"
        log(f"maxsim {shape} ({label}) max_abs_err={err:.3g} "
            f"(of max |score| {float(ref.abs().max()):.3g}); deterministic")
        if label in ("rerank", "hermetic"):
            bnd = maxsim_bound(*args)
            plan = maxsim_plan(dtype, q, lq, c, ld, d)
            timed = {
                "max_abs_err": err,
                "ms": cuda_ms(lambda: maxsim(*args), iters=200),
                "plain_ms": cuda_ms(lambda: maxsim_plain(*args)),
                "device_ms": device_ms(lambda: maxsim(*args),
                                       launches=launches),
                "plain_device_ms": device_ms(lambda: maxsim_plain(*args)),
                # the wrapper's host time a call (calls enqueued back to
                # back; the card runs each in less)
                "host_us": host_us(lambda: maxsim(*args)),
                **bnd, "shape": shape, "launches_a_call": launches,
                "plan": {"row_tile": plan.row_tile,
                         "query_tile": plan.query_tile,
                         "stages": plan.stages, "smem": plan.smem,
                         "blocks": c * plan.row_tiles}}
            log(f"  kernel_ms={timed['ms']:.4f} plain_ms="
                f"{timed['plain_ms']:.4f} (device only: kernel "
                f"{fmt_ms(timed['device_ms'])}, plain "
                f"{fmt_ms(timed['plain_device_ms'])}); wrapper host "
                f"{timed['host_us']:.1f} us a call; bound "
                f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}; products "
                f"{bnd['bound_terms_ms']['products']:.5f}, bytes "
                f"{bnd['bound_terms_ms']['bytes']:.5f}); plan "
                f"{timed['plan']}")
            out[label] = timed
    registers = [f"{kernel}: {report}" for kernel, report in
                 ptxas_report(_kernels.BUILD_LOGS.get("maxsim", ""))]
    # the unprefixed numbers are the rerank's, where the main path's
    # launches are counted; hermetic_ keys hold the replay's shape
    return {**out["rerank"], "library_ms": None, "ptxas": registers or None,
            **{f"hermetic_{k}": v for k, v in out["hermetic"].items()}}


def check_flash_bwd(dev, gen) -> dict:
    import ctypes

    import torch

    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.flash_attention import (
        KERNEL_WIDTHS,
        flash_attention,
    )
    from rag_dpo_tpu_torch.ops.flash_attention_bwd import (
        _row_delta,
        flash_bwd_dkv,
        flash_bwd_dkv_plain,
        flash_bwd_dq,
        flash_bwd_dq_plain,
    )

    # (batch, heads, seq, head_dim, dtype, lengths): the training shape,
    # the ingest batch, a ragged batch with an empty row, bf16, Dh 16/128,
    # and Dh 80 and 320, which go in padded with zero columns (C-20)
    cases = [(16, 16, TRAIN_SEQ, 64, torch.float32, None),
             (64, 16, 512, 64, torch.float32, None),
             (8, 16, 300, 64, torch.float32,
              [300, 0, 1, 17, 64, 65, 299, 128]),
             (4, 16, 256, 64, torch.bfloat16, [256, 100, 0, 3]),
             (4, 8, 200, 16, torch.float32, [200, 0, 64, 199]),
             (4, 8, 130, 128, torch.float32, [130, 64, 0, 1]),
             (4, 4, 150, 80, torch.float32, [150, 0, 77, 1]),
             (2, 4, 100, 320, torch.float32, [100, 33])]
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
        # dq sums keys, dk/dv queries, in tiles of 8 to 64 rows on the
        # tensor cores; the twin in one cuBLAS product; both in f32, and
        # bf16 rounds the outputs
        tol = FLASH_BWD_TOL[str(dtype).split(".")[1]]
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
        again = (flash_bwd_dq(*args), *flash_bwd_dkv(*args))
        check(all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv))),
              f"flash_bwd gave other bits the second time at {q.shape}")
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
            lib = sdpa_bwd_times(q, k, v, lengths, g)
            bnds = flash_bwd_bounds(q, lengths)
            for name, (kd, pd) in dev_ms.items():
                main[name] = {"ms": ms[name], "plain_ms": plain[name],
                              "device_ms": kd, "plain_device_ms": pd,
                              **bnds[name], **lib,
                              "library_covers": "flash_bwd_dq and "
                                                "flash_bwd_dkv together"}
                log(f"  {name} device only: kernel {fmt_ms(kd)}, plain "
                    f"{fmt_ms(pd)}; bound {bnds[name]['bound_ms']:.4f} ms "
                    f"({bnds[name]['bound_by']})")
            log(f"  sdpa backward with a key mask (dq, dk, dv together) "
                f"{lib['library_ms']:.4f} ms (device "
                f"{fmt_ms(lib['library_device_ms'])}, "
                f"{lib['library_kernel']})")
    lib = _kernels.load("flash_bwd_dq")
    lib.flash_bwd_smem.restype = ctypes.c_longlong
    lib.flash_bwd_smem.argtypes = [ctypes.c_int] * 3
    smem = {name: {f"{t}_dh{w}": lib.flash_bwd_smem(dkv, d, w)
                   for t, d in (("f32", 0), ("bf16", 1))
                   for w in KERNEL_WIDTHS}
            for dkv, name in enumerate(worst)}
    log(f"flash_bwd shared memory a block: {smem}")
    shape = f"[16,16,{TRAIN_SEQ},64] f32"
    return {name: {"max_abs_err": worst[name], **main[name], "shape": shape,
                   "smem_bytes": smem[name]}
            for name in worst}


def scale_rows(dev, gen, n: int | None = None):
    """bench.py's corpus: n (default SCALE_N) unit Gaussian rows of
    SCALE_DIM dims (f32, made on the card from `gen`), padded with zero
    rows to the index's 1024-row granularity, and the store's penalty
    (−1e4 on the padding)."""
    import torch

    n, d = n or SCALE_N, SCALE_DIM

    n_pad = -(-n // 1024) * 1024
    rows = torch.zeros((n_pad, d), device=dev)
    for lo in range(0, n, 1 << 17):
        hi = min(n, lo + (1 << 17))
        x = torch.randn((hi - lo, d), generator=gen, device=dev)
        rows[lo:hi] = x / x.norm(dim=1, keepdim=True)
    penalty = torch.zeros((n_pad,), device=dev)
    penalty[n:] = -1e4
    return rows, penalty


def unit_queries(dev, gen, q: int):
    import torch

    x = torch.randn((q, SCALE_DIM), generator=gen, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def fused_topk_bound(q: int, n: int, d: int, k: int, itemsize: int) -> dict:
    """2·Q·N·D operations on bf16 (or f32) inputs; the rows, queries and
    penalty read once, [Q, k] scores and ids written once. With the bound
    on the f32 CUDA cores beside it, the rate the kernel computes at."""
    flops = 2.0 * q * n * d
    nbytes = (n * d + q * d) * itemsize + 4.0 * n + 8.0 * q * k
    rate = BF16_FLOPS if itemsize == 2 else F32_FLOPS
    return {**bound(flops, nbytes, rate),
            "f32_cores_bound_ms": bound(flops, nbytes)["bound_ms"]}


def compare_fused_topk(q, e, pen, k, label) -> tuple:
    """K4 against its twin: scores within NEAR_TIE, ids equal but where
    the twin's score of the kernel's row lies that close to the slot's, the
    same bits twice. Returns the max abs error and the near-tie ids."""
    import torch

    from rag_dpo_tpu_torch.ops.topk import fused_topk, fused_topk_plain

    ks, ki = fused_topk(q, e, k, penalty=pen)
    ps, pi = fused_topk_plain(q, e, k, penalty=pen)
    torch.cuda.synchronize()
    err = float((ks - ps).abs().max())
    check(err <= NEAR_TIE, f"fused_topk {label}: scores differ by {err}")
    differ = ki != pi
    # each id the kernel returns carries the twin's score of its slot
    got = torch.einsum("qd,qkd->qk", q.float(),
                       e[ki.clamp_min(0).long()].float())
    got = got + pen[ki.clamp_min(0).long()]
    gap = float((got - ps)[differ].abs().max()) if differ.any() else 0.
    check(gap <= NEAR_TIE, f"fused_topk {label}: an id differs outside "
          f"a near-tie ({gap})")
    ks2, ki2 = fused_topk(q, e, k, penalty=pen)
    check(torch.equal(ks2, ks) and torch.equal(ki2, ki),
          f"fused_topk {label}: two runs differ")
    return err, int(differ.sum())


def versus_library(name: str, label: str, ms: float, lib_ms: float,
                   bnd: dict, plan: dict) -> dict:
    """One line a (kernel, shape): its time, its ratio to the library
    call, its share of the bound, and the launch plan it ran."""
    ratio, share = ms / lib_ms, bnd["bound_ms"] / ms
    log(f"{name} {label}: {ms:.4f} ms = {ratio:.2f}x torch.topk(addmm) "
        f"({lib_ms:.4f} ms); bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']}) = {share:.3f} of the kernel's time; "
        f"{plan['route']} tile_q {plan['tile_q']} stages {plan['stages']} "
        f"shared {plan['smem_bytes']} B")
    return {"library_ratio": ratio, "bound_share": share,
            "plan": {k: plan[k] for k in ("route", "tile_q", "stages",
                                          "smem_bytes")}}


def check_fused_topk(dev, gen) -> dict:
    """K4 against its twin at the serve shape (4 query variants × the
    16,919-chunk index's 17,408 padded rows, bf16, k 40) and over the 1M
    rows at batches 1, 64 and 256; K5 at the serve shape beside it."""
    import torch

    from rag_dpo_tpu_torch.ops.topk import (
        candidates_plan,
        fused_topk,
        fused_topk_plain,
        seg_candidates,
        seg_candidates_plain,
        topk_plan,
    )

    compare = compare_fused_topk
    out = {}
    rows, pen = scale_rows(dev, gen, n=16_919)
    e = rows[:17_408].to(torch.bfloat16)
    q = unit_queries(dev, gen, 4).to(torch.bfloat16)
    pen = pen[:17_408]
    err, ties = compare(q, e, pen, 40, "serve")
    ms = cuda_ms(lambda: fused_topk(q, e, 40, penalty=pen))
    plain_ms = cuda_ms(lambda: fused_topk_plain(q, e, 40, penalty=pen))
    bnd = fused_topk_bound(4, 17_408, SCALE_DIM, 40, 2)
    log(f"fused_topk [4x1024]x[17408x1024] bf16 k=40: max_abs_err={err:.3g}, "
        f"{ties} near-tie ids; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}; "
        f"bound {bnd['bound_ms']:.5f} ms ({bnd['bound_by']})")
    pen16 = pen.to(torch.bfloat16)[None, :]
    lib_ms = cuda_ms(lambda: torch.topk(torch.addmm(pen16, q, e.T), 40))
    vs = versus_library("K4", "serve [4]x[17408] bf16 k=40", ms, lib_ms, bnd,
                        topk_plan(4, 17_408, 40, torch.bfloat16))
    out.update({"serve_max_abs_err": err, "serve_ms": ms,
                "serve_plain_ms": plain_ms, "serve_library_ms": lib_ms,
                **{f"serve_{k}": v for k, v in {**bnd, **vs}.items()},
                "serve_device_ms": device_ms(
                    lambda: fused_topk(q, e, 40, penalty=pen), launches=2)})
    # the hermetic replay's shape: one query of the trained tiny encoder's
    # 64 dims against its 212 chunks padded to 1,024 bf16 rows, k 40
    hrows, hpen = scale_rows(dev, gen, n=212)
    he = hrows[:1024, :64].to(torch.bfloat16).contiguous()
    hq = unit_queries(dev, gen, 1)[:, :64].to(torch.bfloat16).contiguous()
    hpen = hpen[:1024]
    herr, hties = compare(hq, he, hpen, 40, "hermetic")
    hbnd = fused_topk_bound(1, 1024, 64, 40, 2)
    hmeas = {"ms": cuda_ms(lambda: fused_topk(hq, he, 40, penalty=hpen),
                           iters=200),
             "device_ms": device_ms(
                 lambda: fused_topk(hq, he, 40, penalty=hpen), launches=2),
             "plain_ms": cuda_ms(
                 lambda: fused_topk_plain(hq, he, 40, penalty=hpen)),
             "max_abs_err": herr, **hbnd}
    log(f"fused_topk [1x64]x[1024x64] bf16 k=40 (the hermetic replay's "
        f"shape): max_abs_err={herr:.3g}, {hties} near-tie ids; kernel_ms="
        f"{hmeas['ms']:.4f} (device {fmt_ms(hmeas['device_ms'])}) plain_ms="
        f"{hmeas['plain_ms']:.4f}; bound {hbnd['bound_ms']:.6f} ms "
        f"({hbnd['bound_by']})")
    out.update({f"hermetic_{k}": v for k, v in hmeas.items()})
    del hrows, he
    # K5 at the same shape (its recipe, per_seg 2): the strip to its twin
    kw = dict(penalty=pen, per_seg=2, **CAND_RECIPE)
    strip = seg_candidates(q, e, **kw)
    err5, _ = candidates_gap(q, e, pen, strip,
                             seg_candidates_plain(q, e, **kw), "serve strip")
    ms5 = cuda_ms(lambda: seg_candidates(q, e, **kw))
    bnd5 = fused_topk_bound(4, 17_408, SCALE_DIM, strip[0].shape[1], 2)
    vs5 = versus_library(
        "K5", "serve [4]x[17408] bf16 per_seg 2", ms5, lib_ms, bnd5,
        candidates_plan(4, 17_408, torch.bfloat16, **CAND_RECIPE))
    out["k5_serve"] = {"ms": ms5, "max_abs_err": err5, "library_ms": lib_ms,
                       **bnd5, **vs5}
    del rows, e
    rows, pen = scale_rows(dev, gen)
    e = rows.to(torch.bfloat16)
    del rows
    worst = 0.0
    for nq in SCALE_BATCHES:
        q = unit_queries(dev, gen, nq).to(torch.bfloat16)
        err, ties = compare(q, e, pen, 40, f"1M Q={nq}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: fused_topk(q, e, 40, penalty=pen), iters=10)
        plain_ms = cuda_ms(lambda: fused_topk_plain(q, e, 40, penalty=pen),
                           iters=3, warmup=1)
        pen16 = pen.to(torch.bfloat16)[None, :]
        lib_ms = cuda_ms(lambda: torch.topk(torch.addmm(pen16, q, e.T), 40),
                         iters=10)
        bnd = fused_topk_bound(nq, e.shape[0], SCALE_DIM, 40, 2)
        dms = device_ms(lambda: fused_topk(q, e, 40, penalty=pen),
                        iters=5, launches=2)
        log(f"fused_topk [{nq}x1024]x[{e.shape[0]}x1024] bf16 k=40: "
            f"max_abs_err={err:.3g}, {ties} near-tie ids; kernel_ms={ms:.4f} "
            f"(device {fmt_ms(dms)}) plain_ms={plain_ms:.4f}; torch.topk("
            f"addmm) {lib_ms:.4f} ms; bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}), on the f32 cores "
            f"{bnd['f32_cores_bound_ms']:.4f} ms")
        vs = versus_library("K4", f"1M Q={nq} bf16 k=40", ms, lib_ms, bnd,
                            topk_plan(nq, e.shape[0], 40, torch.bfloat16))
        out[f"q{nq}"] = {"ms": ms, "device_ms": dms, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "near_tie_ids": ties, **bnd,
                         **vs}
    main = out.pop(f"q{SCALE_BATCHES[-1]}")
    return {"max_abs_err": worst, **main,
            "library_calls": "torch.topk(torch.addmm(pen, q, e.T), k): a "
                             "bf16 tensor-core GEMM with a bf16 [Q, N] "
                             "output, then topk",
            "shape": f"[{SCALE_BATCHES[-1]}x1024]x[{e.shape[0]}x1024] bf16 "
                     "k=40", **out}


def candidates_gap(q, e, pen, got, want, label) -> tuple:
    """Scores of `got` (the kernel's strip or top-k) against `want` (the
    twin's): the max abs error, which must stay within NEAR_TIE (relative
    past 1: a row under a −1e4 penalty rounds to 2⁻¹⁰); ids must be equal
    but where the twin's score of the kernel's row lies that close to the
    slot's. Returns the error and the number of such near-tie ids."""
    import torch

    (ks, ki), (ps, pi) = got, want
    tol = NEAR_TIE * ps.abs().clamp_min(1.0)
    check(bool(((ks - ps).abs() <= tol).all()),
          f"fused_candidates {label}: scores differ by "
          f"{float((ks - ps).abs().max())}")
    check(torch.equal(ki >= 0, pi >= 0),
          f"fused_candidates {label}: the valid ids differ")
    r, c = (ki != pi).nonzero(as_tuple=True)
    if len(r):
        rows = ki[r, c].long()
        twin = (q[r].float() * e[rows].float()).sum(1) + pen[rows]
        check(bool(((twin - ps[r, c]).abs() <= tol[r, c]).all()),
              f"fused_candidates {label}: an id differs outside a near-tie")
    return float((ks - ps).abs().max()), len(r)


def check_fused_candidates(dev, seed: int) -> dict:
    """K5 at bench_fused_cand.py's recipe (block_n 2048, seg 128, k 40)
    over 1M bf16 rows made by `scale_rows` from a generator of its own
    (seed + 5), at batches 1, 64 and 256 with per_seg 2 and at 64 with
    per_seg 1: first its path, the public `ops.fused_candidates_topk` once
    a run with the counts from 0, then strip and top-40 against the twin,
    the same bits twice, recall@40 against K4's exact top-40 on the same
    rows (≥ 0.99 at per_seg 2), and the times of the kernel, the entry
    point (the kernel and the plain phase-2 sort), the twin, K4 and
    `torch.topk(addmm)`."""
    import torch

    from rag_dpo_tpu_torch import ops
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.topk import (
        candidates_plan,
        fused_candidates_topk_plain,
        fused_topk,
        seg_candidates,
        seg_candidates_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    rows, pen = scale_rows(dev, gen)
    e = rows.to(torch.bfloat16)
    del rows
    n = e.shape[0]
    queries = {nq: unit_queries(dev, gen, nq).to(torch.bfloat16)
               for nq in SCALE_BATCHES}
    runs = [(nq, 2) for nq in SCALE_BATCHES] + [(64, 1)]

    def entry(nq, per_seg):
        return ops.fused_candidates_topk(queries[nq], e, CAND_K, penalty=pen,
                                         per_seg=per_seg, **CAND_RECIPE)

    _kernels.reset_counts()
    for nq, per_seg in runs:
        entry(nq, per_seg)
    torch.cuda.synchronize()
    launches = _kernels.LAUNCHES["fused_candidates"]
    check(launches == len(runs) and not any(_kernels.PLAIN_ON_CUDA.values()),
          f"fused_candidates path: launches {launches}, plain "
          f"{_kernels.PLAIN_ON_CUDA}")
    log(f"fused_candidates path: ops.fused_candidates_topk at {runs} "
        f"(Q, per_seg) launched K5 {launches} times, no twin")

    out, worst = {"launches": launches}, 0.0
    for nq, per_seg in runs:
        q = queries[nq]
        kw = dict(penalty=pen, per_seg=per_seg, **CAND_RECIPE)
        label = f"1M Q={nq} per_seg={per_seg}"
        strip, top = seg_candidates(q, e, **kw), entry(nq, per_seg)
        err_s, ties_s = candidates_gap(
            q, e, pen, strip, seg_candidates_plain(q, e, **kw),
            f"{label} strip")
        err_t, ties_t = candidates_gap(
            q, e, pen, top, fused_candidates_topk_plain(q, e, CAND_K, **kw),
            f"{label} top-{CAND_K}")
        again = seg_candidates(q, e, **kw) + entry(nq, per_seg)
        check(all(torch.equal(a, b) for a, b in zip(strip + top, again)),
              f"fused_candidates {label}: two runs differ")
        worst = max(worst, err_s, err_t)
        exact = fused_topk(q, e, CAND_K, penalty=pen)[1]
        recall = float((top[1][:, :, None] == exact[:, None, :]).any(2)
                       .float().mean())
        if per_seg == 2:
            check(recall >= SCALE_MIN_RECALL,
                  f"fused_candidates {label}: recall@{CAND_K} {recall}")
        _kernels.reset_counts()
        ms = cuda_ms(lambda: seg_candidates(q, e, **kw), iters=10)
        entry_ms = cuda_ms(lambda: entry(nq, per_seg), iters=10)
        k4_ms = cuda_ms(lambda: fused_topk(q, e, CAND_K, penalty=pen),
                        iters=10)
        check(_kernels.LAUNCHES["fused_candidates"] > 0
              and not any(_kernels.PLAIN_ON_CUDA.values()),
              f"fused_candidates {label}: timed calls ran "
              f"{_kernels.LAUNCHES} / plain {_kernels.PLAIN_ON_CUDA}")
        plain_ms = cuda_ms(lambda: seg_candidates_plain(q, e, **kw), iters=3,
                           warmup=1)
        pen16 = pen.to(torch.bfloat16)[None, :]
        lib_ms = cuda_ms(lambda: torch.topk(torch.addmm(pen16, q, e.T),
                                            CAND_K), iters=10)
        dms = device_ms(lambda: seg_candidates(q, e, **kw), iters=5,
                        launches=1)
        # the [Q, W] strip takes the place of K4's [Q, k] output
        bnd = fused_topk_bound(nq, n, SCALE_DIM, strip[0].shape[1], 2)
        log(f"fused_candidates [{nq}x1024]x[{n}x1024] bf16 per_seg="
            f"{per_seg} (strip {strip[0].shape[1]}): max_abs_err strip "
            f"{err_s:.3g}, top-{CAND_K} {err_t:.3g}, near-tie ids {ties_s}, "
            f"{ties_t}; recall@{CAND_K} vs K4 {recall:.5f}; kernel_ms="
            f"{ms:.4f} (device {fmt_ms(dms)}) entry_ms={entry_ms:.4f} "
            f"plain_ms={plain_ms:.4f}; K4 {k4_ms:.4f} ms; torch.topk(addmm) "
            f"{lib_ms:.4f} ms; bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}), on the f32 cores "
            f"{bnd['f32_cores_bound_ms']:.4f} ms")
        vs = versus_library(
            "K5", f"1M Q={nq} bf16 per_seg {per_seg}", ms, lib_ms, bnd,
            candidates_plan(nq, n, torch.bfloat16, **CAND_RECIPE))
        key = f"q{nq}" + ("" if per_seg == 2 else f"_per_seg{per_seg}")
        out[key] = {"ms": ms, "device_ms": dms, "entry_ms": entry_ms,
                    "plain_ms": plain_ms, "k4_ms": k4_ms,
                    "library_ms": lib_ms, f"recall_at_{CAND_K}": recall,
                    "near_tie_ids": ties_s + ties_t,
                    "strip_width": strip[0].shape[1], **bnd, **vs}
    main = out.pop(f"q{SCALE_BATCHES[-1]}")
    return {"max_abs_err": worst, **main,
            "library_calls": "torch.topk(torch.addmm(pen, q, e.T), k): the "
                             "exact top-k K5 approximates, on the bf16 "
                             "tensor cores",
            "shape": f"[{SCALE_BATCHES[-1]}x1024]x[{n}x1024] bf16, block_n "
                     f"{CAND_RECIPE['block_n']}, seg {CAND_RECIPE['seg']}, "
                     f"per_seg 2, k {CAND_K}", **out}


def check_pooled(dev, gen) -> dict:
    """K6 against its twin over the 1M int8 rows (quantized as the store
    quantizes them) at batches 1, 64 and 256."""
    import torch

    from rag_dpo_tpu_torch.ops.pooled import (
        pooled_group_max,
        pooled_group_max_plain,
    )
    from rag_dpo_tpu_torch.ops.quantize import quantize_rows
    from rag_dpo_tpu_torch.ops.widen_product import widen_plan

    rows, pen = scale_rows(dev, gen)
    e_i8, e_scale = quantize_rows(rows)
    del rows
    n, d = e_i8.shape
    out, worst = {}, 0.0
    for nq in SCALE_BATCHES:
        q = unit_queries(dev, gen, nq).to(torch.bfloat16)
        args = (q, e_i8, e_scale, pen)
        kv, ki = pooled_group_max(*args)
        pv, pi = pooled_group_max_plain(*args)
        torch.cuda.synchronize()
        err = float((kv.float() - pv.float()).abs().max())
        ulp = torch.ldexp(torch.ones_like(pv.float()),
                          torch.frexp(pv.float()).exponent - 8)
        check(bool(((kv.float() - pv.float()).abs() <= ulp).all()),
              f"pooled Q={nq}: a value differs by more than one bf16 ulp")
        s = (q.float() @ e_i8.float().T) * e_scale + pen      # [Q, n_pad]
        nb = -(-n // 8192)
        full = torch.full((nq, nb * 8192), -1e30, device=dev)
        full[:, :n] = s
        top2 = full.reshape(nq, nb, 64, 128).topk(2, dim=2).values
        near = (top2[:, :, 0] - top2[:, :, 1] <= NEAR_TIE).reshape(nq, -1)
        differ = ki != pi
        check(not bool((differ & ~near).any()),
              f"pooled Q={nq}: an id differs outside a near-tie")
        del s, full, top2
        kv2, ki2 = pooled_group_max(*args)
        check(torch.equal(kv2, kv) and torch.equal(ki2, ki),
              f"pooled Q={nq}: two runs differ")
        worst = max(worst, err)
        ms = cuda_ms(lambda: pooled_group_max(*args), iters=10)
        plain_ms = cuda_ms(lambda: pooled_group_max_plain(*args), iters=3,
                           warmup=1)
        # the call's device events: the kernel and the copy of the
        # queries with their columns in the kernel's k order
        dms = device_ms(lambda: pooled_group_max(*args), iters=5)
        # the int8 rows, their scales and the penalty, the queries read
        # once; bf16 maxima and int32 ids written once
        n_pool = ki.shape[1]
        flops = 2.0 * nq * n * d
        nbytes = n * d + 8.0 * n + 2.0 * nq * d + 6.0 * nq * n_pool
        bnd = {**bound(flops, nbytes, BF16_FLOPS),
               "f32_cores_bound_ms": bound(flops, nbytes)["bound_ms"]}
        log(f"pooled_max [{nq}x1024] bf16 x [{n}x1024] int8: max_abs_err="
            f"{err:.3g} (values within a bf16 ulp), {int(differ.sum())} "
            f"near-tie ids; kernel_ms={ms:.4f} (device {fmt_ms(dms)}) "
            f"plain_ms={plain_ms:.4f}; bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}), on the f32 cores "
            f"{bnd['f32_cores_bound_ms']:.4f} ms")
        # the kernel's instance and launch plan at this batch
        plan = widen_plan(nq, d)
        out[f"q{nq}"] = {"ms": ms, "device_ms": dms, "plain_ms": plain_ms,
                         "near_tie_ids": int(differ.sum()),
                         "instance": f"pooled_max_kernel<{plan.nq}>",
                         "plan": {"queries_a_block": plan.nq,
                                  "stages": plan.stages,
                                  "smem_bytes": plan.smem}, **bnd}
    main = out.pop(f"q{SCALE_BATCHES[-1]}")
    return {"max_abs_err": worst, **main, "library_ms": None,
            "shape": f"[{SCALE_BATCHES[-1]}x1024] bf16 x [{n}x1024] int8, "
                     "block 8192, group 64", **out}


def int8_floor_bound(q: int, n: int, d: int, block: int,
                     rate: float) -> dict:
    """K10/K11: 2·Q·rows·D operations at `rate` (bf16 for K10's widened
    operands, int8 for K11) over the whole blocks' rows; those rows and the
    queries read once, the [Q, blocks·128] f32 strip written once."""
    nb = n // block
    rows = nb * block
    return bound(2.0 * q * rows * d, rows * d + q * d + 4.0 * q * nb * 128,
                 rate)


def check_int8_floor(dev, seed: int) -> dict:
    """K10 and K11 at benchmarks/bench_pallas_int8_matmul.py's recipe
    (1,000,000 × 1024 uniform int8 rows made on the card, Q 64, 2048-row
    blocks): first their path, `evals/bench_int8_matmul.run` with the
    counts from 0 (its strips must equal the library product's); then, on
    rows of their own (seed + 7), each against the twin bit for bit, the
    same bits twice, and the times of the kernel, the twin and the library
    strip (`torch._int_mm` + strided `amax`), beside the bound; then K10,
    K11 and K6 at Q 64 side by side on the scale phase's quantized rows
    (`quantize_rows(scale_rows(...))`, what K6 sweeps)."""
    import torch

    from rag_dpo_tpu_torch.evals import bench_int8_matmul as bench
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.int8_matmul import (
        int8_block_max,
        int8_block_max_plain,
    )
    from rag_dpo_tpu_torch.ops.pooled import pooled_group_max
    from rag_dpo_tpu_torch.ops.quantize import quantize_rows

    # benchmarks/bench_pallas_int8_matmul.py:31-33's recipe
    n, d, nq, block = (bench.RECIPE[k] for k in ("n", "d", "q", "block"))
    _kernels.reset_counts()
    line = bench.run(seed=seed, device=dev)
    torch.cuda.synchronize()
    launches = {name: _kernels.LAUNCHES[name] for name in bench.KERNELS}
    check(all(launches.values()) and not any(_kernels.PLAIN_ON_CUDA.values()),
          f"int8 floor path: launches {launches}, plain "
          f"{_kernels.PLAIN_ON_CUDA}")
    log(f"int8 floor path: evals/bench_int8_matmul.run launched {launches}, "
        f"no twin: {json.dumps(line)}")

    # the recipe's Q first (the unprefixed numbers), then Q 1 and 256 (q1,
    # q256): each kernel bit for bit against the twin, twice, beside the
    # library strip
    out = {name: {} for name in bench.KERNELS}
    _, e_i8 = bench.make_inputs(n, d, 1, seed + 7, dev)
    for qn in (nq, 1, 256):
        q_i8 = bench.make_inputs(1, d, qn, seed + 8 + qn, dev)[0]
        lib_ms = cuda_ms(lambda: bench.library_block_max(q_i8, e_i8, block),
                         iters=10)
        for name, upcast in bench.KERNELS.items():
            def kernel(q=q_i8, e=e_i8, upcast=upcast):
                return int8_block_max(q, e, block=block, upcast=upcast)

            got = kernel()
            want = int8_block_max_plain(q_i8, e_i8, block=block,
                                        upcast=upcast)
            err = float((got - want).abs().max())
            check(torch.equal(got, want), f"{name} Q {qn}: differs from "
                  f"the twin by {err}")
            check(torch.equal(kernel(), got), f"{name} Q {qn}: two runs "
                  "differ")
            del want
            ms = cuda_ms(kernel, iters=10)
            dms = device_ms(kernel, iters=5)
            plain_ms = cuda_ms(lambda: int8_block_max_plain(
                q_i8, e_i8, block=block, upcast=upcast), iters=3, warmup=1)
            bnd = int8_floor_bound(qn, n, d, block, BF16_FLOPS
                                   if upcast == "bf16" else INT8_OPS)
            gbps = n * d / ms / 1e6
            log(f"{name} [{qn}x{d}] x [{n}x{d}] int8, block {block} (strip "
                f"{list(got.shape)}): bit for bit against the twin, the "
                f"same bits twice; kernel_ms={ms:.4f} (device {fmt_ms(dms)})"
                f" = {gbps:.0f} GB/s (N·D / time); plain_ms={plain_ms:.4f}; "
                f"library (torch._int_mm + amax) {lib_ms:.4f} ms = "
                f"{lib_ms / ms:.3f}x the kernel's time; bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) = "
                f"{bnd['bound_ms'] / ms:.3f} of the kernel's time")
            meas = {"max_abs_err": err, "ms": ms, "device_ms": dms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "gbps": gbps, **bnd}
            if qn == nq:
                out[name].update({
                    "launches": launches[name], **meas,
                    "entry_ms": line[f"{name}_ms"],
                    "entry_library_ms": line["library_int8_mm_ms"],
                    "library_calls": "torch._int_mm(q, e.T) then amax over "
                                     "the strided [Q, blocks, block/128, "
                                     "128] view",
                    "shape": f"[{qn}x{d}] x [{n}x{d}] int8, block {block}"})
            else:
                out[name][f"q{qn}"] = meas
        del q_i8
    del e_i8
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 6)
    rows, pen = scale_rows(dev, gen)
    e_i8, e_scale = quantize_rows(rows)
    del rows
    qf = unit_queries(dev, gen, nq)
    q_i8 = quantize_rows(qf)[0]
    qb = qf.to(torch.bfloat16)
    side = {name: cuda_ms(lambda up=upcast: int8_block_max(
                q_i8, e_i8, block=block, upcast=up), iters=10)
            for name, upcast in bench.KERNELS.items()}
    side["library_int8_mm"] = cuda_ms(
        lambda: bench.library_block_max(q_i8, e_i8, block), iters=10)
    side["pooled_max"] = cuda_ms(
        lambda: pooled_group_max(qb, e_i8, e_scale, pen), iters=10)
    log(f"int8 sweep side by side on the scale rows ([{e_i8.shape[0]}x{d}] "
        f"int8, Q {nq}): " + ", ".join(f"{k} {v:.4f} ms"
                                       for k, v in side.items())
        + f"; K6 / K11 = {side['pooled_max'] / side['int8_block_max_i8']:.2f}")
    for name in bench.KERNELS:
        out[name]["scale_rows_side_by_side_ms"] = side
    return out


# ROADMAP C-17 and C-19: shapes past the kernels' former limits, each
# held to its twin (unit queries, as the store sends them): K4 (Q, D, k,
# dtype), K5 (Q, D, dtype; top-512 of its strip), K6 at D 1536, K3 with
# 100 query terms and at k 2048
LIMIT_ROWS = 50_000
LIMIT_K4 = ((7, 1000, 40, "bfloat16"), (300, 1536, 40, "bfloat16"),
            (64, 1024, 512, "bfloat16"), (16, 1024, 1024, "bfloat16"),
            (7, 1000, 512, "float32"), (300, 1536, 1024, "float32"))
LIMIT_K5 = ((7, 1000, "bfloat16"), (300, 1536, "bfloat16"),
            (7, 1536, "float32"))
# K5 at segs it refused before (C-19): (block_n, seg, per_seg, dtype) over
# 64 queries × 256 dims: a span cut short of a 128-row tile (lcm(80, 128)
# = 640), a segment narrower than a warp, and segments cut into 512-row
# pieces whose picks a second pass merges
LIMIT_SEGS = ((1280, 80, 2, "bfloat16"), (2048, 8, 2, "float32"),
              (2048, 1024, 4, "bfloat16"), (2000, 1000, 2, "float32"))


def check_former_limits(dev, gen) -> dict:
    """The kernels at the shapes ROADMAP C-17 lists (see LIMIT_*); every
    case launches its kernel once more and matches its twin."""
    import torch

    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.pooled import (
        pooled_group_max,
        pooled_group_max_plain,
    )
    from rag_dpo_tpu_torch.ops.quantize import quantize_rows
    from rag_dpo_tpu_torch.ops.sparse import ell_topk, ell_topk_plain
    from rag_dpo_tpu_torch.ops.topk import (
        fused_candidates_topk,
        fused_candidates_topk_plain,
        seg_candidates,
        seg_candidates_plain,
    )

    def rows(d):
        x = torch.randn((LIMIT_ROWS, d), generator=gen, device=dev)
        return x / x.norm(dim=1, keepdim=True)

    def queries(q, d):
        x = torch.randn((q, d), generator=gen, device=dev)
        return x / x.norm(dim=1, keepdim=True)

    pen = torch.zeros(LIMIT_ROWS, device=dev)
    pen[torch.rand(LIMIT_ROWS, generator=gen, device=dev) < 0.1] = -1e4
    out = {"cases": 0}

    def launched(name, before):
        check(_kernels.LAUNCHES[name] > before,
              f"{name} did not launch at a former limit")
        out["cases"] += 1

    for q, d, k, dtype in LIMIT_K4:
        dt = getattr(torch, dtype)
        e, qq = rows(d).to(dt), queries(q, d).to(dt)
        before = _kernels.LAUNCHES["fused_topk"]
        err, ties = compare_fused_topk(qq, e, pen, k,
                                       f"Q={q} D={d} k={k} {dtype}")
        launched("fused_topk", before)
        log(f"former limit K4 [{q}x{d}]x[{LIMIT_ROWS}x{d}] {dtype} k={k}: "
            f"max_abs_err={err:.3g}, {ties} near-tie ids")
    for q, d, dtype in LIMIT_K5:
        dt = getattr(torch, dtype)
        e, qq = rows(d).to(dt), queries(q, d).to(dt)
        kw = dict(penalty=pen, per_seg=2, **CAND_RECIPE)
        before = _kernels.LAUNCHES["fused_candidates"]
        err_s, _ = candidates_gap(qq, e, pen, seg_candidates(qq, e, **kw),
                                  seg_candidates_plain(qq, e, **kw),
                                  f"Q={q} D={d} {dtype} strip")
        err_t, _ = candidates_gap(
            qq, e, pen, fused_candidates_topk(qq, e, 512, **kw),
            fused_candidates_topk_plain(qq, e, 512, **kw),
            f"Q={q} D={d} {dtype} top-512")
        launched("fused_candidates", before)
        log(f"former limit K5 [{q}x{d}]x[{LIMIT_ROWS}x{d}] {dtype}: "
            f"max_abs_err strip {err_s:.3g}, top-512 {err_t:.3g}")
    for block_n, seg, per_seg, dtype in LIMIT_SEGS:
        dt = getattr(torch, dtype)
        e, qq = rows(256).to(dt), queries(64, 256).to(dt)
        kw = dict(penalty=pen, block_n=block_n, seg=seg, per_seg=per_seg)
        before = _kernels.LAUNCHES["fused_candidates"]
        strip = seg_candidates(qq, e, **kw)
        err_s, ties = candidates_gap(qq, e, pen, strip,
                                     seg_candidates_plain(qq, e, **kw),
                                     f"seg={seg} {dtype} strip")
        check(all(torch.equal(a, b) for a, b in
                  zip(strip, seg_candidates(qq, e, **kw))),
              f"fused_candidates seg={seg}: other bits the second time")
        launched("fused_candidates", before)
        log(f"former limit K5 seg={seg} block_n={block_n} per_seg={per_seg} "
            f"[64x256]x[{LIMIT_ROWS}x256] {dtype}: strip max_abs_err "
            f"{err_s:.3g}, {ties} near-tie ids of {strip[1].numel()}")
    e_i8, e_scale = quantize_rows(rows(1536))
    qq = queries(4, 1536).to(torch.bfloat16)
    before = _kernels.LAUNCHES["pooled_max"]
    kv, ki = pooled_group_max(qq, e_i8, e_scale, pen)
    pv, pi = pooled_group_max_plain(qq, e_i8, e_scale, pen)
    torch.cuda.synchronize()
    ulp = torch.ldexp(torch.ones_like(pv.float()),
                      torch.frexp(pv.float()).exponent - 8)
    check(bool(((kv.float() - pv.float()).abs() <= ulp).all()),
          "pooled D=1536: a value differs by more than one bf16 ulp")
    sc = (qq.float() @ e_i8.float().T) * e_scale + pen
    nb = -(-LIMIT_ROWS // 8192)
    full = torch.full((4, nb * 8192), -1e30, device=dev)
    full[:, :LIMIT_ROWS] = sc
    top2 = full.reshape(4, nb, 64, 128).topk(2, dim=2).values
    near = (top2[:, :, 0] - top2[:, :, 1] <= NEAR_TIE).reshape(4, -1)
    check(not bool(((ki != pi) & ~near).any()),
          "pooled D=1536: an id differs outside a near-tie")
    differ = int((ki != pi).sum())
    launched("pooled_max", before)
    log(f"former limit K6 [4x1536] bf16 x [{LIMIT_ROWS}x1536] int8: values "
        f"within a bf16 ulp, {differ} ids differ (near-ties)")
    # 24 distinct terms a row (197·j mod 2000), a tenth of the slots empty
    base = torch.randint(0, 2000, (LIMIT_ROWS, 1), generator=gen, device=dev)
    terms = (base + 197 * torch.arange(24, device=dev)) % 2000
    empty = torch.rand((LIMIT_ROWS, 24), generator=gen, device=dev) < 0.1
    terms = torch.where(empty, -1, terms).to(torch.int32)
    imps = torch.rand((LIMIT_ROWS, 24), generator=gen, device=dev)
    qt = torch.randperm(2000, generator=gen, device=dev)[:100]
    qt = qt.to(torch.int32)[None, :]
    qw = torch.rand((1, 100), generator=gen, device=dev) + 0.2
    before = _kernels.LAUNCHES["ell_topk"]
    ks, ki = ell_topk(terms, imps, qt, qw, k=40)
    ps, pi = ell_topk_plain(terms, imps, qt, qw, 40)
    torch.cuda.synchronize()
    check(torch.equal(ki, pi) and torch.equal(ks, ps),
          "ell_topk T=100: ids or scores differ")
    launched("ell_topk", before)
    log(f"former limit K3 [{LIMIT_ROWS}x24] Q=1 T=100 k=40: ids and scores "
        f"exact")
    before = _kernels.LAUNCHES["ell_topk"]
    ks, ki = ell_topk(terms, imps, qt[:, :16], qw[:, :16], k=2048)
    ps, pi = ell_topk_plain(terms, imps, qt[:, :16], qw[:, :16], 2048)
    torch.cuda.synchronize()
    check(torch.equal(ki, pi) and torch.equal(ks, ps),
          "ell_topk k=2048: ids or scores differ")
    launched("ell_topk", before)
    log(f"former limit K3 [{LIMIT_ROWS}x24] Q=1 T=16 k=2048: ids and scores "
        f"exact")
    return out


def run_store_limits(seed: int, dev) -> dict:
    """A 50,000-row index at dim 1536, bf16 and int8, through the store's
    entry points: `search_dense(k=512)` and `search_sparse` with 100 terms.
    K4 (bf16) and K3 must launch and no twin may run; the bf16 top-512
    holds the exact f32 top-512 of the device image (recall ≥ 0.99), the
    int8 top-512 is the CPU store's (ids and scores), and the sparse top-40
    is K3's twin's, exactly."""
    import numpy as np
    import torch

    from rag_dpo_tpu_torch.index import DeviceIndex, IndexConfig
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.sparse import ell_topk_plain
    from rag_dpo_tpu_torch.ops.topk import fused_topk_plain

    rng = np.random.default_rng(seed + 17)
    n, dim = LIMIT_ROWS, 1536
    dense = rng.standard_normal((n, dim)).astype(np.float32)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    # 24 distinct terms a row
    terms = ((rng.integers(0, 5000, (n, 1)) + 197 * np.arange(24)) % 5000
             ).astype(np.int32)
    imps = np.abs(rng.standard_normal((n, 24))).astype(np.float32)
    q = rng.standard_normal((4, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qt = rng.choice(5000, (1, 100), replace=False).astype(np.int32)
    qw = rng.uniform(0.2, 3.0, (1, 100)).astype(np.float32)
    ids = [f"s{i}" for i in range(n)]
    out = {}
    for int8 in (False, True):
        idx = DeviceIndex(IndexConfig(dim=dim, ell_width=24,
                                      quantize_int8=int8), device=dev)
        idx.add(ids, dense, terms=terms, impacts=imps)
        image = idx.device_image()
        _kernels.reset_counts()
        t0 = time.perf_counter()
        s, i = idx.search_dense(q, 512)
        ss, si = idx.search_sparse(qt, qw, 40)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        # the int8 arm's product is torch._int_mm: no kernel of the port
        dense_kernel = "int8_product" if int8 else "fused_topk"
        launches["int8_product"] = 0
        check((int8 or launches[dense_kernel] > 0)
              and launches["ell_topk"] > 0,
              f"store dim {dim} int8={int8}: launches {launches}")
        check(not any(_kernels.PLAIN_ON_CUDA.values()),
              f"store dim {dim} int8={int8}: a twin ran "
              f"{_kernels.PLAIN_ON_CUDA}")
        check(s.shape == (4, 512) and np.isfinite(s[i >= 0]).all()
              and (i < n).all(), f"store dim {dim}: bad dense result")
        qd = torch.from_numpy(qt).to(dev)
        ws, wi = ell_topk_plain(image["terms"], image["impacts"], qd,
                                torch.from_numpy(qw).to(dev), 40)
        check(np.array_equal(si, wi.cpu().numpy())
              and np.array_equal(ss, ws.cpu().numpy()),
              f"store dim {dim}: sparse top-40 is not K3's twin's")
        if int8:
            # int8 × int8 ranking and the host refine: the CPU's ids
            cpu = DeviceIndex(IndexConfig(dim=dim, ell_width=24,
                                          quantize_int8=True), device="cpu")
            cpu.add(ids, dense, terms=terms, impacts=imps)
            cs, ci = cpu.search_dense(q, 512)
            check(np.array_equal(i, ci) and np.array_equal(s, cs),
                  f"store dim {dim} int8: ids or scores differ from the "
                  "CPU's")
            recall = None  # approximate by design: the CPU's ids instead
            valid = int((i >= 0).sum())
            del cpu
        else:
            qb = torch.from_numpy(q).to(dev).to(torch.bfloat16)
            qb = torch.nn.functional.pad(qb, (0, image["embs"].shape[1]
                                              - dim))
            _, want = fused_topk_plain(qb, image["embs"], 512,
                                       penalty=image["alive_penalty"])
            want = want.cpu().numpy()
            recall = float(np.mean([len(set(a) & set(b)) / 512
                                    for a, b in zip(i, want)]))
            check(recall >= 0.99, f"store dim {dim}: recall@512 {recall}")
            valid = int((i >= 0).sum())
        log(f"store dim {dim} {'int8' if int8 else 'bf16'}: search_dense("
            f"k=512) + search_sparse(100 terms) {wall * 1e3:.1f} ms, "
            f"launches {launches[dense_kernel]} {dense_kernel}, "
            f"{launches['ell_topk']} ell_topk, no twin; {valid} valid ids, "
            f"recall@512 vs the exact top-512 "
            f"{'n/a (int8: the CPU ids)' if recall is None else f'{recall:.5f}'}"
            f"; sparse top-40 = K3's twin")
        out["int8" if int8 else "bf16"] = {
            "launches": {dense_kernel: launches[dense_kernel],
                         "ell_topk": launches["ell_topk"]},
            "recall_at_512": recall, "valid_ids": valid}
        del idx, image
    return out


def run_scale(seed: int, dev) -> dict:
    """The 1M-chunk index through the index's entry points (see the module
    docstring, phase 4)."""
    import numpy as np
    import torch

    from rag_dpo_tpu_torch.index import DeviceIndex, IndexConfig
    from rag_dpo_tpu_torch.ops import _kernels, rrf_fuse
    from rag_dpo_tpu_torch.ops.sparse import ell_topk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    rows, _ = scale_rows(dev, gen)
    dense = rows[:SCALE_N].to(torch.float16).cpu().numpy()
    del rows
    terms = torch.randint(0, SCALE_VOCAB, (SCALE_N, SCALE_ELL),
                          generator=gen, device=dev, dtype=torch.int32)
    impacts = torch.randn((SCALE_N, SCALE_ELL), generator=gen,
                          device=dev).abs()
    terms, impacts = terms.cpu().numpy(), impacts.cpu().numpy()
    ids = [f"s{i}" for i in range(SCALE_N)]
    cfg = IndexConfig(dim=SCALE_DIM, ell_width=SCALE_ELL, quantize_int8=True,
                      postings_cap=256, postings_candidates=64)
    index = DeviceIndex(cfg, device=dev)
    index.add(ids, dense, terms=terms, impacts=impacts)
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="ragdpo_scale_") as tmp:
        t0 = time.perf_counter()
        index.save(tmp)
        save_s = time.perf_counter() - t0
        ckpt_gb = sum(f.stat().st_size
                      for f in pathlib.Path(tmp).iterdir()) / 1e9
        del index
        t0 = time.perf_counter()
        index = DeviceIndex.load(tmp, device=dev)
        load_s = time.perf_counter() - t0
        # the same checkpoint a second time, searched with device_refine
        refine = DeviceIndex.load(tmp, device=dev)
    refine.config = dataclasses.replace(refine.config, device_refine=True)
    check(index.n_rows == SCALE_N and index.config.quantize_int8,
          f"reloaded {index.n_rows} rows, {index.config}")
    t0 = time.perf_counter()
    image = index.device_image()
    torch.cuda.synchronize()
    image_s = time.perf_counter() - t0
    check(image["embs"] is None and image["embs_i8"].dtype == torch.int8,
          "the int8 index kept a bf16 image")
    log(f"scale: {SCALE_N} rows x {SCALE_DIM} + ELL {SCALE_ELL} built in "
        f"{build_s:.1f} s, saved ({ckpt_gb:.2f} GB) in {save_s:.1f} s, "
        f"reloaded in {load_s:.1f} s; int8 device image in {image_s:.1f} s")

    weights = torch.tensor([2.0, 1.5], device=dev)
    rng = np.random.default_rng(seed + 2)

    def batch(nq):
        q = unit_queries(dev, gen, nq).cpu().numpy()
        qt = rng.integers(0, SCALE_VOCAB, (nq, SCALE_TERMS)).astype(np.int32)
        qw = np.abs(rng.standard_normal((nq, SCALE_TERMS))).astype(
            np.float32)
        return q, qt, qw

    def hybrid(q, qt, qw, parts=None):
        t0 = time.perf_counter()
        ds, di = index.search_dense(q, 40)
        t1 = time.perf_counter()
        ss, si = index.search_sparse(qt, qw, 40)
        t2 = time.perf_counter()
        arms = torch.from_numpy(np.stack([di, si])).to(dev)
        fs, fi = rrf_fuse(arms, weights, topk=10)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if parts is not None:
            parts.append((t1 - t0, t2 - t1, t3 - t2))
        return di, si, fi

    reps = {1: 20, 64: 5, 256: 5}
    _kernels.reset_counts()
    timed, batches = {}, {}
    for nq in SCALE_BATCHES:
        batches[nq] = batch(nq)
        t0 = time.perf_counter()
        hybrid(*batches[nq])  # warm-up; the first builds the postings
        if nq == SCALE_BATCHES[0]:
            first_s = time.perf_counter() - t0
            log(f"scale: first search (inverts the postings) {first_s:.1f} s")
        parts = []
        for _ in range(reps[nq]):
            di, si, fi = hybrid(*batches[nq], parts)
        check(fi.shape == (nq, 10) and bool((fi >= 0).all()),
              f"scale batch {nq}: fused ids {fi}")
        check(bool((di[:, :10] >= 0).all()) and bool((si[:, 0] >= 0).any()),
              f"scale batch {nq}: empty arms")
        tot = [sum(p) for p in parts]
        med = [float(np.median([p[i] for p in parts])) for i in range(3)]
        timed[nq] = {"p50_ms": float(np.median(tot)) * 1e3,
                     "dense_ms": med[0] * 1e3, "sparse_ms": med[1] * 1e3,
                     "rrf_ms": med[2] * 1e3,
                     "queries_per_s": nq / float(np.median(tot))}
        log(f"scale batch {nq}: {reps[nq]} hybrid searches after 1 warm-up: "
            f"p50 {timed[nq]['p50_ms']:.2f} ms (dense {med[0] * 1e3:.2f}, "
            f"sparse {med[1] * 1e3:.2f}, rrf {med[2] * 1e3:.2f}) = "
            f"{timed[nq]['queries_per_s']:.1f} queries/s")
    q256, qt256, qw256 = batches[SCALE_BATCHES[-1]]
    busy, parts = {}, {}
    for nq in (SCALE_BATCHES[0], SCALE_BATCHES[-1]):
        busy[nq], parts[nq] = profile_once(
            lambda b=batches[nq]: hybrid(*b), f"one batch-{nq} hybrid search",
            timed[nq]["p50_ms"] / 1e3, show=("gemm", "topk", "Memcpy"))
        if not parts[nq]["gemm"]:  # the int8 product ran: events were lost
            log(f"profile: batch {nq}: no int8 product in the trace (the "
                "profiler lost its events): busy share not measured")
            busy[nq] = None
    # dense recall@10: the head of the int8 top-40 against exact top-10
    # from an index over the same host rows kept in f32 (K4 on the f16
    # rows widened exactly, the host refine's arithmetic)
    di = index.search_dense(q256, 40)[1]
    exact_index = DeviceIndex(
        dataclasses.replace(cfg, quantize_int8=False,
                            device_dtype=torch.float32), device=dev)
    exact_index.add(ids, dense)
    _, ei = exact_index.search_dense(q256, 10, exact=True)
    recall = float(np.mean([len(set(a[:10]) & set(b)) / 10
                            for a, b in zip(di, ei)]))
    launches = {n: _kernels.LAUNCHES[n] for n in SCALE_KERNELS}
    plain = dict(_kernels.PLAIN_ON_CUDA)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del exact_index
    pooled = run_pooled_topk(image, dense, q256, ei, dev)
    device_refine = run_device_refine(refine, dense, ids,
                                      {nq: b[0] for nq, b in batches.items()},
                                      ei, reps, dev)
    del refine
    # postings recall@40 against the ELL kernel over the same image
    qt16 = torch.from_numpy(qt256[:16]).to(dev)
    qw16 = torch.from_numpy(qw256[:16]).to(dev)
    _, oi = ell_topk(image["terms"], image["impacts"], qt16, qw16, k=40)
    si = index.search_sparse(qt256[:16], qw256[:16], 40)[1]
    oi = oi.cpu().numpy()
    p_recall = float(np.mean([len(set(a) & set(b)) / 40
                              for a, b in zip(si, oi)]))
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    log(f"scale: dense recall@10 (head of the int8 top-40 vs exact) "
        f"{recall:.4f}; postings recall@40 vs K3 over 16 queries "
        f"{p_recall:.4f}; peak device memory {peak_gb:.2f} GB, host peak "
        f"so far {rss_gb:.1f} GB; launches {launches}, plain twins on the "
        f"card {plain}")
    check(recall >= SCALE_MIN_RECALL, f"dense recall@10 {recall}")
    return {"launches": launches, "plain_on_cuda": plain,
            "batch1_p50_ms": timed[1]["p50_ms"],
            "batch256_queries_per_s": timed[256]["queries_per_s"],
            "timed": timed, "dense_recall_at_10": recall,
            "postings_recall_at_40_vs_ell": p_recall,
            "peak_device_gb": peak_gb, "host_peak_gb": rss_gb,
            "build_s": build_s, "save_s": save_s, "load_s": load_s,
            "image_s": image_s, "first_search_s": first_s,
            "checkpoint_gb": ckpt_gb,
            "batch1_device_busy_share": busy[SCALE_BATCHES[0]],
            "batch256_device_busy_share": busy[SCALE_BATCHES[-1]],
            "device_parts": parts,
            "device_refine": device_refine, "pooled_topk_int8": pooled}


def run_pooled_topk(image, dense, queries, exact_ids, dev) -> dict:
    """K6's own path on the scale image, with the counts from 0:
    `pooled_topk_int8` (the reference's composition around K6, which no
    store path calls in either package) at batch 256, k 40, refined against
    the rows' f16 copy on the card; recall@10 of its head against the exact
    f32 top-10 (K4)."""
    import numpy as np
    import torch

    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.pooled import pooled_topk_int8

    e_ref = torch.from_numpy(dense).to(dev)
    q = torch.from_numpy(queries).to(dev)
    q = torch.nn.functional.pad(q, (0, image["embs_i8"].shape[1] - q.shape[1]))
    e_ref = torch.nn.functional.pad(
        e_ref, (0, image["embs_i8"].shape[1] - e_ref.shape[1]))
    _kernels.reset_counts()
    args = (q, image["embs_i8"], image["embs_scale"], e_ref, 40)
    _, ids = pooled_topk_int8(*args, penalty=image["alive_penalty"])
    torch.cuda.synchronize()
    launches = _kernels.LAUNCHES["pooled_max"]
    plain = dict(_kernels.PLAIN_ON_CUDA)
    check(launches == 1 and not any(plain.values()),
          f"pooled_topk_int8: launches {launches}, plain {plain}")
    ms = cuda_ms(lambda: pooled_topk_int8(
        *args, penalty=image["alive_penalty"]), iters=5)
    ids = ids.cpu().numpy()
    recall = float(np.mean([len(set(a[:10]) & set(b)) / 10
                            for a, b in zip(ids, exact_ids)]))
    log(f"scale: pooled_topk_int8 (K6's path) at batch {q.shape[0]}, k 40: "
        f"{ms:.3f} ms, recall@10 {recall:.4f} against the exact f32 top-10; "
        f"K6 launched {launches}x, no twin")
    del e_ref
    return {"launches": launches, "ms": ms, "recall_at_10": recall}


def run_device_refine(index, dense, ids, queries: dict, exact_ids, reps: dict,
                      dev) -> dict:
    """The scale phase's checkpoint loaded a second time with
    `device_refine` (the reference's on-card int8 × int8 search): for each
    of REFINE_BLOCKS, `search_dense(k=40)` alone at batches 1, 64 and 256
    (p50 over `reps` after 1 warm-up), dense recall@10 of the head of the
    top-40 against the exact f32 top-10 (`exact_ids`, K4; recorded, not
    gated: the refine scores the dequantized rows) and the peak device
    memory (≤ 40 GB); no twin may run. Then, held: on the first
    REFINE_SLICE rows, one sweep and REFINE_SLICE_BLOCK-row blocks, the
    same search on the CPU at batch 64 gives scores within NEAR_TIE and the
    same ids."""
    import numpy as np
    import torch

    from rag_dpo_tpu_torch.index import DeviceIndex
    from rag_dpo_tpu_torch.ops import _kernels

    t_start = time.perf_counter()
    out = {}
    _kernels.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for blk in REFINE_BLOCKS:
        index.config = dataclasses.replace(index.config, sweep_block_rows=blk)
        timed = {}
        for nq, q in queries.items():
            index.search_dense(q, 40)  # warm-up; the first builds the image
            times = []
            for _ in range(reps[nq]):
                t0 = time.perf_counter()
                index.search_dense(q, 40)    # ids come back to the host
                times.append(time.perf_counter() - t0)
            p50 = float(np.median(times))
            timed[nq] = {"p50_ms": p50 * 1e3, "queries_per_s": nq / p50}
        di = index.search_dense(queries[SCALE_BATCHES[-1]], 40)[1]
        recall = float(np.mean([len(set(a[:10]) & set(b)) / 10
                                for a, b in zip(di, exact_ids)]))
        route = ("blockscan" if blk and blk < index.device_image()["n_pad"]
                 else "selfrefined (Q·n_pad within the budget at every "
                      "batch)")
        log(f"scale, device_refine, sweep_block_rows {blk} ({route}): "
            + "; ".join(f"batch {nq} p50 {t['p50_ms']:.2f} ms = "
                        f"{t['queries_per_s']:.1f} queries/s"
                        for nq, t in timed.items())
            + f"; dense recall@10 vs exact {recall:.4f}")
        out[f"sweep_block_rows_{blk}"] = {
            "route": route, "timed": timed,
            "batch1_p50_ms": timed[1]["p50_ms"],
            "batch256_queries_per_s": timed[256]["queries_per_s"],
            "dense_recall_at_10": recall}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plain = dict(_kernels.PLAIN_ON_CUDA)
    check(not any(plain.values()), f"a twin ran under device_refine: {plain}")
    check(peak_gb <= 40.0, f"device_refine peak device memory {peak_gb} GB")

    q64 = queries[64]
    same = {}
    for blk in (0, REFINE_SLICE_BLOCK):
        cfg = dataclasses.replace(index.config, sweep_block_rows=blk)
        got = {}
        for device in ("cpu", dev):
            part = DeviceIndex(cfg, device=device)
            part.add(ids[:REFINE_SLICE], dense[:REFINE_SLICE])
            got[str(device)] = part.search_dense(q64, 40)
        (cs, ci), (gs, gi) = got["cpu"], got[str(dev)]
        label = f"device_refine sweep_block_rows {blk}"
        gap = float(np.abs(gs - cs).max())
        check(gap <= NEAR_TIE, f"{label}: scores differ from the CPU's by "
              f"{gap}")
        differ = int((gi != ci).sum())
        check(not differ, f"{label}: {differ} ids differ from the CPU's")
        same[f"sweep_block_rows_{blk}"] = {"max_score_gap": gap}
    log(f"scale, device_refine: peak device memory {peak_gb:.2f} GB; no twin; "
        f"ids at batch 64 on {REFINE_SLICE} rows equal the CPU's ({same}); "
        f"{time.perf_counter() - t_start:.1f} s after the second load")
    return {**out, "peak_device_gb": peak_gb, "slice_vs_cpu": same}


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


def colbert_bucket(chunks) -> tuple[int, list[int]]:
    """The power-of-two bucket that covers the longest chunk's tokens (as
    the embedder tokenizes it), and every chunk's token count."""
    from rag_dpo_tpu_torch.models import EncoderConfig
    from rag_dpo_tpu_torch.tokenize import HashedTokenizer
    from rag_dpo_tpu_torch.tokenize.base import bucket_length

    tok = HashedTokenizer(vocab_size=EncoderConfig.bge_m3().vocab_size)
    texts = [c["text"] for c in chunks]
    lengths = []
    for i in range(0, len(texts), 512):
        lengths += tok.encode_batch(texts[i:i + 512], 8192).lengths.tolist()
    return bucket_length(max(lengths)), lengths


# ------------------------------------------------------- ingest, serve
def run_path(seed: int, dev, dataset, chunks, colbert_len: int) -> dict:
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
    embedder = Embedder(
        EmbedderConfig(model=BgeM3Config(encoder=encoder_cfg)),
        rng_seed=seed, device=dev)
    embedder.load()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index, stats, report = CorpusIndexer(
        embedder, with_colbert=True, colbert_len=colbert_len).build(chunks)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    dense = index._dense.astype(np.float32)
    check(len(index) == N_CHUNKS, f"index holds {len(index)} rows")
    check(np.isfinite(dense).all(), "non-finite dense vectors")
    norms = np.linalg.norm(dense, axis=1)
    check(np.allclose(norms, 1.0, atol=1e-2),
          f"dense norms in [{norms.min()}, {norms.max()}]")
    check(report.verification["self_retrieval_ok"], report.verification)
    cb = index.colbert_vectors([0, N_CHUNKS - 1])
    check(index._colbert.shape == (N_CHUNKS, colbert_len, 1024)
          and cb.dtype == np.float16 and np.isfinite(cb).all(),
          f"ColBERT store {index._colbert.shape} {cb.dtype}")
    store_gb = index._colbert.nbytes / 1e9
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    log(f"ingest: {N_CHUNKS} chunks / {N_DOCS} docs with ColBERT rows in "
        f"{ingest_s:.2f} s = {N_CHUNKS / ingest_s:.1f} chunks/s; ColBERT "
        f"store [{N_CHUNKS}, {colbert_len}, 1024] f16 = {store_gb:.2f} GB; "
        f"host peak resident memory so far {rss_gb:.1f} GB")

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
        times = timed_queries(stack.pipeline, questions)
        launches = dict(_kernels.LAUNCHES)
        plain = dict(_kernels.PLAIN_ON_CUDA)
        shapes = record_flash_shapes(stack.pipeline, questions[1])
        busy, _ = profile_once(lambda: stack.pipeline.query(questions[1]),
                               "one query", float(np.median(times)))
        check(reranker.calls and all(c.rerank_score is not None
                                     for out in reranker.calls for c in out),
              "a rerank fell back to the incoming order")
        log(f"serve: {N_QUESTIONS} queries after 1 warm-up: p50 "
            f"{np.median(times) * 1e3:.1f} ms, max {max(times) * 1e3:.1f} "
            f"ms; launches {launches}, plain twins on the card {plain}")
        agent = serve_agent(stack, questions, dev)
        concurrent = serve_concurrent(stack, questions, dev)
        maxsim = serve_maxsim(stack, questions, colbert_len)
    return {"launches": launches, "plain_on_cuda": plain,
            "embedder": embedder, "agent": agent, "concurrent": concurrent,
            "flash_shapes": shapes,
            "ingest_chunks_per_s": N_CHUNKS / ingest_s,
            "colbert_store_gb": store_gb, "ingest_host_peak_gb": rss_gb,
            "query_p50_ms": float(np.median(times) * 1e3),
            "query_max_ms": float(max(times) * 1e3),
            "query_device_busy_share": busy, "maxsim": maxsim}


def record_flash_shapes(pipeline, question) -> dict:
    """The encoders' attention shapes in one untimed query: the calls of
    each and its first call's lengths, for K1's timing at the serve phase's
    own shapes. Every call must be one of K1's launches."""
    from rag_dpo_tpu_torch.ops import _kernels, flash_attention_bwd

    shapes, forward = {}, flash_attention_bwd.flash_attention

    def recorded(q, k, v, lengths, *a, **kw):
        key = tuple(q.shape)
        if key not in shapes:
            shapes[key] = [0, lengths.clone()]
        shapes[key][0] += 1
        return forward(q, k, v, lengths, *a, **kw)

    before = _kernels.LAUNCHES["flash_fwd"]
    flash_attention_bwd.flash_attention = recorded
    try:
        pipeline.query(question)
    finally:
        flash_attention_bwd.flash_attention = forward
    check(sum(n for n, _ in shapes.values())
          == _kernels.LAUNCHES["flash_fwd"] - before,
          "the recorded attention calls are not K1's launches")
    return shapes


# ------------------------------------------------------ ingest pipeline
def changed_page(p: int, chunks: list[dict], grow: bool) -> str:
    """Page `p` as it reads after an update: every section's text new, and
    three sections fewer (so its stale chunks must go) or two more (the
    next page's first two)."""
    from rag_dpo_tpu_torch.evals.fake_site import page_sections, render_page

    mine = chunks[p::N_DOCS]
    sections = page_sections(mine + chunks[p + 1::N_DOCS][:2] if grow
                             else mine[:-3])
    return render_page(mine[0].get("title", ""), [
        (h, f"Mise à jour du 2 juin 2026, fiche {p}, section {j + 1} : {t}")
        for j, (h, t) in enumerate(sections)])


def python_bm25(texts) -> tuple:
    """The Python BM25 build the native runtime replaces: (stats, terms,
    impacts)."""
    from rag_dpo_tpu_torch.retrieval.bm25 import (
        build_bm25_stats,
        build_ell_corpus_tf,
        impacts_from_tf,
    )
    from rag_dpo_tpu_torch.tokenize.french import tokenize_french_text

    tokens = [tokenize_french_text(t) for t in texts]
    stats = build_bm25_stats(tokens)
    terms, tf, dl = build_ell_corpus_tf(tokens, stats, 32)
    return stats, terms, impacts_from_tf(tf, dl, stats)


def same_bm25(native_build, python_build) -> tuple:
    """Checks the native and the Python BM25 build against each other and
    returns (the largest relative gap of their impacts, the rows whose
    kept terms differ at the cut). The native pass rounds impacts from
    double (ROADMAP C-8) and numbers terms in first-seen order where the
    Python path sorts them; a row with more distinct terms than the ELL
    width keeps its best, the ties at the cut broken by term id, so the
    two may keep different terms of the cut's impact. Each row must hold
    the same impacts in order and the same terms above its cut."""
    import numpy as np

    (ns, nt, ni), (ps, pt, pi) = native_build, python_build
    check(set(ns.vocab) == set(ps.vocab) and ns.n_docs == ps.n_docs,
          "the native and the Python BM25 builds differ in vocabulary")
    to_native = np.full(len(ps.vocab) + 1, -1, np.int64)
    for term, pid in ps.vocab.items():
        to_native[pid] = ns.vocab[term]
    a = -np.sort(-np.where(nt >= 0, ni, 0), axis=1)
    b = -np.sort(-np.where(pt >= 0, pi, 0), axis=1)
    gap = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())
    full = (nt >= 0).all(1, keepdims=True)
    cut = np.where(full, a[:, -1:] * (1 + 1e-6), -np.inf)

    def above_cut(terms, impacts):
        keep = (terms >= 0) & (impacts > cut)
        return np.sort(np.where(keep, terms, np.iinfo(np.int64).max), 1)

    same = above_cut(nt.astype(np.int64), ni) == above_cut(
        np.where(pt >= 0, to_native[pt], -1), pi)
    check(same.all(), "the native and the Python BM25 builds keep different "
          "terms above a row's cut")
    return gap, int((np.sort(np.where(nt >= 0, nt, -1), 1) != np.sort(
        np.where(pt >= 0, to_native[pt], -1), 1)).any(1).sum())


def run_ingest_pipeline(dev, chunks, embedder) -> dict:
    """Phase 5b: the corpus as pages on a loopback site, crawled by the
    port's scraper with its own `default_fetch`, through the nine steps
    of `IngestPipeline` on the card, then an incremental update in which
    8 pages changed and the rest answer 304."""
    import torch

    from rag_dpo_tpu_torch import native
    from rag_dpo_tpu_torch.evals.fake_site import (
        FakeSite,
        page_path,
        render_pages,
    )
    from rag_dpo_tpu_torch.ingest import STEP_ORDER
    from rag_dpo_tpu_torch.ingest.pipeline import (
        IngestPipeline,
        PipelineContext,
    )
    from rag_dpo_tpu_torch.ingest.scraper import Scraper, ScraperConfig
    from rag_dpo_tpu_torch.ingest.update import IncrementalUpdater
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.providers import FakeLLMProvider
    from rag_dpo_tpu_torch.utils.paths import default_paths

    check(native.is_available(),
          f"the native runtime did not build: {native.build_error()}")
    pages = render_pages(chunks, N_DOCS)
    out: dict = {"n_pages": len(pages) - 1, "n_source_chunks": len(chunks)}
    with tempfile.TemporaryDirectory(prefix="ragdpo_ingest_") as tmp, \
            FakeSite(pages) as site:
        paths = default_paths(tmp).ensure()
        scraper = Scraper(paths.raw, ScraperConfig(scope_prefix=site.scope,
                                                   delay_s=0.0))
        t0 = time.perf_counter()
        crawl = scraper.crawl([site.root])
        out["crawl_s"] = time.perf_counter() - t0
        check(crawl["n_fetched"] == len(pages) and not crawl["n_failed"],
              f"the crawl fetched {crawl} of {len(pages)} pages")

        ctx = PipelineContext(paths=paths, llm=FakeLLMProvider(),
                              embedder=embedder)
        calls = dict(native.CALLS)
        _kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reports = IngestPipeline(ctx).run()
        torch.cuda.synchronize()
        out["pipeline_s"] = time.perf_counter() - t0
        out["launches"] = dict(_kernels.LAUNCHES)
        plain = dict(_kernels.PLAIN_ON_CUDA)
        out["native_calls"] = {k: v - calls[k]
                               for k, v in native.CALLS.items()}
        check(list(reports) == STEP_ORDER,
              f"the pipeline ran {list(reports)}")
        n_chunks = reports["chunk"]["n_chunks"]
        check(reports["index"]["n_indexed"] == n_chunks,
              f"indexed {reports['index']['n_indexed']} of {n_chunks}")
        check(reports["index"]["verification"]["self_retrieval_ok"],
              reports["index"]["verification"])
        check(out["native_calls"]["build_ell_corpus_native"] == 1,
              f"the ELL build did not take the native runtime once: "
              f"{out['native_calls']}")
        for name in ("flash_fwd", "fused_topk"):
            check(out["launches"][name] > 0,
                  f"{name} never launched in the ingest pipeline")
        check(not any(plain.values()),
              f"a twin ran in the ingest pipeline: {plain}")
        out["step_s"] = {k: r["seconds"] for k, r in reports.items()}
        out["reports"] = {k: {f: v for f, v in r.items()
                              if f not in ("seconds", "verification")}
                          for k, r in reports.items()}
        out["n_chunks"] = n_chunks
        out["n_docs"] = reports["dedup"]["n_kept"]
        out["index_chunks_per_s"] = n_chunks / reports["index"]["seconds"]
        log(f"ingest pipeline: {out['n_pages']} pages + the site map "
            f"crawled in {out['crawl_s']:.2f} s over loopback HTTP "
            f"(default_fetch); filter kept {reports['filter']['n_kept']}, "
            f"dropped {reports['filter']['n_dropped']}; {out['n_docs']} "
            f"docs after dedup ({reports['dedup']['n_duplicates']} "
            f"duplicates); {n_chunks} chunks of {len(chunks)} source chunks; "
            f"cleanup purged {reports['cleanup']['n_purged']}")
        log(f"ingest pipeline: nine steps in {out['pipeline_s']:.2f} s: "
            + ", ".join(f"{k} {s:.2f}" for k, s in out["step_s"].items())
            + f" s; index step {out['index_chunks_per_s']:.1f} chunks/s; "
            f"launches K1 {out['launches']['flash_fwd']}, K4 "
            f"{out['launches']['fused_topk']}, no twin; native calls "
            f"{out['native_calls']}")

        # the native BM25 build beside the Python path, on the same texts
        texts = [ctx.index.meta.row(i)["text"]
                 for i in range(ctx.index.n_rows)]
        t0 = time.perf_counter()
        nat = native.build_ell_corpus_native(texts, ell_width=32)
        out["bm25_native_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = python_bm25(texts)
        out["bm25_python_s"] = time.perf_counter() - t0
        out["bm25_max_rel_gap"], out["bm25_rows_cut_differently"] = \
            same_bm25(nat, py)
        check(out["bm25_max_rel_gap"] <= 1e-6,
              f"native and Python impacts differ by "
              f"{out['bm25_max_rel_gap']}")
        log(f"BM25 of {len(texts)} texts: native {out['bm25_native_s']:.3f} "
            f"s, Python {out['bm25_python_s']:.3f} s; impacts within "
            f"{out['bm25_max_rel_gap']:.2e} relative, the same terms above "
            f"each row's cut; {out['bm25_rows_cut_differently']} rows keep "
            f"other terms of the cut's impact")

        # the incremental update: 8 pages changed, the rest answer 304
        picks = [k * N_DOCS // 8 for k in range(8)]
        live = {cid for i, cid in enumerate(ctx.index.ids)
                if ctx.index._alive[i]}
        for k, p in enumerate(picks):
            site.set_page(page_path(p), changed_page(p, chunks, k % 2 == 1),
                          "Tue, 02 Jun 2026 08:00:00 GMT")
        _kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = IncrementalUpdater(scraper, ctx).update()
        torch.cuda.synchronize()
        out["update_s"] = time.perf_counter() - t0
        out["update_launches"] = dict(_kernels.LAUNCHES)
        check(not any(_kernels.PLAIN_ON_CUDA.values()),
              f"a twin ran in the update: {_kernels.PLAIN_ON_CUDA}")
        check(result["n_changed"] == 8 and result["n_failed"] == 0
              and result["n_unchanged"] == len(pages) - 8,
              f"the update saw {result}")
        keys = {f"fr_doc_{p}" for p in picks}
        fresh = [c for c in ctx.chunks if c["doc_key"] in keys]
        new_ids = {c["chunk_id"] for c in fresh}
        want = len(live) - result["n_stale_purged"] + len(new_ids - live)
        check(len(ctx.index) == want,
              f"{len(ctx.index)} live rows after the update, not {want}")
        q = embedder.embed([c["text"] for c in fresh])["dense"]
        scores, rows = ctx.index.search_dense(q, 2)
        missed = [(c["chunk_id"], ctx.index.ids[r[0]], float(sc[0]),
                   float(sc[1])) for c, r, sc in zip(fresh, rows, scores)
                  if ctx.index.ids[r[0]] != c["chunk_id"]]
        out["update_top1_margin_min"] = float((scores[:, 0]
                                               - scores[:, 1]).min())
        check(not missed, f"{len(missed)} of a changed page's chunks do not "
              f"retrieve themselves top-1 (wanted, got, scores): "
              f"{missed[:4]}")
        out["update"] = {k: v for k, v in result.items() if k != "changed"}
        out["n_update_chunks"] = len(fresh)
        out["host_peak_gb"] = (resource.getrusage(resource.RUSAGE_SELF)
                               .ru_maxrss / 1e6)
        check(out["host_peak_gb"] <= 48, f"host peak {out['host_peak_gb']} GB")
        log(f"ingest update: 8 pages changed ({result['n_chunks_updated']} "
            f"chunks, {result['n_stale_purged']} stale purged, "
            f"{len(new_ids - live)} new), {result['n_unchanged']} answered "
            f"304, in {out['update_s']:.2f} s; {len(ctx.index)} live rows; "
            f"each new chunk retrieves itself top-1; launches K1 "
            f"{out['update_launches']['flash_fwd']}, K4 "
            f"{out['update_launches']['fused_topk']}; site answers "
            f"{site.counts}; host peak resident memory {out['host_peak_gb']:.1f} "
            f"GB")
        out["site_counts"] = dict(site.counts)
        del ctx
    return out


def timed_queries(pipeline, questions) -> list[float]:
    """Answers every question (the first warms up); the others' seconds."""
    import torch

    times = []
    for i, question in enumerate(questions):
        t0 = time.perf_counter()
        resp = pipeline.query(question)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
        check(resp.error is None, resp.error)
        check(resp.sources, f"no sources for {question!r}")
        check(resp.answer.strip(), f"empty answer for {question!r}")
    return times


def default_config_stack(stack, dev, env: dict, embedder=None,
                         reranker=None):
    """`build_stack` of the shipped default config, with only
    `llm.base_url` (and `env`'s other knobs) set: the LLM from its factory
    (mode "local", the HTTP provider), both orchestrators, the batchers.
    The serve phase's loaded index and full-width encoders are injected:
    the default config names no checkpoint, and its cross-encoder would be
    the tiny one."""
    from rag_dpo_tpu_torch.bootstrap import build_stack
    from rag_dpo_tpu_torch.utils.config import load_config

    config = load_config(env=env)
    check(config.llm.mode == "local" and config.agent.enable,
          f"the default config is mode {config.llm.mode!r}, agent "
          f"{config.agent.enable}")
    return build_stack(config, stack.paths, index=stack.index,
                       embedder=embedder or stack.embedder,
                       reranker=reranker or stack.pipeline.reranker,
                       device=dev)


def record_llm_errors(llm) -> list:
    """Wraps the provider's generate and chat on the instance; the list
    fills with the in-band error of every call that failed (the query
    expander and the intent classifier would degrade quietly)."""
    errors = []
    for name in ("generate", "chat"):
        call = getattr(llm, name)

        def recording(*a, _call=call, **kw):
            resp = _call(*a, **kw)
            if resp.error:
                errors.append(resp.error)
            return resp

        setattr(llm, name, recording)
    return errors


def reranks_scored(calls) -> bool:
    """Every recorded rerank output carries its scores: the cross-encoder's
    fallback to the incoming order (on any error) would hide a fault."""
    return bool(calls) and all(c.rerank_score is not None
                               for out in calls for c in out)


def serve_agent(stack, questions, dev) -> dict:
    """Phase 6b: the default config's stack (`llm.mode="local"` against a
    loopback Ollama-protocol endpoint answering as the fake LLM, the agent
    on) answers the questions through `stack.active()`, the agent graph."""
    import numpy as np

    from rag_dpo_tpu_torch.agent import RAGAgentPipeline
    from rag_dpo_tpu_torch.evals.fake_ollama import FakeOllama
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.providers import HTTPLLMProvider

    reranker = stack.pipeline.reranker
    n_calls = len(reranker.calls)
    with FakeOllama() as ollama:
        agent_stack = default_config_stack(
            stack, dev, {"RAGDPO_LLM_BASE_URL": ollama.url})
        agent = agent_stack.active()
        llm_errors = record_llm_errors(agent_stack.llm)
        check(isinstance(agent, RAGAgentPipeline)
              and isinstance(agent_stack.llm, HTTPLLMProvider)
              and agent.graph.c.reranker is reranker,
              f"the default config's active() is {type(agent).__name__} "
              f"over {type(agent_stack.llm).__name__}")
        _kernels.reset_counts()
        times = timed_queries(agent, questions)
        launches = {n: _kernels.LAUNCHES[n] for n in SERVE_KERNELS}
        plain = dict(_kernels.PLAIN_ON_CUDA)
        trace = agent.query(questions[1]).extras["node_trace"]
        p50 = float(np.median(times))
        busy, _ = profile_once(lambda: agent.query(questions[1]),
                               "one agent query", p50)
        llm_requests = sum(path.startswith("/api/")
                           for path in ollama.paths)
    check(reranks_scored(reranker.calls[n_calls:]),
          "an agent rerank fell back to the incoming order")
    check(llm_requests > 0, "the agent's LLM calls did not go over HTTP")
    check(not llm_errors, f"LLM calls failed: {llm_errors[:3]}")
    log(f"serve, agent (default config): {N_QUESTIONS} queries after 1 "
        f"warm-up: p50 {p50 * 1e3:.1f} ms, max {max(times) * 1e3:.1f} ms; "
        f"{llm_requests} LLM requests over HTTP in all; node trace "
        f"{trace}; launches {launches}, plain twins on the card {plain}")
    return {"launches": launches, "plain_on_cuda": plain,
            "query_p50_ms": p50 * 1e3, "query_max_ms": max(times) * 1e3,
            "query_device_busy_share": busy, "node_trace": trace}


def concurrent_queries(agent, questions) -> tuple:
    """CONCURRENT_THREADS threads, released together, each asking every
    question once (thread i starting at question i); returns (seconds of
    each query, wall seconds). An exception in any thread fails the phase
    with that exception."""
    import threading

    import torch

    gate = threading.Barrier(CONCURRENT_THREADS + 1)
    times, errors = [], []

    def ask(i):
        gate.wait()
        try:
            for j in range(len(questions)):
                question = questions[(i + j) % len(questions)]
                t0 = time.perf_counter()
                resp = agent.query(question)
                times.append(time.perf_counter() - t0)
                if resp.error or not resp.sources or not resp.answer.strip():
                    raise RuntimeError(f"{question!r}: error {resp.error}, "
                                       f"{len(resp.sources)} sources")
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=ask, args=(i,))
               for i in range(CONCURRENT_THREADS)]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return times, wall


def serve_concurrent(stack, questions, dev) -> dict:
    """Phase 6c: `DeviceIndex.warm`, then CONCURRENT_THREADS threads ask
    the questions through the default config's agent, with batching off,
    then with `embedding.query_batch` and `retrieval.rerank_batch` at
    CONCURRENT_BATCH. Each coalesced query vector must equal its direct
    one within COALESCED_TOL and each question's fused ids those of the
    run with batching off; a batcher error or fallback fails the phase."""
    import numpy as np
    import torch

    from rag_dpo_tpu_torch.evals.fake_ollama import FakeOllama
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.providers import Embedder
    from rag_dpo_tpu_torch.retrieval.reranker import CrossEncoderReranker
    from rag_dpo_tpu_torch.serving import batcher_stats

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stack.index.warm(SCALE_BATCHES)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log(f"serve, concurrent: DeviceIndex.warm{SCALE_BATCHES} "
        f"{warm_s:.2f} s")
    # the batched run's own embedder and cross-encoder over the same
    # weights: batching, once on, stays on, and phase 7 reuses the others
    base = stack.pipeline.reranker
    embedder = Embedder(stack.embedder.config, device=dev)
    embedder.model = stack.embedder.model
    reranker = CrossEncoderReranker(config=base.config,
                                    model_config=base.model_config,
                                    device=dev)
    reranker.model = base.model
    out = {}
    with FakeOllama() as ollama:
        env = {"RAGDPO_LLM_BASE_URL": ollama.url}
        batched = {**env,
                   "RAGDPO_EMBEDDING_QUERY_BATCH": str(CONCURRENT_BATCH),
                   "RAGDPO_RETRIEVAL_RERANK_BATCH": str(CONCURRENT_BATCH)}
        # build_stack enables pair batching only on the reranker it builds
        # (as the JAX bootstrap does), so the injected one is enabled here
        reranker.enable_pair_batching(max_batch=CONCURRENT_BATCH)
        for label, stack_env, emb, rr in (
                ("off", env, None, None),
                ("on", batched, embedder, reranker)):
            run_stack = default_config_stack(stack, dev, stack_env,
                                             embedder=emb, reranker=rr)
            agent = run_stack.active()
            llm_errors = record_llm_errors(run_stack.llm)
            check((run_stack.embedder._query_batcher is not None)
                  == (label == "on")
                  and (agent.graph.c.reranker._pair_batcher is not None)
                  == (label == "on"),
                  f"batching {label}: the batchers are not as configured")
            fused, vectors, reranked = [], [], []
            retriever, scorer = agent.components.retriever, \
                agent.graph.c.reranker
            candidates, rerank, encode = (retriever.retrieve_candidates,
                                          scorer.rerank,
                                          run_stack.embedder.embed_queries)

            def recording_candidates(question, *a, **kw):
                got = candidates(question, *a, **kw)
                fused.append((question, [c.row for c in got]))
                return got

            def recording_rerank(*a, **kw):
                got = rerank(*a, **kw)
                reranked.append(got)
                return got

            def recording_encode(texts):
                got = encode(texts)
                vectors.append((list(texts), got))
                return got

            retriever.retrieve_candidates = recording_candidates
            scorer.rerank = recording_rerank
            run_stack.embedder.embed_queries = recording_encode
            agent.query(questions[0])   # the warm-up, as in 6b
            del fused[:], vectors[:], reranked[:]
            _kernels.reset_counts()
            times, wall = concurrent_queries(agent, questions[1:])
            launches = {n: _kernels.LAUNCHES[n] for n in SERVE_KERNELS}
            plain = dict(_kernels.PLAIN_ON_CUDA)
            del retriever.retrieve_candidates, scorer.rerank
            del run_stack.embedder.embed_queries
            check(reranks_scored(reranked),
                  f"batching {label}: a rerank fell back")
            check(not llm_errors,
                  f"batching {label}: LLM calls failed: {llm_errors[:3]}")
            n = len(times)
            run = {"queries": n, "queries_per_s": n / wall,
                   "p50_ms": float(np.median(times)) * 1e3,
                   "max_ms": max(times) * 1e3, "launches": launches,
                   "plain_on_cuda": plain}
            if label == "on":
                # each coalesced vector against the direct path's
                err = max(float(np.abs(got - stack.embedder.embed_queries(
                    texts)).max()) for texts, got in vectors)
                run["max_abs_vector_err"] = err
                run["query_batcher"] = batcher_stats(embedder._query_batcher)
                run["pair_batcher"] = batcher_stats(reranker._pair_batcher)
                check(err <= COALESCED_TOL,
                      f"a coalesced query vector is {err:.3g} from its "
                      f"direct one")
                check(run["query_batcher"]["mean_batch"] > 1
                      and run["query_batcher"]["n_device_calls"]
                      < run["query_batcher"]["n_requests"],
                      f"query encodes did not coalesce: "
                      f"{run['query_batcher']}")
                check(run["query_batcher"]["n_fallbacks"] == 0
                      and run["pair_batcher"]["n_fallbacks"] == 0,
                      "a coalesced batch failed and was rerun per caller")
            by_question = {}
            for question, rows in fused:
                by_question.setdefault(question, []).append(rows)
            run["fused"] = by_question
            out[label] = run
            log(f"serve, concurrent, batching {label}: {n} queries from "
                f"{CONCURRENT_THREADS} threads in {wall:.2f} s = "
                f"{n / wall:.2f} queries/s, p50 {run['p50_ms']:.1f} ms, max "
                f"{run['max_ms']:.1f} ms; launches {launches}, plain twins "
                f"{plain}"
                + (f"; query batcher {run['query_batcher']}, pair batcher "
                   f"{run['pair_batcher']}, max |coalesced - direct| "
                   f"{run['max_abs_vector_err']:.3g}" if label == "on"
                   else ""))
        embedder._query_batcher.close()
        reranker._pair_batcher.close()
    off, on = out["off"].pop("fused"), out["on"].pop("fused")
    check(set(off) == set(questions[1:]) and set(on) == set(off),
          "the runs did not retrieve for every question")
    differ = sorted(q for q in off
                    if any(rows != off[q][0] for rows in off[q] + on[q]))
    check(not differ, f"fused ids differ between the runs for {differ}")
    return {"warm_s": warm_s, **out}


def serve_maxsim(stack, questions, colbert_len: int) -> dict:
    """The same questions through `create_pipeline(use_maxsim=True)` over
    the stack's loaded index: MaxSim reranks the 40 candidates to 10."""
    import numpy as np

    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.rag import create_pipeline
    from rag_dpo_tpu_torch.retrieval.reranker import MaxSimReranker

    base = stack.pipeline
    pipe = create_pipeline(
        stack.index, stack.embedder, stack.llm, bm25_stats=stack.bm25_stats,
        retriever_config=base.retriever.config, use_maxsim=True,
        n_candidates=base.n_candidates, rerank_top_k=base.rerank_top_k)
    check(isinstance(pipe.reranker, MaxSimReranker),
          f"use_maxsim built {type(pipe.reranker).__name__}")
    calls = []
    rerank = pipe.reranker.rerank

    def recording(*a, **kw):  # keeps every rerank output
        out = rerank(*a, **kw)
        calls.append(out)
        return out

    pipe.reranker.rerank = recording
    _kernels.reset_counts()
    times = timed_queries(pipe, questions)
    launches = {n: _kernels.LAUNCHES[n] for n in MAXSIM_KERNELS}
    plain = dict(_kernels.PLAIN_ON_CUDA)
    check(calls and all(len(out) == base.rerank_top_k
                        and all(c.rerank_score is not None for c in out)
                        for out in calls),
          "a MaxSim rerank returned chunks without a rerank_score")
    p50 = float(np.median(times))
    busy, parts = profile_once(lambda: pipe.query(questions[1]),
                               "one MaxSim query", p50,
                               show=("Memcpy HtoD", "maxsim"))
    gathered_mb = base.n_candidates * colbert_len * 1024 * 2 / 1e6
    log(f"serve, MaxSim: {N_QUESTIONS} queries after 1 warm-up: p50 "
        f"{p50 * 1e3:.1f} ms, max {max(times) * 1e3:.1f} ms; per query "
        f"host-to-device copies {parts['Memcpy HtoD']:.3f} ms (the gathered "
        f"ColBERT rows are {gathered_mb:.1f} MB of them), K7 "
        f"{parts['maxsim']:.3f} ms; launches {launches}, plain twins on "
        f"the card {plain}")
    return {"launches": launches, "plain_on_cuda": plain,
            "query_p50_ms": p50 * 1e3, "query_max_ms": max(times) * 1e3,
            "query_device_busy_share": busy,
            "query_h2d_ms": parts["Memcpy HtoD"],
            "query_maxsim_device_ms": parts["maxsim"]}


def profile_once(fn, what: str, unprofiled_s: float, top: int = 8,
                 show: tuple = ("flash_",)) -> tuple:
    """`fn()` once more under torch.profiler: device time by kernel, and
    the card's busy share, taken of `unprofiled_s` (the same call's time
    without the profiler, which about doubles a train step's wall time).
    User annotations (such as the optimizer's `record_function` range)
    are not kernels and are left out of the sum. Returns the share and
    the device ms of the events whose name holds each string of `show`
    (copies included)."""
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
    parts = {name: sum(e.self_device_time_total for e in kernels
                       if name in e.key) / 1e3 for name in show}
    if not busy_us:
        log("profile: the profiler saw no device time")
        return None, parts
    share = busy_us / (unprofiled_s * 1e6)
    log(f"profile: {what}, wall {wall_us / 1e3:.1f} ms under the "
        f"profiler, device busy {busy_us / 1e3:.1f} ms = {share:.1%} of "
        f"the unprofiled {unprofiled_s * 1e3:.1f} ms")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    gemm_us = sum(e.self_device_time_total for e in ranked
                  if "gemm" in e.key.lower())
    log(f"  GEMMs {gemm_us / 1e3:.1f} ms ({gemm_us / busy_us:.1%}); "
        + ", ".join(f"{name} {ms:.3f} ms ({ms * 1e3 / busy_us:.1%})"
                    for name, ms in parts.items()))
    for i, e in enumerate(ranked):
        if i < top or any(name in e.key for name in show):
            log(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x "
                f"{e.key[:90]}")
    return share, parts


def run_hermetic(dev) -> dict:
    """The hermetic replay through the port on the card, with the
    committed trained encoder: the gate, then the MaxSim arm."""
    from rag_dpo_tpu_torch.evals.hermetic import (
        check_against_baseline,
        gated_values,
        run_hermetic_replay,
    )
    from rag_dpo_tpu_torch.evals.train_encoder import load_trained_params
    from rag_dpo_tpu_torch.ops import _kernels

    params = load_trained_params()
    out = {}
    for reranker, kernels in (("none", ("ell_topk", "fused_topk")),
                              ("maxsim", ("ell_topk", "fused_topk",
                                          "maxsim"))):
        _kernels.reset_counts()
        t0 = time.perf_counter()
        record = run_hermetic_replay(n_runs=1, encoder_params=params,
                                     reranker=reranker, device=dev)
        secs = time.perf_counter() - t0
        vals = gated_values(record)
        launches = {n: _kernels.LAUNCHES[n] for n in kernels}
        plain = dict(_kernels.PLAIN_ON_CUDA)
        check(record["reranker"] == reranker
              and all(0.0 <= v <= 1.0 for v in vals.values()),
              f"hermetic {reranker}: {record}")
        check(all(launches.values()), f"hermetic {reranker}: {launches}")
        check(not any(plain.values()), f"hermetic {reranker}: plain {plain}")
        if reranker == "none":
            failures = check_against_baseline(record)
            check(not failures, f"hermetic gate: {failures}")
        log(f"hermetic, trained encoder, reranker {reranker}: "
            f"{json.dumps(vals)} in {secs:.1f} s"
            + ("; gate OK against the committed trained records"
               if reranker == "none" else "; no committed series, not gated")
            + f"; launches {launches}")
        out[reranker] = {"gated": vals, "launches": launches, "seconds": secs}
    return out


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
    busy, _ = profile_once(lambda: step_fn(state, batch), "one train step",
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


def kernel_name(mangled: str) -> str:
    """`name<f32, 64>` of a kernel in an anonymous namespace, from its
    mangled name (the mangled name where it is not one); template
    arguments of type float / bf16 and int are read."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    i = m.end() + int(m.group(1))
    m = re.match(r"(\d+)", mangled[i:])
    if not m:
        return mangled
    j = i + m.end()
    name = mangled[j:j + int(m.group(1))]
    t = re.match(r"I((?:f|13__nv_bfloat16|Li\d+E|Lb[01]E)+)E",
                 mangled[j + int(m.group(1)):])
    if not t:
        return name
    args = [{"f": "f32", "13__nv_bfloat16": "bf16", "Lb0E": "false",
             "Lb1E": "true"}.get(a, n) for a, n in
            re.findall(r"(f|13__nv_bfloat16|Li(\d+)E|Lb[01]E)", t.group(1))]
    return f"{name}<{', '.join(args)}>"


def ptxas_report(text: str) -> list:
    """(kernel, its registers / spill / static shared memory) of a build's
    `-Xptxas -v` output; dynamic shared memory is the launch plan's."""
    out, kernel, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = kernel_name(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and kernel:
            out.append((kernel, line.split("info    :")[-1].strip()
                        + f"; {spill}"))
    return out


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
    log(f"max SM clock {sm_clock_hz() / 1e6:.0f} MHz (the exponentials' "
        f"bound)")

    from rag_dpo_tpu_torch.ops import _kernels

    build_s = _kernels.build_all()
    log(f"build: {build_s:.2f} s for {', '.join(_kernels.KERNELS)}; nvcc "
        + (", ".join(f"{src} {s:.2f} s" for src, s in
                     _kernels.BUILD_SECONDS.items())
           or "not run (libraries already built)"))
    for name, text in _kernels.BUILD_LOGS.items():
        for kernel, report in ptxas_report(text):
            log(f"  ptxas {name} {kernel}: {report}")

    dataset, chunks = build_corpus(args.seed, N_CHUNKS, N_DOCS)
    colbert_len, lengths = colbert_bucket(chunks)
    n_trunc = sum(n > colbert_len for n in lengths)
    log(f"corpus: {N_CHUNKS} chunks of {min(lengths)}-{max(lengths)} tokens "
        f"(mean {sum(lengths) / len(lengths):.1f}); ColBERT rows stored at "
        f"colbert_len {colbert_len}, which truncates {n_trunc} chunks")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    flash = check_flash(dev, gen)
    ell = check_ell(dev, gen)
    mx = check_maxsim(dev, gen, colbert_len)
    k4 = check_fused_topk(dev, gen)
    gc.collect()
    torch.cuda.empty_cache()
    k5 = check_fused_candidates(dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    k6 = check_pooled(dev, gen)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    floor = check_int8_floor(dev, args.seed)
    log(f"int8 floor phase: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    limits = check_former_limits(dev, gen)
    # before the serve phases: after them, the profiler lost the backward
    # kernels' events (device time not measured)
    flash_bwd = check_flash_bwd(dev, gen)
    gc.collect()
    torch.cuda.empty_cache()
    store_limits = run_store_limits(args.seed, dev)
    gc.collect()
    torch.cuda.empty_cache()

    scale = run_scale(args.seed, dev)
    for name in SCALE_KERNELS:
        check(scale["launches"][name] > 0, f"{name} never launched at scale")
    check(not any(scale["plain_on_cuda"].values()),
          f"a twin ran in the scale phase: {scale['plain_on_cuda']}")
    gc.collect()
    torch.cuda.empty_cache()

    path = run_path(args.seed, dev, dataset, chunks, colbert_len)
    embedder = path.pop("embedder")
    for name in SERVE_KERNELS:
        check(path["launches"][name] > 0, f"{name} never launched")
        check(path["plain_on_cuda"][name] == 0, f"{name} ran plain")
    for phase, launched in (
            ("agent", path["agent"]),
            ("concurrent, batching off", path["concurrent"]["off"]),
            ("concurrent, batching on", path["concurrent"]["on"])):
        for name in SERVE_KERNELS:
            check(launched["launches"][name] > 0,
                  f"{name} never launched in the {phase} serve phase")
        check(not any(launched["plain_on_cuda"].values()),
              f"a twin ran in the {phase} serve phase: "
              f"{launched['plain_on_cuda']}")
    for name in MAXSIM_KERNELS:
        check(path["maxsim"]["launches"][name] > 0,
              f"{name} never launched in the MaxSim serve phase")
    check(not any(path["maxsim"]["plain_on_cuda"].values()),
          f"a twin ran in the MaxSim serve phase: "
          f"{path['maxsim']['plain_on_cuda']}")
    gc.collect()  # the serve phase's models and index
    torch.cuda.empty_cache()
    ingest = run_ingest_pipeline(dev, chunks, embedder)
    del chunks, embedder
    gc.collect()
    torch.cuda.empty_cache()
    flash.update(time_serve_flash(dev, gen, path.pop("flash_shapes")))
    hermetic = run_hermetic(dev)
    gc.collect()
    torch.cuda.empty_cache()
    train = run_train(args.seed, dev)
    for name in TRAIN_KERNELS:
        check(train["launches"][name] > 0, f"{name} never launched")
        check(train["plain_on_cuda"][name] == 0, f"{name} ran plain")

    # the agent's and the concurrent phase's launches of the serve kernels
    serve_phase_launches = {
        name: {"agent_launches": path["agent"]["launches"][name],
               "concurrent_launches": path["concurrent"]["off"]["launches"][
                   name],
               "concurrent_batched_launches":
                   path["concurrent"]["on"]["launches"][name]}
        for name in SERVE_KERNELS}
    # the ingest pipeline's (phase 5b) and its update's launches of K1, K4
    ingest_launches = {
        name: {"ingest_pipeline_launches": ingest["launches"][name],
               "ingest_update_launches": ingest["update_launches"][name]}
        for name in ("flash_fwd", "fused_topk")}
    bwd_src = "rag_dpo_tpu_torch/csrc/flash_bwd.cu"
    bwd_mma = ("mma.sync m16n8k8 tf32 (f32: 3xTF32) + m16n8k16 bf16 (bf16 "
               "inputs; P and dS as hi + lo)")
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "rag_dpo_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "rag_dpo_tpu/ops/flash_attention_bwd.py:33",
         "instructions": "mma.sync m16n8k8 tf32 (f32: 3xTF32) + m16n8k16 "
                         "bf16 (bf16 inputs)",
         "launches": train["launches"]["flash_fwd"],
         "serve_launches": path["launches"]["flash_fwd"],
         **serve_phase_launches["flash_fwd"],
         **ingest_launches["flash_fwd"],
         **flash},
        {"name": "ell_topk", "route": "cuda",
         "source": "rag_dpo_tpu_torch/csrc/ell_topk.cu",
         "replaces": "rag_dpo_tpu/ops/sparse.py:71",
         "launches": path["launches"]["ell_topk"],
         "hermetic_launches": hermetic["maxsim"]["launches"]["ell_topk"],
         **serve_phase_launches["ell_topk"],
         **ell},
        {"name": "flash_bwd_dq", "route": "cuda", "source": bwd_src,
         "replaces": "rag_dpo_tpu/ops/flash_attention_bwd.py:81",
         "instructions": bwd_mma,
         "launches": train["launches"]["flash_bwd_dq"],
         **flash_bwd["flash_bwd_dq"]},
        {"name": "flash_bwd_dkv", "route": "cuda", "source": bwd_src,
         "replaces": "rag_dpo_tpu/ops/flash_attention_bwd.py:123",
         "instructions": bwd_mma,
         "launches": train["launches"]["flash_bwd_dkv"],
         **flash_bwd["flash_bwd_dkv"]},
        {"name": "maxsim", "route": "cuda",
         "source": "rag_dpo_tpu_torch/csrc/maxsim.cu",
         "replaces": "rag_dpo_tpu/ops/maxsim.py:43",
         "instructions": "mma.sync m16n8k8 tf32: f32 queries as big + "
                         "small (f32 rows 3xTF32), f16/bf16 rows exact; "
                         "one launch",
         "launches": path["maxsim"]["launches"]["maxsim"],
         "hermetic_launches": hermetic["maxsim"]["launches"]["maxsim"],
         **mx},
        {"name": "fused_topk", "route": "cuda",
         "source": "rag_dpo_tpu_torch/csrc/fused_topk.cu",
         "replaces": "rag_dpo_tpu/ops/topk.py:427",
         "launches": scale["launches"]["fused_topk"],
         "serve_launches": path["launches"]["fused_topk"],
         "maxsim_serve_launches":
             path["maxsim"]["launches"]["fused_topk"],
         "hermetic_launches": hermetic["none"]["launches"]["fused_topk"],
         **serve_phase_launches["fused_topk"],
         **ingest_launches["fused_topk"],
         **k4},
        {"name": "pooled_max", "route": "cuda",
         "source": "rag_dpo_tpu_torch/csrc/pooled.cu",
         "replaces": "rag_dpo_tpu/ops/pooled.py:44",
         "instructions": "wgmma m64nNQk16 bf16, A from registers: the int8 "
                         "rows widened once a block in the lanes that "
                         "multiply them (csrc/widen_product.cuh)",
         "launches": scale["pooled_topk_int8"]["launches"],
         "path": "ops.pooled.pooled_topk_int8 on the scale image",
         **k6},
        {"name": "fused_candidates", "route": "cuda",
         "source": "rag_dpo_tpu_torch/csrc/seg_candidates.cu",
         "replaces": "rag_dpo_tpu/ops/topk.py:136",
         **k5},
        *({"name": name, "route": "cuda",
           "source": "rag_dpo_tpu_torch/csrc/int8_block_max.cu",
           "replaces": f"benchmarks/bench_pallas_int8_matmul.py:{line}",
           "instructions": instructions, **floor[name]}
          for name, line, instructions in (
              ("int8_block_max_bf16", 38,
               "wgmma m64nNQk16 bf16, A from registers: the int8 rows "
               "widened once a block in the lanes that multiply them, the "
               "int8 queries once a block into shared memory "
               "(csrc/widen_product.cuh)"),
              ("int8_block_max_i8", 51,
               "wgmma m64nNQk32 s32.s8.s8, both operands in 128-byte-"
               "swizzled shared memory: the rows from the TMA ring of "
               "csrc/widen_product.cuh, the queries resident or streamed"))),
    ]
    maxsim = path["maxsim"]
    log(json.dumps({"kernels": kernels, "build_s": build_s,
                    "ingest_chunks_per_s": path["ingest_chunks_per_s"],
                    "colbert_len": colbert_len,
                    "colbert_store_gb": path["colbert_store_gb"],
                    "query_p50_ms": path["query_p50_ms"],
                    "query_max_ms": path["query_max_ms"],
                    "query_device_busy_share":
                        path["query_device_busy_share"],
                    **{f"maxsim_{k}": v for k, v in maxsim.items()
                       if k.startswith("query_")},
                    **{f"agent_{k}": v for k, v in path["agent"].items()
                       if k.startswith("query_")},
                    "concurrent_warm_s": path["concurrent"]["warm_s"],
                    **{f"ingest_pipeline_{k}": v for k, v in ingest.items()
                       if k not in ("launches", "update_launches",
                                    "reports")},
                    **{f"concurrent_{label}_{k}": v
                       for label in ("off", "on")
                       for k, v in path["concurrent"][label].items()
                       if k not in ("launches", "plain_on_cuda")},
                    **{f"scale_{k}": v for k, v in scale.items()
                       if k not in ("launches", "plain_on_cuda")},
                    "former_limit_cases": limits["cases"],
                    "store_limits": store_limits,
                    "hermetic_trained": hermetic["none"]["gated"],
                    "hermetic_trained_maxsim": hermetic["maxsim"]["gated"],
                    **{k: v for k, v in train.items()
                       if k.startswith("train_")}}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
