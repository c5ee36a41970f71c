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
   training shape and others (Dh 80 and 320 too); then the decoder's
   causal prefill attention (`flash_prefill`) at Mistral-Nemo-12B's 32
   query heads over 8 KV heads of 128 in bf16, prompts of 2,048, 4,096 and
   8,192 rows, against its plain twin in f32 on the same inputs; timed with
   CUDA events
   and the profiler, beside each kernel's bound and, where one PyTorch
   call computes the same function, that call's time and device time.
   Wherever the decoder runs on the card (6e, 6e′, 6f, 6g, 6h), every
   layer of a forward whose query rows fill the prefill kernel's 64-row
   tile must launch it, and every layer of any other forward (a decode
   step) must run its plain twin: `DecoderLayers` counts both from the
   forwards' inputs, and the phase checks the kernel counters against it;
3c. seeded init — `models/flax_init.py` on the card: its Triton draw
   (threefry bits) bit for bit against its twin (int64 torch ops) at
   counters past 2³² and in a weight's transposed order, both timed over
   the 12B's widest int8 kernel; then the tiny BGE-M3, the cross-encoder,
   the ViT + LLaVA projector and the tiny int8 decoder made from one seed
   on the card and on the CPU: uniforms bit-equal, f32 leaves within
   INIT_ULPS (2), int8 kernels equal but a share ≤ 1e-4 one off; the draw
   must launch;
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
   threads each ask 4 of the questions through the default config's agent,
   with batching off, then with `embedding.query_batch` and
   `retrieval.rerank_batch` at 64 (queries/s, p50, max, the batchers'
   stats): every coalesced query vector must lie within 1e-5 of its
   direct one, query encodes must coalesce (mean batch > 1), every
   question's fused ids must equal the run without batching, no batch may
   fail (an error in a batcher's thread reaches its callers and fails the
   phase), no rerank may fall back, K1, K3 and K4 must launch and no twin
   may run;
6d. serve, HTTP — the serve phase's encoders (made from `--seed`) are
   written to `TMPDIR` as HF snapshots: the BGE-M3 at BAAI/bge-m3's
   published widths in its layout (XLM-R tensor names, `pytorch_model.bin`
   in f32, `sparse_linear.pt`, `colbert_linear.pt`, `config.json`), the
   cross-encoder in `XLMRobertaForSequenceClassification`'s (`roberta.*`,
   `classifier.dense`, `classifier.out_proj`); `python -m
   rag_dpo_tpu_torch.models.convert_weights bge-m3` converts the first in
   a subprocess (seconds, npz bytes, its peak resident memory), the second
   loads through `CrossEncoderReranker.load_converted`; the app's
   `build_system` boots the default config with `embedding.checkpoint_path`
   set to the npz over the saved index (the serve phase's loaded copy and
   the converted cross-encoder injected), whose query vectors must lie
   within 1e-5 of an `Embedder` loaded from the snapshot in process and of
   the serve phase's (which built the index), its rerank scores within
   1e-5 of the serve phase's; then
   `app.server.serve` answers on loopback: /healthz names the card, 8
   /query after 1 warm-up with the in-process pipeline's sources and
   answers (p50 and max beside the in-process p50), a streamed /query,
   /search by texts, by vectors and through the binary route equal to the
   index's own search, 16 threads × 8 one-vector /search through the
   batcher (mean batch > 1, ids equal to the unbatched search),
   /v1/embeddings within 1e-5 of `embed_query`, /stats and /metrics; K1,
   K3 and K4 must launch and no twin may run; then `python -m
   rag_dpo_tpu_torch.app.cli eval --limit 2` boots the same npz over
   the saved index in a subprocess on the card;
6d′. serve, BF16 conversion (after 6d) — a synthetic BF16
   `MistralForCausalLM` snapshot at Mistral-Nemo-12B's published widths
   (5120, 32/8 heads of 128, FFN 14,336, vocab 131,072, the untied
   `lm_head`) but 1 and 2 layers, drawn on the card from `--seed` and
   written as safetensors by hand (the card's machine has no `safetensors`
   package), one file a layer; `convert_weights decoder --quantize-int8`
   converts each depth in a subprocess (seconds, peak resident memory,
   its per-layer slope extrapolated to 40 layers: under 48 GB); the
   2-layer npz must equal, bit for bit, the quantization done in this
   process from the tensors widened by torch; loaded as `llm.mode: tpu`
   loads a checkpoint, one prefill's logits must be finite and the bits of
   the in-process tree's model;
7. serve, MaxSim — `create_pipeline(use_maxsim=True)` over the same loaded
   index answers 8 questions, reranking 40 candidates to 10 by MaxSim over
   the stored ColBERT rows; K7 must launch and no twin may run;
6e. serve, generate (after 7, in the serve phase's temporary root) — (a)
   the tiny decoder on the card in f32, in bf16 with int8 weights and
   with the int8 KV cache: each cached greedy token within
   `DECODER_TOL` of the largest logit of one full forward over the prompt
   and the decoded tokens, and the speculative decode's tokens equal to
   greedy; (c) `build_stack` with `llm.mode="tpu"` and speculation on
   (the factory's Mistral-Nemo-12B: 40 layers at 5120, int8 projections,
   the tied f32 embedding, random init from `--seed` on the card) over
   the serve phase's index and encoders: 1 `pipeline.query` answer of at
   most 64 new tokens (p50 split into retrieval + rerank and generation;
   K1, K3 and K4 must launch, no twin), then one agent query through
   `stack.active()`, whose gates must call `choose()`; (b) the decoder's
   init seconds and bytes on the card, prefill at the answers' prompt
   lengths, decode at batches 1 and 8 over 128 new tokens beside the
   bytes bound (one step profiled), the speculative path's tokens a step
   and the phase's peak device memory;
6e′. judge (inside 6e, on its 12B) — `evals/judge_axis.py::
   run_judge_axis` over the first 8 questions of the hermetic v2 stack
   (the committed trained encoder, the extractive fake LLM) with the 12B
   as the judge in choose mode: every score non-None, every traced bucket
   one of the six and every veto "non" or "oui" (seconds a question, the
   mean); K3 and K4 must launch and no twin may run;
6f. serve, continuous (after 6e, its 12B freed) — (a) the slot pool
   (`serving/continuous.py`) of the tiny decoder in f32 and in bf16 with
   int8 weights and the int8 KV cache: 4 slots, 12 staggered requests,
   greedy and sampled, speculation, chunked prefill, a prefix cache on
   the card (f32) and in host memory (bf16), one preemption, one cancel,
   `logit_bias` and logprobs, then a deadline through the driver; each
   request equal to its solo `generate_ids` but at a near-tie of the solo
   run's logits within `DECODER_TOL` (ROADMAP C-29), prefix hits and a
   preemption counted; (c) `app.server.build_system` with
   `llm.mode: tpu, scheduler: continuous, max_batch: 8, prefix_cache: 4`
   (the 12B at its published widths, random init from `--seed`) over the
   serve phase's index and encoders, on loopback: 1 + 8 concurrent
   /query with answers of 16 new tokens (p50 and max; the pool's mean
   occupancy over them must exceed one slot; K1, K3 and K4 must launch,
   no twin), /stats' `decode_pool`, one /generate with `logprobs` and
   `logit_bias` and one chat completion with top-5 logprobs in JAX's
   response shapes; (b) the same pool alone: the 16 longest distinct of
   those RAG prompts in two waves of 8 streams of 32 new tokens from an
   empty prefix cache (aggregate tokens/s, engine steps, mean occupancy,
   time to first token and latency p50 and max, each wave's p50, prefix
   hits and the prompt tokens they skipped, peak device memory) beside
   6e's direct decode; one wave again with its admissions and decode
   dispatches timed, and under the profiler (the card's busy share);
6g. serve, vision (inside 6f, while its 12B pool is resident) — (a) the
   tiny LLaVA (`models/llava.py`: the CLIP tower of `models/vit.py`, the
   projector, the splice) on the card in f32 and in bf16 with int8
   decoder weights, from a seed, against the same weights on the CPU:
   projected patches (f32 and raw uint8 pixels) and the spliced prefix
   within `VISION_TOL` (f32) or `VISION_BF16_ULPS` bf16 ulps, every
   greedy token with an image within `DECODER_TOL` of one full forward's
   maximum, one image request in a 4-slot pool beside 3 text requests at
   its direct run (C-29); (c) `attach_vision()` on the pool's provider:
   CLIP-ViT-L/14-336 and the 1024 → 5120 → 5120 projector from key 0, as
   JAX's `LlavaGenerator.load` draws them;
   on loopback, one `/v1/chat/completions` with a 336×336 PNG as a
   `data:` URL, one streamed with a 480×320 PNG, then the first image
   again, streamed, while VISION_BESIDE text `/query` are in flight: its
   patches must come from the cache, the pool must hold more than one
   slot on average while it decodes, K1, K3 and K4 must launch and no twin
   may run; `ImageClassifier(vision_llm=...)` must return one of its
   labels; (b) the tower's encode at batch 1 cold, warm and as a cache
   hit beside its bound, the splice, the embeds prefill at its bucket
   beside its bound, each streamed request's time to first token split
   (compose, hand-off, slot wait, admitting step, delivery) and its
   tokens/s, and the phase's peak device memory;
6h. serve, mesh (after 6g, the pool freed; `parallel/`) — (a) NCCL at
   world size 1 (`initialize_multihost` on a free loopback port,
   `create_mesh(MeshSpec(shard=1))`): over the serve phase's 16,919 rows,
   `DeviceIndex(mesh=)`'s dense bf16 (K4), ELL, int8 and `device_refine`
   searches against the unsharded store on the card (ids equal, the ELL
   arm up to ties; scores within 1e-5; each timed beside it),
   `Embedder(mesh=)` against the plain embedder (1e-5), the encoder's
   `attention_impl="ring"` under `context_parallel` against "flash" at
   BGE-M3 widths (1e-5), and the Mistral-Nemo-12B (int8, random init from
   `--seed`) through `shard_params(decoder_flax_tree(model), mesh)` at
   model=1: 8 greedy tokens equal to the unsharded generator's; K1 and K4
   must launch, no twin; (b) 4 logical shards on the one card: the
   collectives' local halves (K4 on each row slice) and the merge against
   one K4 call; ring attention at [2, 16, 8192, 64] (lengths 6,000 and 0),
   K/V in 4 blocks of 2,048, per-block K1 + the lse merge against one K1
   call (f32 1e-5, bf16 2e-2), the length-0 row at JAX's value (the mean
   of the values), both timed; (c) the full-width BGE-M3 query vectors and
   the cross-encoder's scores of 40 candidates in bf16 against f32 within
   2e-2, their device times, and the query p50 of a stack with both
   encoders in bf16 beside f32's;
8. hermetic — the port's hermetic replay with the committed trained
   encoder must pass the gate against the committed trained records; then
   with the port's own seeded init (`encoder_params=None`, Flax's weights
   from the same seed, `models/flax_init.py`) against the committed
   random-init record; then its MaxSim arm. K3 and K4 (and K7 in the
   MaxSim arm) must launch and no twin may run;
8b. the learned-quality loop — `evals/train_encoder.py::train_and_replay`
   on the card from the Flax-equal init: 800 steps of the committed
   trained record's recipe (the tiny encoder, plain in-batch InfoNCE), its
   npz written and loaded back, the replay ×3 with it: the loss must fall,
   K3 and K4 launch with no twin, true_doc@5 beat the best committed
   random-init record; the trained gate's verdict is checked
   (LOOP_GATE_HELD);
9. train — contrastive training of a full-width BGE-M3 (f32, flash on) on
   16 pairs x 192 tokens with one mined hard negative each, through
   `train_retriever`: 2 steps and a checkpoint, then a resume to step 4;
   then 1 warm-up and 8 timed steps on one repeated batch, whose losses
   must be finite and fall. The flash forward and both backward kernels
   must launch, and no plain twin may run on the card.
9b. train, mesh — `make_sharded_train_step` at that width, 2 steps on
   one batch of 16 pairs x 192 tokens with hard negatives (lr 1e-4, no
   warmup), held to 2 steps of `make_train_step` from the same seeded
   weights (losses within rtol 1e-5; the last gradients within 1e-4 by
   norm; all but 1e-4 of the parameter elements within 1% of Σ lr + 1e-5
   relative, the key bias within Σ lr): (a) NCCL at world size 1 on
   phase 6h's group, `create_mesh(MeshSpec(data=1))`; (b) two ranks on
   the one card over gloo on CUDA tensors, spawned once, data=2 (global
   in-batch negatives) and model=2 (TP, 8 heads a rank), both ranks'
   parameters gathered whole. K1, K8 and K9 must launch in every rank and
   no twin may run; the step times are printed, the gloo ones marked as
   going through the host (not a multi-card number).
10. front doors — the Quick start's `python -m
   rag_dpo_tpu_torch.check_install` in a subprocess (exit 0, "Prêt.", its
   device program launching K4), then `python -m
   rag_dpo_tpu_torch.app.rag_cli --canned` in this process, on the demo
   stack and with `--index` over a saved copy of the demo index: 5/5
   answered each time, K4 launched, no twin (no K3 on either path, as in
   JAX: the demo's summary prefilter masks the sparse arm, which a small
   store scores in full, and `--index` has no BM25 arm). The seconds of
   the four phases of this kind (6d′, 6e′, 8b, 10) are printed together.

The second-to-last line is a JSON object with each kernel's launches in
the phase of the main path that runs it (serve for the ELL kernel, MaxSim
serve for K7, train for the flash kernels (with phase 9b's counts rank by
rank), scale for K4, and for K5, K6,
K10 and K11 their own paths: no store path calls them, as in the JAX
package; K1, K3 and K4 also with the agent's, the concurrent phase's,
the HTTP phase's, the continuous pool's, the vision phase's and the mesh
phase's counts, and
K1 and K4 with the
ingest pipeline's and its update's), its max abs
error against the twin, its times, its bound
and the library call's time; the last line is `{"ok": true, "device":
{...}}`. There is no CPU path.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import pathlib
import re
import resource
import struct
import subprocess
import sys
import tempfile
import threading
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
# the decoder's prefill attention: one prompt filling these rows
PREFILL_ROWS = (2048, 4096, 8192)
MAXSIM_KERNELS = ("flash_fwd", "ell_topk", "fused_topk", "maxsim")
# phase 6h (a): the mesh's entry points run K1 (encoders) and K4 (dense)
MESH_KERNELS = ("flash_fwd", "fused_topk")
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
# the questions each thread asks (cut from 8 so that the `cuda` tests and
# the whole smoke, phase 6e included, fit one 900 s chip call; from 4 to 2
# when phase 6g's image requests came)
CONCURRENT_QUESTIONS = 2
# phase 6e: the RAG answers' new tokens, and the decode measurement's new
# tokens and batches; the tiny decoder's cached greedy token may lie this
# far below its full forward's largest logit (f32: the order of sums; bf16
# activations: three bf16 ulps at the logits' magnitude, ~4)
# (cut from 64 and 128 to 32 and 64 when the BF16, judge, loop and
# front-door phases came: the retrieval step's own LLM calls decode up to
# GEN_NEW_TOKENS each)
GEN_NEW_TOKENS, DECODE_NEW_TOKENS, DECODE_BATCHES = 32, 64, (1, 8)
# the RAG answers of phase 6e (cut from 3 so that the `cuda` tests and the
# whole smoke, phase 6f included, keep a 900 s chip call's margin; from 2
# to 1, ~25 s, when phase 6g's image requests came)
GEN_ANSWERS = 1
# the questions of phase 6d's `cli eval` (cut from 4 to 2 for phase 6f's
# timed waves, then to 1 beside phases 3c and 8's random-init arm, so the
# smoke keeps its margin under 1,200 s on a slow host)
CLI_EVAL_LIMIT = 1
# phase 6f: the 12B pool's slots and prefix-cache entries, its two waves of
# requests and their new tokens, and the answers' new tokens of the
# concurrent /query
POOL_SLOTS, POOL_PREFIX, POOL_REQUESTS, POOL_NEW_TOKENS = 8, 4, 16, 32
POOL_QUERIES, POOL_ANSWER_TOKENS = 8, 16
DECODER_TOL = {"float32": 1e-4, "bfloat16": 0.1}
# phase 6g: the image requests' new tokens and the text /query in flight
# beside the third; the tiny LLaVA on the card against the CPU: f32 within
# VISION_TOL (only the order of sums differs), bf16 within VISION_BF16_ULPS
# ulps of the reference's largest value (each GEMM rounds its output to
# bf16 after summing in its own order; tests/test_torch_llava.py measured
# 2 ulps between JAX's compiled encode and the op-by-op one)
VISION_NEW_TOKENS, VISION_BESIDE = 32, 8
VISION_TOL, VISION_BF16_ULPS = 1e-4, 8
# phase 6d′: the synthetic BF16 snapshot's depths (the peak's per-layer
# slope between them is extrapolated to the published 40 layers), the
# loaded model's context, and the card machine's host memory limit
BF16_LAYERS, BF16_CONTEXT, HOST_LIMIT_GB = (1, 2), 4096, 48
# phase 6e′: the judge axis's questions on phase 6e's 12B (the full 48 are
# `python -m rag_dpo_tpu_torch.evals.judge_axis`, outside the smoke)
JUDGE_QUESTIONS = 8
# phase 8b: the learned-quality loop's recipe steps; whether its trained
# gate (each metric within its tolerance of the best committed trained
# record) is checked: from the Flax-equal init the loop trains the
# committed trained record's encoder (its gated values equal on the CPU
# and the card), so the gate holds (ROADMAP C-36, closed)
LOOP_STEPS, LOOP_GATE_HELD = 800, True
# the JAX package's committed random-init record (Flax's init, seed 0)
RANDOM_INIT_RECORD = "results_hermetic_20260820_143837.json"
# phase 3c: the same seed's weights on the card and on the CPU. Both run
# the same IEEE-rounded torch ops after the bits, the erfinv's log1p and
# sqrt in f64 rounded once to f32 (the card's f32 ones are an ulp off the
# CPU's): only a last bit of an f64 log1p could move an f32 rounding, so
# floats are held within 2 ulp; int8 kernels may be one off where an ulp
# moves a rounding tie
INIT_ULPS, INIT_DRAW_ULPS, INIT_INT8_OFF = 2, 2, 1e-4
# the threefry draw's int32 instructions an element: 20 rounds of an add,
# a rotate (one funnel shift) and a xor; 12 key adds; the counter's index
# arithmetic. They issue on the SM's 64 INT32 lanes a clock (Hopper; the
# guide's table has no integer rate off the tensor cores)
DRAW_OPS, INT32_LANES = 20 * 3 + 12 + 8, 64
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
TRAIN_PAIRS, TRAIN_SEQ, TIMED_STEPS = 16, 192, 8
# phase 9b: the sharded step's steps, its learning rate from the first step
# (the parameters move by ~1e-4 a step, so the Σ lr rule has something to
# hold and the second loss sees the first update), the two-rank layouts
# over gloo
MESH_TRAIN_STEPS, MESH_TRAIN_LR = 2, 1e-4
MESH_TRAIN_LAYOUTS = (("data2", {"data": 2}), ("model2", {"model": 2}))
MESH_TRAIN_DEADLINE_S = 420   # the two ranks, killed past it (a hang)
# phase 9b's gates against the one-rank step: the gradients' relative
# distance (f32, the same kernels, only sum orders differ: 5.1e-6 at
# data=2, 2.3e-5 at model=2, where every row product's sum is split) and
# the share of parameter elements past the Σ lr rule (`state_gap`): 2.6e-7
# and 1.05e-5 measured; a fault in a reduction or a slice sends ~half of
# the elements the wrong way
MESH_GRAD_TOL, MESH_PARAM_SHARE = 1e-4, 1e-4
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


def twins_on_the_card() -> dict:
    """The plain twins that ran on CUDA tensors, less the decoder's plain
    attention, which a decode step takes by design: `decoder_attention`
    checks its count."""
    from rag_dpo_tpu_torch.ops import _kernels

    return {n: c for n, c in _kernels.PLAIN_ON_CUDA.items()
            if n != "flash_prefill"}


class DecoderLayers:
    """The decoder's attention calls on the card, counted from each
    `DecoderModel` forward's inputs alone: every layer of a forward whose
    S · nh / nkv query rows fill the prefill kernel's tile should launch
    `flash_prefill`, every layer of any other (a decode step's 1 + k rows)
    should run the plain twin. A prefill that took the twin for any other
    reason (a dtype, a head width, a key mask) shows as a gap against
    `_kernels`' counters. `install` makes `_kernels.reset_counts` reset it
    too."""

    def __init__(self):
        self.lock = threading.Lock()
        self.kernel = self.plain = 0

    def reset(self) -> None:
        with self.lock:
            self.kernel = self.plain = 0

    def install(self) -> None:
        import inspect

        from rag_dpo_tpu_torch.models.decoder import DecoderModel
        from rag_dpo_tpu_torch.ops import _kernels
        from rag_dpo_tpu_torch.ops.causal_attention import TILE_ROWS

        forward, reset = DecoderModel.forward, _kernels.reset_counts
        signature = inspect.signature(forward)

        def counted(model, *args, **kwargs):
            out = forward(model, *args, **kwargs)
            given = signature.bind(model, *args, **kwargs).arguments
            x = given.get("inputs_embeds")
            x = given["input_ids"] if x is None else x
            if x.is_cuda:
                cfg = model.config
                group = cfg.num_heads // cfg.num_kv_heads
                with self.lock:
                    if x.shape[1] * group >= TILE_ROWS:
                        self.kernel += cfg.num_layers
                    else:
                        self.plain += cfg.num_layers
            return out

        def reset_both() -> None:
            reset()
            self.reset()

        DecoderModel.forward = counted
        _kernels.reset_counts = reset_both


DECODER_LAYERS = DecoderLayers()


def decoder_attention(phase: str) -> dict:
    """`flash_prefill`'s launches and its plain twin's calls on the card
    since the counters' reset, which must equal `DECODER_LAYERS`' count
    (the phase launched the kernel at least once)."""
    from rag_dpo_tpu_torch.ops import _kernels

    got = {"launches": _kernels.LAUNCHES["flash_prefill"],
           "plain_layers": _kernels.PLAIN_ON_CUDA["flash_prefill"]}
    with DECODER_LAYERS.lock:
        want = {"launches": DECODER_LAYERS.kernel,
                "plain_layers": DECODER_LAYERS.plain}
    check(got == want and got["launches"] > 0,
          f"phase {phase}: flash_prefill {got}, the decoder's forwards "
          f"asked {want}")
    return got


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


def check_prefill(dev, gen) -> dict:
    """The decoder's causal prefill attention at Mistral-Nemo-12B's heads
    (32 over 8 KV heads of 128, bf16), one prompt filling 2,048, 4,096
    and 8,192 rows: `flash_prefill` against `causal_attention_plain` in
    f32 on the same inputs within the `cuda` tests' tolerance (f32
    accuracy, then half a bf16 ulp for the one rounding), one launch a
    call; the kernel timed (CUDA events and the profiler) beside the twin
    as the decoder would run it (bf16 in, f32 inside) and beside its bound:
    the causal products 2·Dh·nh·n(n+1) at the bf16 peak, n·nh(n+1)/2
    exponentials, q, k, v and the output once."""
    import torch

    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.causal_attention import (
        causal_attention_plain,
        flash_prefill,
        kernel_rows,
    )

    nh, nkv, dh = 32, 8, 128
    out = {}
    for n in PREFILL_ROWS:
        q = torch.randn((1, n, nh, dh), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((1, n, nkv, dh), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        pos = torch.arange(n, device=dev)[None]
        rows = kernel_rows(pos, torch.ones((1, n), dtype=torch.bool,
                                           device=dev))
        before = _kernels.LAUNCHES["flash_prefill"]
        got = flash_prefill(q, k, v, *rows).float()
        want = causal_attention_plain(q.float(), k.float(), v.float(), pos)
        torch.cuda.synchronize()
        check(_kernels.LAUNCHES["flash_prefill"] == before + 1,
              "flash_prefill did not count its launch")
        err = (got - want).abs()
        check(bool((err <= 2.0 ** -8 * want.abs() + 1e-5).all()),
              f"flash_prefill at {n} rows: max abs err {float(err.max())}")
        flops = 2.0 * dh * nh * n * (n + 1)
        nbytes = 2.0 * n * dh * (2 * nh + 2 * nkv)
        row = {"max_abs_err": float(err.max()),
               "kernel_ms": cuda_ms(lambda: flash_prefill(q, k, v, *rows)),
               "kernel_device_ms": device_ms_tries(
                   lambda: flash_prefill(q, k, v, *rows)),
               "plain_ms": cuda_ms(
                   lambda: causal_attention_plain(q, k, v, pos), iters=3,
                   warmup=1),
               **bound(flops, nbytes, BF16_FLOPS,
                       exps=nh * n * (n + 1) / 2)}
        row["causal_tflops"] = flops / row["kernel_ms"] / 1e9
        log(f"flash_prefill [1,{n},{nh}/{nkv},{dh}] bf16: max_abs_err "
            f"{row['max_abs_err']:.3g}; kernel {row['kernel_ms']:.4f} ms "
            f"(device {fmt_ms(row['kernel_device_ms'])}, "
            f"{row['causal_tflops']:.1f} TFLOP/s of causal products), "
            f"plain {row['plain_ms']:.3f} ms; bound {row['bound_ms']:.4f} "
            f"ms ({row['bound_by']})")
        out.update({f"rows_{n}_{key}": x for key, x in row.items()})
        del q, k, v, got, want
    return out


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
        served = serve_http(stack, questions, dev, seed, pathlib.Path(tmp))
        gc.collect()  # the converted encoders
        torch.cuda.empty_cache()
        bf16 = convert_bf16(seed, dev, pathlib.Path(tmp))
        gc.collect()
        torch.cuda.empty_cache()
        maxsim = serve_maxsim(stack, questions, colbert_len)
        generate = serve_generate(stack, questions, dev, seed)
        gc.collect()  # the 12B decoder
        torch.cuda.empty_cache()
        continuous = serve_continuous(stack, questions, dev, seed,
                                      pathlib.Path(tmp), generate["decode"])
        gc.collect()  # the 12B pool
        torch.cuda.empty_cache()
        mesh = serve_mesh(stack, questions, dev, seed)
    return {"launches": launches, "plain_on_cuda": plain,
            "generate": generate, "continuous": continuous, "mesh": mesh,
            "embedder": embedder, "agent": agent, "concurrent": concurrent,
            "http": served, "bf16": bf16,
            "flash_shapes": shapes,
            "ingest_chunks_per_s": N_CHUNKS / ingest_s,
            "colbert_store_gb": store_gb, "ingest_host_peak_gb": rss_gb,
            "query_p50_ms": float(np.median(times) * 1e3),
            "query_max_ms": float(max(times) * 1e3),
            "query_device_busy_share": busy, "maxsim": maxsim}


MESH_SHARDS = 4          # phase 6h (b): logical shards on the one card
MESH_K = 40
# phase 6h (b): the ring's shape, one batch row of length 6,000 and one of 0
RING_SHAPE = (2, 16, 8192, 64)
RING_LENGTHS = (6000, 0)
MESH_NEW_TOKENS = 8
BF16_TOL = 2e-2          # phase 6h (c): bf16 encoders against f32 (C-5)


def mesh_index(index, mesh, **cfg):
    """A `DeviceIndex` over the serve phase's host rows (the arrays shared,
    not copied; no ColBERT rows), its config with `cfg` over it,
    row-sharded over `mesh` (None: the card alone)."""
    from rag_dpo_tpu_torch.index import DeviceIndex

    config = dataclasses.replace(index.config, colbert_dim=0, colbert_len=0,
                                 **cfg)
    out = DeviceIndex(config, device=index.device if mesh is None else None,
                      mesh=mesh)
    for name in ("ids", "_id_pos", "meta", "_dense", "_terms", "_impacts",
                 "_tf", "_dl", "_alive", "bm25_stats"):
        setattr(out, name, getattr(index, name))
    return out


def sharded_refine_alone(index, queries, k: int) -> tuple:
    """The sharded `device_refine` search's algorithm on the card alone,
    what `_sharded_int8` computes at world size 1: the int8 sweep's f32
    top-4k (`approx_topk_int8`), then `dequant_refine`. The unsharded
    store's own `device_refine` (`approx_topk_int8_selfrefined`) picks its
    4k candidates on bf16 scores, as JAX's does: where many rows score
    within a bf16 ulp of its cut it keeps other rows, so it is another
    approximation, not this one."""
    import torch

    from rag_dpo_tpu_torch.ops.quantize import (
        approx_topk_int8,
        dequant_refine,
        quantize_rows,
    )

    img = index.device_image()
    qf = index._queries(queries, torch.float32)
    q_i8, q_scale = quantize_rows(qf)
    s, i = approx_topk_int8(q_i8, q_scale, img["embs_i8"], img["embs_scale"],
                            min(4 * k, img["n_pad"]), oversample=1,
                            penalty=img["alive_penalty"])
    return index._finish(*dequant_refine(qf, img["embs_i8"],
                                         img["embs_scale"], s, i, k), k)


def same_ranking(got, want, what: str, tol: float = NEAR_TIE) -> float:
    """Two (scores, ids) top-k lists equal up to ties: scores rank for
    rank within `tol`, and in each row the same ids above the last score's
    tie group (ids within a group of equal scores may come in any order,
    and the group at the cut may be cut elsewhere); → the largest score
    difference."""
    import numpy as np

    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    (gs, gi), (ws, wi) = ((host(s), host(i)) for s, i in (got, want))
    err = float(np.abs(gs - ws).max())
    check(err <= tol, f"{what}: scores differ by {err}")
    for row in range(ws.shape[0]):
        cut = ws[row, -1] + tol
        check(set(gi[row][gs[row] > cut]) == set(wi[row][ws[row] > cut]),
              f"{what}: row {row} ids differ away from a tie")
    return err


def serve_mesh(stack, questions, dev, seed: int) -> dict:
    """Phase 6h: the mesh (`parallel/`, after 6g, its pool freed). (a) NCCL
    at world size 1: `initialize_multihost` on a free loopback port and
    `create_mesh(MeshSpec(shard=1))`; over the serve phase's rows, the
    row-sharded store's dense bf16, ELL, int8 and `device_refine` searches
    against the unsharded store on the card (ids equal, scores within
    1e-5, each timed beside it; the `device_refine` arm against its own
    algorithm on the card alone, `sharded_refine_alone`, since the store's
    own refine picks its candidates on bf16 scores, as JAX's does: their
    overlap is logged), `Embedder(mesh=)` against the plain
    embedder (1e-5), the encoder's `attention_impl="ring"` at BGE-M3
    widths under `context_parallel` against "flash" (1e-5), and the
    Mistral-Nemo-12B (int8, random init from `--seed`) through
    `shard_params(decoder_flax_tree(model), mesh)` at model=1: 8 greedy
    tokens equal to the unsharded generator's; K1 and K4 must launch there,
    the decoder's attention as `decoder_attention` checks it, and no other
    twin may run. (b) MESH_SHARDS logical shards on the one card:
    the collectives' local halves (K4 with the penalty on each row slice)
    and the merge against one K4 call over all rows; the ring at
    RING_SHAPE (one row of length 6,000, one of 0), K/V in MESH_SHARDS
    blocks of 2,048: per-block K1 + the lse merge against one K1 call (f32
    1e-5, bf16 2e-2), the length-0 row at JAX's value (the mean of the
    values), both timed. (c) bf16: the full-width BGE-M3 query encode and
    the cross-encoder's scores of one question's 40 candidates against
    f32 within BF16_TOL, their device times, and the query p50 through a
    stack with both encoders in bf16 beside f32's."""
    import numpy as np
    import torch
    import torch.distributed

    from rag_dpo_tpu_torch.bootstrap import build_stack
    from rag_dpo_tpu_torch.evals.synthetic import ExtractiveFakeLLM
    from rag_dpo_tpu_torch.models import BgeM3Model, CrossEncoderModel
    from rag_dpo_tpu_torch.models.decoder import (
        DecoderConfig,
        decoder_flax_tree,
    )
    from rag_dpo_tpu_torch.models.encoder import TransformerEncoder
    from rag_dpo_tpu_torch.models.generate import (
        SamplingConfig,
        TextGenerator,
    )
    from rag_dpo_tpu_torch.models.sharding import shard_params
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.flash_attention import flash_attention
    from rag_dpo_tpu_torch.ops.ring_attention import ring_attention_blocks
    from rag_dpo_tpu_torch.ops.topk import fused_topk
    from rag_dpo_tpu_torch.parallel import (
        MeshSpec,
        context_parallel,
        create_mesh,
        initialize_multihost,
    )
    from rag_dpo_tpu_torch.parallel.collectives import local_topk, merge_topk
    from rag_dpo_tpu_torch.parallel.mesh import free_port
    from rag_dpo_tpu_torch.providers import Embedder
    from rag_dpo_tpu_torch.retrieval.reranker import CrossEncoderReranker

    t_phase = time.perf_counter()
    out: dict = {}
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0)
    mesh = create_mesh(MeshSpec(shard=1))
    check(mesh.device_type == "cuda", f"mesh on {mesh.device_type}")
    index, emb = stack.index, stack.embedder
    qs = questions[:8]
    q_dense = emb.embed_queries(qs)
    pairs = [index.bm25_stats.query_terms(q, 16) for q in qs]
    qt, qw = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    # (a) the entry points over NCCL at world size 1
    _kernels.reset_counts()
    arms = {}
    for label, cfg in (("bf16", {}), ("int8", dict(quantize_int8=True)),
                       ("int8_refine", dict(quantize_int8=True,
                                            device_refine=True))):
        sharded, base = mesh_index(index, mesh, **cfg), \
            mesh_index(index, None, **cfg)
        searches = [("dense", lambda i: i.search_dense(q_dense, MESH_K))]
        if label == "bf16":
            searches.append(("sparse", lambda i: i.search_sparse(
                qt, qw, MESH_K)))
        for name, fn in searches:
            got, want = fn(sharded), fn(base)
            extra = {}
            if label == "int8_refine":
                # the store's own refine is another approximation (bf16
                # candidates): its overlap with the sharded ids is logged
                extra["store_refine_overlap"] = float(np.mean([
                    len(set(g) & set(w)) / len(w)
                    for g, w in zip(got[1], want[1])]))
                want = sharded_refine_alone(base, q_dense, MESH_K)
            if name == "sparse":
                # the sharded ELL arm is a stable top-k (JAX's lax.top_k),
                # the unsharded K3 keeps C-1's order among equal scores
                err = same_ranking(got, want, f"6h {label} {name}")
            else:
                check(np.array_equal(got[1], want[1]),
                      f"6h {label} {name}: sharded ids differ")
                err = float(np.abs(got[0] - want[0]).max())
                check(err <= NEAR_TIE,
                      f"6h {label} {name}: scores differ by {err}")
            arms[f"{label}_{name}"] = {
                "max_abs_err": err, **extra,
                "sharded_ms": cuda_ms(lambda: fn(sharded), iters=5),
                "unsharded_ms": cuda_ms(lambda: fn(base), iters=5)}
        del sharded, base
    dp = Embedder(emb.config, tokenizer=emb.tokenizer, mesh=mesh)
    dp.model = emb.model
    texts = [stack.pipeline.retriever.chunk_text(r) for r in range(16)]
    dp_err = float(np.abs(dp.embed(texts)["dense"]
                          - emb.embed(texts)["dense"]).max())
    check(dp_err <= 1e-5, f"6h DP embed differs by {dp_err}")
    enc = emb.model.encoder
    ring_enc = TransformerEncoder(dataclasses.replace(
        enc.config, attention_impl="ring")).to(dev).eval()
    ring_enc.load_state_dict(enc.state_dict())
    tok = emb.tokenizer.encode_batch(qs, 512)
    seq = int(tok.lengths.max())
    ids = torch.from_numpy(tok.input_ids[:, :seq].astype(np.int64)).to(dev)
    lens = torch.from_numpy(tok.lengths.astype(np.int32)).to(dev)
    with torch.inference_mode():
        flash_h = enc(ids, lens)
        with context_parallel(mesh):
            ring_h = ring_enc(ids, lens)
    ring_err = float((ring_h - flash_h).abs().max())
    check(ring_err <= 1e-5, f"6h ring encoder differs by {ring_err}")
    del ring_enc, flash_h, ring_h
    gc.collect()
    torch.cuda.empty_cache()
    cfg12 = dataclasses.replace(DecoderConfig.mistral_nemo_12b(),
                                quantize_weights=True, tie_embeddings=True)
    gen = TextGenerator(cfg12, rng_seed=seed, device=dev)
    t0 = time.perf_counter()
    tp = TextGenerator(cfg12, params=shard_params(
        decoder_flax_tree(gen.load()), mesh), device=dev)
    tp.load()
    torch.cuda.synchronize()
    tp_build_s = time.perf_counter() - t0
    prompt = np.random.default_rng(seed).integers(
        4, cfg12.vocab_size, (1, 64)).astype(np.int32)
    sampling = SamplingConfig(temperature=0.0,
                              max_new_tokens=MESH_NEW_TOKENS, eos_id=-1)
    t0 = time.perf_counter()
    want_tok = gen.generate_ids(prompt, np.asarray([64]), sampling)
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_tok = tp.generate_ids(prompt, np.asarray([64]), sampling)
    tp_s = time.perf_counter() - t0
    check(np.array_equal(got_tok, want_tok),
          f"6h TP 12B tokens {got_tok} != {want_tok}")
    launches = dict(_kernels.LAUNCHES)
    plain = twins_on_the_card()
    attention = decoder_attention("6h")
    del gen, tp
    gc.collect()
    torch.cuda.empty_cache()
    log(f"mesh (a): NCCL world 1; sharded store {json.dumps(arms)}; DP "
        f"embed err {dp_err:.2e}; ring encoder err {ring_err:.2e}; TP 12B "
        f"(model=1) built in {tp_build_s:.2f} s, {MESH_NEW_TOKENS} greedy "
        f"tokens equal: {got_tok.tolist()} ({tp_s:.2f} s; unsharded "
        f"{plain_s:.2f} s); launches {launches}, twins {plain}")
    out.update(launches=launches, plain_on_cuda=plain,
               prefill_attention=attention, store=arms,
               dp_embed_err=dp_err, ring_encoder_err=ring_err,
               tp_12b_tokens_s=tp_s, tp_12b_plain_s=plain_s)

    # (b) logical shards on the one card
    base = mesh_index(index, None)
    img = base.device_image()
    q = base._queries(q_dense)
    per = img["n_pad"] // MESH_SHARDS

    def logical():
        halves = [local_topk(*fused_topk(
            q, img["embs"][j * per:(j + 1) * per], MESH_K,
            penalty=img["alive_penalty"][j * per:(j + 1) * per]), MESH_K,
            torch.arange(j * per, (j + 1) * per, dtype=torch.int32,
                         device=dev)) for j in range(MESH_SHARDS)]
        return merge_topk(torch.stack([h[0] for h in halves], 1),
                          torch.stack([h[1] for h in halves], 1), MESH_K)

    def whole():
        return fused_topk(q, img["embs"], MESH_K,
                          penalty=img["alive_penalty"])

    merge_err = same_ranking(logical(), whole(), "6h logical shards")
    out["logical_shards"] = {"max_abs_err": merge_err,
                             "ms": cuda_ms(logical),
                             "whole_ms": cuda_ms(whole)}
    del base, img
    gen_r = torch.Generator(device=dev).manual_seed(seed)
    ring = {}
    for dt, tol in (("float32", FLASH_TOL["float32"]),
                    ("bfloat16", BF16_TOL)):
        qkv = [torch.randn(RING_SHAPE, generator=gen_r, device=dev).to(
            getattr(torch, dt)) for _ in range(3)]
        lens_r = torch.tensor(RING_LENGTHS, device=dev)
        blocks = ring_attention_blocks(*qkv, lens_r, MESH_SHARDS)
        one = flash_attention(*qkv, lens_r)
        err = float((blocks[0].float() - one[0].float()).abs().max())
        mean_v = qkv[2][1].float().mean(dim=1, keepdim=True)
        empty_err = float((blocks[1].float() - mean_v).abs().max())
        check(err <= tol, f"6h ring {dt}: blocks vs one K1 differ by {err}")
        check(empty_err <= tol, f"6h ring {dt}: the length-0 row is "
              f"{empty_err} from the mean of the values")
        ring[dt] = {"max_abs_err": err, "empty_row_err": empty_err,
                    "blocks_ms": cuda_ms(lambda: ring_attention_blocks(
                        *qkv, lens_r, MESH_SHARDS), iters=10),
                    "one_k1_ms": cuda_ms(lambda: flash_attention(
                        *qkv, lens_r), iters=10),
                    **flash_fwd_bound(qkv[0], lens_r)}
        del qkv, blocks, one
    out["ring"] = ring
    log(f"mesh (b): {MESH_SHARDS} logical shards {out['logical_shards']}; "
        f"ring {RING_SHAPE} lengths {RING_LENGTHS}: {json.dumps(ring)}")

    # (c) the encoders in bf16 against f32
    ecfg16 = dataclasses.replace(enc.config, dtype=torch.bfloat16)
    m3cfg16 = dataclasses.replace(emb.config.model, encoder=ecfg16)
    e16 = Embedder(dataclasses.replace(emb.config, model=m3cfg16),
                   tokenizer=emb.tokenizer, device=dev)
    with torch.device(dev):
        e16.model = BgeM3Model(m3cfg16).eval()
    e16.model.load_state_dict(emb.model.state_dict())
    rr = stack.pipeline.reranker
    rr.load()
    r16 = CrossEncoderReranker(config=rr.config, model_config=ecfg16,
                               device=dev, tokenizer=rr.tokenizer)
    with torch.device(dev):
        r16.model = CrossEncoderModel(
            ecfg16, with_head_dense=rr.model.with_head_dense).eval()
    r16.model.load_state_dict(rr.model.state_dict())
    dense_err = float(np.abs(e16.embed_queries(qs) - q_dense).max())
    _, rows = index.search_dense(q_dense[:1], 40)
    cand = [(qs[0], stack.pipeline.retriever.chunk_text(int(r)))
            for r in rows[0] if r >= 0]
    cross_err = float(np.abs(r16.score_pairs(cand)
                             - rr.score_pairs(cand)).max())
    check(dense_err <= BF16_TOL, f"6h bf16 query vectors differ by "
          f"{dense_err}")
    check(cross_err <= BF16_TOL, f"6h bf16 cross scores differ by "
          f"{cross_err}")
    enc_ms = {"float32": cuda_ms(lambda: emb.embed_queries(qs[:1])),
              "bfloat16": cuda_ms(lambda: e16.embed_queries(qs[:1]))}
    cross_ms = {"float32": cuda_ms(lambda: rr.score_pairs(cand), iters=5),
                "bfloat16": cuda_ms(lambda: r16.score_pairs(cand),
                                    iters=5)}
    p50 = {}
    for dt, (e, r) in (("float32", (emb, rr)), ("bfloat16", (e16, r16))):
        s = build_stack(paths=stack.paths, llm=ExtractiveFakeLLM(),
                        index=index, embedder=e, reranker=r, device=dev)
        p50[dt] = float(np.median(timed_queries(s.pipeline, qs)) * 1e3)
    out["bf16"] = {"query_vector_err": dense_err, "cross_score_err": cross_err,
                   "query_encode_ms": enc_ms, "cross_40_pairs_ms": cross_ms,
                   "query_p50_ms": p50}
    log(f"mesh (c): bf16 against f32: {json.dumps(out['bf16'])}")
    del e16, r16
    gc.collect()
    torch.cuda.empty_cache()
    # the NCCL group of one stays up for phase 9b (a), which destroys it
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"mesh phase: {out['phase_s']:.1f} s")
    return out


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
    asked = questions[1:CONCURRENT_QUESTIONS + 1]
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
            times, wall = concurrent_queries(agent, asked)
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
    check(set(off) == set(asked) and set(on) == set(off),
          "the runs did not retrieve for every question")
    differ = sorted(q for q in off
                    if any(rows != off[q][0] for rows in off[q] + on[q]))
    check(not differ, f"fused ids differ between the runs for {differ}")
    return {"warm_s": warm_s, **out}


# the port's encoder parameters → their XLM-R names (the inverse of
# `models/convert.py::convert_xlmr_state_dict`; torch Linear weights are
# [out, in] in both)
XLMR_NAMES = (
    (r"(word|position|token_type)_embeddings\.", r"embeddings.\1_embeddings."),
    (r"embeddings_norm\.", "embeddings.LayerNorm."),
    (r"layer_(\d+)\.attention\.(query|key|value)\.",
     r"encoder.layer.\1.attention.self.\2."),
    (r"layer_(\d+)\.attention\.output\.",
     r"encoder.layer.\1.attention.output.dense."),
    (r"layer_(\d+)\.attention_norm\.",
     r"encoder.layer.\1.attention.output.LayerNorm."),
    (r"layer_(\d+)\.intermediate\.", r"encoder.layer.\1.intermediate.dense."),
    (r"layer_(\d+)\.mlp_output\.", r"encoder.layer.\1.output.dense."),
    (r"layer_(\d+)\.output_norm\.", r"encoder.layer.\1.output.LayerNorm."),
)


def xlmr_state(encoder, prefix: str) -> dict:
    """A port `TransformerEncoder`'s parameters under XLM-R's names, on
    the host, a tensor at a time."""
    out = {}
    for name, value in encoder.state_dict().items():
        for pattern, hf in XLMR_NAMES:
            renamed, n = re.subn("^" + pattern, hf, name)
            if n:
                out[prefix + renamed] = value.detach().cpu()
                break
        else:
            raise KeyError(f"no XLM-R name for {name}")
    return out


def write_hf_snapshots(seed: int, dev, root: pathlib.Path, m3,
                       cross) -> tuple:
    """Phase 6d's snapshots of the serve phase's encoders, whose weights
    were made from `seed`: the BGE-M3 in the layout BAAI/bge-m3 ships (XLM-R
    tensor names, `pytorch_model.bin` in f32 with a pooler made from the
    seed, `sparse_linear.pt` 1024 → 1 and `colbert_linear.pt` 1024 → 1024,
    a `config.json` with its published widths) and the cross-encoder in
    the `XLMRobertaForSequenceClassification` layout (`roberta.*`,
    `classifier.dense`, `classifier.out_proj`). Returns (BGE-M3 dir,
    reranker dir, seconds)."""
    import torch

    cfg = m3.config.encoder
    h = cfg.hidden_size
    config = {"model_type": "xlm-roberta", "vocab_size": cfg.vocab_size,
              "hidden_size": h, "num_hidden_layers": cfg.num_layers,
              "num_attention_heads": cfg.num_heads,
              "intermediate_size": cfg.intermediate_size,
              "max_position_embeddings": cfg.max_position_embeddings,
              "type_vocab_size": cfg.type_vocab_size,
              "pad_token_id": cfg.pad_token_id,
              "layer_norm_eps": cfg.layer_norm_eps, "hidden_act": "gelu",
              "torch_dtype": "float32"}
    t0 = time.perf_counter()
    m3_dir, rr_dir = root / "bge-m3", root / "reranker"
    m3_dir.mkdir()
    rr_dir.mkdir()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = xlmr_state(m3.encoder, "")
    state["pooler.dense.weight"] = (torch.randn(
        (h, h), generator=gen, device=dev) * 0.02).cpu()
    state["pooler.dense.bias"] = torch.zeros(h)
    torch.save(state, m3_dir / "pytorch_model.bin")
    del state
    for head, module in (("sparse_linear", m3.sparse_head),
                         ("colbert_linear", m3.colbert_head)):
        torch.save({k: v.detach().cpu()
                    for k, v in module.state_dict().items()},
                   m3_dir / f"{head}.pt")
    (m3_dir / "config.json").write_text(json.dumps(
        {"architectures": ["XLMRobertaModel"], **config}))
    state = xlmr_state(cross.encoder, "roberta.")
    for hf, module in (("classifier.dense", cross.head_dense),
                       ("classifier.out_proj", cross.classifier)):
        state.update({f"{hf}.{k}": v.detach().cpu()
                      for k, v in module.state_dict().items()})
    torch.save(state, rr_dir / "pytorch_model.bin")
    del state
    (rr_dir / "config.json").write_text(json.dumps(
        {"architectures": ["XLMRobertaForSequenceClassification"],
         "num_labels": 1, **config}))
    return m3_dir, rr_dir, time.perf_counter() - t0


def resident_kb(pid: int) -> int:
    """The process's resident memory in kB as /proc shows it now: the
    larger of its `VmHWM` (high-water mark since its exec) and `VmRSS`,
    else `statm`'s resident pages; 0 where /proc shows neither."""
    proc = pathlib.Path(f"/proc/{pid}")
    with contextlib.suppress(OSError, ValueError, IndexError):
        fields = [int(line.split()[1])
                  for line in (proc / "status").read_text().splitlines()
                  if line.startswith(("VmHWM:", "VmRSS:"))]
        if fields:
            return max(fields)
    with contextlib.suppress(OSError, ValueError, IndexError):
        return int((proc / "statm").read_text().split()[1]) \
            * os.sysconf("SC_PAGE_SIZE") // 1024
    return 0


def convert_snapshots(jobs: list) -> list:
    """`python -m rag_dpo_tpu_torch.models.convert_weights KIND SNAPSHOT
    OUT [EXTRA...]` for each (snapshot, out, kind, extra) of `jobs`, in
    subprocesses started together: each one's seconds, printout, the npz's
    bytes and the child's own peak resident memory, read from /proc every
    20 ms (`resident_kb`; a child's `ru_maxrss` would count this process's
    pages, which it shares until its exec), None where /proc shows none."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    runs = []
    with contextlib.ExitStack() as stack:
        for snapshot, out, kind, extra in jobs:
            logs = (out.with_suffix(".out"), out.with_suffix(".err"))
            fo, fe = (stack.enter_context(open(f, "w")) for f in logs)
            runs.append({"logs": logs, "peak_kb": 0, "t0": time.perf_counter(),
                         "proc": subprocess.Popen(
                             [sys.executable, "-m",
                              "rag_dpo_tpu_torch.models.convert_weights",
                              kind, str(snapshot), str(out), *extra],
                             cwd=ROOT, env=env, stdout=fo, stderr=fe)})
        while any("seconds" not in r for r in runs):
            for r in runs:
                if "seconds" in r:
                    continue
                r["peak_kb"] = max(r["peak_kb"], resident_kb(r["proc"].pid))
                if r["proc"].poll() is not None:
                    r["seconds"] = time.perf_counter() - r["t0"]
            time.sleep(0.02)
    results = []
    for r, (_, out, _, _) in zip(runs, jobs):
        printed = r["logs"][0].read_text()
        check(r["proc"].returncode == 0,
              f"the converter exited {r['proc'].returncode}: "
              f"{r['logs'][1].read_text()[-2000:]}")
        check("loaded " in printed and "wrote " in printed,
              f"the converter printed {printed!r}")
        results.append({"seconds": r["seconds"],
                        "npz_bytes": out.stat().st_size,
                        "peak_gb": r["peak_kb"] * 1024 / 1e9
                        if r["peak_kb"] else None, "printed": printed})
    return results


def write_safetensors(path: pathlib.Path, tensors: dict) -> int:
    """Host torch tensors → one `*.safetensors` file, written by hand (the
    card's machine has no `safetensors` package): an 8-byte little-endian
    header length, the JSON header {name: {dtype, shape, data_offsets}}
    padded with spaces to 8 bytes, then the tensors' bytes in order. →
    the bytes written."""
    import torch

    names = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.uint8).numpy().data)
    return 8 + len(blob) + offset


# HF `MistralForCausalLM` tensor names of a layer → the Flax path under it
MISTRAL_NAMES = (("self_attn.q_proj", ("attention", "q_proj")),
                 ("self_attn.k_proj", ("attention", "k_proj")),
                 ("self_attn.v_proj", ("attention", "v_proj")),
                 ("self_attn.o_proj", ("attention", "o_proj")),
                 ("mlp.gate_proj", ("gate_proj",)),
                 ("mlp.up_proj", ("up_proj",)),
                 ("mlp.down_proj", ("down_proj",)))


def write_bf16_snapshot(seed: int, dev, snap: pathlib.Path, cfg) -> tuple:
    """Phase 6d′'s synthetic BF16 `MistralForCausalLM` snapshot at `cfg`'s
    widths (drawn on the card from `seed`: N(0, 0.02) weights, norms
    1 + N(0, 0.1), the untied `lm_head`), one file for the embedding, the
    final norm and the head and one a layer, as published snapshots are
    sharded; and, tensor by tensor as it is written, the tree the converter
    should write: each tensor widened by torch (`.float()`, exact), the
    kernels quantized by `quantize_decoder_params`. → (that tree, the
    files, bytes written)."""
    import torch

    from rag_dpo_tpu_torch.models.decoder import quantize_decoder_params

    h, dh, ffn = cfg.hidden_size, cfg.dh, cfg.intermediate_size
    shapes = {"self_attn.q_proj": (cfg.num_heads * dh, h),
              "self_attn.k_proj": (cfg.num_kv_heads * dh, h),
              "self_attn.v_proj": (cfg.num_kv_heads * dh, h),
              "self_attn.o_proj": (h, cfg.num_heads * dh),
              "mlp.gate_proj": (ffn, h), "mlp.up_proj": (ffn, h),
              "mlp.down_proj": (h, ffn)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(shape, std=0.02, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std
                + mean).to(torch.bfloat16).cpu()

    def quantized(w):
        return quantize_decoder_params(
            {"x": {"kernel": w.float().numpy().T}})["x"]

    n_files = cfg.num_layers + 1
    files = [snap / f"model-{i + 1:05d}-of-{n_files:05d}.safetensors"
             for i in range(n_files)]
    emb, norm, head = draw((cfg.vocab_size, h)), draw((h,), 0.1, 1.0), \
        draw((cfg.vocab_size, h))
    tree = {"embed_tokens": {"embedding": emb.float().numpy()},
            "final_norm": {"scale": norm.float().numpy()},
            "lm_head": quantized(head)}
    nbytes = write_safetensors(files[0], {
        "model.embed_tokens.weight": emb, "model.norm.weight": norm,
        "lm_head.weight": head})
    del emb, head
    for i in range(cfg.num_layers):
        tensors, layer = {}, {"attention": {}}
        for name, path in MISTRAL_NAMES:
            w = tensors[f"model.layers.{i}.{name}.weight"] = draw(
                shapes[name])
            node = layer
            for part in path[:-1]:
                node = node[part]
            node[path[-1]] = quantized(w)
        for name, key in (("input_layernorm", "input_norm"),
                          ("post_attention_layernorm",
                           "post_attention_norm")):
            w = tensors[f"model.layers.{i}.{name}.weight"] = draw(
                (h,), 0.1, 1.0)
            layer[key] = {"scale": w.float().numpy()}
        nbytes += write_safetensors(files[i + 1], tensors)
        tree[f"layer_{i}"] = layer
        del tensors
    return tree, files, nbytes


def mistral_config_json(cfg, layers: int) -> str:
    return json.dumps({
        "architectures": ["MistralForCausalLM"], "model_type": "mistral",
        "hidden_size": cfg.hidden_size, "num_hidden_layers": layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.dh,
        "intermediate_size": cfg.intermediate_size,
        "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps, "tie_word_embeddings": False,
        "torch_dtype": "bfloat16"})


def convert_bf16(seed: int, dev, root: pathlib.Path) -> dict:
    """Phase 6d′: a synthetic BF16 Mistral-Nemo-12B snapshot at its
    published widths but BF16_LAYERS layers (`write_bf16_snapshot`; the
    one-layer snapshot links the two-layer one's first files) through
    `convert_weights decoder --quantize-int8` in a subprocess at each
    depth, side by side: their seconds and peak resident memory, extrapolated by the
    per-layer difference to the published 40 layers (must stay under
    HOST_LIMIT_GB); the deeper npz must hold the tree made in process
    (int8 kernels and f32 scales, the f32 embedding and norms) bit for
    bit; loaded as `llm.mode: tpu` loads a checkpoint (`load_params_npz`
    into a `TPULLMProvider`, the untied head), one prefill's logits must be
    finite and the bits of a model loaded from the in-process tree."""
    import numpy as np
    import torch

    from rag_dpo_tpu_torch.models.convert import (
        flatten_params,
        load_params_npz,
    )
    from rag_dpo_tpu_torch.models.decoder import DecoderConfig
    from rag_dpo_tpu_torch.providers.tpu_llm import TPULLMProvider

    t_phase = time.perf_counter()
    deep = max(BF16_LAYERS)
    published = DecoderConfig.mistral_nemo_12b()
    cfg = dataclasses.replace(
        published, num_layers=deep, quantize_weights=True,
        tie_embeddings=False, max_seq_len=BF16_CONTEXT)
    base = root / "bf16"
    base.mkdir()
    snaps = {layers: base / f"mistral_nemo_12b_{layers}l"
             for layers in BF16_LAYERS}
    for layers, snap in snaps.items():
        snap.mkdir()
        (snap / "config.json").write_text(mistral_config_json(cfg, layers))
    t0 = time.perf_counter()
    want, files, nbytes = write_bf16_snapshot(seed, dev, snaps[deep], cfg)
    write_s = time.perf_counter() - t0
    for layers, snap in snaps.items():
        if layers != deep:
            for f in files[:layers + 1]:
                (snap / f.name).symlink_to(f)
    log(f"BF16 (6d′): snapshot of Mistral-Nemo-12B's widths at {deep} "
        f"layers (untied head) written in {write_s:.2f} s: "
        f"{nbytes / 1e9:.2f} GB of BF16 in {len(files)} files")
    outs = {layers: base / f"mistral_{layers}l_int8.npz"
            for layers in BF16_LAYERS}
    conv = dict(zip(BF16_LAYERS, convert_snapshots(
        [(snaps[n], outs[n], "decoder", ("--quantize-int8",))
         for n in BF16_LAYERS])))
    for layers, c in conv.items():
        check(c["peak_gb"] is not None,
              "the converter's peak resident memory was not read")
        log(f"BF16 (6d′): convert_weights decoder --quantize-int8 at "
            f"{layers} layer(s) in {c['seconds']:.2f} s (the depths side "
            f"by side), npz {c['npz_bytes'] / 1e9:.3f} GB, peak resident "
            f"{fmt_gb(c['peak_gb'])}")
        if layers != deep:
            outs[layers].unlink()
    lo, hi = min(BF16_LAYERS), deep
    per_layer = (conv[hi]["peak_gb"] - conv[lo]["peak_gb"]) / (hi - lo)
    projected = conv[hi]["peak_gb"] + (published.num_layers - hi) \
        * per_layer
    int8_layer_gb = sum(
        a.nbytes for a in flatten_params(want["layer_0"]).values()) / 1e9
    log(f"BF16 (6d′): peak {per_layer:.3f} GB a layer (the int8 kernels "
        f"it keeps: {int8_layer_gb:.3f} GB) → {projected:.2f} GB at "
        f"{published.num_layers} layers (limit {HOST_LIMIT_GB} GB)")
    check(0 < projected < HOST_LIMIT_GB,
          f"the converter would hold {projected:.2f} GB at "
          f"{published.num_layers} layers")

    # read once: compared here, then loaded as the factory loads it
    converted = load_params_npz(outs[deep])
    got, flat = flatten_params(converted["params"]), flatten_params(want)
    check(sorted(got) == sorted(flat),
          f"npz keys {sorted(set(got) ^ set(flat))[:6]}")
    for key, value in flat.items():
        check(got[key].dtype == value.dtype
              and got[key].shape == value.shape
              and np.array_equal(got[key].view(np.uint8),
                                 value.view(np.uint8)),
              f"BF16 (6d′): {key} differs from the in-process conversion")
    n_int8 = sum(k.endswith("kernel_q") for k in flat)
    del got

    ids = torch.as_tensor(np.random.default_rng(seed).integers(
        4, cfg.vocab_size, (2, 64)), device=dev)
    lens = torch.tensor([64, 40], device=dev)
    logits = {}
    for label, params in (("npz", converted),
                          ("in process", {"params": want})):
        llm = TPULLMProvider(cfg, params=params, device=dev)
        model = llm.generator.load()
        check(model.lm_head.weight_q.dtype == torch.int8
              and model.embed_tokens.weight.dtype == torch.float32,
              f"BF16 (6d′): the {label} model's head / embedding")
        logits[label] = llm.generator._prefill(ids, lens)[0].float().cpu()
        del llm, model, params
        gc.collect()
        torch.cuda.empty_cache()
    check(torch.isfinite(logits["npz"]).all()
          and tuple(logits["npz"].shape) == (2, cfg.vocab_size),
          f"BF16 (6d′): logits {tuple(logits['npz'].shape)}")
    check(torch.equal(logits["npz"], logits["in process"]),
          "BF16 (6d′): the converted model's logits are not the in-process "
          "model's bits")
    del want, flat, converted
    seconds = time.perf_counter() - t_phase
    log(f"BF16 (6d′): {n_int8} int8 kernels and every f32 tensor equal to "
        f"the in-process conversion; the npz loaded as llm.mode: tpu "
        f"loads a checkpoint, prefill logits [2, {cfg.vocab_size}] finite "
        f"and bit-equal to the in-process model's; phase {seconds:.1f} s")
    return {"layers": list(BF16_LAYERS),
            "snapshot_gb": nbytes / 1e9, "write_s": write_s,
            "convert_s": {n: c["seconds"] for n, c in conv.items()},
            "peak_gb": {n: c["peak_gb"] for n, c in conv.items()},
            "peak_gb_per_layer": per_layer,
            "int8_gb_per_layer": int8_layer_gb,
            "projected_peak_gb_40_layers": projected,
            "npz_gb": conv[deep]["npz_bytes"] / 1e9,
            "int8_kernels": n_int8, "phase_s": seconds}


@contextlib.contextmanager
def environ(**values):
    """Sets environment variables for a `with` block, then restores them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def fmt_gb(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.2f} GB"


def http(base: str, path: str, payload=None, raw: bytes | None = None,
         headers: dict | None = None) -> tuple:
    """One request to the phase's server: (status, body, seconds)."""
    import urllib.error
    import urllib.request

    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, data=data, headers=headers or {
        "Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            body, code = r.read(), r.status
    except urllib.error.HTTPError as e:
        body, code = e.read(), e.code
    return code, body, time.perf_counter() - t0


def serve_http(stack, questions, dev, seed: int,
               root: pathlib.Path) -> dict:
    """Phase 6d: HF-layout snapshots of the serve phase's encoders (made
    from `seed`) are converted by the port's CLI, the app's `build_system` boots the default config with
    `embedding.checkpoint_path` set to the npz (the converted cross-encoder
    injected) over the saved index, and `app.server.serve` answers over
    loopback HTTP: /healthz, 8 /query (sources equal to the in-process
    pipeline's), a streamed /query, /search by texts, vectors and the
    binary route, 16 threads × 8 vector searches through the batcher (ids
    equal to the unbatched search), /v1/embeddings, /stats and /metrics;
    then the CLI's `eval --limit CLI_EVAL_LIMIT` in a subprocess on the
    card."""
    import threading

    import numpy as np
    import torch

    import rag_dpo_tpu_torch.bootstrap as bootstrap
    from rag_dpo_tpu_torch.app.server import build_system, serve
    from rag_dpo_tpu_torch.evals.synthetic import ExtractiveFakeLLM
    from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
    from rag_dpo_tpu_torch.models.convert_weights import load_state_dict
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.providers import Embedder, EmbedderConfig
    from rag_dpo_tpu_torch.retrieval.reranker import CrossEncoderReranker
    from rag_dpo_tpu_torch.serving import batcher_stats

    torch.cuda.reset_peak_memory_stats()
    snaps = root / "snapshots"
    snaps.mkdir()
    m3_dir, rr_dir, write_s = write_hf_snapshots(
        seed, dev, snaps, stack.embedder.load(), stack.pipeline.reranker.load())
    log(f"serve, HTTP: snapshots written in {write_s:.2f} s: BGE-M3 "
        f"{(m3_dir / 'pytorch_model.bin').stat().st_size / 1e9:.2f} GB, "
        f"cross-encoder "
        f"{(rr_dir / 'pytorch_model.bin').stat().st_size / 1e9:.2f} GB")
    npz = snaps / "bge_m3.npz"
    (conv,) = convert_snapshots([(m3_dir, npz, "bge-m3", ())])
    log(f"serve, HTTP: convert_weights bge-m3 in {conv['seconds']:.2f} s, "
        f"npz {conv['npz_bytes'] / 1e9:.3f} GB, converter peak resident "
        f"memory {fmt_gb(conv['peak_gb'])}; it printed "
        f"{conv['printed'].strip().splitlines()}")

    t0 = time.perf_counter()
    rr_state = load_state_dict(rr_dir)
    reranker = CrossEncoderReranker(model_config=EncoderConfig.bge_m3(),
                                    device=dev)
    reranker.load_converted(rr_state)
    check(np.array_equal(reranker.model.classifier.weight.detach().cpu(),
                         rr_state["classifier.out_proj.weight"]),
          "the converted cross-encoder's head is not the snapshot's")
    del rr_state
    reranked = []
    rerank = reranker.rerank

    def recording(*a, **kw):  # keeps every rerank output
        out = rerank(*a, **kw)
        reranked.append(out)
        return out

    reranker.rerank = recording
    rr_s = time.perf_counter() - t0

    booted = {}
    build_stack = bootstrap.build_stack

    def injected(config=None, paths=None, llm=None, **kw):
        # the config names no cross-encoder checkpoint (nor does the JAX
        # package's): the converted one is injected, and the serve phase's
        # loaded index with it, so the host holds one ColBERT store
        booted["config"] = config
        booted["stack"] = build_stack(config, paths, llm=llm,
                                      index=stack.index, reranker=reranker,
                                      **kw)
        return booted["stack"]

    bootstrap.build_stack = injected
    try:
        with environ(RAGDPO_TPU_ROOT=str(root),
                     RAGDPO_EMBEDDING_CHECKPOINT_PATH=str(npz)):
            t0 = time.perf_counter()
            system = build_system(agent_too=True, llm=ExtractiveFakeLLM(),
                                  device=dev)
            system["embedder"].load()
            torch.cuda.synchronize()
            boot_s = time.perf_counter() - t0
    finally:
        bootstrap.build_stack = build_stack
    embedder = system["embedder"]
    check(booted and booted["config"].embedding.checkpoint_path == str(npz)
          and system["pipe"] is booted["stack"].pipeline
          and system["pipe"].reranker is reranker,
          "build_system did not boot the converted checkpoint's stack")
    check(embedder.config.model == BgeM3Config()
          and embedder.device == torch.device(dev),
          f"the booted embedder is {embedder.config.model} on "
          f"{embedder.device}")

    # the booted encoder holds the snapshot's weights, and encodes as an
    # Embedder loaded from the snapshot in process does
    t0 = time.perf_counter()
    m3_state = load_state_dict(m3_dir)
    direct = Embedder(EmbedderConfig(model=BgeM3Config()), device=dev)
    direct.load_converted(m3_state)
    direct_s = time.perf_counter() - t0
    word = embedder.model.encoder.word_embeddings.weight
    check(np.array_equal(word[:8].detach().cpu(),
                         m3_state["embeddings.word_embeddings.weight"][:8]),
          "the booted encoder's embeddings are not the snapshot's")
    del m3_state
    vector_err = max(float(np.abs(direct.embed_query(q)
                                  - embedder.embed_query(q)).max())
                     for q in questions[:2])
    del direct
    gc.collect()
    torch.cuda.empty_cache()
    check(vector_err <= COALESCED_TOL,
          f"a booted query vector is {vector_err:.3g} from the direct one")
    # the snapshot was written from the serve phase's encoders, which
    # built the index: the converted ones must encode and score as they do
    serve_err = float(np.abs(embedder.embed_queries(questions)
                             - stack.embedder.embed_queries(questions)).max())
    pairs = [(q, f"{q} {q}") for q in questions[:4]]
    score_err = float(np.abs(reranker.score_pairs(pairs)
                             - stack.pipeline.reranker.score_pairs(pairs)).max())
    check(serve_err <= COALESCED_TOL and score_err <= COALESCED_TOL,
          f"the converted encoders are {serve_err:.3g} (vectors) and "
          f"{score_err:.3g} (scores) from the serve phase's")
    log(f"serve, HTTP: cross-encoder loaded in {rr_s:.2f} s; build_system "
        f"booted the converted checkpoint in {boot_s:.2f} s; an Embedder "
        f"loaded from the snapshot in process ({direct_s:.2f} s) is "
        f"{vector_err:.3g} from it; against the serve phase's encoders the "
        f"converted ones are {serve_err:.3g} (query vectors) and "
        f"{score_err:.3g} (rerank scores) apart")

    srv = serve(port=0, system=system)
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    _kernels.reset_counts()
    try:
        code, body, _ = http(base, "/healthz")
        health = json.loads(body)
        check(code == 200 and torch.cuda.get_device_name(0)
              in health["devices"] and health["n_chunks"] == N_CHUNKS,
              f"/healthz answered {code} {health}")

        http_times, replies = [], []
        for i, question in enumerate(questions):
            code, body, dt = http(base, "/query", {"question": question})
            data = json.loads(body)
            check(code == 200 and data["error"] is None and data["sources"]
                  and data["answer"].strip(),
                  f"/query {question!r}: {code} {str(data)[:300]}")
            replies.append(data)
            if i:
                http_times.append(dt)
        inproc_times = []
        for question, data in zip(questions, replies):
            t0 = time.perf_counter()
            resp = system["pipe"].query(question)
            torch.cuda.synchronize()
            inproc_times.append(time.perf_counter() - t0)
            check(json.loads(json.dumps(resp.sources)) == data["sources"]
                  and resp.answer == data["answer"],
                  f"/query {question!r} answered other sources than the "
                  f"in-process pipeline: {data['sources']} against "
                  f"{resp.sources}")
        inproc_times = inproc_times[1:]

        code, body, stream_s = http(base, "/query", {
            "question": questions[1], "stream": True})
        events = [json.loads(line[6:]) for line in body.decode().splitlines()
                  if line.startswith("data: ") and line != "data: [DONE]"]
        deltas = [e["delta"] for e in events if "delta" in e]
        check(code == 200 and deltas and "response" in events[-1]
              and events[-1]["response"]["sources"] == replies[1]["sources"],
              f"the streamed /query gave {code}, {len(events)} events")

        k = 10
        qv = embedder.embed_queries(questions[1:])
        want_scores, want_ids = stack.index.search_dense(qv, k)
        code, body, _ = http(base, "/search", {"vectors": qv.tolist(),
                                               "k": k})
        by_vectors = json.loads(body)["results"]
        check(code == 200 and [[h["id"] for h in hits] for hits in by_vectors]
              == [[stack.index.ids[r] for r in row] for row in want_ids],
              "/search by vectors is not the index's search")
        dense = embedder.embed(questions[1:3])["dense"]
        _, text_ids = stack.index.search_dense(dense, k)
        code, body, _ = http(base, "/search", {"texts": questions[1:3],
                                               "k": k})
        check(code == 200 and [[h["id"] for h in hits]
                               for hits in json.loads(body)["results"]]
              == [[stack.index.ids[r] for r in row] for row in text_ids],
              "/search by texts is not the index's search")
        q, dim = qv.shape
        code, out, _ = http(
            base, "/search",
            raw=b"RDPV" + struct.pack("<III", q, dim, k)
            + np.ascontiguousarray(qv, np.float32).tobytes(),
            headers={"Content-Type": "application/octet-stream"})
        check(code == 200 and out[:4] == b"RDPR"
              and struct.unpack("<II", out[4:12]) == (q, k),
              f"binary /search answered {code} {out[:16]!r}")
        rows = np.frombuffer(out, np.int32, q * k, 12 + q * k * 4)
        scores = np.frombuffer(out, np.float32, q * k, 12)
        check(np.array_equal(rows.reshape(q, k), want_ids)
              and np.allclose(scores.reshape(q, k), want_scores, atol=1e-6),
              "binary /search is not the index's search")

        # 16 threads × 8 one-vector searches through the batcher
        batcher = system["search"].batcher
        before = batcher_stats(batcher)
        gate = threading.Barrier(CONCURRENT_THREADS)
        got, errors = {}, []

        def searcher(i):
            try:
                gate.wait()
                for j in range(len(qv)):
                    row = (i + j) % len(qv)
                    code, body, _ = http(base, "/search", {
                        "vectors": qv[row:row + 1].tolist(), "k": k})
                    if code != 200:
                        raise RuntimeError(f"/search answered {code}")
                    got[(i, j)] = (row, [h["id"] for h in
                                         json.loads(body)["results"][0]])
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=searcher, args=(i,))
                   for i in range(CONCURRENT_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        search_wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        after = batcher_stats(batcher)
        requests = after["n_requests"] - before["n_requests"]
        calls = after["n_device_calls"] - before["n_device_calls"]
        mean_batch = requests / max(calls, 1)
        unbatched = [[stack.index.ids[r] for r in stack.index.search_dense(
            qv[row:row + 1], k)[1][0]] for row in range(len(qv))]
        wrong = sorted({row for row, ids in got.values()
                        if ids != unbatched[row]})
        check(len(got) == CONCURRENT_THREADS * len(qv) and not wrong,
              f"concurrent /search ids differ from the unbatched search for "
              f"rows {wrong}")
        check(requests == CONCURRENT_THREADS * len(qv) and mean_batch > 1,
              f"concurrent /search did not coalesce: {requests} requests in "
              f"{calls} device calls")

        code, body, _ = http(base, "/v1/embeddings",
                             {"input": questions[1:3]})
        served = np.asarray([d["embedding"] for d in
                             json.loads(body)["data"]], np.float32)
        embed_err = float(np.abs(served - np.stack(
            [embedder.embed_query(q) for q in questions[1:3]])).max())
        check(code == 200 and embed_err <= COALESCED_TOL,
              f"/v1/embeddings is {embed_err:.3g} from embed_query")
        code, body, _ = http(base, "/stats")
        stats = json.loads(body)
        check(code == 200 and stats["n_queries"] >= len(questions) + 1
              and "search_batcher" in stats, f"/stats answered {stats}")
        code, body, _ = http(base, "/metrics")
        check(code == 200 and "ragdpo_n_queries " in body.decode(),
              "/metrics has no ragdpo_n_queries")
        launches = {n: _kernels.LAUNCHES[n] for n in SERVE_KERNELS}
        plain = dict(_kernels.PLAIN_ON_CUDA)
    finally:
        srv.shutdown()
        srv.server_close()
        server_thread.join()
        system["search"].batcher.close()
    check(reranked and all(c.rerank_score is not None
                           for out in reranked for c in out),
          "a converted cross-encoder rerank fell back to the incoming order")

    # the terminal app: `eval --limit CLI_EVAL_LIMIT` over the saved index,
    # booting the converted checkpoint in its own process on the card
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "rag_dpo_tpu_torch.app.cli", "--root",
         str(root), "eval", "--limit", str(CLI_EVAL_LIMIT)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT), RAGDPO_TPU_ROOT=str(root),
                 RAGDPO_EMBEDDING_CHECKPOINT_PATH=str(npz)))
    cli_s = time.perf_counter() - t0
    check(cli.returncode == 0 and "score global" in cli.stdout,
          f"the CLI's eval exited {cli.returncode}: {cli.stderr[-2000:]}")
    score = [ln for ln in cli.stdout.splitlines() if "score global" in ln]

    p50, inproc_p50 = (float(np.median(ts)) * 1e3
                       for ts in (http_times, inproc_times))
    device_gb = torch.cuda.max_memory_allocated() / 1e9
    host_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    check(device_gb <= 40 and host_gb <= 48,
          f"phase 6d's peak memory: {device_gb:.2f} GB on the card, "
          f"{host_gb:.1f} GB on the host")
    log(f"serve, HTTP: {N_QUESTIONS} /query after 1 warm-up: p50 "
        f"{p50:.1f} ms, max {max(http_times) * 1e3:.1f} ms; in process "
        f"p50 {inproc_p50:.1f} ms; streamed /query {stream_s * 1e3:.1f} ms "
        f"({len(deltas)} deltas); {CONCURRENT_THREADS} threads × {len(qv)} "
        f"/search in {search_wall:.2f} s, mean batch {mean_batch:.2f} "
        f"({requests} requests, {calls} device calls); /v1/embeddings "
        f"{embed_err:.3g} from embed_query; CLI eval --limit "
        f"{CLI_EVAL_LIMIT} in "
        f"{cli_s:.2f} s: {score}; peak device memory {device_gb:.2f} GB, "
        f"host peak so far {host_gb:.1f} GB; launches {launches}, plain "
        f"twins on the card {plain}")
    del system, reranker, embedder
    return {"launches": launches, "plain_on_cuda": plain,
            "snapshot_write_s": write_s, "convert_s": conv["seconds"],
            "convert_npz_bytes": conv["npz_bytes"],
            "convert_peak_gb": conv["peak_gb"], "reranker_load_s": rr_s,
            "boot_s": boot_s, "boot_vector_err": vector_err,
            "vs_serve_vector_err": serve_err, "vs_serve_score_err": score_err,
            "query_p50_ms": p50, "query_max_ms": max(http_times) * 1e3,
            "inprocess_query_p50_ms": inproc_p50,
            "stream_query_ms": stream_s * 1e3,
            "search_concurrent_wall_s": search_wall,
            "search_mean_batch": mean_batch,
            "embeddings_max_abs_err": embed_err, "cli_eval_s": cli_s,
            "peak_device_gb": device_gb, "host_peak_gb": host_gb}


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


def check_decoder_tiny(dev) -> dict:
    """Phase 6e (a): the tiny decoder on the card, seeded random weights.
    Its cached greedy decode (prefill, then one token a step) must be the
    argmax chain of one full forward over the prompt and the decoded tokens
    (each decoded token's logit within `DECODER_TOL` of that position's
    maximum: only the order of sums differs), in f32, in bf16 with int8
    weights, and with the int8 KV cache (whose full forward goes through a
    fresh int8 cache, so every query attends the same dequantized K/V);
    the speculative decode must give the same tokens bit for bit."""
    import numpy as np
    import torch

    from rag_dpo_tpu_torch.models.decoder import DecoderConfig, DecoderModel
    from rag_dpo_tpu_torch.models.generate import (
        SamplingConfig,
        TextGenerator,
    )
    from rag_dpo_tpu_torch.models.speculative import SpeculativeGenerator

    rng = np.random.default_rng(0)
    ids = rng.integers(3, 512, (3, 24)).astype(np.int32)
    lengths = np.asarray([24, 17, 5], np.int32)
    greedy = SamplingConfig(temperature=0.0, max_new_tokens=24, eos_id=-1)
    gaps = {}
    for label, kw in (("f32", dict(dtype=torch.float32)),
                      ("bf16_int8", dict(quantize_weights=True,
                                         tie_embeddings=True)),
                      ("f32_int8_kv", dict(dtype=torch.float32,
                                           quantize_kv=True))):
        cfg = DecoderConfig.tiny(**kw)
        gen = TextGenerator(cfg, device=dev)
        model = gen.load()
        check(all(t.is_cuda for t in model.state_dict().values()),
              f"tiny decoder {label}: a weight is not on the card")
        tokens = gen.generate_ids(ids, lengths, greedy)
        gap = 0.0
        with torch.no_grad():
            for r in range(len(ids)):
                n = int(lengths[r])
                seq = torch.as_tensor(np.concatenate([ids[r, :n],
                                                      tokens[r]]),
                                      dtype=torch.long, device=dev)[None]
                if cfg.quantize_kv:
                    logits, _ = model(seq, None, DecoderModel.init_cache(
                        cfg, 1, device=dev))
                else:
                    logits = model(seq)
                logits = logits[0, n - 1:-1].float()
                picked = logits.gather(1, seq[0, n:, None])[:, 0]
                gap = max(gap, float((logits.max(-1).values - picked).max()))
        tol = DECODER_TOL[str(cfg.dtype).split(".")[-1]]
        check(gap <= tol, f"tiny decoder {label}: a cached greedy token "
              f"lies {gap} below its full forward's maximum (> {tol})")
        spec, stats = SpeculativeGenerator(gen, draft_len=4).generate_ids(
            ids, lengths, greedy)
        check(np.array_equal(spec, tokens),
              f"tiny decoder {label}: speculative tokens differ from greedy")
        check(stats.tokens == tokens.size,
              f"tiny decoder {label}: speculative emitted {stats.tokens}")
        gaps[label] = gap
    log(f"generate (a): the tiny decoder's cached greedy tokens are its full "
        f"forward's argmax chain (largest gap to the max logit: "
        + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
        + "); speculative tokens equal greedy in all three")
    return gaps


def decoder_step_bound(model, batch: int, context: float) -> dict:
    """The least time of one decode step: every weight read once (the int8
    projections, the f32 tied embedding, the norms) and each row's K/V of
    `context` positions once, over HBM; 2 operations a weight a row over
    the bf16 tensor cores' peak."""
    cfg = model.config
    weights = sum(t.numel() * t.element_size()
                  for t in model.state_dict().values())
    kv_itemsize = 1 if cfg.quantize_kv else 2
    kv = batch * context * cfg.num_layers * 2 * cfg.num_kv_heads * cfg.dh \
        * kv_itemsize
    params = sum(t.numel() for t in model.state_dict().values())
    return {**bound(2.0 * params * batch, weights + kv, BF16_FLOPS),
            "bound_weight_bytes": weights, "bound_kv_bytes": kv}


def serve_generate(stack, questions, dev, seed: int) -> dict:
    """Phase 6e: the in-process decoder. (a) the tiny decoder's checks;
    (c) the serve phase's index and encoders through `build_stack` with
    `llm.mode="tpu"` (Mistral-Nemo-12B, int8 weights, speculative greedy,
    the direct scheduler; random init on the card): GEN_ANSWERS
    `pipeline.query` answers of at most GEN_NEW_TOKENS tokens (no warm-up:
    nothing compiles), then one agent query through `stack.active()`,
    whose gates call `choose()`;
    (b) the same decoder's init, bytes, prefill at the answers' prompt
    lengths, decode at DECODE_BATCHES over DECODE_NEW_TOKENS tokens beside
    the bytes bound, one profiled decode step, and the speculative path's
    tokens a step."""
    import numpy as np
    import torch

    from rag_dpo_tpu_torch.agent import RAGAgentPipeline
    from rag_dpo_tpu_torch.bootstrap import build_stack
    from rag_dpo_tpu_torch.models import flax_init
    from rag_dpo_tpu_torch.models.decoder import QuantDense
    from rag_dpo_tpu_torch.models.generate import SamplingConfig
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.providers.tpu_llm import TPULLMProvider
    from rag_dpo_tpu_torch.utils.config import load_config

    tiny = check_decoder_tiny(dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    config = load_config(env={"RAGDPO_LLM_MODE": "tpu",
                              "RAGDPO_LLM_SPECULATIVE": "true"})
    c = config.llm
    check(c.arch == "mistral-nemo-12b" and c.quantize_int8
          and c.scheduler == "direct" and config.agent.enable,
          f"llm config {c}")
    gstack = build_stack(config, stack.paths, index=stack.index,
                         embedder=stack.embedder,
                         reranker=stack.pipeline.reranker, device=dev)
    llm = gstack.llm
    gen = llm.generator
    check(isinstance(llm, TPULLMProvider) and gen.device.type == "cuda"
          and llm._spec is not None, f"llm.mode tpu built {llm!r}")
    gen._rng_seed = seed
    flax_init.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = gen.load()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_draws = flax_init.LAUNCHES["threefry_bits"]
    check(init_draws > 0, "the 12B's init launched no Triton draw")
    state = model.state_dict()
    check(all(t.is_cuda for t in state.values()),
          "a 12B weight is not on the card")
    weight_gb = sum(t.numel() * t.element_size()
                    for t in state.values()) / 1e9
    int8_gb = sum(m.weight_q.numel() for m in model.modules()
                  if isinstance(m, QuantDense)) / 1e9
    check(all(m.weight_q.dtype == torch.int8 for m in model.modules()
              if isinstance(m, QuantDense)) and int8_gb > 10,
          f"int8 projections {int8_gb} GB")
    embed_gb = model.embed_tokens.weight.numel() * 4 / 1e9
    log(f"generate (b): Mistral-Nemo-12B (40 layers, 5120 wide, vocab "
        f"131,072, int8 projections, tied f32 embedding; Flax's random init "
        f"from seed {seed}, {init_draws} Triton draws) made on the card in "
        f"{init_s:.2f} s: {weight_gb:.2f} "
        f"GB on the card ({int8_gb:.2f} GB int8 projections, {embed_gb:.2f} "
        f"GB f32 embedding)")

    # (c) end to end: the answers, then the agent
    llm.max_new_tokens = GEN_NEW_TOKENS
    pipe = gstack.pipeline
    pipe.max_quality_retries = 0   # random weights never ground an answer
    prompts = []
    prefill = gen._prefill

    def recording(ids, lengths, cache_len=None):
        prompts.append((tuple(ids.shape), lengths.tolist()))
        return prefill(ids, lengths, cache_len)

    gen._prefill = recording
    _kernels.reset_counts()
    answers = []
    for question in questions[:GEN_ANSWERS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resp = pipe.query(question)
        torch.cuda.synchronize()
        answers.append((time.perf_counter() - t0, resp))
        check(resp.error is None, resp.error)
        check(resp.answer.strip() and resp.n_candidates,
              f"no answer for {question!r}")
    launches = {n: _kernels.LAUNCHES[n] for n in SERVE_KERNELS}
    plain = twins_on_the_card()
    for name in SERVE_KERNELS:
        check(launches[name] > 0, f"{name} never launched in phase 6e")
    check(not any(plain.values()), f"a twin ran in phase 6e: {plain}")
    attention = decoder_attention("6e")
    p50 = float(np.median([w for w, _ in answers]))
    retrieve = float(np.median([r.retrieval_time + r.rerank_time
                                for _, r in answers]))
    generate = float(np.median([r.generation_time for _, r in answers]))
    n_words = [len(r.answer.split()) for _, r in answers]
    answer_prompts = [p for p in prompts if p[0][0] == 1]
    lengths = sorted({n for _, ls in answer_prompts for n in ls})
    log(f"generate (c): {GEN_ANSWERS} RAG answers by the 12B decoder "
        f"(temperature {c.temperature}, at most {GEN_NEW_TOKENS} new "
        f"tokens, no quality retry): p50 {p50 * 1e3:.1f} ms = retrieval + "
        f"rerank {retrieve * 1e3:.1f} ms (the retrieval step's own LLM "
        f"calls included: {len(prompts) / GEN_ANSWERS:.0f} prefills a query "
        f"in all) + generation {generate * 1e3:.1f} ms (p50s); prompts of "
        f"{lengths} "
        f"tokens in buckets {sorted({p[0][1] for p in answer_prompts})}; "
        f"{n_words} words in the answers; launches {launches}")
    agent = gstack.active()
    check(isinstance(agent, RAGAgentPipeline), f"active() is {agent!r}")
    chosen = []
    choose = llm.choose

    def counting(*a, **kw):
        chosen.append(a[1] if len(a) > 1 else kw.get("choices"))
        return choose(*a, **kw)

    llm.choose = counting
    n_prefills = len(prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent_resp = agent.query(questions[1])
    torch.cuda.synchronize()
    agent_s = time.perf_counter() - t0
    llm.choose = choose
    check(agent_resp.error is None and agent_resp.answer.strip(),
          f"agent: {agent_resp.error}")
    check(chosen, "the agent's gates never called choose()")
    trace = agent_resp.extras.get("node_trace")
    log(f"generate (c): one agent query through stack.active() in "
        f"{agent_s * 1e3:.1f} ms: {len(chosen)} choose() calls "
        f"({chosen}), {len(prompts) - n_prefills} prefills of generate "
        f"calls; node trace {trace}")
    gen._prefill = prefill

    # (b) the decoder alone
    greedy = SamplingConfig(temperature=0.0, eos_id=-1,
                            max_new_tokens=DECODE_NEW_TOKENS)
    rng = np.random.default_rng(seed)
    vocab = model.config.vocab_size
    prefill_ms = {}
    for s in sorted({p[0][1] for p in answer_prompts}):
        n = max(ls[0] for shape, ls in answer_prompts if shape[1] == s)
        ids = torch.as_tensor(rng.integers(4, vocab, (1, s)), device=dev)
        lens = torch.tensor([n], device=dev)
        prefill_ms[s] = cuda_ms(lambda: gen._prefill(ids, lens), iters=3,
                                warmup=1)
        log(f"generate (b): prefill of a {n}-token prompt (bucket {s}) at "
            f"batch 1: {prefill_ms[s]:.1f} ms "
            f"({n / prefill_ms[s]:.0f} tokens/ms)")
    s = max(prefill_ms)
    context = s + DECODE_NEW_TOKENS / 2
    decode = {}
    for b in DECODE_BATCHES:
        ids = rng.integers(4, vocab, (b, s)).astype(np.int32)
        carry = gen._start(ids, np.full(b, s, np.int32), greedy, 0, None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, tokens = gen._decode_chunk(carry, DECODE_NEW_TOKENS, greedy)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(tokens.shape == (b, DECODE_NEW_TOKENS)
              and bool(((tokens >= 0) & (tokens < vocab)).all()),
              f"decode tokens {tuple(tokens.shape)}")
        ms = dt / DECODE_NEW_TOKENS * 1e3
        bnd = decoder_step_bound(model, b, context)
        decode[b] = {"ms_per_step": ms, "tokens_per_s": b / ms * 1e3, **bnd}
        log(f"generate (b): decode at batch {b} after a {s}-token prompt, "
            f"{DECODE_NEW_TOKENS} new tokens: {ms:.2f} ms a step, "
            f"{b / ms * 1e3:.1f} tokens/s; bound {bnd['bound_ms']:.3f} ms a "
            f"step ({bnd['bound_by']}: {bnd['bound_weight_bytes'] / 1e9:.2f} "
            f"GB of weights + {bnd['bound_kv_bytes'] / 1e9:.3f} GB of K/V at "
            f"{context:.0f} positions a row) = "
            f"{bnd['bound_ms'] / ms:.1%} of it")
        if b == 1:
            busy, _ = profile_once(
                lambda: gen._decode_chunk(carry, 1, greedy),
                "one decode step at batch 1", ms / 1e3, top=10, show=())
            decode[b]["device_busy_share"] = busy
        del carry, tokens
    ids = rng.integers(4, vocab, (1, s)).astype(np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, stats = llm._spec.generate_ids(
        ids, np.asarray([s], np.int32),
        SamplingConfig(temperature=0.0, eos_id=-1,
                       max_new_tokens=GEN_NEW_TOKENS))
    torch.cuda.synchronize()
    spec_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"generate (b): speculative greedy (draft {llm._spec.draft_len}, "
        f"{GEN_NEW_TOKENS} tokens after a {s}-token random prompt): "
        f"{stats.tokens_per_step:.2f} tokens a step, {stats.steps} verify "
        f"forwards, {spec_ms:.1f} ms with its prefill; peak device memory "
        f"{peak_gb:.2f} GB in phase 6e ({before / 1e9:.2f} GB held before "
        f"it)")
    judge = serve_judge(llm, dev)
    out = {"tiny_max_gap": tiny, "init_s": init_s,
           "init_draw_launches": init_draws, "weight_gb": weight_gb,
           "int8_gb": int8_gb, "embedding_gb": embed_gb,
           "peak_device_gb": peak_gb, "prefill_ms": prefill_ms,
           "decode": decode, "spec_tokens_per_step": stats.tokens_per_step,
           "spec_ms": spec_ms, "answer_p50_ms": p50 * 1e3,
           "answer_retrieval_rerank_ms": retrieve * 1e3,
           "answer_generation_ms": generate * 1e3,
           "answer_prompt_tokens": lengths, "agent_ms": agent_s * 1e3,
           "agent_choose_calls": len(chosen), "launches": launches,
           "prefill_attention": attention, "judge": judge}
    del gstack, llm, gen, model, state, pipe, agent, prefill, recording, \
        choose, counting
    return out


def serve_judge(llm, dev) -> dict:
    """Phase 6e′ (inside 6e, on its 12B): `evals/judge_axis.py::
    run_judge_axis` over the first JUDGE_QUESTIONS questions: the hermetic
    v2 stack with the committed trained encoder, the 12B as the judge in
    choose mode. Every score must be non-None (the first exception the
    judge raised is printed), every traced bucket one of
    `JUDGE_SCORE_BUCKETS` and every veto "non" or "oui"; the stack's
    queries launch K3 and K4 and no twin may run."""
    from rag_dpo_tpu_torch.evals.harness import JUDGE_SCORE_BUCKETS
    from rag_dpo_tpu_torch.evals.judge_axis import run_judge_axis, verdict
    from rag_dpo_tpu_torch.ops import _kernels

    _kernels.reset_counts()
    t0 = time.perf_counter()
    record = run_judge_axis(llm, JUDGE_QUESTIONS, dev)
    seconds = time.perf_counter() - t0
    launches = {n: _kernels.LAUNCHES[n] for n in ("ell_topk", "fused_topk")}
    plain = twins_on_the_card()
    code, line = verdict(record)
    check(code == 0, f"judge (6e′): {line}; first judge error: "
                     f"{record['first_judge_error']}")
    check(len(record["bucket_sample"]) == JUDGE_QUESTIONS
          and set(record["bucket_sample"]) <= set(JUDGE_SCORE_BUCKETS)
          and set(record["veto_sample"]) <= {"non", "oui"},
          f"judge (6e′): buckets {record['bucket_sample']}, vetoes "
          f"{record['veto_sample']}")
    check(all(launches.values()) and not any(plain.values()),
          f"judge (6e′): launches {launches}, plain twins {plain}")
    attention = decoder_attention("6e′")
    per_q = record["judge_seconds_per_question"]
    log(f"judge (6e′): {record['n_judged_non_null']}/{record['n_questions']}"
        f" judged by the 12B in choose mode, {record['judge_calls']} choose "
        f"calls in {record['judge_seconds']:.2f} s = {per_q:.3f} s a "
        f"question; mean {record['judge_mean']}, buckets "
        f"{record['bucket_sample']}, vetoes {record['veto_sample']}; global "
        f"score with the judge {record['global_score_with_judge']}; "
        f"launches {launches}; phase {seconds:.1f} s")
    return {k: record[k] for k in (
        "n_questions", "n_judged_non_null", "judge_mean", "bucket_sample",
        "veto_sample", "judge_vetoes_sample", "global_score_with_judge",
        "judge_seconds", "judge_seconds_per_question", "judge_calls",
        "judge_wall_seconds")} | {"launches": launches,
                                  "prefill_attention": attention,
                                  "phase_s": seconds}



def solo_run(gen, ids, max_new: int, temperature: float, seed: int) -> list:
    """One request's tokens from the decoder's solo `generate_ids`, cut at
    its first EOS (2) or pad (1)."""
    import numpy as np

    from rag_dpo_tpu_torch.models.generate import SamplingConfig

    out = gen.generate_ids(
        ids[None], np.asarray([len(ids)], np.int32),
        SamplingConfig(temperature=temperature, eos_id=2, pad_id=1,
                       max_new_tokens=max_new), rng_seeds=[seed])[0]
    toks = []
    for t in out:
        if int(t) in (1, 2):
            break
        toks.append(int(t))
    return toks


def check_pool_tiny(dev) -> dict:
    """Phase 6f (a): the slot pool of the tiny decoder on the card (seeded
    random weights), in f32 with its prefix cache on the card and in bf16
    with int8 weights, the int8 KV cache and its prefix cache in host
    memory: 4 slots, speculation, chunked prefill; 12 requests arrive in
    four groups (greedy and sampled, a low-priority group that a priority-0
    request preempts, one cancel, a `logit_bias` ban, a logprobs request).
    Each request's tokens equal its solo run's, or first differ at a
    near-tie of the solo run's logits (`divergence_gap` within
    `DECODER_TOL`: ROADMAP C-29); a cancelled request's tokens are a prefix
    of its solo run. Then the driver: a request whose deadline expires
    returns a prefix of its solo run, and a neighbour finishes whole."""
    import numpy as np
    import torch

    from rag_dpo_tpu_torch.models.decoder import DecoderConfig
    from rag_dpo_tpu_torch.models.generate import (
        SamplingConfig,
        TextGenerator,
    )
    from rag_dpo_tpu_torch.serving import (
        ContinuousDriver,
        ContinuousEngine,
        DeadlineExceeded,
    )
    from rag_dpo_tpu_torch.serving.continuous import divergence_gap

    sampling = SamplingConfig(temperature=0.0, eos_id=2, pad_id=1)
    out = {}
    for label, kw, host in (
            ("f32", dict(dtype=torch.float32), False),
            ("bf16_int8_kv", dict(quantize_weights=True, tie_embeddings=True,
                                  quantize_kv=True), True)):
        cfg = DecoderConfig.tiny(**kw)
        tol = DECODER_TOL[str(cfg.dtype).split(".")[-1]]
        gen = TextGenerator(cfg, device=dev)
        eng = ContinuousEngine(gen, slots=4, sampling=sampling, chunk=4,
                               speculative=True, draft_len=4,
                               prefill_chunk=16, prefix_cache=4,
                               prefix_block=16, prefix_cache_host=host,
                               preemption=True)
        check(all(t.is_cuda for layer in eng._carry.caches
                  for t in layer.values()),
              f"pool {label}: a cache tensor is not on the card")
        rng = np.random.default_rng(7)
        shared = rng.integers(4, 512, 32)
        reqs = {}

        def submit(i, priority=1, max_new=24, temperature=None, **extra):
            ids = rng.integers(4, 512, int(rng.integers(5, 40)))
            if i % 3 == 0:                   # the shared 32-token prefix
                ids = np.concatenate([shared, ids])
            temp = (0.8 if i % 2 else 0.0) if temperature is None \
                else temperature
            rid = eng.submit(ids, len(ids), max_new, temperature=temp,
                             seed=100 + i, priority=priority, **extra)
            reqs[i] = (rid, ids, max_new, temp, 100 + i)

        for i in range(8):                      # 4 run, 4 wait
            submit(i)
        for _ in range(3):
            eng.step()
        submit(8, priority=0, max_new=12)       # preempts a priority-1 slot
        eng.step()
        victim = next(i for i, (rid, *_) in reqs.items()
                      if eng.result(rid).slot >= 0
                      and not eng.result(rid).done and i != 8)
        check(eng.cancel(reqs[victim][0]), f"pool {label}: cancel refused")
        submit(9, max_new=12, logit_bias={7: -100.0, 11: -100.0})
        submit(10, max_new=12, temperature=0.0, logprobs=5)
        submit(11, max_new=12)
        eng.run()
        stats = dict(eng.stats)
        check(stats["prefix_hits"] > 0 and stats["preempted"] > 0
              and stats["cancelled"] == 1,
              f"pool {label}: the schedule missed a feature: {stats}")
        gaps = []
        for i, (rid, ids, max_new, temp, seed) in reqs.items():
            got = eng.result(rid).tokens
            want = solo_run(gen, ids, max_new, temp, seed)
            if i == victim:
                want = want[:len(got)]
            elif i == 9:
                check(not {7, 11} & set(got),
                      f"pool {label}: a banned token came out: {got}")
                continue
            gap = divergence_gap(gen, ids, want, got, sampling, temp, seed)
            check(gap <= tol, f"pool {label}: request {i} (temperature "
                  f"{temp}) lies {gap} from its solo run (> {tol}): "
                  f"{got} against {want}")
            gaps.append(gap)
        lp_req = eng.result(reqs[10][0])
        check(len(lp_req.logprobs) == len(lp_req.tokens) > 0
              and all(top[0][0] == t and abs(top[0][1] - lp) <= tol
                      for t, (lp, top) in zip(lp_req.tokens,
                                              lp_req.logprobs)),
              f"pool {label}: the greedy logprobs are not the top-1's")
        # the driver: a deadline expires mid-decode (each step slowed
        # by 10 ms), a neighbour finishes
        driver = ContinuousDriver(eng)
        step = eng.step
        eng.step = lambda: (time.sleep(0.01), step())[1]
        # a prompt whose solo run does not stop before 80 tokens
        ids = next(x for x in (rng.integers(4, 512, 9) for _ in range(50))
                   if len(solo_run(gen, x, 80, 0.0, 0)) == 80)
        partial = None
        try:
            driver.generate(ids, 9, 80, deadline_s=0.05)
        except DeadlineExceeded as e:
            partial = e.tokens
        other = rng.integers(4, 512, 7)
        whole = driver.generate(other, 7, 6)
        driver.close()
        check(partial is not None and driver.timeouts == 1,
              f"pool {label}: the deadline never expired")
        partial = partial or []
        want = solo_run(gen, ids, 80, 0.0, 0)[:len(partial)]
        check(divergence_gap(gen, ids, want, partial, sampling) <= tol
              and divergence_gap(gen, other, solo_run(gen, other, 6, 0.0, 0),
                                 whole, sampling) <= tol,
              f"pool {label}: the deadline's partial or its neighbour left "
              f"the solo runs")
        out[label] = {"max_gap": max(gaps), "stats": stats,
                      "deadline_tokens": len(partial)}
        log(f"serve, continuous (a): tiny pool {label} (4 slots, prefix "
            f"cache {'in host memory' if host else 'on the card'}): 12 "
            f"requests equal their solo runs but at near-ties (largest gap "
            f"{max(gaps):.3g} <= {tol}); {stats['prefix_hits']} prefix "
            f"hits, {stats['preempted']} preempted, 1 cancelled, "
            f"{stats['spec_dispatches']} speculative / "
            f"{stats['plain_dispatches']} plain dispatches; a 50 ms deadline "
            f"returned {len(partial)} tokens of its solo run")
    return out


def serve_continuous(stack, questions, dev, seed: int, root: pathlib.Path,
                     direct_decode: dict) -> dict:
    """Phase 6f: the continuous slot pool. (a) `check_pool_tiny`; (c)
    `app.server.build_system` with `llm.mode: tpu, scheduler: continuous`
    (the 12B, POOL_SLOTS slots, POOL_PREFIX prefix-cache entries on the
    card) over the serve phase's index and encoders, served on loopback:
    one warm-up /query, then POOL_QUERIES concurrent /query with answers
    of POOL_ANSWER_TOKENS new tokens, /stats, one /generate with
    `logprobs` and `logit_bias`, one chat completion with top-5 logprobs;
    (b) `pool_alone` over the RAG prompts (c) sent."""
    import threading

    import numpy as np
    import torch

    import rag_dpo_tpu_torch.bootstrap as bootstrap
    from rag_dpo_tpu_torch.app.server import build_system, serve
    from rag_dpo_tpu_torch.models.decoder import init_random_
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.providers.tpu_llm import TPULLMProvider

    tiny = check_pool_tiny(dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()

    build_stack = bootstrap.build_stack

    def injected(config=None, paths=None, llm=None, **kw):
        # the serve phase's loaded index and encoders, as in phase 6d
        return build_stack(config, paths, llm=llm, index=stack.index,
                           embedder=stack.embedder,
                           reranker=stack.pipeline.reranker, **kw)

    bootstrap.build_stack = injected
    try:
        with environ(RAGDPO_TPU_ROOT=str(root), RAGDPO_LLM_MODE="tpu",
                     RAGDPO_LLM_SCHEDULER="continuous",
                     RAGDPO_LLM_MAX_BATCH=str(POOL_SLOTS),
                     RAGDPO_LLM_PREFIX_CACHE=str(POOL_PREFIX)):
            t0 = time.perf_counter()
            system = build_system(agent_too=False, device=dev)
            torch.cuda.synchronize()
            boot_s = time.perf_counter() - t0
    finally:
        bootstrap.build_stack = build_stack
    llm = system["llm"]
    engine = llm._driver.engine
    check(isinstance(llm, TPULLMProvider) and engine.slots == POOL_SLOTS
          and engine.prefix_cache == POOL_PREFIX and engine.chunk == 4
          and not engine.speculative
          and llm.config.num_layers == 40 and llm.config.hidden_size == 5120
          and llm.config.quantize_weights,
          f"build_system's llm: {llm!r}, {llm.config}")
    check(all(t.is_cuda for t in engine.model.state_dict().values())
          and all(t.is_cuda for layer in engine._carry.caches
                  for t in layer.values()),
          "a 12B weight or pool tensor is not on the card")
    if seed:
        init_random_(engine.model, seed)
    pool_gb = sum(t.numel() * t.element_size() for layer in
                  engine._carry.caches for t in layer.values()) / 1e9
    llm.max_new_tokens = POOL_ANSWER_TOKENS
    system["pipe"].max_quality_retries = 0   # random weights never ground
    sent = []
    generate = llm.generate

    @functools.wraps(generate)   # the server reads the options it takes
    def recording(prompt, system=None, **kw):
        sent.append((prompt, system))
        return generate(prompt, system=system, **kw)

    llm.generate = recording
    srv = serve(port=0, system=system)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        code, body, warm_s = http(base, "/query", {"question": questions[0]})
        check(code == 200 and json.loads(body)["error"] is None,
              f"warm-up /query: {code} {body[:300]}")
        snap = dict(engine.stats)
        _kernels.reset_counts()
        times, replies = [None] * POOL_QUERIES, [None] * POOL_QUERIES

        def ask(i):
            code, body, dt = http(base, "/query", {
                "question": questions[1 + i % (len(questions) - 1)]})
            replies[i], times[i] = (code, json.loads(body)), dt

        workers = [threading.Thread(target=ask, args=(i,))
                   for i in range(POOL_QUERIES)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        launches = {n: _kernels.LAUNCHES[n] for n in SERVE_KERNELS}
        plain = twins_on_the_card()
        for code, data in replies:
            check(code == 200 and data["error"] is None
                  and data["answer"].strip(),
                  f"concurrent /query: {code} {str(data)[:300]}")
        for name in SERVE_KERNELS:
            check(launches[name] > 0, f"{name} never launched in phase 6f")
        check(not any(plain.values()), f"a twin ran in phase 6f: {plain}")
        attention = decoder_attention("6f")
        steps = engine.stats["steps"] - snap["steps"]
        occupancy = (engine.stats["occupancy_sum"]
                     - snap["occupancy_sum"]) / max(steps, 1)
        calls = engine.stats["admitted"] - snap["admitted"]
        code, body, _ = http(base, "/stats")
        dpool = json.loads(body)["decode_pool"]
        check(code == 200 and dpool["slots"] == POOL_SLOTS
              and occupancy > 1.0,
              f"/stats decode_pool {dpool}; mean occupancy over the "
              f"concurrent queries {occupancy}")
        # the decoder's options in the JAX server's response shapes
        banned = 5
        code, body, _ = http(base, "/generate", {
            "prompt": questions[2], "max_tokens": 8, "logprobs": 5,
            "logit_bias": {str(banned): -100}})
        gen_reply = json.loads(body)
        check(code == 200 and set(gen_reply) == {"text", "model", "error"}
              and gen_reply["error"] is None,
              f"/generate with logprobs and logit_bias: {code} {gen_reply}")
        code, body, _ = http(base, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": questions[3]}],
            "max_tokens": 8, "logprobs": True, "top_logprobs": 5})
        chat = json.loads(body)
        content = (chat.get("choices") or [{}])[0].get("logprobs") or {}
        entries = content.get("content") or []
        check(code == 200 and entries
              and all(set(e) == {"token", "logprob", "top_logprobs"}
                      and len(e["top_logprobs"]) == 5 for e in entries),
              f"chat completion with top-5 logprobs: {code} "
              f"{str(chat)[:400]}")
    finally:
        srv.shutdown()
    llm.generate = generate
    p50, worst = float(np.median(times)) * 1e3, max(times) * 1e3
    log(f"serve, continuous (c): build_system booted the 12B pool "
        f"({POOL_SLOTS} slots, {pool_gb:.2f} GB of K/V, {POOL_PREFIX} "
        f"prefix entries on the card) in {boot_s:.2f} s; {POOL_QUERIES} "
        f"concurrent /query (answers of {POOL_ANSWER_TOKENS} new tokens) "
        f"after a {warm_s * 1e3:.0f} ms warm-up: p50 {p50:.1f} ms, max "
        f"{worst:.1f} ms; {calls} LLM calls through the pool in {steps} "
        f"engine steps, mean occupancy {occupancy:.2f} slots; /stats "
        f"decode_pool {dpool}; launches {launches}, plain twins on the "
        f"card {plain}")

    pool = pool_alone(llm, sent, direct_decode, before)
    vision = serve_vision(system, questions, dev, seed)
    llm._driver.close()
    out = {"tiny": tiny, "boot_s": boot_s, "pool_kv_gb": pool_gb,
           "query_p50_ms": p50, "query_max_ms": worst,
           "query_llm_calls": calls, "query_steps": steps,
           "query_mean_occupancy": occupancy, "decode_pool": dpool,
           "launches": launches, "plain_on_cuda": plain,
           "prefill_attention": attention, **pool, "vision": vision}
    del system, llm, engine, generate, recording
    return out


def pool_alone(llm, sent: list, direct_decode: dict, before: int) -> dict:
    """Phase 6f (b): the continuous provider's pool alone over the
    POOL_REQUESTS longest distinct prompts of `sent` ((prompt, system)
    pairs), alternated into two waves of streams of POOL_NEW_TOKENS
    tokens, the second starting when the first stream ends; then the
    first wave once more, timed, and once more under the profiler. Each
    starts from an empty prefix cache, so the only hits are prefixes that
    different prompts share (the system prompt, a query's context), never
    a prompt sent twice. `before` is the device bytes held before the
    phase."""
    import threading

    import numpy as np
    import torch

    engine = llm._driver.engine
    prompts = sorted(set(sent), key=lambda p: -len(p[0]))[:POOL_REQUESTS]
    check(len(prompts) == POOL_REQUESTS,
          f"(c) sent {len(prompts)} distinct prompts, (b) needs "
          f"{POOL_REQUESTS}")
    lengths = [int(llm.tokenizer.encode_batch(
        [f"{s}\n\n{p}" if s else p], 8192).lengths[0]) for p, s in prompts]
    waves = (list(range(0, POOL_REQUESTS, 2)),
             list(range(1, POOL_REQUESTS, 2)))
    ttft, latency, streamed, errors = {}, {}, {}, []

    def stream(i, done=None):
        prompt, sysmsg = prompts[i]
        t0 = time.perf_counter()
        n = 0
        try:
            for _ in llm.generate_stream(prompt, system=sysmsg,
                                         max_tokens=POOL_NEW_TOKENS):
                if not n:
                    ttft[i] = time.perf_counter() - t0
                n += 1
            latency[i], streamed[i] = time.perf_counter() - t0, n
        except Exception as exc:  # reported by the check after the joins
            errors.append((i, repr(exc)))
        finally:
            if done is not None:
                done.set()

    def idle_empty_cache():
        # the driver's thread touches the prefix cache only while a
        # request is queued or resident: once the pool is idle it may be
        # emptied from here
        t0 = time.perf_counter()
        while engine.busy and time.perf_counter() - t0 < 30:
            time.sleep(0.01)
        check(not engine.busy, "the pool stayed busy after its streams")
        engine._pentries.clear()
        engine._phash.clear()

    def run_wave(indices, done=None):
        threads = [threading.Thread(target=stream, args=(i, done))
                   for i in indices]
        for t in threads:
            t.start()
        return threads

    idle_empty_cache()
    snap = dict(engine.stats)
    first_done = threading.Event()
    t0 = time.perf_counter()
    threads = run_wave(waves[0], first_done)
    first_done.wait()      # set in a finally: a failed stream sets it too
    t_second = time.perf_counter()
    threads += run_wave(waves[1])
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not errors and len(latency) == POOL_REQUESTS,
          f"phase 6f (b): streams failed {errors} or never answered: "
          f"{sorted(set(range(POOL_REQUESTS)) - set(latency))}")
    tokens = sum(streamed.values())
    pool_steps = engine.stats["steps"] - snap["steps"]
    occupancy_b = (engine.stats["occupancy_sum"]
                   - snap["occupancy_sum"]) / max(pool_steps, 1)
    hits = engine.stats["prefix_hits"] - snap["prefix_hits"]
    saved = engine.stats["prefix_saved_tokens"] \
        - snap["prefix_saved_tokens"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    d1, d8 = (direct_decode[b]["tokens_per_s"] for b in DECODE_BATCHES)
    per_wave = [{"ttft_p50_ms": float(np.median([ttft[i] for i in w])) * 1e3,
                 "latency_p50_ms":
                     float(np.median([latency[i] for i in w])) * 1e3,
                 "prompt_tokens": [lengths[i] for i in w]} for w in waves]
    log(f"serve, continuous (b): {POOL_REQUESTS} distinct RAG prompts of "
        f"{min(lengths)}-{max(lengths)} tokens in two waves of "
        f"{POOL_REQUESTS // 2} streams of {POOL_NEW_TOKENS} new tokens "
        f"(the second started {(t_second - t0) * 1e3:.0f} ms in, when the "
        f"first stream ended): {tokens} tokens in {wall:.2f} s = "
        f"{tokens / wall:.1f} tokens/s (6e's direct decode: {d1:.1f} at "
        f"batch 1, {d8:.1f} at batch 8); {pool_steps} engine steps, mean "
        f"occupancy {occupancy_b:.2f}; time to first token p50 "
        f"{np.median(list(ttft.values())) * 1e3:.1f} ms, max "
        f"{max(ttft.values()) * 1e3:.1f} ms (wave 1 p50 "
        f"{per_wave[0]['ttft_p50_ms']:.1f}, wave 2 "
        f"{per_wave[1]['ttft_p50_ms']:.1f}); latency p50 "
        f"{np.median(list(latency.values())) * 1e3:.1f} ms, max "
        f"{max(latency.values()) * 1e3:.1f} ms (wave 1 p50 "
        f"{per_wave[0]['latency_p50_ms']:.1f}, wave 2 "
        f"{per_wave[1]['latency_p50_ms']:.1f}); {hits} prefix hits "
        f"skipping {saved} of {sum(lengths)} prompt tokens "
        f"({saved / sum(lengths):.1%}); peak device memory {peak_gb:.2f} "
        f"GB in phase 6f ({before / 1e9:.2f} GB held before it)")

    out = {"pool_tokens_per_s": tokens / wall, "pool_tokens": tokens,
           "pool_steps": pool_steps, "pool_mean_occupancy": occupancy_b,
           "pool_ttft_p50_ms": float(np.median(list(ttft.values()))) * 1e3,
           "pool_ttft_max_ms": max(ttft.values()) * 1e3,
           "pool_latency_p50_ms":
               float(np.median(list(latency.values()))) * 1e3,
           "pool_latency_max_ms": max(latency.values()) * 1e3,
           "pool_waves": per_wave, "pool_prefix_hits": hits,
           "pool_prefix_saved_tokens": saved,
           "pool_prompt_tokens": lengths, "peak_device_gb": peak_gb}

    # where the pool's time goes: wave 1 once more from an empty prefix
    # cache, each admission (prefill, insert, prefix store) and each
    # decode dispatch timed on the driver's thread and closed by a
    # synchronize; then once more under the profiler for the card's busy
    # share
    admits, dispatches = [], []

    def timed(fn, spent):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - t)
            return out
        return run

    def one_wave():
        idle_empty_cache()
        for t in run_wave(waves[0]):
            t.join()
        check(not errors, f"phase 6f (b): streams failed {errors}")

    snap = dict(engine.stats)
    engine._admit_into = timed(engine._admit_into, admits)
    engine._plain_advance = timed(engine._plain_advance, dispatches)
    try:
        t0 = time.perf_counter()
        one_wave()
        wave_s = time.perf_counter() - t0
    finally:
        idle_empty_cache()
        del engine._admit_into, engine._plain_advance
    wave_steps = engine.stats["steps"] - snap["steps"]
    busy_b, _ = profile_once(one_wave, "one pool wave of "
                             f"{len(waves[0])} streams", wave_s, show=())
    rest = wave_s - sum(admits) - sum(dispatches)
    log(f"serve, continuous (b), one wave alone: {wave_s * 1e3:.1f} ms, "
        f"{len(admits)} admissions {sum(admits) * 1e3:.1f} ms (mean "
        f"{np.mean(admits) * 1e3:.1f}), {len(dispatches)} decode dispatches "
        f"of {engine.chunk} steps {sum(dispatches) * 1e3:.1f} ms (mean "
        f"{np.mean(dispatches) * 1e3:.1f}, "
        f"{np.mean(dispatches) * 1e3 / engine.chunk:.1f} a step), the rest "
        f"{rest * 1e3:.1f} ms; {wave_steps} engine steps; device busy "
        f"{busy_b if busy_b is None else f'{busy_b:.1%}'}")
    return {**out, "wave_ms": wave_s * 1e3,
            "wave_admit_ms": [x * 1e3 for x in admits],
            "wave_dispatch_ms": [x * 1e3 for x in dispatches],
            "wave_device_busy_share": busy_b}


def vision_err(got, want, dtype) -> tuple:
    """(largest |got − want|, its tolerance) of two tensors of the tiny
    LLaVA on the card and on the CPU: VISION_TOL in f32 (only the order of
    sums differs), VISION_BF16_ULPS bf16 ulps of the reference's largest
    value in bf16 (the GEMMs round their outputs in their own order)."""
    import torch

    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    err = float((g - w).abs().max())
    if dtype == torch.float32:
        return err, VISION_TOL
    top = max(float(w.abs().max()), 2.0 ** -126)
    return err, VISION_BF16_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)


def check_llava_tiny(dev) -> dict:
    """Phase 6g (a): the tiny LLaVA on the card (seeded random weights),
    in f32 and in bf16 with int8 decoder weights, against a copy of the
    same weights on the CPU: `encode_image` on the card within
    `vision_err`'s tolerance of the CPU's; raw uint8 pixels (normalized on
    the card) within it of the host-normalized f32 ones; `compose`'s
    spliced embeddings within it of the CPU's; every greedy token of
    `generate` within `DECODER_TOL` of the largest logit of one full
    forward over the spliced prefix and the decoded tokens; then one image
    request through a 4-slot pool beside three text requests, equal to its
    direct run but at a near-tie of its logits (ROADMAP C-29), as each
    text request is to its solo run."""
    import numpy as np
    import torch

    from rag_dpo_tpu_torch.models.decoder import DecoderConfig
    from rag_dpo_tpu_torch.models.generate import SamplingConfig
    from rag_dpo_tpu_torch.models.llava import LlavaConfig, LlavaGenerator
    from rag_dpo_tpu_torch.models.vit import (
        ViTConfig,
        preprocess_image,
        preprocess_image_raw,
    )
    from rag_dpo_tpu_torch.serving import ContinuousEngine
    from rag_dpo_tpu_torch.serving.continuous import divergence_gap

    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (40, 52, 3), dtype=np.uint8),
              rng.integers(0, 256, (28, 28, 3), dtype=np.uint8)]
    pre = np.asarray([5, 6, 7], np.int32)
    post = rng.integers(3, 512, 9).astype(np.int32)
    stops = SamplingConfig(temperature=0.0, eos_id=2, pad_id=1)
    out = {}
    for label, vdt, kw in (
            ("f32", torch.float32, dict(dtype=torch.float32)),
            ("bf16_int8", torch.bfloat16, dict(quantize_weights=True,
                                               tie_embeddings=True))):
        cfg = LlavaConfig(vision=ViTConfig.tiny(dtype=vdt),
                          text=DecoderConfig.tiny(**kw))
        dt = cfg.text.dtype
        lg = LlavaGenerator(cfg, rng_seed=1, device=dev)
        mods = lg.load()
        check(all(t.is_cuda for m in (*mods.values(), lg.generator.load())
                  for t in m.state_dict().values()),
              f"tiny LLaVA {label}: a weight is not on the card")
        cpu = LlavaGenerator(cfg, device="cpu")
        cpu.generator.load().load_state_dict(lg.generator.load().state_dict())
        for name, m in cpu.load().items():
            m.load_state_dict(mods[name].state_dict())
        raw = preprocess_image_raw(images[0], cfg.vision.image_size)
        f32 = preprocess_image(images[0], cfg.vision.image_size)[None]
        card = lg.encode_image(f32, fetch=False)
        errs = {"encode": vision_err(card, cpu.encode_image(f32, fetch=False),
                                     dt),
                "uint8": vision_err(lg.encode_image(raw[None], fetch=False),
                                    card, dt)}
        e, n = lg.compose(pre, post, images[0])
        ec, nc = cpu.compose(pre, post, images[0])
        check(e.is_cuda and n == nc and e.shape == ec.shape
              and e.dtype == dt, f"tiny LLaVA {label}: compose gave "
              f"{tuple(e.shape)} {e.dtype} ({n}) against {tuple(ec.shape)}")
        errs["compose"] = vision_err(e, ec, dt)
        for what, (err, tol) in errs.items():
            check(err <= tol, f"tiny LLaVA {label}: {what} on the card lies "
                  f"{err} from the CPU's (> {tol})")
        # generate against one full forward over prefix + decoded tokens
        greedy = SamplingConfig(temperature=0.0, max_new_tokens=16,
                                eos_id=-1, pad_id=0)
        toks = lg.generate(pre, post, images[1], greedy)[0]
        e1, n1 = lg.compose(pre, post, images[1])
        model = lg.generator.load()
        t = torch.as_tensor(toks, dtype=torch.long, device=dev)
        with torch.no_grad():
            seq = torch.cat([e1[0, :n1], model.embed_tokens(t)])[None]
            logits = model(None, inputs_embeds=seq)[0, n1 - 1:-1].float()
        gap = float((logits.max(-1).values
                     - logits.gather(1, t[:, None])[:, 0]).max())
        tol = DECODER_TOL[str(dt).split(".")[-1]]
        check(len(toks) == 16 and gap <= tol,
              f"tiny LLaVA {label}: a greedy token lies {gap} below its full "
              f"forward's maximum (> {tol})")
        # one image request in a 4-slot pool beside text requests
        gen = lg.generator
        eng = ContinuousEngine(gen, slots=4, sampling=stops, chunk=4,
                               prefix_cache=2, prefix_block=8,
                               prefill_chunk=16)
        texts = [rng.integers(3, 512, int(rng.integers(5, 40)))
                 for _ in range(3)]
        rids = [eng.submit(x, len(x), 16) for x in texts[:2]]
        eng.step()
        vid = eng.submit_embeds(e[0], n, 16)
        rids.append(eng.submit(texts[2], len(texts[2]), 16))
        eng.run()
        direct = gen.generate_with_embeds(
            e, np.asarray([n], np.int32),
            SamplingConfig(temperature=0.0, eos_id=2, pad_id=1,
                           max_new_tokens=16))[0]
        want = list(itertools.takewhile(lambda x: int(x) not in (1, 2),
                                        direct))
        pool_gaps = [divergence_gap(gen, e[0, :n], want,
                                    eng.result(vid).tokens, stops)]
        for rid, x in zip(rids, texts):
            pool_gaps.append(divergence_gap(
                gen, x, solo_run(gen, x, 16, 0.0, 0),
                eng.result(rid).tokens, stops))
        check(max(pool_gaps) <= tol, f"tiny LLaVA {label}: the pool's "
              f"requests lie {pool_gaps} from their direct runs (> {tol})")
        out[label] = {**{f"{k}_err": v[0] for k, v in errs.items()},
                      "generate_gap": gap, "pool_gap": max(pool_gaps)}
        log(f"serve, vision (a): tiny LLaVA {label} on the card against the "
            f"CPU: " + ", ".join(f"{k} {v[0]:.3g} (<= {v[1]:.3g})"
                                 for k, v in errs.items())
            + f"; greedy tokens within {gap:.3g} of the full forward's "
            f"maximum; the image request in a 4-slot pool beside 3 text "
            f"requests within {max(pool_gaps):.3g} of its direct run "
            f"(<= {tol})")
    return out


def vision_encode_bound(cfg) -> dict:
    """The least time of one image's encode at batch 1: the products of
    the patch embedding, the `output_layer` layers' Dense layers and the
    projector on the bf16 tensor cores, the attention's two products in f32
    on the CUDA cores (as the tower runs them), or the bf16 weights and the
    pixels read once and the patches written once, whichever is longer."""
    v = cfg.vision
    layers, h, f = cfg.output_layer, v.hidden_size, v.intermediate_size
    s, n_img, th = v.num_patches + 1, v.num_patches, cfg.text.hidden_size
    dense = 2 * s * (4 * h * h + 2 * h * f) * layers \
        + 2 * n_img * 3 * v.patch_size ** 2 * h \
        + 2 * n_img * (h * th + th * th)
    attn = 2 * 2 * s * s * h * layers
    weights = 2 * ((4 * h * h + 2 * h * f) * layers
                   + 3 * v.patch_size ** 2 * h + s * h
                   + h * th + th * th)
    nbytes = weights + 3 * v.image_size ** 2 + 2 * n_img * th
    ops_ms = (dense / BF16_FLOPS + attn / F32_FLOPS) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "bound_terms_ms": {"bf16_products": dense / BF16_FLOPS * 1e3,
                               "f32_attention": attn / F32_FLOPS * 1e3,
                               "bytes": bytes_ms}}


def sse_chat(base: str, payload: dict) -> dict:
    """One streamed chat completion: the content deltas with the seconds
    each arrived after the request left, and whether `[DONE]` ended it."""
    import urllib.request

    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    stamps, parts, done = [], [], False
    with urllib.request.urlopen(req, timeout=300) as r:
        check(r.status == 200, f"streamed chat: {r.status}")
        for raw in r:
            line = raw.decode().strip()
            if line == "data: [DONE]":
                done = True
                break
            if line.startswith("data: "):
                delta = json.loads(line[6:])["choices"][0]["delta"]
                if delta.get("content"):
                    stamps.append(time.perf_counter() - t0)
                    parts.append(delta["content"])
    check(done and len(parts) >= 2,
          f"streamed chat: {len(parts)} deltas, [DONE] {done}")
    return {"sent": t0, "ttft_ms": stamps[0] * 1e3,
            "total_ms": stamps[-1] * 1e3, "deltas": len(parts),
            "tokens_per_s": (len(parts) - 1) / (stamps[-1] - stamps[0]),
            "text": "".join(parts)}


def fmt_where(stream: dict) -> str:
    return ", ".join(f"{k[:-3]} {v:.1f}" for k, v in stream["where"].items())


def serve_vision(system, questions, dev, seed: int) -> dict:
    """Phase 6g, inside 6f while its 12B pool is resident: (a)
    `check_llava_tiny`; then `attach_vision()` on the pool's provider
    (CLIP-ViT-L/14-336 and the 1024 → 5120 → 5120 projector, JAX's random
    init from key 0); (b) the tower's encode at batch 1 cold, warm and as a
    patch-cache hit beside its bound, the splice, the embeds prefill at
    its bucket beside its bound; (c) on loopback: one chat completion with
    a 336×336 PNG as a `data:` URL, one streamed with a 480×320 PNG (time
    to first token, tokens/s), then the first image again, streamed, while
    VISION_BESIDE text /query are in flight: its patches must come from the
    cache, the pool must hold more than one slot on average while it
    decodes, K1, K3 and K4 must launch and no twin may run; then
    `ImageClassifier(vision_llm=...)` must return one of its labels."""
    import base64
    import io
    import threading

    import numpy as np
    import torch
    from PIL import Image

    from rag_dpo_tpu_torch.app.server import serve
    from rag_dpo_tpu_torch.ingest.images import (
        CLASSES,
        VISION_PROMPT,
        ImageClassifier,
    )
    from rag_dpo_tpu_torch.models.vit import preprocess_image_raw
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.tokenize.base import bucket_length

    t_phase = time.perf_counter()
    tiny = check_llava_tiny(dev)
    tiny_s = time.perf_counter() - t_phase
    llm = system["llm"]
    engine = llm._driver.engine
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    lg = llm.attach_vision()
    mods = lg.load()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, v = lg.config, lg.config.vision
    check((v.image_size, v.patch_size, v.hidden_size, v.num_layers,
           v.num_heads, v.intermediate_size, cfg.num_image_tokens,
           cfg.output_layer, v.dtype, lg.generator is llm.generator,
           mods["projector"].linear_2.weight.shape)
          == (336, 14, 1024, 24, 16, 4096, 576, 23, torch.bfloat16, True,
              (5120, 5120)), f"attach_vision built {cfg}")
    check(all(t.is_cuda for m in mods.values()
              for t in m.state_dict().values()),
          "a vision weight is not on the card")
    tower_gb = sum(t.numel() * t.element_size() for m in mods.values()
                   for t in m.state_dict().values()) / 1e9
    rng = np.random.default_rng(seed)

    def png(h, w):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(buf, format="PNG")
        return buf.getvalue()

    square, wide, fresh = png(336, 336), png(320, 480), png(336, 336)

    # (b) the tower at batch 1, the splice, the embeds prefill
    raw = preprocess_image_raw(Image.open(io.BytesIO(fresh)), v.image_size)
    pix = torch.as_tensor(np.array(raw[None]), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    patches = lg._encode(pix)[0]       # the first: the bf16 copies made
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    warm_ms = cuda_ms(lambda: lg._encode(pix), iters=10, warmup=1)
    encode_device_ms = device_ms(lambda: lg._encode(pix))
    lg.encode_patches(raw)             # a miss: now cached
    hits = lg.cache_stats["hits"]
    t0 = time.perf_counter()
    hit = lg.encode_patches(raw)
    hit_ms = (time.perf_counter() - t0) * 1e3
    check(lg.cache_stats["hits"] == hits + 1 and torch.equal(hit, patches),
          "the patch cache missed a repeated image, or its patches differ")
    encode_bound = vision_encode_bound(cfg)
    pre, post, _, _ = llm._prepare_image_request(VISION_PROMPT, fresh)
    n = len(pre) + cfg.num_image_tokens + len(post)
    s = bucket_length(n)
    splice_ms = cuda_ms(lambda: lg.splice(patches, pre, post, s), iters=20)
    embeds = lg.splice(patches, pre, post, s)
    lengths = torch.tensor([n], device=dev)
    gen = llm.generator
    prefill_ms = cuda_ms(lambda: gen._prefill(None, lengths, cache_len=s,
                                              embeds=embeds),
                         iters=3, warmup=1)
    weights = gen.load().state_dict().values()
    prefill_bound = bound(2.0 * sum(t.numel() for t in weights) * n,
                          sum(t.numel() * t.element_size() for t in weights),
                          BF16_FLOPS)
    log(f"serve, vision (b): attach_vision built CLIP-ViT-L/14-336 and the "
        f"projector ({tower_gb:.2f} GB of f32 weights) in {init_s:.2f} s; "
        f"one image's encode at batch 1 cold {cold_ms:.2f} ms (the bf16 "
        f"copies made), warm {warm_ms:.4f} ms (device "
        f"{fmt_ms(encode_device_ms)}), a patch-cache hit {hit_ms:.4f} ms; "
        f"bound {encode_bound['bound_ms']:.4f} ms "
        f"({encode_bound['bound_by']}: "
        + ", ".join(f"{k} {x:.4f}" for k, x in
                    encode_bound["bound_terms_ms"].items())
        + f"); the splice of {n} rows into a {s}-row bucket "
        f"{splice_ms:.4f} ms; the embeds prefill of {n} positions at its "
        f"{s}-row bucket {prefill_ms:.2f} ms, bound "
        f"{prefill_bound['bound_ms']:.2f} ms ({prefill_bound['bound_by']})")

    # (c) the chat surface on loopback, beside text /query
    def messages(image):
        return [{"role": "user", "content": [
            {"type": "text", "text": VISION_PROMPT},
            {"type": "image_url", "image_url": {
                "url": "data:image/png;base64,"
                       + base64.b64encode(image).decode()}}]}]

    srv = serve(port=0, system=system)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    steps, marks = [], {}
    step, compose, submit = engine.step, lg.compose, engine.submit_embeds

    def watched():
        # the pool's rows, whether an image row decodes in this step, and
        # when the step ended
        was = any(r.embeds is not None for r in engine._active.values())
        occ = engine.stats["occupancy_sum"]
        t = time.perf_counter()
        out = step()
        steps.append((engine.stats["occupancy_sum"] - occ, was or any(
            r.embeds is not None for r in engine._active.values()),
            t, time.perf_counter()))
        return out

    def stamped(name, fn):
        # when an image request's compose ended, and when the driver
        # handed it to the engine
        def run(*a, **kw):
            out = fn(*a, **kw)
            marks[name] = time.perf_counter()
            return out
        return run

    def where(stream: dict) -> dict:
        # an image request's time to first token, split: compose (on the
        # HTTP thread), until the driver handed it to the engine, waiting
        # for a slot, the step that admitted it (its prefill and the
        # pool's dispatch), then until the first delta reached the client
        first = next(((a, b) for _, v, a, b in steps if v),
                     (float("nan"),) * 2)
        t0 = stream["sent"]
        return {"compose_ms": (marks["compose"] - t0) * 1e3,
                "handoff_ms": (marks["submit"] - marks["compose"]) * 1e3,
                "slot_wait_ms": (first[0] - marks["submit"]) * 1e3,
                "admit_step_ms": (first[1] - first[0]) * 1e3,
                "delivery_ms": stream["ttft_ms"] - (first[1] - t0) * 1e3}

    try:
        code, body, oneshot_s = http(base, "/v1/chat/completions", {
            "messages": messages(square), "max_tokens": VISION_NEW_TOKENS})
        reply = json.loads(body)
        content = ((reply.get("choices") or [{}])[0].get("message")
                   or {}).get("content")
        check(code == 200 and isinstance(content, str) and content.strip(),
              f"image chat completion: {code} {str(reply)[:300]}")
        lg.compose = stamped("compose", compose)
        engine.submit_embeds = stamped("submit", submit)
        engine.step = watched
        alone = sse_chat(base, {"messages": messages(wide), "stream": True,
                                "max_tokens": VISION_NEW_TOKENS})
        alone["where"] = where(alone)
        steps.clear()
        hits = lg.cache_stats["hits"]
        _kernels.reset_counts()
        replies = [None] * VISION_BESIDE

        def ask(i):
            code, body, _ = http(base, "/query", {
                "question": questions[1 + i % (len(questions) - 1)]})
            replies[i] = (code, json.loads(body))

        workers = [threading.Thread(target=ask, args=(i,))
                   for i in range(VISION_BESIDE)]
        for w in workers:
            w.start()
        t0 = time.perf_counter()
        while not engine._active and time.perf_counter() - t0 < 60:
            time.sleep(0.005)
        beside = sse_chat(base, {"messages": messages(square),
                                 "stream": True,
                                 "max_tokens": VISION_NEW_TOKENS})
        beside["where"] = where(beside)
        for w in workers:
            w.join()
    finally:
        del engine.step, engine.submit_embeds, lg.compose
        srv.shutdown()
    launches = {k: _kernels.LAUNCHES[k] for k in SERVE_KERNELS}
    plain = twins_on_the_card()
    for code, data in replies:
        check(code == 200 and data["error"] is None,
              f"a /query beside the image request: {code} {str(data)[:300]}")
    decoding = [occ for occ, vis, *_ in steps if vis]
    occupancy = float(np.mean(decoding)) if decoding else 0.0
    check(lg.cache_stats["hits"] > hits,
          "the repeated image missed the patch cache")
    check(occupancy > 1.0, f"the pool held {occupancy} slots on average "
          f"while the image request decoded ({len(decoding)} steps)")
    for name in SERVE_KERNELS:
        check(launches[name] > 0, f"{name} never launched in phase 6g")
    check(not any(plain.values()), f"a twin ran in phase 6g: {plain}")
    attention = decoder_attention("6g")
    t0 = time.perf_counter()
    decision = ImageClassifier(vision_llm=llm).classify(square)
    classify_s = time.perf_counter() - t0
    check(decision.label in CLASSES, f"ImageClassifier: {decision}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    phase_s = time.perf_counter() - t_phase
    log(f"serve, vision (c): an image chat completion (336×336 PNG, "
        f"{VISION_NEW_TOKENS} new tokens) in {oneshot_s * 1e3:.1f} ms; "
        f"streamed alone (480×320 PNG): first token {alone['ttft_ms']:.1f} "
        f"ms, {alone['tokens_per_s']:.2f} tokens/s over {alone['deltas']} "
        f"deltas ({fmt_where(alone)}); the first image again beside "
        f"{VISION_BESIDE} text /query: a patch-cache hit, first token "
        f"{beside['ttft_ms']:.1f} ms ({fmt_where(beside)}), "
        f"{beside['tokens_per_s']:.2f} tokens/s, the pool's mean occupancy "
        f"{occupancy:.2f} slots over the {len(decoding)} steps it decoded; "
        f"launches {launches}, plain twins on the card {plain}; "
        f"ImageClassifier: {decision.label} by {decision.method} in "
        f"{classify_s:.2f} s; peak device memory {peak_gb:.2f} GB in phase "
        f"6g ({before / 1e9:.2f} GB held before it); phase 6g took "
        f"{phase_s:.1f} s, (a) {tiny_s:.1f} s of them")
    return {"tiny": tiny, "init_s": init_s, "tower_gb": tower_gb,
            "encode_cold_ms": cold_ms, "encode_warm_ms": warm_ms,
            "encode_device_ms": encode_device_ms, "encode_hit_ms": hit_ms,
            "encode_bound": encode_bound, "splice_ms": splice_ms,
            "prefill_positions": n, "prefill_bucket": s,
            "prefill_ms": prefill_ms, "prefill_bound": prefill_bound,
            "chat_ms": oneshot_s * 1e3,
            "alone": {k: x for k, x in alone.items()
                      if k not in ("text", "sent")},
            "beside": {k: x for k, x in beside.items()
                       if k not in ("text", "sent")},
            "beside_mean_occupancy": occupancy,
            "classifier": [decision.label, decision.method],
            "launches": launches, "plain_on_cuda": plain,
            "prefill_attention": attention,
            "peak_device_gb": peak_gb, "phase_s": phase_s}


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


def f32_ulps(want, got) -> int:
    """The largest gap of two f32 tensors in ulps (their bit patterns)."""
    import torch

    a = want.detach().float().cpu().contiguous().view(torch.int32)
    b = got.detach().float().cpu().contiguous().view(torch.int32)
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def init_gap(want: dict, got: dict, what: str) -> dict:
    """Leaf by leaf, two Flax-named trees of one family's init: f32 leaves
    within INIT_ULPS, int8 leaves equal but a share ≤ INIT_INT8_OFF one
    off. → the largest gaps."""
    import torch
    from rag_dpo_tpu_torch.models.convert import flatten_params

    want, got = flatten_params(want), flatten_params(got)
    check(sorted(want) == sorted(got), f"3c {what}: leaves differ")
    ulps, off = 0, 0.0
    for name, w in want.items():
        g = got[name]
        check(w.shape == g.shape and w.dtype == g.dtype,
              f"3c {what} {name}: {w.shape} {w.dtype} vs {g.shape} {g.dtype}")
        if w.dtype == torch.int8:
            d = (w.cpu().int() - g.cpu().int()).abs()
            check(int(d.max()) <= 1, f"3c {what} {name}: int8 off by more "
                  f"than one")
            off = max(off, float((d > 0).float().mean()))
        else:
            ulps = max(ulps, f32_ulps(w, g))
    check(ulps <= INIT_ULPS and off <= INIT_INT8_OFF,
          f"3c {what}: card against CPU {ulps} ulp, int8 one off in a "
          f"share {off}")
    return {"max_ulps": ulps, "int8_off_share": off}


def check_flax_init(dev, seed: int) -> dict:
    """Phase 3c: the seeded Flax init on the card. (a) the Triton draw
    against its twin, bit for bit, and both timed over the 12B's widest
    int8 kernel; (b) the four model families from one seed on the card
    and on the CPU."""
    import torch

    from rag_dpo_tpu_torch.models import flax_init
    from rag_dpo_tpu_torch.models.bge_m3 import BgeM3Config, build_bge_m3
    from rag_dpo_tpu_torch.models.decoder import (
        DecoderConfig,
        build_decoder,
        decoder_flax_tree,
        init_random_,
    )
    from rag_dpo_tpu_torch.models.llava import LlavaConfig, LlavaGenerator
    from rag_dpo_tpu_torch.retrieval.reranker import CrossEncoderReranker

    t0 = time.perf_counter()
    key = flax_init.flax_param_key(seed, ("layer_0", "mlp", "up_proj"), 1)
    # (a) counters in the weight's order of a [5120, 14336] kernel, a block
    # of rows past 2^32, a 1-D leaf
    cases = {"transposed": [(0, 14_336, 1), (0, 5120, 14_336)],
             "past_2^32": [(300_000, 300_064, 14_336), (0, 14_336, 1)],
             "one_axis": [(7, 100_007, 1)]}
    for label, axes in cases.items():
        got = flax_init.bits_triton(key, axes, dev)
        want = flax_init.bits_plain(key, axes, dev)
        check(torch.equal(got, want), f"3c draw ({label}): the Triton bits "
              f"differ from the twin's")
    axes = cases["transposed"]
    n = 14_336 * 5120
    ms = cuda_ms(lambda: flax_init.bits_triton(key, axes, dev), iters=5)
    plain_ms = cuda_ms(lambda: flax_init.bits_plain(key, axes, dev),
                       iters=2, warmup=1)
    draw = {"name": "threefry_bits", "route": "triton",
            "source": "rag_dpo_tpu_torch/models/flax_init.py",
            "shape": [14_336, 5120], "ms": ms, "plain_ms": plain_ms,
            **bound(DRAW_OPS * n, 4 * n, flops_rate=INT32_LANES * H100_SMS
                    * sm_clock_hz()), "library_ms": None}
    for dt, bits in ((torch.float32, torch.int32),
                     (torch.bfloat16, torch.int16)):
        u = [flax_init.uniform(key, (1000, 999), -0.9545, 0.9545, dt, d)
             .cpu().view(bits) for d in (dev, "cpu")]
        check(torch.equal(*u),
              f"3c uniforms ({dt}) differ between the card and the CPU")
    x = flax_init.uniform(key, (4096, 1024), -1.0 + 2 ** -24, 1.0, device=dev)
    draw_ulps = f32_ulps(flax_init.erfinv_f32(x.cpu()),
                         flax_init.erfinv_f32(x))
    check(draw_ulps <= INIT_DRAW_ULPS,
          f"3c erfinv: card against CPU {draw_ulps} ulp")

    # (b) the families, card against CPU
    flax_init.reset_counts()
    views = flax_init.flax_views
    fam = {}
    pair = [build_bge_m3(BgeM3Config.tiny(), rng_seed=seed, device=d)
            for d in (dev, "cpu")]
    fam["bge_m3"] = init_gap(views(pair[1]), views(pair[0]), "BGE-M3")
    pair = [CrossEncoderReranker(device=d).load() for d in (dev, "cpu")]
    fam["cross_encoder"] = init_gap(views(pair[1]), views(pair[0]),
                                    "cross-encoder")
    pair = [LlavaGenerator(LlavaConfig.tiny(), device=d).load()
            for d in (dev, "cpu")]
    for part in ("vision", "projector"):
        fam[part] = init_gap(views(pair[1][part]), views(pair[0][part]),
                             part)
    cfg = DecoderConfig.tiny(quantize_weights=True)
    pair = [init_random_(build_decoder(cfg, d), seed) for d in (dev, "cpu")]
    fam["decoder_int8"] = init_gap(decoder_flax_tree(pair[1]),
                                   decoder_flax_tree(pair[0]), "decoder")
    launches = flax_init.LAUNCHES["threefry_bits"]
    check(launches > 0, "3c: the Triton draw never launched")
    secs = time.perf_counter() - t0
    log(f"seeded init (3c): the Triton draw equals its twin bit for bit "
        f"({', '.join(cases)}); over a [14336, 5120] kernel {fmt_ms(ms)} "
        f"(twin {fmt_ms(plain_ms)}, bound {fmt_ms(draw['bound_ms'])} by "
        f"{draw['bound_by']}); uniforms card = CPU; erfinv within "
        f"{draw_ulps} ulp; families card against CPU {json.dumps(fam)}; "
        f"{launches} draws launched; phase {secs:.1f} s")
    return {"draw": dict(draw, launches=launches), "families": fam,
            "erfinv_ulps": draw_ulps, "phase_s": secs}


def run_hermetic(dev) -> dict:
    """The hermetic replay through the port on the card: with the
    committed trained encoder, the gate against the trained records; with
    the port's own seeded init, the gate against the random-init record;
    then the MaxSim arm (trained)."""
    from rag_dpo_tpu_torch.evals.hermetic import (
        RESULTS_DIR,
        check_against_baseline,
        gated_values,
        run_hermetic_replay,
    )
    from rag_dpo_tpu_torch.evals.train_encoder import load_trained_params
    from rag_dpo_tpu_torch.ops import _kernels

    params = load_trained_params()
    committed = json.loads((RESULTS_DIR / RANDOM_INIT_RECORD).read_text())
    out = {}
    for arm, weights, reranker, kernels in (
            ("none", params, "none", ("ell_topk", "fused_topk")),
            ("random", None, "none", ("ell_topk", "fused_topk")),
            ("maxsim", params, "maxsim", ("ell_topk", "fused_topk",
                                          "maxsim"))):
        _kernels.reset_counts()
        t0 = time.perf_counter()
        record = run_hermetic_replay(n_runs=1, encoder_params=weights,
                                     reranker=reranker, device=dev)
        secs = time.perf_counter() - t0
        vals = gated_values(record)
        launches = {n: _kernels.LAUNCHES[n] for n in kernels}
        plain = dict(_kernels.PLAIN_ON_CUDA)
        check(record["reranker"] == reranker
              and all(0.0 <= v <= 1.0 for v in vals.values()),
              f"hermetic {arm}: {record}")
        check(all(launches.values()), f"hermetic {arm}: {launches}")
        check(not any(plain.values()), f"hermetic {arm}: plain {plain}")
        encoder = "trained" if weights is not None else "random-init"
        check(record["encoder"] == encoder, f"hermetic {arm}: {record}")
        if reranker == "none":
            failures = check_against_baseline(record)
            check(not failures, f"hermetic gate ({encoder}): {failures}")
        same = ""
        if weights is None:
            diff = {k: round(v - gated_values(committed)[k], 6)
                    for k, v in vals.items()}
            same = ("; every gated value equals the committed record's"
                    if not any(diff.values()) else
                    f"; against the committed record {json.dumps(diff)}")
            out[arm + "_vs_committed"] = diff
        log(f"hermetic, {encoder} encoder, reranker {reranker}: "
            f"{json.dumps(vals)} in {secs:.1f} s"
            + (f"; gate OK against the committed {encoder} records"
               if reranker == "none" else "; no committed series, not gated")
            + same + f"; launches {launches}")
        out[arm] = {"gated": vals, "launches": launches, "seconds": secs}
    return out


def run_quality_loop(dev) -> dict:
    """Phase 8b: `python -m rag_dpo_tpu_torch.evals.train_encoder`'s body
    on the card: LOOP_STEPS steps of the committed record's recipe (the
    tiny encoder, plain in-batch InfoNCE), the npz written to `TMPDIR` and
    loaded back, then the replay of the 48 questions three times with it.
    The loss must fall, the npz's leaves be finite, K3 and K4 launch with
    no twin, and true_doc@5 beat the best committed random-init record;
    the trained gate's verdict is checked where LOOP_GATE_HELD, else
    logged."""
    import numpy as np

    from rag_dpo_tpu_torch.evals.hermetic import (
        baseline_from_records,
        comparable_records,
        gated_values,
        load_committed_records,
    )
    from rag_dpo_tpu_torch.evals.train_encoder import (
        gate,
        load_trained_params,
        train_and_replay,
    )
    from rag_dpo_tpu_torch.models.convert import flatten_params
    from rag_dpo_tpu_torch.ops import _kernels

    _kernels.reset_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ragdpo_loop_") as tmp:
        out = pathlib.Path(tmp) / "trained_encoder_v2.npz"
        metrics, record = train_and_replay(out, LOOP_STEPS, device=dev)
        leaves = flatten_params(load_trained_params(out))
    seconds = time.perf_counter() - t0
    launches = {n: _kernels.LAUNCHES[n] for n in ("ell_topk", "fused_topk")}
    plain = dict(_kernels.PLAIN_ON_CUDA)
    check(metrics["loss_last"] < metrics["loss_first"],
          f"loop (8b): the loss did not fall: {metrics}")
    check(all(np.isfinite(v).all() for v in leaves.values()),
          "loop (8b): a non-finite weight in the npz")
    check(all(launches.values()) and not any(plain.values()),
          f"loop (8b): launches {launches}, plain twins {plain}")
    vals = gated_values(record)
    rand = baseline_from_records(comparable_records(
        load_committed_records(), dict(record, encoder="random-init")))
    check(vals["true_doc_hit_rate_at_5"] > rand["true_doc_hit_rate_at_5"],
          f"loop (8b): true_doc@5 {vals['true_doc_hit_rate_at_5']} does "
          f"not beat random-init's {rand['true_doc_hit_rate_at_5']}")
    code, lines = gate(record)
    if LOOP_GATE_HELD:
        check(code == 0, f"loop (8b): {lines}")
    log(f"loop (8b): {LOOP_STEPS} steps in {metrics['train_seconds']:.2f} "
        f"s = {metrics['steps_per_s']:.1f} steps/s, loss "
        f"{metrics['loss_first']} → {metrics['loss_last']}; replay ×3: "
        f"{json.dumps(vals)}; true_doc@5 beats random-init's "
        f"{rand['true_doc_hit_rate_at_5']}; trained gate: "
        + " / ".join(lines[1:])
        + ("" if LOOP_GATE_HELD else " (logged, not checked)")
        + f"; launches {launches}; phase {seconds:.1f} s")
    return {"train_s": metrics["train_seconds"],
            "steps_per_s": metrics["steps_per_s"],
            "loss_first": metrics["loss_first"],
            "loss_last": metrics["loss_last"], "gated": vals,
            "random_init_true_doc_at_5": rand["true_doc_hit_rate_at_5"],
            "trained_gate": lines[-1], "trained_gate_code": code,
            "launches": launches, "phase_s": seconds}


def run_front_doors(dev) -> dict:
    """The Quick start's commands on the card: `python -m
    rag_dpo_tpu_torch.check_install` in a subprocess (rc 0, "Prêt.", K4
    launched by its device program), then `python -m
    rag_dpo_tpu_torch.app.rag_cli --canned` through `runpy` in this
    process, its launches counted from 0, on the demo stack and with
    `--index` over a saved copy of the demo index: 5/5 answered each time,
    K4 launched, no twin. Neither runs K3, in either package: the demo
    stack's summary prefilter masks the sparse arm, which a small store
    scores in full and masks, and `--index` has no BM25 stats."""
    import io
    import runpy

    from rag_dpo_tpu_torch.app.demo import build_demo_stack
    from rag_dpo_tpu_torch.ops import _kernels

    out = {}
    with tempfile.TemporaryDirectory(prefix="ragdpo_doors_") as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT), RAGDPO_TPU_ROOT=tmp)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "rag_dpo_tpu_torch.check_install"],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        out["check_install_s"] = time.perf_counter() - t0
        printed = proc.stdout.strip()
        k4 = re.search(r"noyau fused_topk: (\d+) lancement", printed)
        check(proc.returncode == 0 and printed.endswith("Prêt.") and k4
              and int(k4.group(1)) > 0,
              f"check_install exited {proc.returncode}: {printed[-2000:]} "
              f"{proc.stderr[-2000:]}")
        out["check_install_k4_launches"] = int(k4.group(1))
        log("front doors: check_install in "
            f"{out['check_install_s']:.1f} s:\n" + printed)

        _, demo = build_demo_stack(device=dev)
        demo["index"].save(pathlib.Path(tmp) / "index")
        del demo
        for label, args in (("demo", []),
                            ("index", ["--index", f"{tmp}/index"])):
            _kernels.reset_counts()
            buf = io.StringIO()
            argv = sys.argv
            t0 = time.perf_counter()
            try:
                sys.argv = ["rag_cli", "--canned", *args]
                with environ(RAGDPO_TPU_ROOT=tmp), \
                        contextlib.redirect_stdout(buf):
                    runpy.run_module("rag_dpo_tpu_torch.app.rag_cli",
                                     run_name="__main__")
                code = 0
            except SystemExit as e:
                code = e.code
            finally:
                sys.argv = argv
            seconds = time.perf_counter() - t0
            launches = {n: _kernels.LAUNCHES[n]
                        for n in ("ell_topk", "fused_topk")}
            plain = dict(_kernels.PLAIN_ON_CUDA)
            summary = buf.getvalue().strip().splitlines()[-1]
            check(code == 0 and summary.startswith("==== 5/5 ok"),
                  f"rag_cli --canned {args} exited {code}: "
                  f"{buf.getvalue()[-2000:]}")
            # K4 only: the demo stack's summary prefilter masks the sparse
            # arm, which a small store then scores in full and masks, as
            # JAX's does (rag_dpo_tpu/index/store.py:780-783), and
            # `--index` builds no BM25 arm (no stats), as the root script
            check(launches["fused_topk"] and not any(plain.values()),
                  f"rag_cli {label}: launches {launches}, plain twins "
                  f"{plain}")
            log(f"front doors: rag_cli --canned {' '.join(args)} in "
                f"{seconds:.1f} s: {summary}; launches {launches}")
            out[f"rag_cli_{label}"] = {"seconds": seconds,
                                       "summary": summary,
                                       "launches": launches}
    return out


@functools.lru_cache(maxsize=1)
def train_pairs() -> tuple:

    """The recipe's training pairs over the synthetic corpus and a mined
    hard negative for each (phases 9 and 9b)."""
    from rag_dpo_tpu_torch.evals.synthetic import build_synthetic_corpus
    from rag_dpo_tpu_torch.evals.train_encoder import (
        build_training_pairs,
        mine_hard_negatives,
    )

    chunks = build_synthetic_corpus(
        json.loads(QA_DATASET.read_text(encoding="utf-8")))
    pairs, groups = build_training_pairs(chunks, return_groups=True)
    return pairs, mine_hard_negatives(pairs, groups, chunks)


def run_train(seed: int, dev) -> dict:
    """Train phase: the full-width BGE-M3 through `train_retriever`, a
    resume from its checkpoint, then timed steps on one repeated batch."""
    import numpy as np
    import torch

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

    pairs, negatives = train_pairs()
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


def mesh_train_config():
    """Phase 9b's config: phase 9's full-width BGE-M3 (f32, flash on) at
    `MESH_TRAIN_LR` from the first step (no warmup), so the second step's
    loss already shows the first update."""
    from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
    from rag_dpo_tpu_torch.train import TrainConfig

    return TrainConfig(model=BgeM3Config(encoder=EncoderConfig.bge_m3()),
                       learning_rate=MESH_TRAIN_LR, warmup_steps=0)


def state_gap(params: dict, grads: dict, ref: dict) -> dict:
    """A sharded run's whole parameters and last gradients against the
    one-rank step's (`ref`: {"params", "grads"}, name → tensor).

    * gradients: ‖g − g_ref‖ / ‖g_ref‖ over the whole tree (the data sum,
      the TP reductions and the global negatives all show here; only sum
      orders differ);
    * parameters: `tests/test_torch_train.py`'s tolerance, |p − p_ref| ≤
      1% of Σ lr + 1e-5·|p_ref| (Σ lr for the key bias, whose gradient is
      0 in exact arithmetic): the worst element's share of it, and how
      many elements are past it. Adam moves an element by ~±lr whatever its
      gradient's size, so an element whose gradient nearly cancels (about
      one in 10^5 at this width under TP) takes its sign from rounding."""
    import torch

    from rag_dpo_tpu_torch.train.contrastive import learning_rate_at

    cfg = mesh_train_config()
    lr_sum = sum(learning_rate_at(cfg, c) for c in range(MESH_TRAIN_STEPS))
    worst, where, beyond, total = 0.0, None, 0, 0
    diff_sq = ref_sq = 0.0
    with torch.no_grad():
        for name, value in params.items():
            want = ref["params"][name].to(value.device)
            diff = (value - want).abs()
            tol = (torch.full_like(want, lr_sum) if name.endswith("key.bias")
                   else 0.01 * lr_sum + 1e-5 * want.abs())
            share = diff / tol
            beyond += int((share > 1).sum())
            total += share.numel()
            if float(share.max()) > worst:
                worst, where = float(share.max()), name
            g, g_ref = grads[name], ref["grads"][name].to(value.device)
            diff_sq += float(((g - g_ref).double() ** 2).sum())
            ref_sq += float((g_ref.double() ** 2).sum())
    return {"grad_rel_err": (diff_sq / ref_sq) ** 0.5,
            "param_tolerance_share": worst, "worst_param": where,
            "params_beyond_tolerance": beyond, "param_elements": total,
            "lr_sum": lr_sum}


def _grads(model) -> dict:
    import torch

    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()}


def mesh_train_steps(step, state, batch) -> tuple:
    """`MESH_TRAIN_STEPS` steps: (state, losses, accuracies, seconds a
    step by the host clock around a synchronised step)."""
    import torch

    losses, accs, secs = [], [], []
    for _ in range(MESH_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return state, losses, accs, secs


def _train_mesh_rank(rank: int, world: int, port: int, seed: int,
                     batch: dict, ref: dict, out_dir: str) -> None:
    """Phase 9b (b), one of two ranks on the one card over gloo: every
    layout of `MESH_TRAIN_LAYOUTS` from the seeded weights, its steps
    timed, its launches counted from 0, its parameters and gradients
    gathered whole and held (by the first rank) to the one-rank step's
    (`ref`, the parent's tensors)."""
    import torch
    import torch.distributed as dist

    from rag_dpo_tpu_torch.models.sharding import gather_state
    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.parallel import (
        MeshSpec,
        create_mesh,
        initialize_multihost,
    )
    from rag_dpo_tpu_torch.train import (
        create_train_state,
        make_sharded_train_step,
    )

    from rag_dpo_tpu_torch.parallel.mesh import mesh_device

    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    cfg = mesh_train_config()
    ref = ref if rank == 0 else None
    out = {}
    for label, spec in MESH_TRAIN_LAYOUTS:
        mesh = create_mesh(MeshSpec(**spec))
        dev = mesh_device(mesh)
        step, state = make_sharded_train_step(
            cfg, mesh, create_train_state(cfg, rng_seed=seed, device=dev))
        gc.collect()
        torch.cuda.empty_cache()
        _kernels.reset_counts()
        state, losses, accs, secs = mesh_train_steps(step, state, batch)
        res = {"losses": losses, "accuracies": accs, "step_s": secs,
               "launches": {n: _kernels.LAUNCHES[n] for n in TRAIN_KERNELS},
               "plain_on_cuda": dict(_kernels.PLAIN_ON_CUDA),
               "query_rows": state.model.encoder.layer_0.attention.query
               .weight.shape[0],
               "heads": state.model.encoder.layer_0.attention.heads,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        whole = gather_state(dict(state.model.named_parameters()),
                             state.model.tp)
        grads = gather_state(_grads(state.model), state.model.tp)
        if rank == 0:
            res.update(state_gap(whole, grads, ref))
        out[label] = res
        del step, state, whole, grads
        gc.collect()
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    pathlib.Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def run_train_mesh(seed: int, dev) -> dict:
    """Phase 9b: `make_sharded_train_step` at full width, held to 2 steps
    of `make_train_step` (the one-rank step) from the same seeded weights
    on one global batch of TRAIN_PAIRS pairs x TRAIN_SEQ tokens with mined
    hard negatives. (a) NCCL at world size 1 on phase 6h's group (then
    destroyed), `create_mesh(MeshSpec(data=1))`, in this process; (b) two
    ranks on the one card over gloo on CUDA tensors (NCCL cannot put two
    ranks on a card), spawned once: data=2 (global negatives) and model=2
    (TP, 8 heads a rank). Losses within rtol 1e-5, gradients and
    parameters by `state_gap`; K1, K8 and K9 launch in every rank and no twin runs. The
    gloo step times go through the host: not a multi-card number."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.parallel import (
        MeshSpec,
        create_mesh,
        initialize_multihost,
    )
    from rag_dpo_tpu_torch.parallel.mesh import free_port
    from rag_dpo_tpu_torch.tokenize import HashedTokenizer
    from rag_dpo_tpu_torch.train import (
        create_train_state,
        make_sharded_train_step,
        make_train_step,
    )
    from rag_dpo_tpu_torch.train.loop import PairBatcher

    t_phase = time.perf_counter()
    cfg = mesh_train_config()
    pairs, negatives = train_pairs()
    batch = PairBatcher(pairs, HashedTokenizer(cfg.model.encoder.vocab_size),
                        TRAIN_PAIRS, TRAIN_SEQ, seed,
                        negatives=negatives).batch_at(0)
    check(bool(batch["negative_valid"].any()), "9b: no hard negative")
    out: dict = {}

    # the one-rank step: the reference of (a) and (b)
    state = create_train_state(cfg, rng_seed=seed, device=dev)
    state, ref_losses, ref_accs, ref_s = mesh_train_steps(
        make_train_step(cfg, state), state, batch)
    ref = {"params": {k: v.detach().clone()
                      for k, v in state.model.named_parameters()},
           "grads": {k: v.clone() for k, v in _grads(state.model).items()}}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    out["one_rank"] = {"losses": ref_losses, "accuracies": ref_accs,
                       "step_s": ref_s}

    # (a) NCCL, world size 1
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0)  # 6h's, if up
    mesh = create_mesh(MeshSpec(data=1))
    check(dist.get_backend() == "nccl", f"9b (a) on {dist.get_backend()}")
    _kernels.reset_counts()
    step, state = make_sharded_train_step(
        cfg, mesh, create_train_state(cfg, rng_seed=seed, device=dev))
    state, losses, accs, secs = mesh_train_steps(step, state, batch)
    res = {"losses": losses, "accuracies": accs, "step_s": secs,
           "launches": {n: _kernels.LAUNCHES[n] for n in TRAIN_KERNELS},
           "plain_on_cuda": dict(_kernels.PLAIN_ON_CUDA),
           **state_gap(dict(state.model.named_parameters()),
                       _grads(state.model), ref)}
    out["nccl_world1"] = res
    del step, state
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    log(f"train mesh (a) NCCL world 1: {json.dumps(res)}")

    # (b) two gloo ranks on the one card; the reference reaches them as
    # CUDA IPC handles of this process's tensors (no copy)
    with tempfile.TemporaryDirectory(prefix="ragdpo_mesh_train_") as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(
            _train_mesh_rank,
            args=(2, free_port(), seed,
                  {k: v.numpy() for k, v in batch.items()}, ref, tmp),
            nprocs=2, join=False, start_method="spawn")
        while not ctx.join(timeout=1.0):   # a rank that raised re-raises
            if time.perf_counter() - t0 > MESH_TRAIN_DEADLINE_S:
                for proc in ctx.processes:
                    proc.kill()
                check(False, f"9b (b): the ranks ran past "
                      f"{MESH_TRAIN_DEADLINE_S} s")
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads((pathlib.Path(tmp) / f"rank{r}.json")
                            .read_text()) for r in range(2)]
    del ref
    gc.collect()
    torch.cuda.ipc_collect()       # the ranks' handles of the reference
    torch.cuda.empty_cache()
    for label, spec in MESH_TRAIN_LAYOUTS:
        out[f"gloo_{label}"] = {
            "ranks": [r[label] for r in ranks],
            **{k: v for k, v in ranks[0][label].items()
               if k in ("grad_rel_err", "param_tolerance_share",
                        "worst_param", "params_beyond_tolerance",
                        "param_elements")}}
        log(f"train mesh (b) gloo {label}, 2 ranks on one card (step times "
            f"through the host, not a multi-card number): "
            f"{json.dumps(out[f'gloo_{label}'])}")
    out["gloo_spawn_s"] = spawn_s

    for label in ("nccl_world1", *(f"gloo_{n}" for n, _ in
                                   MESH_TRAIN_LAYOUTS)):
        runs = out[label].get("ranks", [out[label]])
        for r, run in enumerate(runs):
            check(np.allclose(run["losses"], ref_losses, rtol=1e-5, atol=0),
                  f"9b {label} rank {r}: losses {run['losses']} vs the "
                  f"one-rank step's {ref_losses}")
            for name in TRAIN_KERNELS:
                check(run["launches"][name] > 0,
                      f"9b {label} rank {r}: {name} never launched")
            check(not any(run["plain_on_cuda"].values()),
                  f"9b {label} rank {r}: a twin ran: "
                  f"{run['plain_on_cuda']}")
        gap = out[label]
        check(gap["grad_rel_err"] <= MESH_GRAD_TOL,
              f"9b {label}: gradients {gap['grad_rel_err']:.3g} from the "
              f"one-rank step's")
        check(gap["params_beyond_tolerance"]
              <= MESH_PARAM_SHARE * gap["param_elements"],
              f"9b {label}: {gap['params_beyond_tolerance']} of "
              f"{gap['param_elements']} parameters past the Σ lr rule "
              f"(worst {gap['worst_param']}, "
              f"{gap['param_tolerance_share']:.3g} of its tolerance)")
    model2 = out["gloo_model2"]["ranks"]
    check(all(r["query_rows"] == 512 and r["heads"] == 8 for r in model2),
          f"9b model=2 is not split: {model2}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"train mesh phase: {out['phase_s']:.1f} s (the two ranks "
        f"{spawn_s:.1f} s with their start); one-rank step "
        + ", ".join(f"{x:.3f}" for x in ref_s) + " s")
    return out


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

    DECODER_LAYERS.install()
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
    prefill = check_prefill(dev, gen)
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
    seeded_init = check_flax_init(dev, args.seed)
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
            ("concurrent, batching on", path["concurrent"]["on"]),
            ("HTTP", path["http"]),
            ("continuous", path["continuous"]),
            ("vision", path["continuous"]["vision"])):
        for name in SERVE_KERNELS:
            check(launched["launches"][name] > 0,
                  f"{name} never launched in the {phase} serve phase")
        check(not any(launched["plain_on_cuda"].values()),
              f"a twin ran in the {phase} serve phase: "
              f"{launched['plain_on_cuda']}")
    for name in MESH_KERNELS:
        check(path["mesh"]["launches"][name] > 0,
              f"{name} never launched in the mesh phase (6h)")
    check(not any(path["mesh"]["plain_on_cuda"].values()),
          f"a twin ran in the mesh phase: {path['mesh']['plain_on_cuda']}")
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
    loop = run_quality_loop(dev)
    gc.collect()
    torch.cuda.empty_cache()
    train = run_train(args.seed, dev)
    for name in TRAIN_KERNELS:
        check(train["launches"][name] > 0, f"{name} never launched")
        check(train["plain_on_cuda"][name] == 0, f"{name} ran plain")
    gc.collect()
    torch.cuda.empty_cache()
    train_mesh = run_train_mesh(args.seed, dev)
    # phase 9b's launches of K1, K8 and K9 (rank by rank over gloo)
    mesh_train_launches = {
        name: {"mesh_train_nccl_launches":
               train_mesh["nccl_world1"]["launches"][name],
               **{f"mesh_train_gloo_{label}_launches":
                  [r["launches"][name]
                   for r in train_mesh[f"gloo_{label}"]["ranks"]]
                  for label, _ in MESH_TRAIN_LAYOUTS}}
        for name in TRAIN_KERNELS}
    doors = run_front_doors(dev)
    new_phases_s = {
        "bf16_conversion": path["bf16"]["phase_s"],
        "judge": path["generate"]["judge"]["phase_s"],
        "quality_loop": loop["phase_s"],
        "front_doors": doors["check_install_s"]
        + doors["rag_cli_demo"]["seconds"]
        + doors["rag_cli_index"]["seconds"]}
    log(f"the BF16, judge, loop and front-door phases: "
        f"{json.dumps(new_phases_s)}, "
        f"{sum(new_phases_s.values()):.1f} s in all")

    # the agent's and the concurrent phase's launches of the serve kernels
    serve_phase_launches = {
        name: {"agent_launches": path["agent"]["launches"][name],
               "concurrent_launches": path["concurrent"]["off"]["launches"][
                   name],
               "concurrent_batched_launches":
                   path["concurrent"]["on"]["launches"][name],
               "http_launches": path["http"]["launches"][name],
               "continuous_launches":
                   path["continuous"]["launches"][name],
               "vision_launches":
                   path["continuous"]["vision"]["launches"][name],
               "mesh_launches": path["mesh"]["launches"][name]}
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
         **mesh_train_launches["flash_fwd"],
         "serve_launches": path["launches"]["flash_fwd"],
         **serve_phase_launches["flash_fwd"],
         **ingest_launches["flash_fwd"],
         **flash},
        {"name": "flash_prefill", "route": "cuda",
         "source": "rag_dpo_tpu_torch/csrc/flash_prefill.cu",
         "replaces": "none: rag_dpo_tpu/models/decoder.py:301 (einsums)",
         "instructions": "mma.sync m16n8k16 bf16 (P·V with P as three bf16 "
                         "pieces; f32: 3xTF32 on m16n8k8)",
         **{f"{phase}_launches": record["prefill_attention"]["launches"]
            for phase, record in (
                ("generate", path["generate"]),
                ("judge", path["generate"]["judge"]),
                ("continuous", path["continuous"]),
                ("vision", path["continuous"]["vision"]),
                ("mesh", path["mesh"]))},
         **prefill},
        {"name": "ell_topk", "route": "cuda",
         "source": "rag_dpo_tpu_torch/csrc/ell_topk.cu",
         "replaces": "rag_dpo_tpu/ops/sparse.py:71",
         "launches": path["launches"]["ell_topk"],
         "hermetic_launches": hermetic["maxsim"]["launches"]["ell_topk"],
         "hermetic_random_init_launches":
             hermetic["random"]["launches"]["ell_topk"],
         **serve_phase_launches["ell_topk"],
         **ell},
        {"name": "flash_bwd_dq", "route": "cuda", "source": bwd_src,
         "replaces": "rag_dpo_tpu/ops/flash_attention_bwd.py:81",
         "instructions": bwd_mma,
         "launches": train["launches"]["flash_bwd_dq"],
         **mesh_train_launches["flash_bwd_dq"],
         **flash_bwd["flash_bwd_dq"]},
        {"name": "flash_bwd_dkv", "route": "cuda", "source": bwd_src,
         "replaces": "rag_dpo_tpu/ops/flash_attention_bwd.py:123",
         "instructions": bwd_mma,
         "launches": train["launches"]["flash_bwd_dkv"],
         **mesh_train_launches["flash_bwd_dkv"],
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
         "hermetic_random_init_launches":
             hermetic["random"]["launches"]["fused_topk"],
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
                    **{f"http_{k}": v for k, v in path["http"].items()
                       if k not in ("launches", "plain_on_cuda")},
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
                    **{f"generate_{k}": v
                       for k, v in path["generate"].items()},
                    **{f"continuous_{k}": v
                       for k, v in path["continuous"].items()
                       if k not in ("launches", "plain_on_cuda")},
                    **{f"mesh_{k}": v for k, v in path["mesh"].items()
                       if k not in ("launches", "plain_on_cuda")},
                    "bf16_conversion": path["bf16"],
                    "quality_loop": loop, "front_doors": doors,
                    "front_door_phases_s": new_phases_s,
                    "hermetic_trained": hermetic["none"]["gated"],
                    "hermetic_trained_maxsim": hermetic["maxsim"]["gated"],
                    "hermetic_random_init": hermetic["random"]["gated"],
                    "hermetic_random_init_vs_committed":
                        hermetic["random_vs_committed"],
                    "seeded_init": seeded_init,
                    **{k: v for k, v in train.items()
                       if k.startswith("train_")},
                    "train_mesh": {
                        k: ({kk: vv for kk, vv in v.items()
                             if kk not in ("launches", "plain_on_cuda")}
                            if isinstance(v, dict) else v)
                        for k, v in train_mesh.items()}}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
