"""Continuous batching for the decoder on the card.

Port of `rag_dpo_tpu/serving/continuous.py`. The micro-batched decode path
(providers/tpu_llm.py) groups requests that ARRIVE together; a group then
decodes in lockstep, so one long generation holds the whole batch and late
arrivals wait for the next group. This engine instead admits requests at
step granularity into a fixed pool of decode SLOTS:

* the KV cache is ONE pool allocated at construction, a
  [slots, max_seq, kv_heads, head_dim] K and V per layer (plus the int8
  cache's scale rows); a slot is the unit of admission;
* prefill runs per request at batch 1 into a row cache sized to its
  prompt bucket, and the rows it wrote are copied in place into the pool's
  slot (`cache[slot, :n].copy_(row)`); no pool tensor is ever built
  again. With `prefill_chunk=N` a longer prompt prefills in bounded
  N-token segments, one per engine step, so the pool keeps decoding
  between segments (chunked prefill);
* decode advances ALL slots together through
  `TextGenerator._decode_chunk_mixed` (per-row temperature, seed,
  penalties, logit bias, logprobs); free slots ride along `done` and emit
  pad into nowhere. Every slot attends the first `kv_len` cache rows, the
  largest position of a LIVE slot + 1, which the engine knows on the host:
  so every slot pays the width of the longest resident request;
* completion is per slot: EOS or the request's own token budget frees the
  slot at once (host bookkeeping and the slot's `done` flag; no cache row
  is touched) and the next queued request joins at the next chunk boundary.

A request's output is its solo `generate_ids` run's, whenever it joins,
whatever shares the pool and however often its slot was reused. Cache
isolation comes from the overwrite-on-insert plus the causal mask
(`key_pos <= q_pos` hides any stale rows past the new occupant's length);
sampling isolation from position-keyed draws (models/generate.py
`step_keys`). JAX's engine asserts equal tokens; here a GEMM over eight
rows need not give the bits of one row, so the port's tests hold tokens
equal up to near-ties of the solo run's logits (ROADMAP C-29).

`prefix_cache=N` adds automatic prefix caching: admissions store their
prompt's block-aligned K/V prefix in an N-entry LRU keyed by token bytes,
on the card or (`prefix_cache_host`) in pinned host memory; a later request
sharing that prefix skips to a suffix-only `_extend` prefill.

Multimodal submissions (`submit_embeds` and the driver's
`submit_embeds`, `generate_embeds` and `generate_embeds_stream`) carry the
composed prefix (token embeddings with projected image patches spliced in,
models/llava.py) and decode co-resident with text requests; only their
prefill differs: the whole row at once through the decoder's
`inputs_embeds` (never chunked), never reading or filling the prefix cache
(entries key by token bytes), never preempted (a recompute resume cannot
rebuild a spliced prefix from ids), and their draft history holds only
their emitted tokens.

The engine counts its own time in `stats`: `queue_wait_ns` (enqueue to
admission into a slot, summed over admissions, on the monotonic clock),
`prefills` (one an admission, a chunked prompt's segments together) with
the rows each computed (`prefill_rows`) against its valid tokens
(`prefill_tokens`), and the device time of the prefill calls and the
decode dispatches (`prefill_device_ns`, `decode_device_ns`). On the card
those come from CUDA event pairs around each call, read once the step's
own harvest has synchronised and `query()` says they are done; on the CPU
from the host clock around the call. The step's stages are spans
(`pool.admit`, `pool.prefill`, `pool.decode`).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import threading
import time as _time
from typing import Any, Callable

import numpy as np
import torch

from ..models.decoder import DecoderModel
from ..models.generate import (
    DecodeCarry,
    SamplingConfig,
    TextGenerator,
    apply_penalties,
    mix_seed,
    penalized_rows,
    sampling_logprobs,
    step_gumbel,
    step_keys,
    step_uniforms,
    topk_topp_sample,
    truncated_token_prob,
)
from ..tokenize.base import bucket_length
from ..utils.profiling import span


@dataclasses.dataclass
class _Request:
    rid: int
    ids: np.ndarray          # [S] bucketed prompt
    length: int
    max_new: int
    temperature: float = 0.0  # per-request; ≤0 decodes greedily
    frequency_penalty: float = 0.0   # OpenAI-style, completion tokens
    presence_penalty: float = 0.0    # (vLLM counting semantics)
    seed: int = 0             # sampling seed: draws are position-keyed
    #                           off it, so a sampled request is a pure
    #                           function of (prompt, params, seed)
    tokens: list[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False
    on_token: Callable | None = None
    error: Exception | None = None   # per-request failure (bad callback)
    priority: int = 0        # lower admits first (0 = interactive)
    submit_step: int = 0     # engine step count at submit (aging clock)
    preempt_count: int = 0   # recompute-preemptions suffered so far
    consumed: int = 0        # leading tokens already baked into `ids`
    #                          by a preemption resume (ids holds
    #                          prompt + tokens[:consumed])
    logit_bias: Any = None   # {token_id: additive logit bias} — static
    #                          per request, rebuilt on every admission
    want_logprobs: Any = None  # None=off; 0..LOGPROB_TOPK = number of
    #                            top alternatives to keep per token
    logprobs: list = dataclasses.field(default_factory=list)
    #                          per emitted token: (lp, [(id, lp)...])
    embeds: Any = None       # [S, H] prefix embeddings on the device
    #                          (multimodal submit_embeds): prefill runs
    #                          through inputs_embeds, ids is a pad
    #                          placeholder; no prefix cache, no preemption
    enqueued_ns: int = 0     # monotonic ns it (re-)joined the queue
    waited_ns: int = 0       # its last wait, enqueue to admission
    prefill_rows: int = 0    # rows its prefill computed (every segment)
    prefill_tokens: int = 0  # the valid tokens among them


def _lookup_draft_np(hist: np.ndarray, k: int, n: int,
                     pad: int) -> np.ndarray:
    """Host-side prompt lookup (models/speculative.py semantics): the k
    tokens that followed the LATEST strictly-earlier occurrence of the
    tail n-gram of `hist`, padded when absent or truncated."""
    out = np.full((k,), pad, np.int32)
    L = len(hist)
    nw = L - n  # windows strictly before the tail n-gram itself
    if nw <= 0:
        return out
    windows = np.lib.stride_tricks.sliding_window_view(hist, n)[:nw]
    match = np.all(windows == hist[-n:], axis=1)
    if not match.any():
        return out
    j = int(np.nonzero(match)[0].max())
    src = hist[j + n:j + n + k]
    out[:len(src)] = src
    return out


_WARM = object()   # ContinuousDriver queue sentinel: run engine.warm


class _EmbedsPrompt:
    """Driver queue wrapper marking a multimodal submission: the payload
    routes to `engine.submit_embeds` instead of `submit`."""

    __slots__ = ("embeds",)

    def __init__(self, embeds):
        self.embeds = embeds

# default warm ladder: shared by engine.warm / driver.warm /
# TPULLMProvider.warm_decoder
WARM_BUCKETS = (64, 128, 256, 512, 1024)


class ContinuousEngine:
    """Step-level continuous batching over a fixed slot pool.

    Sampling is PER REQUEST: `submit(..., temperature=t)` decodes that
    slot greedily (t ≤ 0) or top-k-sampled at its own temperature; the
    engine's SamplingConfig temperature is only the default.

    `speculative=True` composes prompt-lookup speculative decoding with the
    pool: each step drafts per slot from the slot's own prompt + emission
    history (on the card, over a [slots, max_seq] token buffer), runs ONE
    (1+draft_len)-position cached verify forward over ALL slots and
    harvests each slot's accepted run. Greedy slots are lossless (the
    emitted tokens are the verify forward's own argmax chain). SAMPLED
    slots use speculative SAMPLING: a draft d is accepted with probability
    p(d) under the target's truncated distribution (the draft is a point
    mass, so min(1, p/q) = p), and the first rejection's token is EXCLUDED
    from the next draw, so the emitted marginal is the plain-sampling
    distribution. The exclusion crosses dispatch boundaries; it is dropped
    on preemption and on the adaptive fallback to plain decode (one draw
    then samples from full p). The host-drafted path (`draft_fn=`) stays
    greedy-only: its sampled slots draw one token a verify.

    `adaptive=True` tracks accepted tokens per slot-step and drops back to
    the plain chunked decode while the EMA sits under `spec_breakeven`,
    re-probing with exponential backoff. Penalized, biased and logprobs
    slots decode one token a step under speculation while their neighbours
    keep speculating."""

    def __init__(self, generator: TextGenerator, *, slots: int = 8,
                 sampling: SamplingConfig | None = None,
                 chunk: int = 4, rng_seed: int = 0,
                 speculative: bool = False, draft_len: int = 7,
                 ngram: int = 2, draft_fn: Callable | None = None,
                 device_draft_fn: Callable | None = None,
                 prefix_cache: int = 0, prefix_block: int = 64,
                 prefix_cache_host: bool = False,
                 adaptive: bool = True, spec_breakeven: float = 1.7,
                 spec_hold: int = 16, spec_probe: int = 2,
                 spec_hold_max: int = 256, prefill_chunk: int = 0,
                 age_steps: int = 0, preemption: bool = False,
                 max_preempt: int = 2):
        self.gen = generator
        self.cfg = generator.config
        self.device = generator.device
        self.slots = int(slots)
        self.sampling = sampling or SamplingConfig()
        self.chunk = int(chunk)
        self.speculative = bool(speculative)
        self.draft_len = int(draft_len)
        self.ngram = int(ngram)
        # draft_fn(hist [L] int32, k, ngram, pad) -> [k] int32 overrides the
        # prompt lookup on the HOST (the step-per-dispatch path);
        # device_draft_fn(ids_buf [slots, L], cur [slots]) -> [slots, k]
        # (device tensors) swaps the draft source of the chunked path. Any
        # draft source is lossless under the greedy verify.
        self._draft_fn = draft_fn
        self._device_draft_fn = device_draft_fn
        self._rid = itertools.count()
        self._queue: list[_Request] = []
        self._active: dict[int, _Request] = {}   # slot → request
        self._requests: dict[int, _Request] = {}  # rid → request (all)
        self.stats = {"steps": 0, "tokens": 0, "admitted": 0,
                      "occupancy_sum": 0, "prefix_hits": 0,
                      "prefix_saved_tokens": 0,
                      "spec_dispatches": 0, "plain_dispatches": 0,
                      "prefill_segments": 0, "cancelled": 0,
                      "preempted": 0, "queue_wait_ns": 0, "prefills": 0,
                      "prefill_rows": 0, "prefill_tokens": 0,
                      "prefill_device_ns": 0, "decode_device_ns": 0}
        # CUDA event pairs not read yet: (stats key, start, end)
        self._timing: list[tuple] = []
        # priority scheduling: admission picks the queued request with the
        # lowest (effective priority, rid); `age_steps=N` ages a waiting
        # request one level per N engine steps; `preemption=True` lets a
        # strictly-higher-priority queued request evict the worst active
        # slot (recompute preemption: the victim re-queues and later
        # re-prefills prompt + emissions); `max_preempt` pins a request
        # after that many evictions
        self.age_steps = int(age_steps)
        self.preemption = bool(preemption)
        self.max_preempt = int(max_preempt)
        # chunked prefill: a prompt longer than `prefill_chunk` tokens
        # prefills one segment per engine step (0 = whole prompt at
        # admission)
        self.prefill_chunk = int(prefill_chunk)
        self._prefilling: dict[int, dict] = {}   # slot → prefill state
        # automatic prefix cache: LRU of single-row K/V prefixes keyed by
        # block-aligned token prefixes, sliced to the prefix's rows; on
        # the card, or in pinned host memory with `prefix_cache_host`
        self.prefix_cache = int(prefix_cache)
        self.prefix_block = int(prefix_block)
        self.prefix_cache_host = bool(prefix_cache_host)
        self._pentries: dict[int, dict] = {}     # eid → entry (LRU)
        self._phash: dict[bytes, int] = {}       # prefix bytes → eid
        self._peid = itertools.count()
        # adaptive speculation (device-draft path only)
        self.adaptive = bool(adaptive)
        self.spec_breakeven = float(spec_breakeven)
        self.spec_hold = int(spec_hold)
        self.spec_probe = int(spec_probe)
        self.spec_hold_max = int(spec_hold_max)
        self._spec_mode = True
        self._spec_seen = 0
        self._accept_ema: float | None = None
        self._hold_len = self.spec_hold
        self._plain_left = 0

        b, dev, vocab = self.slots, self.device, self.cfg.vocab_size
        # probe the logits' dtype with a 1-row prefill
        logits1, _ = generator._prefill(
            torch.full((1, 8), self.sampling.pad_id, dtype=torch.int64,
                       device=dev),
            torch.ones(1, dtype=torch.int64, device=dev), cache_len=8)
        # the pool carry: PER-SLOT seeds key every draw (position-keyed),
        # so a sampled request's tokens are a pure function of (prompt,
        # params, seed); `rng_seed` only salts the DEFAULT per-request seed
        self._base_seed = int(rng_seed)
        self._carry = DecodeCarry(
            logits=torch.zeros((b, vocab), dtype=logits1.dtype, device=dev),
            caches=DecoderModel.init_cache(
                self.cfg, b, device=dev,
                kv_heads=generator.load().cache_heads),
            pos=torch.zeros(b, dtype=torch.int64, device=dev),
            done=torch.ones(b, dtype=torch.bool, device=dev),  # slot free
            seeds=torch.zeros(b, dtype=torch.int64, device=dev),
            pos_max=0)
        # the host's copy of each live slot's next position: the decode's
        # `kv_len` comes from it without a device read
        self._pos = np.zeros((b,), np.int64)
        # per-slot sampling state, written in place at admission
        self._temps = torch.zeros(b, dtype=torch.float32, device=dev)
        self._fp = torch.zeros(b, dtype=torch.float32, device=dev)
        self._pp = torch.zeros(b, dtype=torch.float32, device=dev)
        self._lpf = torch.zeros(b, dtype=torch.bool, device=dev)
        # completion-token counts (penalties) and static logit_bias rows
        self._counts = torch.zeros((b, vocab), dtype=torch.float32,
                                   device=dev)
        self._bias = torch.zeros((b, vocab), dtype=torch.float32,
                                 device=dev)
        if self.speculative and self._draft_fn is None:
            # the chunked path's token history (one spare column takes the
            # writes of rejected positions), each slot's emission cap, and
            # the speculative-sampling residual: the rejected draft a slot
            # must exclude from its next draw (-1 = none)
            L = self.cfg.max_seq_len
            self._ids_buf = torch.full((b, L + 1), self.sampling.pad_id,
                                       dtype=torch.int64, device=dev)
            self._limits = torch.zeros(b, dtype=torch.int64, device=dev)
            self._excl = torch.full((b,), -1, dtype=torch.int64,
                                    device=dev)

    @property
    def model(self):
        """The generator's decoder, as loaded now (`load_converted` swaps
        it)."""
        return self.gen.load()

    # ------------------------------------------------------------ public
    def warm(self, prompt_buckets: tuple[int, ...] | None = None,
             max_new: int = 8) -> None:
        """Run one throwaway request per prompt bucket, with speculation
        forced on AND off, so the allocator holds the pool's working
        blocks before traffic; then leave no trace: counters, the
        warm-added prefix entries, the throwaway requests and the adaptive
        posture are restored."""
        prompt_buckets = prompt_buckets or WARM_BUCKETS
        snap = dict(self.stats)
        pre_entries = set(self._pentries)
        room = self.cfg.max_seq_len - max_new \
            - (self.draft_len if self.speculative else 0) - 1
        spec_states = (True, False) if self.speculative and self.adaptive \
            else (self._spec_mode,)
        warm_rids = []
        for spec_on in spec_states:
            for j, b in enumerate(prompt_buckets):
                n = min(int(b), max(room, 1))
                # a distinct token per bucket: identical warm prompts would
                # prefix-cache-hit each other and skip the full prefills
                ids = np.full((n,), 3 + j % 64, np.int32)
                rid = self.submit(ids, n, max_new)
                warm_rids.append(rid)
                if self.speculative and self.adaptive:
                    self._spec_mode = spec_on
                    self._plain_left = 0 if spec_on else 10**9
                while not self._requests[rid].done and self.busy:
                    self.step()
        self._timing.clear()
        self.stats.update(snap)
        for eid in [e for e in self._pentries if e not in pre_entries]:
            entry = self._pentries.pop(eid)
            for k in entry["keys"]:
                if self._phash.get(k) == eid:
                    del self._phash[k]
        for rid in warm_rids:
            self._requests.pop(rid, None)
        if self.speculative and self.adaptive:
            self._spec_mode = True
            self._spec_seen = 0
            self._accept_ema = None
            self._plain_left = 0
            self._hold_len = self.spec_hold

    def _check_bias(self, logit_bias) -> dict | None:
        """Normalize a {token_id: bias} mapping: int keys in vocab, finite
        float values; a bad id raises here instead of indexing out of
        bounds on the card."""
        if not logit_bias:
            return None
        out = {}
        for t, v in logit_bias.items():
            t, v = int(t), float(v)
            if not 0 <= t < self.cfg.vocab_size:
                raise ValueError(
                    f"logit_bias token id {t} outside vocab "
                    f"[0, {self.cfg.vocab_size})")
            if not np.isfinite(v):
                raise ValueError("logit_bias values must be finite")
            out[t] = v
        return out

    def _check_logprobs(self, logprobs) -> int | None:
        """None = off; 0..LOGPROB_TOPK = how many top alternatives to keep
        per emitted token (the chosen token's lp always comes)."""
        if logprobs is None:
            return None
        from ..models.generate import LOGPROB_TOPK

        lp = int(logprobs)
        if not 0 <= lp <= LOGPROB_TOPK:
            raise ValueError(
                f"logprobs must be in [0, {LOGPROB_TOPK}], got {lp}")
        return lp

    def submit(self, prompt_ids, length: int, max_new: int,
               on_token: Callable | None = None,
               temperature: float | None = None,
               priority: int = 0,
               frequency_penalty: float = 0.0,
               presence_penalty: float = 0.0,
               logit_bias: dict | None = None,
               logprobs: int | None = None,
               seed: int | None = None,
               enqueued_ns: int | None = None) -> int:
        """Queue a request; returns its id. `on_token(rid, token_id)` fires
        per decoded token. `temperature` overrides the engine default for
        THIS request (≤0 = greedy); `priority` orders admission (lower
        first, ties FIFO); the penalties are OpenAI-style over completion
        tokens; `seed` pins THIS request's sampling stream (None derives
        one from the engine's base seed and the request id); `logit_bias`
        adds a static per-request adjustment to every draw's logits;
        `logprobs` keeps that many top alternatives per token;
        `enqueued_ns` (`time.perf_counter_ns`, default now) is where its
        queue wait starts. Admission happens at the next `step()` if a
        slot is free."""
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        length = min(int(length), len(ids))
        s = self._bucket("prompt", len(ids), length, max_new)
        padded = np.full((s,), self.sampling.pad_id, np.int32)
        padded[:min(len(ids), s)] = ids[:s]
        return self._enqueue(padded, length, max_new, on_token, temperature,
                             priority, frequency_penalty, presence_penalty,
                             logit_bias, logprobs, seed,
                             enqueued_ns=enqueued_ns)

    def submit_embeds(self, embeds, length: int, max_new: int,
                      on_token: Callable | None = None,
                      temperature: float | None = None,
                      priority: int = 0,
                      frequency_penalty: float = 0.0,
                      presence_penalty: float = 0.0,
                      logit_bias: dict | None = None,
                      logprobs: int | None = None,
                      seed: int | None = None,
                      enqueued_ns: int | None = None) -> int:
        """Queue a MULTIMODAL request: `embeds` [S, H] (or [1, S, H]) is
        the full prefix, prompt-token embeddings with projected image
        patches spliced in (models/llava.py `compose` builds it on the
        card), of which the first `length` rows are real. It decodes
        co-resident with text requests; unlike `submit`, it prefills as a
        whole row through `inputs_embeds`, takes no part in the prefix
        cache, is never preempted, and its draft history sees only its
        emitted tokens (the prompt positions stay pad)."""
        e = torch.as_tensor(embeds, device=self.device)
        if e.ndim == 3:
            e = e[0]
        length = min(int(length), e.shape[0])
        s = self._bucket("embeds", e.shape[0], length, max_new)
        if e.shape[0] > s:
            e = e[:s]        # only padding past `length` is cut
        elif e.shape[0] < s:
            e = torch.cat([e, e.new_zeros((s - e.shape[0], e.shape[1]))])
        return self._enqueue(np.full((s,), self.sampling.pad_id, np.int32),
                             length, max_new, on_token, temperature,
                             priority, frequency_penalty, presence_penalty,
                             logit_bias, logprobs, seed, embeds=e,
                             enqueued_ns=enqueued_ns)

    def _bucket(self, what: str, n: int, length: int, max_new: int) -> int:
        """The row width of a prompt of `n` positions (`length` real):
        its length bucket, within the context left after `max_new` and the
        speculative verify window."""
        room = self.cfg.max_seq_len - max_new \
            - (self.draft_len if self.speculative else 0)
        s = min(bucket_length(max(n, 1)), room)
        if length > s:   # silent truncation would decode a corrupted prompt
            raise ValueError(
                f"{what} length {length} + max_new {max_new} exceeds "
                f"max_seq_len {self.cfg.max_seq_len}")
        return s

    def _enqueue(self, ids, length, max_new, on_token, temperature,
                 priority, frequency_penalty, presence_penalty, logit_bias,
                 logprobs, seed, embeds=None, enqueued_ns=None) -> int:
        logit_bias = self._check_bias(logit_bias)
        logprobs = self._check_logprobs(logprobs)
        temp = self.sampling.temperature if temperature is None \
            else float(temperature)
        rid = next(self._rid)
        req = _Request(rid=rid, ids=ids, length=int(length),
                       max_new=int(max_new), temperature=temp,
                       frequency_penalty=float(frequency_penalty),
                       presence_penalty=float(presence_penalty),
                       seed=(mix_seed(self._base_seed, rid)
                             if seed is None
                             else int(seed) & 0xFFFFFFFF),
                       on_token=on_token, priority=int(priority),
                       submit_step=self.stats["steps"],
                       logit_bias=logit_bias, want_logprobs=logprobs,
                       embeds=embeds,
                       enqueued_ns=(_time.perf_counter_ns()
                                    if enqueued_ns is None else enqueued_ns))
        self._queue.append(req)
        self._requests[req.rid] = req
        return req.rid

    def cancel(self, rid: int) -> bool:
        """Abort a request: queued → never admits, prefilling → its
        segments stop, active → the slot frees NOW and the next queued
        request takes it. The partial `tokens` stay readable through
        `result(rid)`. Returns True iff the request was still live. Engine
        methods are single-threaded: under a ContinuousDriver, cancel
        through the driver."""
        req = self._requests.get(rid)
        if req is None or req.done:
            return False
        req.done = True
        if req in self._queue:
            self._queue.remove(req)
        for slot, st in list(self._prefilling.items()):
            if st["req"] is req:
                del self._prefilling[slot]
        slot = req.slot
        if slot >= 0 and self._active.get(slot) is req:
            self._release(slot)
        self.stats["cancelled"] += 1
        return True

    def _order_key(self, req: _Request) -> tuple[int, int]:
        """Admission order: (effective priority, arrival). With aging on,
        a request's effective priority improves one level per `age_steps`
        engine steps waited."""
        eff = req.priority
        if self.age_steps:
            eff -= (self.stats["steps"] - req.submit_step) \
                // self.age_steps
        return (eff, req.rid)

    def _admit_into(self, slot: int, req: _Request):
        req.waited_ns = _time.perf_counter_ns() - req.enqueued_ns
        if self.prefill_chunk and req.length > self.prefill_chunk \
                and req.embeds is None:
            # long prompt: prefill in segments across steps so the pool
            # keeps decoding in between (_prefill_step); a spliced prefix
            # has no id segments to extend from
            self._prefilling[slot] = self._prefill_begin(req)
            req.slot = slot
            return
        with span("pool.prefill"):
            logits1, caches1 = self._prefill_row(req)
        self._activate(slot, req, logits1, caches1)

    def _preempt(self, req: _Request):
        """Evict an ACTIVE request from its slot (recompute preemption):
        the slot frees now and the victim re-queues. On re-admission it
        re-prefills prompt + everything already emitted, so decoding
        resumes where it stopped: greedy through prefill-then-decode, the
        same chain as decode alone (up to the near-ties of ROADMAP C-29),
        sampled through position-keyed draws. `tokens` stays CUMULATIVE
        (`consumed` marks what `ids` now bakes in)."""
        slot = req.slot
        self._release(slot)
        req.slot = -1
        req.preempt_count += 1
        hist = np.concatenate([
            req.ids[:req.length],
            np.asarray(req.tokens[req.consumed:], np.int32)])
        req.consumed = len(req.tokens)
        remaining = req.max_new - req.consumed
        room = self.cfg.max_seq_len - remaining \
            - (self.draft_len if self.speculative else 0)
        s = min(bucket_length(len(hist)), room)
        assert len(hist) <= s, "preempt: resume prompt exceeds budget"
        padded = np.full((s,), self.sampling.pad_id, np.int32)
        padded[:len(hist)] = hist
        req.ids = padded
        req.length = len(hist)
        req.enqueued_ns = _time.perf_counter_ns()
        self.stats["preempted"] += 1

    def _admit(self):
        free = [s for s in range(self.slots)
                if s not in self._active and s not in self._prefilling]
        while free and self._queue:
            slot = free.pop(0)
            req = min(self._queue, key=self._order_key)
            self._queue.remove(req)
            self._admit_into(slot, req)
        if not (self.preemption and self._queue and self._active):
            return
        # recompute preemption: while a queued request strictly outranks
        # the worst unpinned active one, swap them
        while self._queue and self._active:
            best = min(self._queue, key=self._order_key)
            victims = [r for r in self._active.values()
                       if r.preempt_count < self.max_preempt
                       and r.embeds is None]
            if not victims:
                return
            worst = max(victims, key=lambda r: (r.priority, r.rid))
            if self._order_key(best)[0] >= worst.priority:
                return
            self._queue.remove(best)
            slot = worst.slot
            self._preempt(worst)
            self._queue.append(worst)
            self._admit_into(slot, best)

    def _insert(self, slot: int, logits1, caches1, length: int,
                seed: int):
        """Copy a prefilled row into the pool's slot, in place: its
        logits, the cache rows it wrote, its position and seed. Rows past
        the copy keep the previous occupant's values, hidden by the causal
        mask until this occupant overwrites them."""
        c = self._carry
        c.logits[slot].copy_(logits1[0])
        n = caches1[0]["k"].shape[1]
        for pool, row in zip(c.caches, caches1):
            for name, t in pool.items():
                t[slot, :n].copy_(row[name][0])
        c.pos[slot] = length
        c.done[slot] = False
        c.seeds[slot] = seed
        self._pos[slot] = length

    def _release(self, slot: int):
        del self._active[slot]
        self._carry.done[slot] = True

    def _activate(self, slot: int, req: _Request, logits1, caches1):
        """Insert a fully-prefilled single-row cache into the pool and set
        the slot's sampling state, in place, for the next decode
        dispatch."""
        self._insert(slot, logits1, caches1, req.length, req.seed)
        req.slot = slot
        self._active[slot] = req
        self._temps[slot] = req.temperature
        self._fp[slot] = req.frequency_penalty
        self._pp[slot] = req.presence_penalty
        self._lpf[slot] = req.want_logprobs is not None
        # completion-token counts: zero for a fresh request; a penalized
        # preemption-resumed one rebuilds its row from the tokens emitted
        # so far, so penalty state survives eviction
        if req.tokens and (req.frequency_penalty or req.presence_penalty):
            self._counts[slot] = torch.bincount(
                torch.as_tensor(req.tokens, dtype=torch.int64,
                                device=self.device),
                minlength=self.cfg.vocab_size).to(torch.float32)
        else:
            self._counts[slot].zero_()
        # static logit_bias row, rebuilt on every admission and zeroed for
        # unbiased occupants, so slot reuse cannot leak a predecessor's
        self._bias[slot].zero_()
        if req.logit_bias:
            ids = torch.as_tensor(list(req.logit_bias), dtype=torch.int64,
                                  device=self.device)
            self._bias[slot, ids] = torch.as_tensor(
                list(req.logit_bias.values()), dtype=torch.float32,
                device=self.device)
        if self.speculative and self._draft_fn is None:
            # no pending residual exclusion for a fresh (or resumed)
            # occupant; the token history is its prompt, pad past it (so
            # drafts never read a predecessor's tokens); the emission cap
            # is length + REMAINING budget
            self._excl[slot] = -1
            self._ids_buf[slot].fill_(self.sampling.pad_id)
            self._ids_buf[slot, :len(req.ids)] = torch.as_tensor(
                req.ids, dtype=torch.int64, device=self.device)
            self._limits[slot] = req.length + req.max_new - req.consumed
        if self.prefix_cache and not req.consumed and req.embeds is None:
            # a resumed request's "prompt" tail is generated text: caching
            # it would only pollute the prefix LRU; an embeds prefix has no
            # token key to store under
            self._prefix_store(req, caches1)
        self.stats["admitted"] += 1
        self.stats["queue_wait_ns"] += req.waited_ns
        self.stats["prefills"] += 1
        self.stats["prefill_rows"] += req.prefill_rows
        self.stats["prefill_tokens"] += req.prefill_tokens
        req.prefill_rows = req.prefill_tokens = 0

    def _segments(self, req: _Request, p: int):
        """The (start, tokens, bucket) of each prefill segment from p."""
        out = []
        while p < req.length:
            seg = min(self.prefill_chunk, req.length - p)
            out.append((p, seg, min(bucket_length(seg),
                                    self.cfg.max_seq_len - p)))
            p += seg
        return out

    def _prefill_begin(self, req: _Request) -> dict:
        """Start an incremental prefill, reusing any cached block-aligned
        prefix (a hit skips its blocks entirely). The row cache covers
        every segment's window."""
        p, entry = self._prefix_lookup(req)
        rows = max(q + s2 for q, _, s2 in self._segments(req, p))
        if entry is not None:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_saved_tokens"] += p
        return {"req": req, "done_to": p, "rows": rows,
                "caches": (self._entry_caches(entry, rows)
                           if entry is not None else None),
                "logits": None}

    def _prefill_step(self, st: dict) -> bool:
        """Advance one bounded prefill segment; True when the prompt is
        fully prefilled (st then holds the row's logits + caches)."""
        req, p = st["req"], st["done_to"]
        _, seg, s2 = self._segments(req, p)[0]
        suffix = np.full((1, s2), self.sampling.pad_id, np.int32)
        suffix[0, :seg] = req.ids[p:p + seg]
        ids = self.gen._tensor(suffix)
        stop = self._timed("prefill", req, s2, seg)
        if p == 0:
            logits1, caches1 = self.gen._prefill(
                ids, self.gen._tensor([seg]), cache_len=st["rows"])
        else:
            logits1, caches1 = self.gen._extend(ids, [p], [seg],
                                                st["caches"])
        stop()
        st["caches"], st["logits"] = caches1, logits1
        st["done_to"] = p + seg
        self.stats["prefill_segments"] += 1
        return st["done_to"] >= req.length

    # ------------------------------------------------- prefix caching
    def _prefill_row(self, req: _Request):
        """Prefill one request into a row cache of its bucket's rows,
        reusing the longest cached block-aligned token prefix when the
        prefix cache is on. Causal K/V at position i depends only on
        tokens ≤ i, so an entry serves ANY request matching a
        block-aligned prefix of its prompt: `_extend` writes positions
        p..p+suffix and everything past the write pointer stays causally
        invisible. A multimodal request prefills its whole row from its
        embeddings, with no prefix cache."""
        if req.embeds is not None:
            stop = self._timed("prefill", req, req.embeds.shape[0],
                               req.length)
            out = self.gen._prefill(None, self.gen._tensor([req.length]),
                                    cache_len=req.embeds.shape[0],
                                    embeds=req.embeds[None])
            stop()
            return out
        p, entry = self._prefix_lookup(req)
        if entry is None:
            s = len(req.ids)
            stop = self._timed("prefill", req, s, req.length)
            out = self.gen._prefill(self.gen._tensor(req.ids[None]),
                                    self.gen._tensor([req.length]),
                                    cache_len=s)
            stop()
            return out
        suf_len = req.length - p
        s2 = min(bucket_length(suf_len), self.cfg.max_seq_len - p)
        suffix = np.full((1, s2), self.sampling.pad_id, np.int32)
        suffix[0, :suf_len] = req.ids[p:req.length]
        stop = self._timed("prefill", req, s2, suf_len)
        logits1, caches1 = self.gen._extend(
            self.gen._tensor(suffix), [p], [suf_len],
            self._entry_caches(entry, p + s2))
        stop()
        self.stats["prefix_hits"] += 1
        self.stats["prefix_saved_tokens"] += p
        return logits1, caches1

    def _entry_caches(self, entry, rows: int):
        """A row cache of `rows` rows that starts with the entry's rows (as
        many as fit: a borrower matching a shorter prefix needs fewer): a
        device entry copies on the card, a host entry (pinned) uploads
        without blocking the host. Rows past the matched prefix are
        causally invisible until the suffix overwrites them."""
        caches = DecoderModel.init_cache(self.cfg, 1, rows, self.device,
                                         self.gen.load().cache_heads)
        n = min(entry["len"], rows)
        saved_kv = entry["kv_host"] if "kv_host" in entry \
            else entry["kv_dev"]
        for layer, saved in zip(caches, saved_kv):
            for name, t in layer.items():
                t[:, :n].copy_(saved[name][:, :n], non_blocking=True)
        return caches

    def _prefix_lookup(self, req: _Request):
        """Longest cached block-aligned prefix of this prompt, leaving at
        least one suffix token to produce the first logits."""
        if not self.prefix_cache:
            return 0, None
        blk = self.prefix_block
        ids = req.ids[:req.length]
        m_max = (req.length - 1) // blk
        for m in range(m_max, 0, -1):
            eid = self._phash.get(ids[:m * blk].tobytes())
            if eid is not None:
                entry = self._pentries.pop(eid)    # LRU: move to end
                self._pentries[eid] = entry
                return m * blk, entry
        return 0, None

    def _host_copy(self, t):
        if t.device.type != "cuda":
            return t.clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t)

    def _prefix_store(self, req: _Request, caches1):
        """Register this prompt's full block-aligned prefix (the row covers
        positions < req.length, on a miss and on a hit), sliced to the
        prefix's rows: on the card, or in pinned host memory."""
        blk = self.prefix_block
        m = req.length // blk
        if m < 1:
            return
        key = req.ids[:m * blk].tobytes()
        if key in self._phash:
            return                                 # already cached
        eid = next(self._peid)
        keys = [req.ids[:j * blk].tobytes() for j in range(1, m + 1)]
        for k in keys:
            self._phash.setdefault(k, eid)
        plen = m * blk
        copy = self._host_copy if self.prefix_cache_host \
            else (lambda t: t.clone())
        kv = [{name: copy(t[:, :plen]) for name, t in layer.items()}
              for layer in caches1]
        self._pentries[eid] = {
            "kv_host" if self.prefix_cache_host else "kv_dev": kv,
            "len": plen, "keys": keys}
        while len(self._pentries) > self.prefix_cache:
            old_eid = next(iter(self._pentries))
            old = self._pentries.pop(old_eid)
            for k in old["keys"]:
                if self._phash.get(k) == old_eid:
                    del self._phash[k]

    @torch.no_grad()
    def step(self) -> int:
        """Admit what fits, advance every active slot (by `chunk` tokens,
        or by speculative verifies), harvest, free finished slots. Returns
        the number of live tokens emitted."""
        with span("pool.admit"):
            self._admit()
            # advance every in-flight chunked prefill by one segment; a
            # prompt finishing here joins this same step's decode dispatch
            for slot in list(self._prefilling):
                st = self._prefilling[slot]
                with span("pool.prefill"):
                    whole = self._prefill_step(st)
                if whole:
                    del self._prefilling[slot]
                    self._activate(slot, st["req"], st["logits"],
                                   st["caches"])
        if not self._active:
            self._read_timing()
            return 0
        with span("pool.decode"):
            tokens, lpinfo = self._advance()
        self._read_timing()
        self.stats["steps"] += 1
        self.stats["occupancy_sum"] += len(self._active)

        emitted = 0
        eos, pad = self.sampling.eos_id, self.sampling.pad_id
        for slot, req in list(self._active.items()):
            finished = False
            for i, t in enumerate(tokens[slot]):
                t = int(t)
                if len(req.tokens) >= req.max_new:
                    finished = True
                    break
                if t == eos:
                    finished = True
                    break
                if t == pad:      # post-EOS filler inside the chunk
                    finished = True
                    break
                req.tokens.append(t)
                if req.want_logprobs is not None and slot in lpinfo:
                    lp, ti, tv = lpinfo[slot][i]
                    k = req.want_logprobs
                    req.logprobs.append(
                        (float(lp),
                         [(int(a), float(b))
                          for a, b in zip(ti[:k], tv[:k])]))
                emitted += 1
                if req.on_token is not None:
                    try:
                        req.on_token(req.rid, t)
                    except Exception as cb_err:
                        # a raising callback fails ITS request only
                        req.error = cb_err
                        req.on_token = None
                        finished = True
                        break
            if finished or len(req.tokens) >= req.max_new:
                req.done = True
                self._release(slot)
        self.stats["tokens"] += emitted
        return emitted

    def _advance(self):
        """One decode dispatch over the pool on the path the engine is on
        (speculative, its plain fallback, host drafts or plain)."""
        if self.speculative and self._draft_fn is None:
            if self._spec_mode or not self.adaptive:
                tokens, lpinfo = self._spec_chunk_advance()
                self.stats["spec_dispatches"] += 1
                if self.adaptive:
                    self._judge_speculation()
            else:
                # the fallback to plain decode drops any pending residual
                # exclusion (the plain path draws from full p)
                self._excl.fill_(-1)
                tokens, lpinfo = self._plain_advance()
                self.stats["plain_dispatches"] += 1
                self._plain_left -= 1
                if self._plain_left <= 0:         # probe speculation
                    self._sync_ids_buf()
                    self._spec_mode = True
                    self._spec_seen = 0
                    self._accept_ema = None
        elif self.speculative:
            tokens, lpinfo = self._spec_advance()
        else:
            tokens, lpinfo = self._plain_advance()
        return tokens, lpinfo

    def _timed(self, kind: str, req: _Request | None = None, rows: int = 0,
               tokens: int = 0):
        """Start timing a prefill call of `req` (`rows` computed, `tokens`
        of them valid: added to the request's, counted at its activation)
        or a decode dispatch; the returned `stop()` ends it, before any
        host read. On the card a CUDA event pair, read later
        (`_read_timing`); on the CPU the host clock."""
        if req is not None:
            req.prefill_rows += rows
            req.prefill_tokens += tokens
        key = f"{kind}_device_ns"
        if self.device.type != "cuda":
            t0 = _time.perf_counter_ns()

            def stop():
                self.stats[key] += _time.perf_counter_ns() - t0

            return stop
        stream = torch.cuda.current_stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)

        def stop():
            end.record(stream)
            self._timing.append((key, start, end))

        return stop

    def _read_timing(self):
        """Count the event pairs the device has finished (no wait: the
        step's harvest has synchronised; the rest stay for a later step)."""
        left = []
        for key, start, end in self._timing:
            if end.query():
                self.stats[key] += round(start.elapsed_time(end) * 1e6)
            else:
                left.append((key, start, end))
        self._timing = left

    def _live_pos_max(self) -> int:
        return int(max(self._pos[s] for s in self._active))

    def _want_logprobs(self) -> bool:
        return any(r.want_logprobs is not None
                   for r in self._active.values())

    def _plain_advance(self):
        """One chunked-decode dispatch over the pool. Returns (tokens
        [slots, chunk], lpinfo) where lpinfo[slot] lists (lp, top_ids,
        top_vals) aligned with tokens[slot], read back only for slots that
        asked for logprobs."""
        carry = self._carry
        carry.pos_max = self._live_pos_max()
        want = self._want_logprobs()
        stop = self._timed("decode")
        self._carry, toks, lps, tis, tvs = self.gen._decode_chunk_mixed(
            carry, self.chunk, self.sampling, self._temps, self._counts,
            self._fp, self._pp, self._bias, logprobs=want)
        stop()
        for slot in self._active:
            self._pos[slot] += self.chunk
        lpinfo = {}
        if want:
            lps, tis, tvs = (lps.cpu().numpy(), tis.cpu().numpy(),
                             tvs.cpu().numpy())
            for slot, r in self._active.items():
                if r.want_logprobs is not None:
                    lpinfo[slot] = [(lps[slot, j], tis[slot, j],
                                     tvs[slot, j])
                                    for j in range(lps.shape[1])]
        return toks.cpu().numpy(), lpinfo

    def _judge_speculation(self):
        """After a probe window, keep speculating only while the EMA
        acceptance clears the verify step's cost premium; otherwise hold
        on the plain path with exponential backoff."""
        self._spec_seen += 1
        if self._spec_seen < self.spec_probe or self._accept_ema is None:
            return
        if self._accept_ema >= self.spec_breakeven:
            self._hold_len = self.spec_hold       # probe succeeded
        else:
            self._spec_mode = False
            self._plain_left = self._hold_len
            self._hold_len = min(self._hold_len * 2, self.spec_hold_max)

    def _sync_ids_buf(self):
        """Rebuild the token history from host request state before
        re-entering speculation: plain dispatches do not maintain
        `_ids_buf`, but every emitted token lives in `req.tokens`."""
        L = self.cfg.max_seq_len
        buf = np.full((self.slots, L + 1), self.sampling.pad_id, np.int64)
        for slot, req in self._active.items():
            hist = np.concatenate([
                req.ids[:req.length],
                np.asarray(req.tokens[req.consumed:], np.int32)])[:L]
            buf[slot, :len(hist)] = hist
        self._ids_buf.copy_(torch.as_tensor(buf))

    def _sequential_rows(self):
        """Slots whose target distribution depends on the run's own
        earlier tokens (penalties, negative ones too), whose logits a bias
        reorders, or whose logprobs come from the position-0 draw: they
        accept no drafts."""
        return penalized_rows(self._fp, self._pp) \
            | (self._bias != 0).any(dim=-1) | self._lpf

    def _spec_chunk_advance(self):
        """`chunk` draft → verify → accept steps for every slot with no
        host read in between: drafting runs on the card over each slot's
        token buffer, EOS and budgets resolve there, and the host harvests
        the (tokens, valid) stacks once. Each step attends rows up to a
        bound the host knows (the largest live position + (1 + draft_len)
        a step)."""
        from ..models.speculative import prompt_lookup_draft

        cfg, k, n = self.cfg, self.draft_len, self.ngram
        eos, pad = self.sampling.eos_id, self.sampling.pad_id
        top_k, top_p = self.sampling.top_k, self.sampling.top_p
        b, L, dev = self.slots, cfg.max_seq_len, self.device
        draft_src = self._device_draft_fn or (
            lambda buf, cur: prompt_lookup_draft(buf, cur, k, n, pad))
        c = self._carry
        logits, caches, pos, done, seeds = (c.logits, c.caches, c.pos,
                                            c.done, c.seeds)
        temps, counts, ids_buf, limits = (self._temps, self._counts,
                                          self._ids_buf, self._limits)
        excl = self._excl
        idx = torch.arange(1 + k, device=dev)[None, :]
        rowi = torch.arange(b, device=dev)
        seq = self._sequential_rows()
        sampled = temps > 0
        pos_hi = self._live_pos_max()
        want = self._want_logprobs()
        steps = []
        stop = self._timed("decode")
        for j in range(self.chunk):
            live = ~done
            # `excl` holds the last rejection's token: this draw IS the
            # residual draw
            pl = apply_penalties(logits, counts, self._fp, self._pp,
                                 self._bias)
            t1 = topk_topp_sample(pl, temps, step_keys(seeds, pos, 0),
                                  top_k, top_p, exclude=excl)
            lp1, lti, ltv = (sampling_logprobs(pl, temps, t1) if want
                             else (None, None, None))
            # t1 goes into the buffer so the tail n-gram includes it
            cur_c = pos.clamp(0, L - 1)
            ids_buf[rowi, cur_c] = torch.where(live, t1, ids_buf[rowi, cur_c])
            drafts = draft_src(ids_buf[:, :L], pos + 1).to(torch.int64)
            inputs = torch.cat([t1[:, None], drafts], dim=1)
            positions = pos[:, None] + idx
            wmask = live[:, None] & (positions < L)
            la, _ = self.model(inputs, positions.clamp(0, L - 1), caches,
                               write_mask=wmask,
                               kv_len=min(pos_hi + (j + 1) * (1 + k), L))
            g = torch.argmax(la, dim=-1)
            ok_greedy = inputs[:, 1:] == g[:, :-1]
            # speculative SAMPLING: draft d_i accepted with probability
            # p_i(d_i) under the target's truncated distribution
            u = step_uniforms(step_keys(seeds, pos, 1), k)
            p_draft = truncated_token_prob(
                la[:, :-1].reshape(b * k, -1), temps.repeat_interleave(k),
                drafts.reshape(b * k), top_k, top_p).reshape(b, k)
            ok = torch.where(sampled[:, None], u < p_draft, ok_greedy) \
                & ~seq[:, None]
            n_acc = 1 + torch.cumprod(ok.to(torch.int64), dim=1).sum(dim=1)
            # the first rejected draft (if any) is excluded next draw
            d_rej = drafts.gather(
                1, (n_acc - 1).clamp(0, k - 1)[:, None])[:, 0]
            excl = torch.where(sampled & (n_acc <= k) & live & ~seq, d_rej,
                               -1)
            base = (idx < n_acc[:, None]) & live[:, None] \
                & (positions < limits[:, None])
            is_eos = (inputs == eos) & base
            after = (torch.cumsum(is_eos.to(torch.int64), dim=1)
                     - is_eos.to(torch.int64)) > 0
            valid = base & ~after                 # EOS emitted too
            nv = valid.sum(dim=1)
            # accepted drafts extend the buffer (t1 already there);
            # everything else lands in the spare column
            ids_buf.scatter_(1, torch.where(valid & (idx > 0), positions, L),
                             inputs)
            new_logits = la[rowi, (nv - 1).clamp_min(0)]
            logits = torch.where((live & (nv > 0))[:, None], new_logits,
                                 logits)
            counts.index_put_((rowi[:, None].expand_as(inputs), inputs),
                              valid.to(counts.dtype), accumulate=True)
            pos = pos + nv
            done = done | (is_eos & valid).any(dim=1) | (pos >= limits)
            steps.append((inputs, valid, lp1, lti, ltv))
        self._carry = DecodeCarry(logits, caches, pos, done, seeds,
                                  c.pos_max)
        self._excl = excl
        stop()
        toks = torch.stack([s[0] for s in steps]).cpu().numpy()
        valid = torch.stack([s[1] for s in steps]).cpu().numpy()
        n_live = len(self._active)
        for slot in self._active:
            self._pos[slot] += int(valid[:, slot].sum())
        if self.adaptive and n_live:
            # emitted tokens per slot-step against a plain step's one
            a = float(valid.sum()) / (self.chunk * n_live)
            self._accept_ema = a if self._accept_ema is None \
                else 0.5 * self._accept_ema + 0.5 * a
        lpinfo = {}
        if want:
            lps, tis, tvs = (torch.stack([s[i] for s in steps]).cpu().numpy()
                             for i in (2, 3, 4))
            for slot, r in self._active.items():
                if r.want_logprobs is not None:
                    # logprobs slots accept no drafts: each step emits at
                    # most its position-0 token, the one `lps` covers
                    lpinfo[slot] = [(lps[st, slot], tis[st, slot],
                                     tvs[st, slot])
                                    for st in range(toks.shape[0])
                                    if valid[st, slot, 0]]
        return {slot: [int(t) for s in range(toks.shape[0])
                       for t, v in zip(toks[s, slot], valid[s, slot])
                       if v]
                for slot in self._active}, lpinfo

    def _spec_advance(self):
        """One speculative pool step with HOST drafts (`draft_fn`): one
        verify forward for all slots, returns slot → accepted run. Greedy
        slots anchor the draft on the argmax of the carried logits, as the
        verify does; sampled slots draw their token in the verify and
        advance one."""
        pad = self.sampling.pad_id
        k, n = self.draft_len, self.ngram
        L, dev = self.cfg.max_seq_len, self.device
        draft = self._draft_fn or _lookup_draft_np
        c = self._carry
        t1g = torch.argmax(c.logits, dim=-1).cpu().numpy()
        drafts = np.full((self.slots, k), pad, np.int32)
        for slot, req in self._active.items():
            if req.temperature > 0:
                continue                  # drafts unused for sampled
            hist = np.concatenate([
                req.ids[:req.length],
                np.asarray(req.tokens[req.consumed:] + [int(t1g[slot])],
                           np.int32)])
            drafts[slot] = draft(hist, k, n, pad)
        stop = self._timed("decode")
        live = ~c.done
        pl = apply_penalties(c.logits, self._counts, self._fp, self._pp,
                             self._bias)
        t1 = topk_topp_sample(pl, self._temps, step_keys(c.seeds, c.pos, 0),
                              self.sampling.top_k, self.sampling.top_p)
        want = self._want_logprobs()
        if want:
            lp1, lti, ltv = sampling_logprobs(pl, self._temps, t1)
        inputs = torch.cat([t1[:, None], self.gen._tensor(drafts)], dim=1)
        idx = torch.arange(1 + k, device=dev)[None, :]
        positions = c.pos[:, None] + idx
        wmask = live[:, None] & (positions < L)
        la, _ = self.model(inputs, positions.clamp(0, L - 1), c.caches,
                           write_mask=wmask,
                           kv_len=min(self._live_pos_max() + 1 + k, L))
        g = torch.argmax(la, dim=-1)
        ok = inputs[:, 1:] == g[:, :-1]
        n_acc = 1 + torch.where(
            (self._temps > 0) | self._sequential_rows(), 0,
            torch.cumprod(ok.to(torch.int64), dim=1).sum(dim=1))
        n_acc = torch.where(live, n_acc, 0)
        emitted = idx < n_acc[:, None]
        rowi = torch.arange(self.slots, device=dev)
        self._counts.index_put_((rowi[:, None].expand_as(inputs), inputs),
                                emitted.to(torch.float32), accumulate=True)
        new_logits = la[rowi, (n_acc - 1).clamp_min(0)]
        self._carry = DecodeCarry(
            torch.where(live[:, None], new_logits, c.logits), c.caches,
            c.pos + n_acc, c.done, c.seeds, c.pos_max)
        stop()
        n_acc, t1 = n_acc.cpu().numpy(), t1.cpu().numpy()
        for slot in self._active:
            self._pos[slot] += int(n_acc[slot])
        lpinfo = {}
        if want:
            lp1, lti, ltv = (lp1.cpu().numpy(), lti.cpu().numpy(),
                             ltv.cpu().numpy())
            for slot, r in self._active.items():
                if r.want_logprobs is not None:
                    # one token a step for them: the only emission is t1
                    lpinfo[slot] = [(lp1[slot], lti[slot], ltv[slot])]
        return {slot: [int(t1[slot])]
                + [int(t) for t in drafts[slot][:n_acc[slot] - 1]]
                for slot in self._active}, lpinfo

    @property
    def busy(self) -> bool:
        return bool(self._queue or self._active or self._prefilling)

    def run(self) -> dict[int, list[int]]:
        """Drive until queue and pool are empty; returns rid → tokens for
        every request ever submitted."""
        while self.busy:
            self.step()
        return {rid: req.tokens for rid, req in self._requests.items()}

    def result(self, rid: int) -> _Request:
        return self._requests[rid]

    @property
    def occupancy(self) -> float:
        return self.stats["occupancy_sum"] / max(self.stats["steps"], 1)


class DeadlineExceeded(TimeoutError):
    """A deadline'd request ran out of wall-clock budget (queue wait +
    decode combined) and was cancelled. `.tokens` holds the partial decode
    — exactly the tokens that streamed before the abort."""

    def __init__(self, tokens: list[int], deadline_s: float):
        super().__init__(
            f"decode deadline exceeded ({deadline_s:.3g}s)")
        self.tokens = tokens
        self.deadline_s = deadline_s


class GenerationHandle:
    """A request submitted through `ContinuousDriver.submit`: `result()`
    blocks for the final tokens, `cancel()` aborts it (the slot frees at
    the next step boundary), `done()` polls. A cancelled request's
    `result()` returns the tokens emitted before the abort."""

    __slots__ = ("_driver", "_evt", "_box", "_ctl")

    def __init__(self, driver, evt, box, ctl):
        self._driver = driver
        self._evt = evt
        self._box = box
        self._ctl = ctl

    def result(self) -> list[int]:
        self._evt.wait()
        return ContinuousDriver._result(self._box)

    def cancel(self) -> bool:
        """Request the abort; False if already finished or cancelled. The
        abort lands on the decode thread; `result()` unblocks once the
        slot is released."""
        return self._driver._cancel(self._ctl, self._evt)

    def done(self) -> bool:
        return self._evt.is_set()

    def cancelled(self) -> bool:
        return self._box.get("cancelled", False)

    def timed_out(self) -> bool:
        return self._box.get("timed_out", False)


class ContinuousDriver:
    """Thread-safe front of a ContinuousEngine: concurrent callers submit
    and block (or stream); ONE driver thread owns the engine, the only
    thread that launches on the card, and steps it while any work exists.
    Callers only touch `_sub_lock` for a list append and wait on events;
    the driver drains the queue between steps, so admission latency is
    bounded by one step."""

    def __init__(self, engine: ContinuousEngine):
        self.engine = engine
        self._sub_lock = threading.Lock()   # guards _pending/_cancels/_closed
        self._pending: list[tuple] = []
        self._cancels: list[dict] = []       # ctl dicts awaiting abort
        self._events: dict[int, tuple] = {}  # rid → (evt, box); driver-owned
        self._watch: list[dict] = []         # deadline'd ctls; driver-owned
        self.timeouts = 0                    # deadline aborts (driver-owned)
        self._work = threading.Event()
        self._closed = False
        self._thread = threading.Thread(target=self._loop,
                                        name="continuous-decode",
                                        daemon=True)
        self._thread.start()

    def _submit(self, prompt_ids, length, max_new, on_token, temperature,
                deadline_s=None, priority=0,
                frequency_penalty=0.0, presence_penalty=0.0,
                seed=None, logit_bias=None, logprobs=None):
        evt = threading.Event()
        box: dict = {}
        ctl: dict = {"rid": None, "cancelled": False,
                     "seed": seed, "logit_bias": logit_bias,
                     "logprobs": logprobs,
                     "penalties": (float(frequency_penalty),
                                   float(presence_penalty)),
                     "submitted_ns": _time.perf_counter_ns()}
        if deadline_s is not None:
            if not deadline_s > 0:          # rejects 0, <0 AND nan
                raise ValueError(
                    f"deadline_s must be positive, got {deadline_s}")
            # absolute, from SUBMIT time: the budget covers queue wait AND
            # decode
            ctl["deadline"] = _time.monotonic() + deadline_s
            ctl["deadline_s"] = float(deadline_s)
        with self._sub_lock:
            if self._closed:
                raise RuntimeError("driver is closed")
            self._pending.append((prompt_ids, length, max_new,
                                  on_token, temperature, evt, box, ctl,
                                  int(priority)))
        self._work.set()
        return evt, box, ctl

    def _cancel(self, ctl: dict, evt) -> bool:
        """Queue an abort for the decode thread. A submission and its
        cancel are appended under the same lock, so the loop never sees
        the cancel before the submission."""
        if evt.is_set():
            return False
        with self._sub_lock:
            if ctl["cancelled"]:
                return False
            ctl["cancelled"] = True
            self._cancels.append(ctl)
        self._work.set()
        return True

    def submit(self, prompt_ids, length: int, max_new: int,
               on_token=None, temperature: float | None = None,
               deadline_s: float | None = None,
               priority: int = 0,
               frequency_penalty: float = 0.0,
               presence_penalty: float = 0.0,
               logit_bias: dict | None = None,
               seed: int | None = None) -> GenerationHandle:
        """Non-blocking submit; the handle can wait for or cancel the
        request (`generate()` is `submit().result()`). `deadline_s` bounds
        queue wait + decode together: an expired request is cancelled on
        the decode thread and its `result()` raises `DeadlineExceeded`
        carrying the partial tokens."""
        evt, box, ctl = self._submit(prompt_ids, length, max_new,
                                     on_token, temperature, deadline_s,
                                     priority, frequency_penalty,
                                     presence_penalty, seed,
                                     logit_bias)
        return GenerationHandle(self, evt, box, ctl)

    def submit_embeds(self, embeds, length: int, max_new: int,
                      on_token=None, temperature: float | None = None,
                      deadline_s: float | None = None,
                      priority: int = 0,
                      frequency_penalty: float = 0.0,
                      presence_penalty: float = 0.0,
                      logit_bias: dict | None = None,
                      seed: int | None = None) -> GenerationHandle:
        """Multimodal `submit`: `embeds` [S, H] is the composed prefix
        (token embeddings + spliced image patches); the request joins the
        SAME slot pool as text traffic (`engine.submit_embeds`). Penalties
        count COMPLETION tokens, as on a text request."""
        evt, box, ctl = self._submit(_EmbedsPrompt(embeds), length,
                                     max_new, on_token, temperature,
                                     deadline_s, priority,
                                     frequency_penalty, presence_penalty,
                                     seed, logit_bias)
        return GenerationHandle(self, evt, box, ctl)

    def generate_embeds(self, embeds, length: int, max_new: int,
                        on_token=None, temperature: float | None = None,
                        deadline_s: float | None = None,
                        priority: int = 0,
                        frequency_penalty: float = 0.0,
                        presence_penalty: float = 0.0,
                        logit_bias: dict | None = None,
                        seed: int | None = None) -> list[int]:
        """Blocking multimodal generate through the pool."""
        return self.submit_embeds(
            embeds, length, max_new, on_token=on_token,
            temperature=temperature, deadline_s=deadline_s,
            priority=priority, frequency_penalty=frequency_penalty,
            presence_penalty=presence_penalty, logit_bias=logit_bias,
            seed=seed).result()

    def generate_embeds_stream(self, embeds, length: int, max_new: int,
                               temperature: float | None = None,
                               deadline_s: float | None = None,
                               priority: int = 0,
                               frequency_penalty: float = 0.0,
                               presence_penalty: float = 0.0,
                               logit_bias: dict | None = None,
                               seed: int | None = None):
        """`generate_stream` for a MULTIMODAL request: the composed
        [S, H] prefix prefills through `inputs_embeds` and the stream
        yields token ids as the pool decodes them, with the text stream's
        early-close cancel and deadline."""
        return self._token_stream(_EmbedsPrompt(embeds), length, max_new,
                                  temperature, deadline_s, priority,
                                  frequency_penalty, presence_penalty,
                                  seed, logit_bias)

    def generate_with_logprobs(self, prompt_ids, length: int,
                               max_new: int, logprobs: int = 0,
                               temperature: float | None = None,
                               deadline_s: float | None = None,
                               priority: int = 0,
                               frequency_penalty: float = 0.0,
                               presence_penalty: float = 0.0,
                               logit_bias: dict | None = None,
                               seed: int | None = None
                               ) -> tuple[list[int], list]:
        """`generate` that also returns per-token logprobs: [(lp, [(token_id,
        lp), ...top]) ...] aligned with the tokens; `logprobs` = how many
        top alternatives per token (0..5)."""
        evt, box, _ = self._submit(prompt_ids, length, max_new,
                                   None, temperature, deadline_s,
                                   priority, frequency_penalty,
                                   presence_penalty, seed, logit_bias,
                                   int(logprobs))
        evt.wait()
        toks = self._result(box)
        return toks, box.get("logprobs") or []

    @staticmethod
    def _result(box: dict) -> list[int]:
        if "error" in box:
            raise box["error"]
        return box["tokens"]

    def generate(self, prompt_ids, length: int, max_new: int,
                 on_token=None, temperature: float | None = None,
                 deadline_s: float | None = None,
                 priority: int = 0,
                 frequency_penalty: float = 0.0,
                 presence_penalty: float = 0.0,
                 logit_bias: dict | None = None,
                 seed: int | None = None) -> list[int]:
        """Block until this request completes; returns its tokens. With
        `deadline_s`, raises `DeadlineExceeded` (partial tokens on the
        exception) if the budget expires first."""
        evt, box, _ = self._submit(prompt_ids, length, max_new,
                                   on_token, temperature, deadline_s,
                                   priority, frequency_penalty,
                                   presence_penalty, seed,
                                   logit_bias)
        evt.wait()
        return self._result(box)

    def generate_stream(self, prompt_ids, length: int, max_new: int,
                        temperature: float | None = None,
                        deadline_s: float | None = None,
                        priority: int = 0,
                        frequency_penalty: float = 0.0,
                        presence_penalty: float = 0.0,
                        logit_bias: dict | None = None,
                        seed: int | None = None):
        """Yield this request's token ids as the pool decodes them. The
        engine's `on_token` fires on the driver thread; a queue bridges to
        the consumer. Closing the generator before exhaustion CANCELS the
        request: its slot frees at the next step boundary."""
        return self._token_stream(prompt_ids, length, max_new, temperature,
                                  deadline_s, priority, frequency_penalty,
                                  presence_penalty, seed, logit_bias)

    def _token_stream(self, payload, length, max_new, temperature,
                      deadline_s, priority, frequency_penalty,
                      presence_penalty, seed, logit_bias):
        """The stream of one request (ids or an `_EmbedsPrompt`),
        submitted now, its tokens bridged through a queue."""
        import queue as _queue

        q: _queue.Queue = _queue.Queue()
        evt, box, ctl = self._submit(payload, length, max_new,
                                     lambda _rid, t: q.put(t),
                                     temperature, deadline_s, priority,
                                     frequency_penalty,
                                     presence_penalty, seed,
                                     logit_bias)

        def _iter():
            try:
                while not evt.is_set():
                    try:
                        yield q.get(timeout=0.05)
                    except _queue.Empty:
                        continue
                while True:
                    try:
                        yield q.get_nowait()
                    except _queue.Empty:
                        break
                self._result(box)   # surface engine errors to consumers
            finally:
                # abandoned mid-stream: stop paying decode steps for a
                # consumer that is gone
                if not evt.is_set():
                    self._cancel(ctl, evt)

        return _iter()

    def warm(self, prompt_buckets: tuple[int, ...] | None = None
             ) -> None:
        """Run `engine.warm` ON THE DRIVER THREAD (the engine is
        single-threaded). Blocks until done."""
        evt = threading.Event()
        box: dict = {}
        with self._sub_lock:
            if self._closed:
                raise RuntimeError("driver is closed")
            self._pending.append((_WARM, prompt_buckets, None, None,
                                  None, evt, box, None, 0))
        self._work.set()
        evt.wait()
        if "error" in box:
            raise box["error"]

    def close(self):
        with self._sub_lock:
            self._closed = True
        self._work.set()
        self._thread.join(timeout=10)

    def _loop(self):
        while True:
            self._work.wait()
            with self._sub_lock:
                if self._closed:
                    # never strand a caller on evt.wait(): fail every
                    # queued and in-flight request before exiting
                    err = RuntimeError("driver is closed")
                    for item in self._pending:
                        item[6]["error"] = err
                        item[5].set()
                    self._pending.clear()
                    for evt, box in self._events.values():
                        box["error"] = err
                        evt.set()
                    self._events.clear()
                    return
                pending, self._pending = self._pending, []
                cancels, self._cancels = self._cancels, []
            for (ids, length, max_new, on_token, temp,
                 evt, box, ctl, prio) in pending:
                if ids is _WARM:
                    try:
                        self.engine.warm(length)   # length = buckets
                    except Exception as e:
                        box["error"] = e
                    evt.set()
                    continue
                try:
                    fp, pp = ctl.get("penalties", (0.0, 0.0))
                    sub = (functools.partial(self.engine.submit_embeds,
                                             ids.embeds)
                           if isinstance(ids, _EmbedsPrompt)
                           else functools.partial(self.engine.submit, ids))
                    rid = sub(
                        length, max_new, on_token=on_token,
                        temperature=temp, priority=prio,
                        frequency_penalty=fp, presence_penalty=pp,
                        logit_bias=ctl.get("logit_bias"),
                        logprobs=ctl.get("logprobs"),
                        seed=ctl.get("seed"),
                        # the queue wait counts from the caller's submit,
                        # the step it waited out here included
                        enqueued_ns=ctl["submitted_ns"])
                    ctl["rid"] = rid
                    self._events[rid] = (evt, box)
                    if "deadline" in ctl:
                        self._watch.append(ctl)
                except Exception as e:           # bad request: fail caller
                    box["error"] = e
                    evt.set()
            for ctl in cancels:
                rid = ctl.get("rid")
                if rid is None or rid not in self._events:
                    continue    # failed submit, or finished first
                self.engine.cancel(rid)
                evt, box = self._events.pop(rid)
                box["cancelled"] = True
                req_done = self.engine._requests[rid]
                box["tokens"] = req_done.tokens
                if req_done.want_logprobs is not None:
                    box["logprobs"] = req_done.logprobs
                evt.set()
            if self._watch:
                # deadline sweep: while a deadline'd request is live the
                # engine is busy, so the loop passes here once a step
                now = _time.monotonic()
                alive = []
                for ctl in self._watch:
                    rid = ctl.get("rid")
                    if rid not in self._events:
                        continue        # finished, cancelled, or failed
                    if now < ctl["deadline"]:
                        alive.append(ctl)
                        continue
                    self.engine.cancel(rid)
                    evt, box = self._events.pop(rid)
                    toks = self.engine._requests[rid].tokens
                    box["timed_out"] = True
                    box["tokens"] = toks
                    box["error"] = DeadlineExceeded(toks,
                                                    ctl["deadline_s"])
                    self.timeouts += 1
                    evt.set()
                self._watch = alive
            if not self.engine.busy:
                # re-check under the lock so a racing submit (or cancel)
                # cannot have its work-flag clear swallowed
                with self._sub_lock:
                    if (not self._pending and not self._cancels
                            and not self.engine.busy):
                        self._work.clear()
                continue
            try:
                self.engine.step()
            except Exception as e:
                # a failed step fails every in-flight request instead of
                # stranding its caller on evt.wait()
                for rid, (evt, box) in self._events.items():
                    box["error"] = e
                    evt.set()
                self._events.clear()
                with self._sub_lock:
                    # submissions queued DURING the failing step drain on
                    # the next pass (and fail the same way if it still
                    # fails)
                    if not self._pending and not self._cancels:
                        self._work.clear()
                continue
            for rid, (evt, box) in list(self._events.items()):
                req = self.engine._requests[rid]
                if req.done:
                    if req.error is not None:
                        box["error"] = req.error
                    else:
                        box["tokens"] = req.tokens
                    if req.want_logprobs is not None:
                        box["logprobs"] = req.logprobs
                    evt.set()
                    del self._events[rid]


@torch.no_grad()
def divergence_gap(generator: TextGenerator, prompt, want, got,
                   sampling: SamplingConfig, temperature: float = 0.0,
                   seed: int = 0) -> float:
    """How far apart, in logits, the first differing tokens of two runs of
    one request lie under the solo run's own forward (ROADMAP C-29): 0.0
    when the runs are equal, else the largest of (the top logit − each
    run's token's logit) at the first position where they differ, from one
    full forward over prompt + `want`'s tokens before it. A run that
    stopped there stands for its best stop token (EOS or pad). For a
    sampled request (`temperature` > 0, its `seed`) the logits are the
    draw's own scores: the temperature-scaled kept set plus its Gumbel
    noise, times the temperature. A pool's run is its solo run's when the
    gap is 0 or within a near-tie tolerance of the logits' rounding.
    A multimodal request's `prompt` is its prefix embeddings [n, H] (a
    floating tensor): the forward then runs through `inputs_embeds`, with
    the tokens' own embedding rows after them."""
    want, got = [int(t) for t in want], [int(t) for t in got]
    if want == got:
        return 0.0
    n = min(len(want), len(got))
    j = next((i for i in range(n) if want[i] != got[i]), n)
    cfg, dev = generator.config, generator.device
    model = generator.load()
    tail = torch.as_tensor(np.asarray(want[:j], np.int64), device=dev)
    if torch.is_tensor(prompt) and prompt.is_floating_point():
        embeds = torch.cat([prompt.to(dev, cfg.dtype),
                            model.embed_tokens(tail)])[None]
        seq = None
        s = embeds.shape[1]
    else:
        embeds = None
        seq = torch.cat([torch.as_tensor(np.asarray(prompt, np.int64),
                                         device=dev), tail])[None]
        s = seq.shape[1]
    logits, _ = model(seq, None, DecoderModel.init_cache(
        cfg, 1, s, dev, model.cache_heads),
                      kv_len=s, inputs_embeds=embeds)
    score = logits[0, -1].float()
    if temperature > 0:
        keys = step_keys(torch.tensor([seed], device=dev),
                         torch.tensor([s], device=dev), 0)
        kk = min(int(sampling.top_k), score.shape[-1])
        vals, idxs = torch.topk(score, kk)
        scaled = vals / temperature
        if sampling.top_p < 1.0:
            probs = torch.softmax(scaled, dim=-1)
            keep = (torch.cumsum(probs, dim=-1) - probs < sampling.top_p) \
                | (torch.arange(kk, device=dev) == 0)
            scaled = torch.where(keep, scaled, -torch.inf)
        g = step_gumbel(keys, kk)[0]
        score = torch.full_like(score, -torch.inf).scatter(
            0, idxs, (scaled + g) * temperature)
    stops = (sampling.eos_id, sampling.pad_id)

    def picked(run):
        return max(float(score[t]) for t in
                   ((run[j],) if j < len(run) else stops))

    return float(score.max()) - min(picked(want), picked(got))
