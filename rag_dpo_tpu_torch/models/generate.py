"""KV-cached text generation: prefill, then a decode loop on the host.

Port of `rag_dpo_tpu/models/generate.py`. The JAX package compiles a
prefill program and scans the decode steps on the device; here each step is
one eager forward of `DecoderModel` with the KV cache written in place, and
every step attends only the cache rows written so far (`kv_len`, see
`models/decoder.py`). Finished rows keep emitting pad, as in the scan;
a row that emitted EOS is never reset.

Sampling draws are POSITION-KEYED, as `step_keys` makes them in JAX: each
draw is a pure function of (row seed, position, tag), computed on the device
by JAX's own counter-based hash (threefry-2x32, `threefry2x32`) with no
generator state. So a sampled stream is the same however it is chunked and
whatever shares its batch, identical prompts in one batch differ by their
row seeds, and the uniforms are `jax.random.uniform`'s bit for bit.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..ops import default_device
from .decoder import (
    DecoderConfig,
    DecoderModel,
    build_decoder,
    init_random_,
    load_decoder_params,
)

# decode steps between two host checks of "every row is done"
DECODE_CHUNK = 16


@dataclasses.dataclass
class SamplingConfig:
    temperature: float = 0.0      # 0 = greedy
    top_k: int = 40
    top_p: float = 1.0            # nucleus cutoff within the top-k (1 = off)
    max_new_tokens: int = 256
    eos_id: int = 2
    pad_id: int = 1


def mix_seed(a: int, b: int) -> int:
    """Deterministic 32-bit mix (golden-ratio / Murmur odd constants,
    each a bijection mod 2³²): the default per-row / per-request
    sampling seed when the caller doesn't pass one — distinct rows and
    distinct base seeds land on distinct streams without any shared
    rng state to thread or lock."""
    return ((a * 0x9E3779B9) ^ (b * 0x85EBCA6B)) & 0xFFFFFFFF


def default_row_seeds(rng_seed: int, b: int) -> np.ndarray:
    """Per-row seeds for a batched decode given one call-level seed:
    co-batched rows sample INDEPENDENT streams (an identical prompt
    twice in one batch draws two different generations) while the call
    stays reproducible from `rng_seed` alone."""
    return np.asarray([mix_seed(rng_seed, r) for r in range(b)],
                      np.uint32)


_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds, `jax.random`'s hash, on int64 tensors
    holding uint32 values (every sum masked back to 32 bits): the key pair
    (k1, k2) hashes the counter pair (x1, x2), all broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl32(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


@dataclasses.dataclass(frozen=True)
class StepKeys:
    """Per-row threefry keys of one decode position, the two 32-bit words
    of JAX's `fold_in(fold_in(key(seed), pos), tag)`."""
    k1: torch.Tensor         # [B] int64 in [0, 2³²)
    k2: torch.Tensor


def _fold_in(k1, k2, data):
    """`jax.random.fold_in`: the key hashes the counter pair (0, data)."""
    return threefry2x32(k1, k2, torch.zeros_like(data), data)


def step_keys(seeds, pos, tag: int) -> StepKeys:
    """Per-row keys for POSITION-KEYED sampling, JAX's `step_keys`:
    key_i = fold_in(fold_in(key(seeds[i]), pos[i]), tag), where
    `key(s)` is the pair (0, s) of a 32-bit seed. `tag` separates several
    draws at one position (0 = the token draw, 1 = speculative-sampling
    accept uniforms)."""
    seeds = seeds.to(torch.int64) & _M32
    k1, k2 = _fold_in(torch.zeros_like(seeds), seeds,
                      pos.to(torch.int64) & _M32)
    k1, k2 = _fold_in(k1, k2, torch.full_like(k1, int(tag) & _M32))
    return StepKeys(k1, k2)


def step_bits(keys: StepKeys, n: int) -> torch.Tensor:
    """[B, n] int64 uint32 values: `jax.random.bits(key, (n,))` of each
    row's key, in JAX's partitionable layout (the counters are the 64-bit
    iota 0 … n−1 as (hi, lo) words, the two output words xor-ed)."""
    j = torch.arange(n, device=keys.k1.device, dtype=torch.int64)[None, :]
    b1, b2 = threefry2x32(keys.k1[:, None], keys.k2[:, None],
                          torch.zeros_like(j), j)
    return b1 ^ b2


def step_uniforms(keys: StepKeys, n: int, minval: float = 0.0
                  ) -> torch.Tensor:
    """[B, n] f32: `jax.random.uniform(key, (n,), minval=minval)` of each
    row's key, bit for bit: the top 23 bits as the mantissa of a float in
    [1, 2), minus 1, scaled to [minval, 1) in f32."""
    bits = (step_bits(keys, n) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    return torch.maximum(u * (1.0 - lo) + lo, lo.to(u.device))


def step_gumbel(keys: StepKeys, n: int) -> torch.Tensor:
    """[B, n] f32: `jax.random.gumbel(key, (n,))` of each row's key (the
    "low" mode, JAX's default): −log(−log(u)), u uniform on [tiny, 1)."""
    u = step_uniforms(keys, n, float(torch.finfo(torch.float32).tiny))
    return -torch.log(-torch.log(u))


def topk_topp_sample(logits, temps, keys: StepKeys, top_k: int,
                     top_p: float, exclude=None):
    """Top-k then nucleus draw with PER-ROW temperature; rows with
    temps ≤ 0 return the argmax (bit-identical to greedy decode, so
    greedy and sampled requests share one path). logits [B, V]; `keys`
    the rows' position keys (gumbel-argmax, as `jax.random.categorical`).

    Nucleus rule: keep the smallest prefix of the (descending) top-k
    whose mass reaches `top_p` — a token stays iff the mass BEFORE it
    is < top_p, so the first token always survives.

    `exclude` [B] (optional): per-row token id masked out WITHIN the
    kept set (the residual draw of speculative sampling); -1 excludes
    nothing; the kept set is computed before the exclusion."""
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    kk = min(int(top_k), logits.shape[-1])
    vals, idxs = torch.topk(logits, kk, dim=-1)          # sorted desc
    safe = torch.where(temps > 0, temps, 1.0)[:, None]
    scaled = vals.float() / safe
    if top_p < 1.0:
        probs = torch.softmax(scaled, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs
        keep = (before < top_p) | (torch.arange(
            kk, device=logits.device)[None, :] == 0)
        scaled = torch.where(keep, scaled, -torch.inf)
    if exclude is not None:
        scaled = torch.where(idxs == exclude[:, None], -torch.inf, scaled)
    g = step_gumbel(keys, kk)
    choice = torch.argmax(scaled + g, dim=-1)
    drawn = idxs.gather(1, choice[:, None])[:, 0]
    # the greedy rows' token is the argmax (the first of equal maxima),
    # which torch.topk's order among ties does not promise
    return torch.where(temps > 0, drawn,
                       torch.argmax(logits, dim=-1)).to(torch.int64)


def apply_penalties(logits, counts, freqs, pres, bias=None):
    """OpenAI-style logit adjustment: logits − freq·count −
    pres·1[count>0] (counts over completion tokens) + bias (static
    per-request `logit_bias` rows, [b, V] or None). Zero penalties
    and zero bias are bitwise no-ops (x − 0.0 ≡ x ≡ x + 0.0)."""
    out = logits - freqs[:, None] * counts \
        - pres[:, None] * (counts > 0).to(counts.dtype)
    if bias is not None:
        out = out + bias
    return out


LOGPROB_TOPK = 5   # static top-k alternatives emitted with logprobs


def sampling_logprobs(pl, temps, token):
    """Per-row logprob of `token` [b] plus the top-LOGPROB_TOPK (ids,
    values) under the sampling distribution: log-softmax of the
    adjusted logits `pl` [b, V], temperature-scaled (greedy rows use
    temp 1), over the FULL vocab — pre top-k/top-p truncation."""
    scaled = pl / torch.where(temps > 0, temps, 1.0)[:, None]
    ls = torch.log_softmax(scaled, dim=-1)
    lp = ls.gather(1, token[:, None].long())[:, 0]
    tv, ti = torch.topk(ls, LOGPROB_TOPK, dim=-1)
    return lp, ti.to(torch.int32), tv


def penalized_rows(freqs, pres):
    """Rows whose target distribution depends on the run's own earlier
    tokens — parallel draft verification is unsound for them. NEGATIVE
    penalties count too."""
    return (freqs != 0) | (pres != 0)


def truncated_token_prob(logits, temps, tokens, top_k: int,
                         top_p: float):
    """Probability `topk_topp_sample` assigns to `tokens` [B] under
    `logits` [B, V] — softmax over the temperature-scaled kept set
    (top-k ∩ nucleus), 0 for tokens outside it: the target-side
    acceptance probability of speculative sampling with a deterministic
    draft. Works over the kk-sized top-k only."""
    kk = min(int(top_k), logits.shape[-1])
    vals, idxs = torch.topk(logits, kk, dim=-1)
    safe = torch.where(temps > 0, temps, 1.0)[:, None]
    scaled = vals / safe
    if top_p < 1.0:
        p0 = torch.softmax(scaled, dim=-1)
        before = torch.cumsum(p0, dim=-1) - p0
        keep = (before < top_p) | (torch.arange(
            kk, device=logits.device)[None, :] == 0)
        scaled = torch.where(keep, scaled, -torch.inf)
    probs = torch.softmax(scaled, dim=-1)        # kept-set dist
    match = idxs == tokens[:, None]
    return torch.where(match, probs, 0.0).sum(dim=-1)


@dataclasses.dataclass
class DecodeCarry:
    """What one decode chunk hands the next: the logits after the last
    token, the caches, each row's next position, done flags and seeds,
    and on the host the largest position the next step writes."""
    logits: torch.Tensor
    caches: list
    pos: torch.Tensor
    done: torch.Tensor
    seeds: torch.Tensor
    pos_max: int


class TextGenerator:
    """Host wrapper around the decoder: prefill, decode, choice scoring.

    `params`: a Flax `DecoderModel` tree ({'params': ...} or bare, as
    `models.convert.load_params_npz` reads it) or None for a seeded random
    init (`rng_seed`) on `device` (default: the first CUDA card). A tree
    of `models.sharding.shard_params` builds this rank's tensor-parallel
    slice of the model; every rank of its model axis then runs the same
    calls in the same order."""

    def __init__(self, config: DecoderConfig, params=None,
                 rng_seed: int = 0, device=None):
        self.config = config
        self.device = default_device(device)
        self._params = params
        self.tp = getattr(params, "tp", None)
        self._rng_seed = rng_seed
        self.model: DecoderModel | None = None
        self._load_lock = threading.Lock()
        # bound concurrent score_choices calls: each holds a k-broadcast
        # KV transient
        self._choose_slots = threading.Semaphore(2)
        self._choose_batcher = None   # see enable_choose_batching

    def load(self) -> DecoderModel:
        with self._load_lock:
            if self.model is None:
                model = build_decoder(self.config, self.device, self.tp)
                if self._params is None:
                    gen = torch.Generator(device=self.device)
                    gen.manual_seed(self._rng_seed)
                    init_random_(model, gen)
                else:
                    load_decoder_params(model, self._params)
                    self._params = None
                self.model = model
            return self.model

    def load_converted(self, state_dict):
        from .convert import convert_llama_state_dict

        self.load_converted_tree(convert_llama_state_dict(state_dict))

    def load_converted_tree(self, params: dict):
        """Install an ALREADY-converted DecoderModel param tree, applying
        the quantization rule of the config (a float tree quantizes when
        the model's projections are int8)."""
        if self.config.quantize_weights:
            from .decoder import quantize_decoder_params

            params = quantize_decoder_params(params)
        with self._load_lock:
            self.model = None
            self._params = {"params": params}
        self.load()

    # ------------------------------------------------------------ device
    def _tensor(self, x, dtype=torch.int64):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    @torch.no_grad()
    def _prefill(self, ids, lengths, cache_len: int | None = None,
                 embeds=None):
        """Prompt forward that writes the cache: ids [B, S] (or `embeds`
        [B, S, H] with ids None: the multimodal path, models/llava.py's
        token rows with projected image patches spliced in) and lengths
        [B] on the device → (logits after each row's last valid position
        [B, V], caches of `cache_len` rows, default max_seq_len)."""
        model = self.load()
        b, s = ids.shape if embeds is None else embeds.shape[:2]
        caches = DecoderModel.init_cache(self.config, b, cache_len,
                                         self.device, model.cache_heads)
        positions = torch.arange(s, device=self.device).expand(b, s)
        valid = positions < lengths[:, None]
        logits, caches = model(ids, positions, caches, write_mask=valid,
                               last_index=(lengths - 1).clamp_min(0),
                               kv_len=s, inputs_embeds=embeds)
        return logits[:, 0], caches

    @torch.no_grad()
    def _extend(self, ids, start, suffix_len, caches):
        """Continue a prefill from a cached prefix: write K/V for the
        `s` suffix positions of ids [B, s] from `start` [B] (host ints) on
        into `caches`, whose rows must cover start + s, and return the
        logits at each row's last valid suffix token [B, V]
        (serving/continuous.py: prefix-cache hits and prefill segments)."""
        model = self.load()
        cfg = self.config
        b, s = ids.shape
        start = np.asarray(start, np.int64)
        assert int(start.max()) + s <= caches[0]["k"].shape[1], (
            "the suffix window runs past the caches' rows")
        offs = torch.arange(s, device=self.device)[None, :]
        positions = self._tensor(start)[:, None] + offs
        valid = (offs < self._tensor(suffix_len)[:, None]) \
            & (positions < cfg.max_seq_len)
        logits, caches = model(
            ids, positions.clamp(0, cfg.max_seq_len - 1), caches,
            write_mask=valid,
            last_index=(self._tensor(suffix_len) - 1).clamp_min(0),
            kv_len=int(start.max()) + s)
        return logits[:, 0], caches

    def _start(self, input_ids, lengths, sampling: SamplingConfig,
               rng_seed: int, rng_seeds, embeds=None) -> DecodeCarry:
        """Prefill the prompts (ids [B, S], or `embeds` [B, S, H] on the
        device with `input_ids` None) into a carry for the decode."""
        b, s = (input_ids.shape if embeds is None else embeds.shape[:2])
        assert s + sampling.max_new_tokens <= self.config.max_seq_len, (
            "prompt + generation exceeds max_seq_len")
        # the cache write CLAMPS an overflowing window (dynamic_update_
        # slice semantics): a lying `lengths` would corrupt the final rows
        # instead of no-oping, so reject it here
        assert int(np.max(lengths)) <= s, "lengths exceed prompt width"
        seeds = default_row_seeds(rng_seed, b) if rng_seeds is None \
            else np.asarray(rng_seeds).astype(np.uint32)
        lens = self._tensor(lengths)
        if embeds is None:
            logits, caches = self._prefill(self._tensor(input_ids), lens)
        else:
            logits, caches = self._prefill(None, lens, embeds=embeds)
        return DecodeCarry(logits, caches, lens,
                           torch.zeros(b, dtype=torch.bool,
                                       device=self.device),
                           self._tensor(seeds.astype(np.int64)),
                           int(np.max(lengths)))

    @torch.no_grad()
    def _decode_chunk(self, carry: DecodeCarry, n_steps: int,
                      sampling: SamplingConfig):
        """`n_steps` decode steps from `carry` → (carry, tokens [B, n] on
        the device). Each step samples from the carried logits, then feeds
        the token at its position."""
        model = self.load()
        temp = sampling.temperature
        b = carry.pos.shape[0]
        temps = torch.full((b,), temp, dtype=torch.float32,
                           device=self.device)
        logits, caches, pos, done = (carry.logits, carry.caches, carry.pos,
                                     carry.done)
        pos_max = carry.pos_max
        tokens = []
        for _ in range(n_steps):
            if temp <= 0:
                token = torch.argmax(logits, dim=-1)
            else:
                token = topk_topp_sample(
                    logits, temps, step_keys(carry.seeds, pos, 0),
                    sampling.top_k, sampling.top_p)
            token = torch.where(done, sampling.pad_id, token)
            done = done | (token == sampling.eos_id)
            new_logits, caches = model(token[:, None], pos[:, None], caches,
                                       kv_len=pos_max + 1)
            logits = new_logits[:, 0]
            pos = pos + 1
            pos_max += 1
            tokens.append(token)
        return (DecodeCarry(logits, caches, pos, done, carry.seeds, pos_max),
                torch.stack(tokens, dim=1))

    @torch.no_grad()
    def _decode_chunk_mixed(self, carry: DecodeCarry, n_steps: int,
                            sampling: SamplingConfig, temps, counts, freqs,
                            pres, biases, logprobs: bool = True):
        """`_decode_chunk` with PER-ROW temperatures (temps [B] ≤ 0 decode
        greedily), OpenAI-style penalties over completion-token counts
        (counts [B, V], updated in place; freqs / pres [B]) and static
        `logit_bias` rows (biases [B, V]): one path serves a pool mixing
        all of them (serving/continuous.py). Zero penalties and bias are
        bitwise no-ops. Besides the tokens [B, n] it returns, per step,
        the chosen token's logprob [B, n] and the top-`LOGPROB_TOPK` ids
        and values [B, n, LOGPROB_TOPK] under the adjusted,
        temperature-scaled full-vocab log-softmax (`sampling_logprobs`);
        with `logprobs` False those three are None and the log-softmax is
        skipped. `carry.pos_max` bounds every LIVE row's position."""
        model = self.load()
        logits, caches, pos, done = (carry.logits, carry.caches, carry.pos,
                                     carry.done)
        pos_max = carry.pos_max
        rowi = torch.arange(pos.shape[0], device=self.device)
        tokens, lps, tis, tvs = [], [], [], []
        for _ in range(n_steps):
            pl = apply_penalties(logits, counts, freqs, pres, biases)
            token = topk_topp_sample(pl, temps,
                                     step_keys(carry.seeds, pos, 0),
                                     sampling.top_k, sampling.top_p)
            token = torch.where(done, sampling.pad_id, token)
            if logprobs:
                lp, ti, tv = sampling_logprobs(pl, temps, token)
                lps.append(lp)
                tis.append(ti)
                tvs.append(tv)
            counts[rowi, token] += (~done).to(counts.dtype)
            done = done | (token == sampling.eos_id)
            new_logits, caches = model(token[:, None], pos[:, None], caches,
                                       kv_len=pos_max + 1)
            logits = new_logits[:, 0]
            pos = pos + 1
            pos_max += 1
            tokens.append(token)
        stacks = (tuple(torch.stack(x, dim=1) for x in (lps, tis, tvs))
                  if logprobs else (None, None, None))
        return (DecodeCarry(logits, caches, pos, done, carry.seeds, pos_max),
                torch.stack(tokens, dim=1), *stacks)

    def _choose(self, prompt_ids, prompt_len, cand_ids, cand_lens):
        """Teacher-forced candidate scoring: prefill `b` prompts ONCE,
        copy each prompt's K/V prefix to its `k` candidate rows, run one
        teacher-forced forward over the `c`-token candidate bucket, and
        sum each candidate's next-token log-probs → [b, k] on the host.
        The cache holds only the s + c rows the call writes."""
        b, s = prompt_ids.shape
        _, k, c = cand_ids.shape
        cfg = self.config
        cache_len = min(s + c, cfg.max_seq_len)
        model = self.load()
        dev = self.device
        with torch.no_grad():
            pids, plen = self._tensor(prompt_ids), self._tensor(prompt_len)
            cflat = self._tensor(cand_ids).reshape(b * k, c)
            lflat = self._tensor(cand_lens).reshape(b * k)
            logits1, caches = self._prefill(pids, plen, cache_len)
            caches_k = [{name: x.repeat_interleave(k, dim=0)
                         for name, x in layer.items()} for layer in caches]
            plen_k = plen.repeat_interleave(k)                   # [b·k]
            offs = torch.arange(c, device=dev)[None, :]
            pos_c = plen_k[:, None] + offs
            valid_c = (offs < lflat[:, None]) & (pos_c < cache_len)
            logits_c, _ = model(cflat, pos_c.clamp(0, cache_len - 1),
                                caches_k, write_mask=valid_c,
                                kv_len=cache_len)
            l1 = logits1.float()                                 # [b, V]
            lp1 = l1 - torch.logsumexp(l1, dim=-1, keepdim=True)
            first = lp1.repeat_interleave(k, dim=0).gather(
                1, cflat[:, :1])[:, 0]                           # [b·k]
            lc = logits_c.float()                                # [b·k, c, V]
            lse = torch.logsumexp(lc, dim=-1)                    # [b·k, c]
            tgt = lc[:, :-1].gather(-1, cflat[:, 1:, None])[..., 0]
            nxt = tgt - lse[:, :-1]
            jmask = (torch.arange(c - 1, device=dev)[None, :] + 1) \
                < lflat[:, None]
            out = first + torch.where(jmask, nxt, 0.0).sum(dim=-1)
            return out.reshape(b, k).cpu().numpy()

    # ------------------------------------------------------------ choose
    def score_choices(self, prompt_ids: np.ndarray, prompt_len: int,
                      cand_ids: np.ndarray,
                      cand_lens: np.ndarray) -> np.ndarray:
        """Sum log-prob of each candidate continuation [k, c] after the
        shared prompt [s] (true length `prompt_len`). Shapes are
        bucketed (k → pow2, s/c → length buckets); pad rows score
        garbage and are sliced away. With `enable_choose_batching`,
        concurrent same-bucket callers coalesce into ONE forward pair."""
        from ..tokenize.base import bucket_length

        self.load()
        prompt_ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        cand_ids = np.asarray(cand_ids, np.int32)
        cand_lens = np.asarray(cand_lens, np.int32)
        k, c = cand_ids.shape
        kb = 1
        while kb < k:
            kb *= 2
        s = bucket_length(len(prompt_ids))
        cb = bucket_length(c, buckets=(4, 8, 16, 32, 64, 128))
        pad = getattr(self.config, "pad_id", 1)
        pids = np.full((s,), pad, np.int32)
        pids[:len(prompt_ids)] = prompt_ids[:s]
        cids = np.full((kb, cb), pad, np.int32)
        cids[:k, :c] = cand_ids[:, :cb]
        lens = np.ones((kb,), np.int32)
        lens[:k] = np.clip(cand_lens, 1, cb)
        plen = min(int(prompt_len), s)
        if self._choose_batcher is not None:
            # pack one flat int32 row [s | 1 | kb·cb | kb]; same-bucket
            # rows stack into one call by the MicroBatcher
            row = np.concatenate([
                pids, np.asarray([plen], np.int32),
                cids.reshape(-1), lens])
            (out,) = self._choose_batcher(row[None, :], key=(kb, s, cb))
            return np.asarray(out)[0, :k]
        with self._choose_slots:
            out = self._choose(pids[None, :], np.asarray([plen], np.int32),
                               cids[None], lens[None])
            return out[0, :k]

    def enable_choose_batching(self, max_batch: int = 4,
                               max_wait_ms: float = 2.0) -> None:
        """Coalesce concurrent score_choices calls into batched forwards
        (one weight sweep each for the prefill and the extend, shared by
        every caller in the window). Idempotent."""
        if self._choose_batcher is not None:
            return
        from ..serving.batcher import MicroBatcher

        self._choose_batcher = MicroBatcher(
            self._choose_batch_fn, max_batch=max_batch,
            max_wait_ms=max_wait_ms)

    def warm_choose(self, k: int, s: int, c: int) -> None:
        """Run the choice scoring once at the (k, s, c) bucket for every
        batch size the batcher can produce (pow2s up to its max_batch;
        just b=1 unbatched), so the allocator holds its blocks before
        traffic."""
        from ..tokenize.base import bucket_length

        self.load()
        kb = 1
        while kb < k:
            kb *= 2
        s = bucket_length(s)
        cb = bucket_length(c, buckets=(4, 8, 16, 32, 64, 128))
        bs = [1]
        if self._choose_batcher is not None:
            b = 1
            while b < self._choose_batcher.max_batch:
                b *= 2
                bs.append(b)
        pad = getattr(self.config, "pad_id", 1)
        for b in bs:
            self._choose(np.full((b, s), pad, np.int32),
                         np.ones((b,), np.int32),
                         np.full((b, kb, cb), pad, np.int32),
                         np.ones((b, kb), np.int32))

    def _choose_batch_fn(self, stacked: np.ndarray, key):
        """MicroBatcher fn: unpack [B, s+1+kb·(cb+1)] rows, pad B to a
        power of two, run the batched scoring, return per-row scores
        [B, kb]."""
        kb, s, cb = key
        q = stacked.shape[0]
        b = 1
        while b < q:
            b *= 2
        if b > q:  # replicate row 0: real shapes, results sliced off
            stacked = np.concatenate(
                [stacked, np.repeat(stacked[:1], b - q, axis=0)])
        pids = stacked[:, :s]
        plens = stacked[:, s]
        cids = stacked[:, s + 1:s + 1 + kb * cb].reshape(b, kb, cb)
        lens = stacked[:, s + 1 + kb * cb:].reshape(b, kb)
        with self._choose_slots:
            return (self._choose(pids, plens, cids, lens)[:q],)

    # ------------------------------------------------------------ public
    def generate_stream(self, input_ids: np.ndarray,
                        lengths: np.ndarray,
                        sampling: SamplingConfig | None = None,
                        rng_seed: int = 0, chunk: int = 8,
                        rng_seeds=None):
        """Yield [B, ≤chunk] token blocks as they decode. Streams equal
        generate_ids, greedy and sampled (position-keyed draws make
        chunking invisible); stops once every row has emitted EOS.
        `rng_seeds` [B] pins per-row sampling seeds (else they derive
        from `rng_seed` + row)."""
        sampling = sampling or SamplingConfig()
        carry = self._start(input_ids, lengths, sampling, rng_seed,
                            rng_seeds)
        yield from self._stream_carry(carry, sampling, chunk)

    def _stream_carry(self, carry: DecodeCarry, sampling: SamplingConfig,
                      chunk: int):
        """Decode from a prefilled carry, yielding [B, ≤chunk] blocks
        until the budget is spent or every row has emitted EOS."""
        emitted = 0
        while emitted < sampling.max_new_tokens:
            n = min(chunk, sampling.max_new_tokens - emitted)
            carry, tokens = self._decode_chunk(carry, n, sampling)
            emitted += n
            yield tokens.cpu().numpy().astype(np.int32)
            if bool(carry.done.all()):
                return

    def generate_ids(self, input_ids: np.ndarray, lengths: np.ndarray,
                     sampling: SamplingConfig | None = None,
                     rng_seed: int = 0, rng_seeds=None) -> np.ndarray:
        """[B, S] padded prompts → [B, max_new_tokens] generated ids
        (pad_id after each row's EOS). Sampled rows draw position-keyed
        per-row streams: `rng_seeds` [B] pins them per request, else they
        derive from `rng_seed` + row index."""
        sampling = sampling or SamplingConfig()
        return _collect(
            self.generate_stream(input_ids, lengths, sampling, rng_seed,
                                 DECODE_CHUNK, rng_seeds),
            np.asarray(input_ids).shape[0], sampling)

    def embed_ids(self, ids) -> np.ndarray:
        """Token ids → rows of the decoder's own embedding table (its
        parameter dtype, as JAX's `embed_ids` returns them), on the host:
        for building multimodal prefixes by hand."""
        table = self.load().embed_tokens.weight
        idx = torch.as_tensor(np.asarray(ids, np.int64),
                              device=table.device)
        return table[idx].float().cpu().numpy()

    def generate_with_embeds(self, embeds, lengths: np.ndarray,
                             sampling: SamplingConfig | None = None,
                             rng_seed: int = 0,
                             rng_seeds=None) -> np.ndarray:
        """[B, S, H] prefix embeddings (tokens + spliced image patches; a
        tensor on any device or an array) → [B, max_new_tokens] generated
        ids. The decode is the text path's own loop: only the prefill
        differs."""
        sampling = sampling or SamplingConfig()
        e = torch.as_tensor(embeds if torch.is_tensor(embeds)
                            else np.array(embeds), device=self.device)
        carry = self._start(None, lengths, sampling, rng_seed, rng_seeds,
                            embeds=e)
        return _collect(self._stream_carry(carry, sampling, DECODE_CHUNK),
                        e.shape[0], sampling)


def _collect(blocks, b: int, sampling: SamplingConfig) -> np.ndarray:
    """A stream's [B, ≤chunk] blocks → [B, max_new_tokens], pad after the
    last block."""
    out = np.full((b, sampling.max_new_tokens), sampling.pad_id, np.int32)
    at = 0
    for block in blocks:
        out[:, at:at + block.shape[1]] = block
        at += block.shape[1]
    return out
