"""In-process LLM provider: generation served on the card.

Port of `rag_dpo_tpu/providers/tpu_llm.py` (the class keeps its name, so
configs, the server and the bootstrap see the same provider): a
`BaseLLMProvider` whose backend is the port's decoder (`models.decoder` +
`models.generate`) on `device` (default: the first CUDA card) instead of an
HTTP sidecar. With converted Mistral/Llama weights and a real tokenizer it
serves the role of the reference's Ollama process; with random weights it
still runs the whole generation machinery (tests, load measurements).

Schedulers: "direct" (one decode per call; greedy calls through the
prompt-lookup speculative decoder when `speculative`), "batch"
(`batch_concurrent=True`: concurrent same-(bucket, sampling) calls arriving
within the window run as ONE batched decode, padded to a power-of-two
batch) and "continuous" (`continuous=True`: a decode-slot pool,
`serving/continuous.py`, with step-level admission, so a short answer never
waits for a long neighbour; it carries the speculation, `logit_bias`,
logprobs, penalties, priorities and deadlines). `attach_vision` adds a
CLIP tower and the LLaVA projector over this provider's own decoder
(`models/llava.py`): `generate_with_image` and `generate_with_image_stream`
answer image + prompt requests through the pool on the continuous
scheduler, or by the direct decode.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..models.decoder import DecoderConfig
from ..models.generate import SamplingConfig, TextGenerator
from ..serving.continuous import DeadlineExceeded
from ..tokenize import HashedTokenizer, Tokenizer
from ..tokenize.base import bucket_length
from .base import BaseLLMProvider, LLMResponse


class TPULLMProvider(BaseLLMProvider):
    def __init__(
        self,
        config: DecoderConfig | None = None,
        params=None,
        tokenizer: Tokenizer | None = None,
        max_new_tokens: int = 256,
        model_name: str = "tpu-decoder",
        batch_concurrent: bool = False,
        continuous: bool = False,
        max_batch: int = 8,
        max_wait_ms: float = 6.0,
        speculative: bool = False,
        draft_len: int = 7,
        ngram: int = 2,
        prefix_cache: int = 0,
        prefix_block: int = 64,
        prefix_cache_host: bool = False,
        prefill_chunk: int = 0,
        decode_chunk: int = 4,
        top_p: float = 1.0,
        request_timeout_s: float | None = None,
        priority: int = 0,
        age_steps: int = 0,
        preemption: bool = False,
        choose_batch: int = 0,
        device=None,
    ):
        self.config = config or DecoderConfig.tiny()
        self.generator = TextGenerator(self.config, params=params,
                                       device=device)
        self.tokenizer = tokenizer or HashedTokenizer(
            vocab_size=self.config.vocab_size)
        self.max_new_tokens = max_new_tokens
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        self.top_p = float(top_p)
        # default wall-clock budget (queue wait + decode) per request on
        # the continuous scheduler; None = unbounded; per-call `timeout_s`
        # overrides. Expiry cancels the request and answers in band.
        if request_timeout_s is not None and not request_timeout_s > 0:
            raise ValueError("request_timeout_s must be positive, "
                             f"got {request_timeout_s}")
        self.request_timeout_s = request_timeout_s
        # default scheduling class of this provider's requests on the
        # continuous scheduler (lower admits first); per-call `priority`
        # overrides
        self.priority = int(priority)
        self.model_name = model_name
        # per-REQUEST sampling seed: a counter (or the caller's OpenAI-style
        # `seed`) threaded into each decode, so identical prompts sampled
        # at temperature > 0 are independent across calls and rows
        self._seed_counter = 0
        self._seed_lock = threading.Lock()
        if choose_batch > 0:
            self.generator.enable_choose_batching(
                max_batch=int(choose_batch))
        self._batcher = None
        if batch_concurrent:
            from ..serving.batcher import MicroBatcher

            self._batcher = MicroBatcher(
                self._generate_batched, max_batch=max_batch,
                max_wait_ms=max_wait_ms)
        # continuous batching: a fixed decode-slot pool with step-level
        # admission (serving/continuous.py); the server and the Streamlit
        # pages read `_driver` to find it
        self._driver = None
        # speculation reserves a verify window in the prompt budget
        # whichever engine carries it (_fit_budget)
        self._spec_reserve = draft_len if speculative else 0
        if continuous:
            from ..serving.continuous import (
                ContinuousDriver,
                ContinuousEngine,
            )

            engine = ContinuousEngine(
                self.generator, slots=max_batch,
                sampling=SamplingConfig(
                    top_p=self.top_p,
                    temperature=0.0, eos_id=self.tokenizer.sep_id,
                    pad_id=self.tokenizer.pad_id),
                # decode_chunk tokens a dispatch between two host reads
                chunk=decode_chunk, speculative=speculative,
                draft_len=draft_len, ngram=ngram,
                prefix_cache=prefix_cache, prefix_block=prefix_block,
                prefix_cache_host=prefix_cache_host,
                prefill_chunk=prefill_chunk,
                age_steps=age_steps, preemption=preemption)
            self._driver = ContinuousDriver(engine)
        # speculative decoding: prompt-lookup drafts verified in one cached
        # forward — lossless under greedy, so it carries the direct
        # temperature-0 path; with continuous=True the pool carries the
        # speculation instead; sampled and micro-batched calls stay plain
        self._spec = None
        self.spec_stats = {"calls": 0, "steps": 0, "tokens": 0}
        if speculative and not continuous:
            from ..models.speculative import SpeculativeGenerator

            self._spec = SpeculativeGenerator(
                self.generator, draft_len=draft_len, ngram=ngram)

    # ------------------------------------------------- batched decode path
    def _generate_batched(self, stacked, key):
        """MicroBatcher fn: rows = [q, S+2] (ids ‖ length ‖ seed).
        Generation is row-independent (per-row attention, greedy/per-row
        sampling, position-keyed per-row seeds), so padding the batch to a
        power of two with copies of row 0 changes nothing for real rows."""
        _, max_new, temp = key
        ids = np.ascontiguousarray(stacked[:, :-2], dtype=np.int32)
        lengths = np.ascontiguousarray(stacked[:, -2], dtype=np.int32)
        seeds = stacked[:, -1].astype(np.uint32)
        q = ids.shape[0]
        b = 1
        while b < q:
            b *= 2
        if b > q:
            pad = np.repeat(ids[:1], b - q, axis=0)
            ids = np.concatenate([ids, pad], axis=0)
            lengths = np.concatenate(
                [lengths, np.repeat(lengths[:1], b - q)], axis=0)
            seeds = np.concatenate(
                [seeds, np.repeat(seeds[:1], b - q)], axis=0)
        sampling = SamplingConfig(
            top_p=self.top_p,
            temperature=temp, max_new_tokens=max_new,
            eos_id=self.tokenizer.sep_id, pad_id=self.tokenizer.pad_id,
        )
        tokens = self.generator.generate_ids(
            ids, lengths, sampling, rng_seeds=seeds)
        return (tokens[:q],)

    def _next_seed(self, temperature: float) -> int:
        """Fresh seed per sampled decode; stable 0 when greedy."""
        if temperature <= 0:
            return 0
        with self._seed_lock:
            self._seed_counter += 1
            return self._seed_counter

    def _row_seed(self, temperature: float, seed: int | None) -> int:
        """THIS request's sampling seed: the caller's (OpenAI `seed`
        semantics) or a fresh counter value — draws are position-keyed
        off it, so the value alone pins the stream."""
        if seed is not None:
            return int(seed) & 0xFFFFFFFF
        return self._next_seed(temperature)

    def load_converted(self, state_dict):
        self.generator.load_converted(state_dict)

    def _format_logprobs(self, toks, raw) -> list:
        """Engine logprobs [(lp, [(id, lp)...])] → OpenAI-shaped dicts with
        each token decoded alone (subword pieces, the logprobs
        convention)."""
        out = []
        for t, (lp, top) in zip(toks, raw):
            out.append({
                "id": int(t),
                "token": self._decode_text(np.asarray([t], np.int32)),
                "logprob": float(lp),
                "top_logprobs": [
                    {"id": int(a),
                     "token": self._decode_text(
                         np.asarray([a], np.int32)),
                     "logprob": float(b)} for a, b in top]})
        return out

    def _decode_text(self, token_ids) -> str:
        tok = self.tokenizer
        if hasattr(tok, "_tok"):  # HF fast tokenizer adapter
            return tok._tok.decode(
                [int(t) for t in token_ids
                 if int(t) not in (tok.pad_id, tok.sep_id)],
                skip_special_tokens=True,
            )
        # hashed tokenizer has no inverse — emit id stream (tests only)
        return " ".join(
            str(int(t)) for t in token_ids
            if int(t) not in (tok.pad_id, tok.sep_id)
        )

    def _fit_budget(self, max_tokens, spec: bool = False):
        """Clamp (prompt budget, max_new) into the decoder context: a
        request sized for a 16k-context model degrades to shorter output
        against a smaller one, never to a negative prompt budget."""
        max_new = max_tokens or self.max_new_tokens
        reserve = 1 + (self._spec_reserve if spec else 0)
        cap = self.config.max_seq_len - reserve
        min_prompt = min(8, max(1, cap - 1))
        max_new = max(1, min(max_new, cap - min_prompt))
        return cap - max_new, max_new

    def warm_decoder(self,
                     prompt_buckets: tuple[int, ...] | None = None
                     ) -> None:
        """Run the slot pool once per prompt bucket before traffic
        (continuous scheduler only — a no-op otherwise), on the driver
        thread: the engine is single-threaded and the driver may be
        stepping live requests."""
        if self._driver is not None:
            self.generator.load()
            self._driver.warm(prompt_buckets)

    def _sampling(self, temperature, max_new) -> SamplingConfig:
        return SamplingConfig(
            top_p=self.top_p, temperature=temperature,
            max_new_tokens=max_new, eos_id=self.tokenizer.sep_id,
            pad_id=self.tokenizer.pad_id)

    def generate(self, prompt, system=None, temperature=0.0,
                 json_mode=False, max_tokens=None,
                 timeout_s: float | None = None,
                 priority: int | None = None,
                 frequency_penalty: float = 0.0,
                 presence_penalty: float = 0.0,
                 logit_bias: dict | None = None,
                 logprobs: int | None = None,
                 seed: int | None = None) -> LLMResponse:
        """`timeout_s` (or the provider-wide `request_timeout_s`) bounds
        queue wait + decode on the continuous scheduler; expiry cancels the
        request and returns the partial text with `error` set, in band.
        `priority` and the penalties ride the pool too; off the pool they
        are ignored and `logit_bias` / `logprobs` are an in-band input
        error, as in the JAX provider. `seed` pins the sampling stream
        (OpenAI semantics): the same (prompt, params, seed) reproduces the
        same sampled generation on every scheduler. None samples a fresh
        stream per call."""
        t0 = time.time()
        try:
            if (logit_bias or logprobs is not None) \
                    and self._driver is None:
                raise ValueError("logit_bias/logprobs require the "
                                 "continuous scheduler")
            text = f"{system}\n\n{prompt}" if system else prompt
            # the verify window applies to anything the speculative paths
            # carry: every pool call, greedy direct ones
            budget, max_new = self._fit_budget(
                max_tokens,
                spec=self._driver is not None or temperature <= 0)
            enc = self.tokenizer.encode_batch(
                [text], min(bucket_length(len(text) // 3 + 2), budget))
            if self._driver is not None:
                row = np.asarray(enc.input_ids[0], np.int32)
                kw = dict(
                    temperature=temperature,
                    deadline_s=(timeout_s if timeout_s is not None
                                else self.request_timeout_s),
                    priority=(self.priority if priority is None
                              else int(priority)),
                    frequency_penalty=frequency_penalty,
                    presence_penalty=presence_penalty,
                    logit_bias=logit_bias, seed=seed)
                try:
                    lps = None
                    if logprobs is not None:
                        toks, raw_lps = self._driver.generate_with_logprobs(
                            row, int(enc.lengths[0]), max_new,
                            logprobs=int(logprobs), **kw)
                        lps = self._format_logprobs(toks, raw_lps)
                    else:
                        toks = self._driver.generate(
                            row, int(enc.lengths[0]), max_new, **kw)
                except DeadlineExceeded as e:
                    # the partial answer with an in-band error
                    return LLMResponse(self._decode_text(e.tokens),
                                       self.model_name,
                                       time.time() - t0, error=str(e))
                return LLMResponse(self._decode_text(toks),
                                   self.model_name, time.time() - t0,
                                   logprobs=lps)
            if self._spec is not None and temperature <= 0:
                tokens, st = self._spec.generate_ids(
                    np.asarray(enc.input_ids, np.int32),
                    np.asarray(enc.lengths, np.int32),
                    self._sampling(0.0, max_new))
                self.spec_stats["calls"] += 1
                self.spec_stats["steps"] += st.steps
                self.spec_stats["tokens"] += st.tokens
                return LLMResponse(self._decode_text(tokens[0]),
                                   self.model_name, time.time() - t0)
            row_seed = self._row_seed(temperature, seed)
            if self._batcher is not None:
                # the per-request seed rides the row DATA (last column),
                # not the batching key
                rows = np.concatenate(
                    [np.asarray(enc.input_ids, np.int32),
                     np.asarray(enc.lengths, np.int32)[:, None],
                     np.full((len(enc.lengths), 1), row_seed,
                             np.uint32).astype(np.int32)], axis=1)
                (tokens,) = self._batcher(
                    rows,
                    key=(rows.shape[1] - 2, max_new, float(temperature)),
                )
            else:
                tokens = self.generator.generate_ids(
                    enc.input_ids, enc.lengths,
                    self._sampling(temperature, max_new),
                    rng_seeds=np.full((len(enc.lengths),), row_seed,
                                      np.uint32))
            return LLMResponse(self._decode_text(tokens[0]),
                               self.model_name, time.time() - t0)
        except Exception as e:
            return LLMResponse("", self.model_name, time.time() - t0,
                               error=str(e),
                               error_kind=("input"
                                           if isinstance(e, ValueError)
                                           else None))

    def generate_stream(self, prompt, system=None, temperature=0.0,
                        max_tokens=None, chunk: int = 8,
                        timeout_s: float | None = None,
                        priority: int | None = None,
                        frequency_penalty: float = 0.0,
                        presence_penalty: float = 0.0,
                        logit_bias: dict | None = None,
                        seed: int | None = None):
        """Yield text deltas as the decoder produces them. Incremental
        detokenization re-decodes the full emitted prefix each block and
        yields the string delta. Greedy streams concatenate to exactly the
        non-streaming output. On the continuous scheduler the stream joins
        the slot pool and yields per decoded token; closing it cancels the
        request, and an expired `timeout_s` raises `DeadlineExceeded` after
        the partial deltas. Input errors raise EAGERLY, before the returned
        iterator yields."""
        if logit_bias and self._driver is None:
            raise ValueError("logit_bias requires the continuous "
                             "scheduler")
        text = f"{system}\n\n{prompt}" if system else prompt
        # the pool carries the speculation (if any): reserve its window
        budget, max_new = self._fit_budget(
            max_tokens, spec=self._driver is not None)
        enc = self.tokenizer.encode_batch(
            [text], min(bucket_length(len(text) // 3 + 2), budget))
        if self._driver is not None:
            stream = self._driver.generate_stream(
                np.asarray(enc.input_ids[0], np.int32),
                int(enc.lengths[0]), max_new,
                temperature=temperature,
                deadline_s=(timeout_s if timeout_s is not None
                            else self.request_timeout_s),
                priority=(self.priority if priority is None
                          else int(priority)),
                frequency_penalty=frequency_penalty,
                presence_penalty=presence_penalty,
                logit_bias=logit_bias, seed=seed)

            return self._pool_deltas(stream)
        sampling = self._sampling(temperature, max_new)

        def _direct_deltas():
            emitted: list[int] = []
            prev = ""
            for block in self.generator.generate_stream(
                    np.asarray(enc.input_ids), np.asarray(enc.lengths),
                    sampling,
                    rng_seeds=np.full((len(enc.lengths),),
                                      self._row_seed(temperature, seed),
                                      np.uint32),
                    chunk=chunk):
                emitted.extend(int(t) for t in block[0])
                full = self._decode_text(emitted)
                delta, prev = full[len(prev):], full
                if delta:
                    yield delta

        return _direct_deltas()

    def choose(self, prompt, choices, system=None,
               normalize: bool = True):
        """Constrained decoding: rank candidate continuations by
        teacher-forced log-likelihood in ONE prefill + one small extend —
        the answer is ALWAYS one of `choices`. Returns (best_choice,
        scores), scores[i] the candidate's log-prob (mean per token when
        `normalize`). Candidates are tokenized JOINTLY with the prompt;
        the shared prefix prefills once whatever k is."""
        choices = list(choices)
        if not choices:
            raise ValueError("choose() needs at least one choice")
        prow, p, cand_ids, cand_lens = self._encode_choices(
            prompt, choices, system)
        scores = self.generator.score_choices(prow[:p], p, cand_ids,
                                              cand_lens)
        if normalize:
            scores = scores / np.maximum(cand_lens, 1)
        best = int(np.argmax(scores))
        return choices[best], [float(x) for x in scores]

    def _encode_choices(self, prompt, choices, system=None):
        """Joint prompt+candidate tokenization for choose(): returns
        (prompt_row, shared_prefix_len, cand_ids [k, c], cand_lens)."""
        text = f"{system}\n\n{prompt}" if system else prompt
        est = len(text) // 3 + max(len(ch) for ch in choices) + 16
        max_len = min(bucket_length(est), self.config.max_seq_len)
        enc = self.tokenizer.encode_batch(
            [text] + [f"{text} {ch}" for ch in choices], max_len)
        ids, lens = enc.input_ids, enc.lengths
        prow, plen = ids[0], int(lens[0])
        # shared prefix: the longest run every full row agrees on with
        # the bare prompt row, capped so every candidate keeps ≥1 token
        p = plen
        for i in range(1, len(choices) + 1):
            li = int(lens[i])
            n = min(p, li - 1)
            eq = np.nonzero(prow[:n] != ids[i][:n])[0]
            p = int(eq[0]) if len(eq) else n
        k = len(choices)
        c = max(int(lens[i + 1]) - p for i in range(k))
        cand_ids = np.full((k, c), self.tokenizer.pad_id, np.int32)
        cand_lens = np.zeros((k,), np.int32)
        for i in range(k):
            li = int(lens[i + 1])
            cand_ids[i, :li - p] = ids[i + 1][p:li]
            cand_lens[i] = li - p
        return prow, p, cand_ids, cand_lens

    def warm_choose(self, prompt, choices, system=None) -> None:
        """Run the choose path once at this prompt/choices SHAPE for every
        batch size the choose batcher can coalesce, before traffic."""
        prow, p, cand_ids, cand_lens = self._encode_choices(
            prompt, list(choices), system)
        self.generator.warm_choose(cand_ids.shape[0], p,
                                   cand_ids.shape[1])

    def attach_vision(self, vision_config=None, params=None):
        """Enable image+text generation on the card (LLaVA-class): a ViT
        tower + MLP projector sharing THIS provider's decoder weights and
        decode path (models/llava.py). The reference routes the same
        traffic (image classification, the infographic-PDF description
        fallback) to an external Ollama LLaVA endpoint
        (`classify_images.py:45-70`).

        `vision_config`: the tower (default CLIP-ViT-L/14-336). `params`:
        output of `convert_llava_state_dict` (installs vision + projector
        here and the decoder tree in the shared generator) or None (JAX's
        random init, from key 0, for tests and measurements)."""
        from ..models.llava import LlavaConfig, LlavaGenerator
        from ..models.vit import ViTConfig

        cfg = LlavaConfig(
            vision=vision_config or ViTConfig.clip_vit_l_336(),
            text=self.config)
        self._llava = LlavaGenerator(cfg, generator=self.generator)
        if params is not None:
            self._llava.load_converted(params)
        return self._llava

    def _prepare_image_request(self, prompt, image_bytes,
                               max_tokens=None):
        """Shared prep for the image paths: decode the image, encode the
        pre/post prompt spans around the patch window, fit the decode
        budget. → (pre_ids, post_ids, PIL image, max_new). Raises on bad
        input (callers map it to in-band errors / 400s)."""
        import io

        from PIL import Image

        try:
            image = Image.open(io.BytesIO(image_bytes))
            image.load()
        except Exception as e:
            # a decode failure is the caller's error: ValueError, so the
            # in-band error carries error_kind="input" (400, not 502)
            raise ValueError(f"bad image data: {e}") from e
        pre_text = "USER: "
        post_text = "\n" + prompt + "\nASSISTANT:"
        n_img = self._llava.config.num_image_tokens
        # as the text paths do: a speculative pool budgets room =
        # max_seq_len - max_new - draft_len, so the draft reserve comes out
        # of max_new here
        budget, max_new = self._fit_budget(
            max_tokens, spec=self._driver is not None)
        post_cap = max(budget - n_img - 8, 16)
        enc = self.tokenizer.encode_batch(
            [pre_text, post_text],
            min(bucket_length(len(post_text) // 3 + 2), post_cap))
        pre_ids = np.asarray(enc.input_ids[0][: enc.lengths[0]], np.int32)
        post_ids = np.asarray(enc.input_ids[1][: enc.lengths[1]], np.int32)
        # the two spans were encoded apart: keep pre's leading BOS/CLS,
        # drop its trailing SEP, drop post's leading CLS and trailing SEP,
        # so no special token lands MID-sequence around the image
        tok = self.tokenizer
        if len(pre_ids) and pre_ids[-1] == tok.sep_id:
            pre_ids = pre_ids[:-1]
        if len(post_ids) and post_ids[0] == tok.cls_id:
            post_ids = post_ids[1:]
        if len(post_ids) and post_ids[-1] == tok.sep_id:
            post_ids = post_ids[:-1]
        total = len(pre_ids) + n_img + len(post_ids)
        s = bucket_length(total)
        pool_reserve = self._spec_reserve if self._driver is not None \
            else 0
        max_new = min(max_new, self.config.max_seq_len - s - pool_reserve)
        if max_new < 1:
            raise ValueError(
                f"image prefix ({total} tokens, bucket {s}) leaves "
                "no decode budget in this context")
        return pre_ids, post_ids, image, max_new

    def generate_with_image(self, prompt, image_bytes,
                            temperature: float = 0.0,
                            max_tokens: int | None = None,
                            frequency_penalty: float = 0.0,
                            presence_penalty: float = 0.0,
                            logit_bias: dict | None = None,
                            seed: int | None = None) -> LLMResponse:
        """Image + prompt → text on the card once `attach_vision` ran
        (in-band 'vision not supported' before, as the base provider
        answers). On the continuous scheduler the request joins the SLOT
        POOL (its composed prefix prefills through the embeds path and
        decodes beside text traffic at this provider's priority); without
        a pool it runs the direct decode. Penalties and `logit_bias` ride
        the pool; the direct decode does not carry them, so off the pool
        they are an in-band input error rather than a silent drop."""
        t0 = time.time()
        if getattr(self, "_llava", None) is None:
            return LLMResponse(text="", model=self.model_name,
                               error="vision not supported",
                               error_kind="input")
        try:
            if (frequency_penalty or presence_penalty or logit_bias) \
                    and self._driver is None:
                raise ValueError("penalties/logit_bias with image input "
                                 "require the continuous scheduler")
            pre_ids, post_ids, image, max_new = \
                self._prepare_image_request(prompt, image_bytes, max_tokens)
            if self._driver is not None:
                embeds, n = self._llava.compose(pre_ids, post_ids, image)
                try:
                    toks = self._driver.generate_embeds(
                        embeds[0], n, max_new, temperature=temperature,
                        deadline_s=self.request_timeout_s,
                        priority=self.priority,
                        frequency_penalty=frequency_penalty,
                        presence_penalty=presence_penalty,
                        logit_bias=logit_bias, seed=seed)
                except DeadlineExceeded as e:
                    return LLMResponse(self._decode_text(e.tokens),
                                       self.model_name, time.time() - t0,
                                       error=str(e))
                return LLMResponse(self._decode_text(toks),
                                   self.model_name, time.time() - t0)
            tokens = self._llava.generate(
                pre_ids, post_ids, image,
                self._sampling(temperature, max_new),
                rng_seed=self._row_seed(temperature, seed))
            return LLMResponse(self._decode_text(tokens[0]),
                               self.model_name, time.time() - t0)
        except Exception as e:  # in band, like generate
            return LLMResponse("", self.model_name, time.time() - t0,
                               error=str(e),
                               error_kind=("input"
                                           if isinstance(e, ValueError)
                                           else None))

    def generate_with_image_stream(self, prompt, image_bytes,
                                   temperature: float = 0.0,
                                   max_tokens: int | None = None,
                                   timeout_s: float | None = None,
                                   priority: int | None = None,
                                   frequency_penalty: float = 0.0,
                                   presence_penalty: float = 0.0,
                                   logit_bias: dict | None = None,
                                   seed: int | None = None):
        """`generate_stream` for an image+text request. Input errors (no
        vision tower, bad image, no decode budget, penalties off the pool)
        raise EAGERLY, before the returned iterator yields, so an HTTP
        caller can still answer 400. On the continuous scheduler the
        deltas are per decoded token, beside pool traffic (closing the
        iterator cancels the request); on the direct scheduler the decode
        is one-shot and yields a single delta. Greedy streams concatenate
        to `generate_with_image(...)`'s text."""
        if getattr(self, "_llava", None) is None:
            raise ValueError("vision not supported")
        if (frequency_penalty or presence_penalty or logit_bias) \
                and self._driver is None:
            raise ValueError("penalties/logit_bias with image input "
                             "require the continuous scheduler")
        pre_ids, post_ids, image, max_new = \
            self._prepare_image_request(prompt, image_bytes, max_tokens)
        if self._driver is None:
            tokens = self._llava.generate(
                pre_ids, post_ids, image,
                self._sampling(temperature, max_new),
                rng_seed=self._row_seed(temperature, seed))
            text = self._decode_text(tokens[0])
            return iter([text] if text else [])
        embeds, n = self._llava.compose(pre_ids, post_ids, image)
        stream = self._driver.generate_embeds_stream(
            embeds[0], n, max_new, temperature=temperature,
            deadline_s=(timeout_s if timeout_s is not None
                        else self.request_timeout_s),
            priority=(self.priority if priority is None
                      else int(priority)),
            frequency_penalty=frequency_penalty,
            presence_penalty=presence_penalty, logit_bias=logit_bias,
            seed=seed)

        return self._pool_deltas(stream)

    def _pool_deltas(self, stream):
        """Text deltas of a pool's token stream: the emitted prefix decoded
        again at each token, its new tail yielded."""
        emitted: list[int] = []
        prev = ""
        try:
            for t in stream:
                emitted.append(int(t))
                full = self._decode_text(emitted)
                delta, prev = full[len(prev):], full
                if delta:
                    yield delta
        finally:
            # an abandoned consumer cancels the request at once
            stream.close()

    def chat_stream(self, messages, temperature=0.0, max_tokens=None,
                    priority: int | None = None, **gen_kwargs):
        """Native token-streamed chat: flatten messages the same way the
        base `chat()` does, then ride the decoder's chunked stream. NOT a
        generator function: input errors raise at CALL time."""
        system, parts = None, []
        for m in messages:
            if m["role"] == "system":
                system = m["content"]
            else:
                parts.append(f"{m['role']}: {m['content']}")
        return self.generate_stream(
            "\n\n".join(parts), system=system, temperature=temperature,
            max_tokens=max_tokens, priority=priority, **gen_kwargs)

    def is_available(self) -> bool:
        return True
