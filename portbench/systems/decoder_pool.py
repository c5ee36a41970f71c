"""The in-process generator on its slot pool: `TPULLMProvider` with the
continuous scheduler (`llm.mode: tpu, scheduler: continuous`).

Set-up makes the weights on the card from the seed (int8 projections and
f32 channel scales, the f32 embedding table that is also the head) and
hands them to the provider's load path; the provider's decoder copies
them and the benchmark keeps none. A request is one
`generate_stream(prompt, system=...)`: its text deltas are the served
tokens (the hashed tokenizer's text is the ids, space-separated), each
timed as it reaches the client.

`correct`: after the window, the finished requests (at most
`check.requests` of them, drawn from the seed, the longest always among
them) are run through the plain reference (`reference/decoder.py`, the
weights made again from the seed, layer by layer): the
widest gap by which a served token's logit lies below the reference's
best at its position (`served_gap`), prefill's first token and every
decoded one, and where a request stopped before its budget, the stop
token's.
"""

from __future__ import annotations

import gc

import torch

from .. import weights
from ..counts import decoder as counts
from ..loop import clock, note
from ..reference import decoder as ref
from ..reference import tokenizer as tok
from ..traffic import full_text, rng

STOP_IDS = (tok.PAD, tok.SEP)   # the pool ends a request on either


def decoder_config(m: dict):
    """The port's DecoderConfig of a config file (keys as `config.json`)."""
    from rag_dpo_tpu_torch.models.decoder import DecoderConfig

    s = m["serving"]
    return DecoderConfig(
        vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
        num_layers=m["num_hidden_layers"],
        num_heads=m["num_attention_heads"],
        num_kv_heads=m["num_key_value_heads"], head_dim=m["head_dim"],
        intermediate_size=m["intermediate_size"],
        rope_theta=float(m["rope_theta"]), rms_norm_eps=m["rms_norm_eps"],
        max_seq_len=m["max_position_embeddings"],
        tie_embeddings=m["tie_word_embeddings"],
        quantize_weights=s["quantize_int8"], quantize_kv=s["quantize_kv"])


class System:
    def __init__(self, config: dict, traffic, seed: int, device,
                 trace: bool = False):
        from rag_dpo_tpu_torch.providers.tpu_llm import TPULLMProvider

        self.m = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        s = config["serving"]
        if s["scheduler"] != "continuous":
            raise ValueError("decoder_pool serves the continuous scheduler")
        t = clock()
        self.llm = TPULLMProvider(
            decoder_config(config),
            params=weights.decoder_tree(config, self.seed, self.device),
            continuous=True, max_batch=s["max_batch"],
            decode_chunk=s["decode_chunk"], prefix_cache=s["prefix_cache"],
            prefill_chunk=s["prefill_chunk"], speculative=s["speculative"],
            device=self.device)
        self.engine = self.llm._driver.engine
        t = note("weights, load and the slot pool", t)
        self.warm()
        note("warm-up", t)

    def warm(self) -> None:
        """One request at every prompt width from the narrowest to the
        widest that the traffic's first block of requests is padded to, on
        the pool (prefill and decode)."""
        widths = []
        for i in range(self.traffic.strata):
            r = self.traffic.request(i)
            widths.append(min(tok.bucket(len(full_text(r)) // 3 + 2),
                              self.m["max_position_embeddings"] - 1
                              - r["max_tokens"]))
        buckets = [b for b in tok.BUCKETS if min(widths) <= b <= max(widths)]
        self.llm.warm_decoder(prompt_buckets=tuple(buckets or widths))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------------------------------------------------- requests
    def request(self, spec: dict, rec) -> None:
        stream = self.llm.generate_stream(
            spec["prompt"], system=spec["system"],
            temperature=spec["temperature"], max_tokens=spec["max_tokens"])
        parts = []
        try:
            for delta in stream:
                now = clock()
                rec.arrivals.append((now, len(delta.split())))
                parts.append(delta)
                if now > rec.cut_after:
                    break
            else:
                rec.done = True
        finally:
            stream.close()
        rec.output = "".join(parts)

    def counters(self) -> dict:
        return dict(self.engine.stats)

    def observe(self, records, t0, t1, before, after) -> dict:
        """Engine counters over the window and the work the window's
        tokens needed: the prefills whose first token arrived in it, every
        later token at its position."""
        m = self.m
        flops = 0
        for r in records:
            n = r.spec["prompt_tokens"]
            k = 0
            for t, got in r.arrivals:
                for _ in range(got):
                    if t0 <= t <= t1:
                        flops += (counts.prefill_flops(m, n) if k == 0 else
                                  counts.decode_flops(m, n + k - 1))
                    k += 1
        return {"engine": {k: after[k] - before[k] for k in after},
                "model_flops": flops}

    def release(self) -> None:
        self.llm._driver.close()
        self.llm = self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def sample(self, records) -> list:
        """The finished requests to compare: the one with the most
        positions, then others drawn from the seed, `check.requests` in
        all."""
        done = [r for r in records if r.done and r.error is None]
        if not done:
            return []
        want = int(self.traffic.p["check"]["requests"])
        longest = max(done, key=lambda r: r.spec["prompt_tokens"]
                      + len(r.output.split()))
        rest = [r for r in done if r is not longest]
        pick = rng(self.seed, "check").permutation(len(rest))[:want - 1]
        return [longest] + [rest[int(i)] for i in sorted(pick)]

    def check(self, records) -> list:
        gaps = self.reference_gaps(self.sample(records))
        limit = float(self.m["limits"]["served_gap"])
        return [("served_gap", max(gaps) if gaps else float("inf"), limit)]

    def control(self, records, precision: str) -> dict:
        """The check's numbers with the reference at `precision` in the
        program's place, over the same sample."""
        gaps = self.reference_gaps(self.sample(records), precision)
        return {"served_gap": max(gaps) if gaps else float("inf"),
                "positions": len(gaps),
                "positions_off": sum(g > 0 for g in gaps)}

    def reference_gaps(self, sample, control: str | None = None) -> list:
        """Every compared position's gap, over the sample: the served
        token's, or with `control` ("fp8" or "int4") the token that the
        reference computed at that precision puts first."""
        m, dev = self.m, self.device
        t = clock()
        table = weights.decoder_table(m, self.seed, dev)
        final = weights.decoder_final_norm(m, self.seed, dev)

        def layer(i):
            return weights.decoder_layer(m, self.seed, i, dev)

        seqs, served_of = [], []
        for r in sample:
            prompt, served, ended = self.sequence(r)
            ids = prompt + (served if ended else served[:-1])
            seqs.append((ids, range(len(prompt) - 1, len(ids))))
            served_of.append((served, ended))
        if not seqs:
            return []
        logits = ref.forward_many(m, layer, table, final, seqs)
        low = (ref.forward_many(m, layer, table, final, seqs, control)
               if control is not None else None)
        gaps = []
        for j, (served, ended) in enumerate(served_of):
            if low is not None:
                gaps += ref.served_gaps(logits[j],
                                        low[j].argmax(-1).tolist())
                continue
            gaps += ref.served_gaps(logits[j][:len(served)], served)
            if ended:
                last = logits[j][-1]
                gaps.append(float(last.max() - last[list(STOP_IDS)].max()))
        note(f"reference over {len(sample)} requests, {len(gaps)} "
             f"positions", t)
        return gaps

    def sequence(self, r) -> tuple[list, list, bool]:
        """(the prompt's ids as the serving front encodes them, the served
        tokens, whether the request stopped before its budget)."""
        prompt = tok.generation_prompt(full_text(r.spec), self.m["vocab_size"],
                                       self.m["max_position_embeddings"],
                                       r.spec["max_tokens"])
        served = [int(x) for x in r.output.split()]
        return prompt, served, len(served) < r.spec["max_tokens"]
