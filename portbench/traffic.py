"""The one traffic generator: a mix's parameters (`traffic/<name>.json`)
and the seed give every request of a run.

Request i is a pure function of (seed, i), so a run may take as many as
its window holds. Sizes are stratified: each block of `strata` requests
takes the same `strata` quantiles of a size's distribution, in an order
drawn from the seed, so every seed offers the same set of sizes and only
their order and the texts change. Texts are French words of the copied
evaluation questions (`data/qa_dataset.json`).

Request kinds:
* "prompt": a RAG answer request to the generator: the answer system
  prompt (`system_prompt`), then a context of documents × chunks of
  filler words and one of the questions, sized so that the whole prompt is
  `prompt_tokens` tokens ([CLS] and [SEP] included) under the deployment's
  hashed tokenizer; `max_tokens` new tokens, at `temperature`;
* "question": one of the 48 questions, or a seeded rewording of it to
  `question_words` words, for the agent.
"""

from __future__ import annotations

import functools
import hashlib
import json
import math

import numpy as np

from . import spec
from .reference import tokenizer as tok

DATA = spec.HERE / "data"


def rng(seed: int, *labels) -> np.random.Generator:
    digest = hashlib.sha256("/".join(map(str, (seed, *labels))).encode())
    return np.random.default_rng(
        int.from_bytes(digest.digest()[:8], "little"))


@functools.lru_cache(maxsize=None)
def questions() -> tuple[str, ...]:
    data = json.loads((DATA / "qa_dataset.json").read_text(encoding="utf-8"))
    return tuple(d["question"] for d in data)


@functools.lru_cache(maxsize=None)
def vocabulary() -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(filler words, one-piece words): the alphabetic words of the
    dataset's questions and answer summaries. A prompt of them runs 3.5-3.7
    characters a token, so the serving front's width rule (a third of the
    characters) never cuts one."""
    data = json.loads((DATA / "qa_dataset.json").read_text(encoding="utf-8"))
    seen: dict[str, None] = {}
    for d in data:
        for key in ("question", "expected_answer_summary"):
            for w in tok.words(str(d.get(key, ""))):
                if w.isalpha():
                    seen.setdefault(w, None)
    fill = tuple(seen)
    return fill, tuple(w for w in fill if tok.word_pieces(w) == 1)


def full_text(spec: dict) -> str:
    """A prompt request's text as the generator's front joins it."""
    if spec["system"]:
        return f"{spec['system']}\n\n{spec['prompt']}"
    return spec["prompt"]


def stratified(seed: int, label: str, i: int, dist: dict,
               strata: int) -> float:
    """Request i's value of a size drawn from `dist` ({"low", "high",
    "scale": "log" | "linear"}): the quantile (k + 0.5) / strata, k the
    place of i in its block's seeded permutation."""
    block, j = divmod(i, strata)
    return float(stratified_block(seed, label, block, dist, strata)[j])


def stratified_block(seed: int, label: str, block: int, dist: dict,
                     strata: int) -> np.ndarray:
    """The values of a whole block of `strata` requests at once."""
    u = (rng(seed, label, block).permutation(strata) + 0.5) / strata
    lo, hi = float(dist["low"]), float(dist["high"])
    if dist.get("scale") == "log":
        return np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    return lo + u * (hi - lo)


class Traffic:
    def __init__(self, params: dict, seed: int):
        self.p = params
        self.seed = int(seed)
        self.strata = int(params.get("strata", 64))
        self._system = None
        if params.get("system_prompt"):
            self._system = (DATA / params["system_prompt"]).read_text(
                encoding="utf-8").strip()

    @property
    def loop(self) -> str:
        return self.p["loop"]

    def request(self, i: int) -> dict:
        kind = self.p["request"]
        if kind == "prompt":
            return self._prompt(i)
        if kind == "question":
            return self._question(i)
        raise ValueError(f"unknown request kind {kind!r}")

    # ------------------------------------------------------------ prompt
    def _prompt(self, i: int) -> dict:
        p = self.p
        n = int(round(stratified(self.seed, "prompt_tokens", i,
                                 p["prompt_tokens"], self.strata)))
        max_new = int(round(stratified(self.seed, "max_tokens", i,
                                       p["max_tokens"], self.strata)))
        r = rng(self.seed, "prompt", i)
        qs = questions()
        question = qs[int(r.integers(len(qs)))]
        text = self._context(r, n - 2 - tok.count(self._system or ""),
                             question)
        return {"index": i, "system": self._system, "prompt": text,
                "prompt_tokens": n, "max_tokens": max_new,
                "temperature": float(p.get("temperature", 0.0))}

    def _context(self, r, budget: int, question: str) -> str:
        """Text of exactly `budget` tokens: the chunks' headers, the
        question and filler words."""
        ctx = self.p.get("context", {})
        docs = int(ctx.get("documents", 5))
        per = int(ctx.get("chunks_per_document", 3))
        heads = [f"[Source {d * per + c + 1}] Document {d + 1}, partie {c + 1}"
                 for d in range(docs) for c in range(per)]
        tail = f"Question : {question}\n\nRéponse :"
        left = budget - sum(tok.count(h) for h in heads) \
            - tok.count("Contexte :") - tok.count(tail)
        if left < len(heads):
            raise ValueError(f"a prompt budget of {budget} tokens is too "
                             "short for its context")
        fill, ones = vocabulary()
        pieces = np.asarray([tok.word_pieces(w) for w in fill])
        parts = ["Contexte :"]
        for c, head in enumerate(heads):
            want = left // len(heads) + (c < left % len(heads))
            idx = r.integers(len(fill), size=want)
            cum = np.cumsum(pieces[idx])
            k = int(np.searchsorted(cum, want, side="right"))
            words = [fill[j] for j in idx[:k]]
            rest = want - (int(cum[k - 1]) if k else 0)
            words += [ones[j] for j in r.integers(len(ones), size=rest)]
            parts.append(f"{head}\n{' '.join(words)}")
        parts.append(tail)
        return "\n\n".join(parts)

    # ---------------------------------------------------------- question
    def _question(self, i: int) -> dict:
        qs = questions()
        block, j = divmod(i, len(qs))
        base = qs[rng(self.seed, "question", block).permutation(len(qs))[j]]
        want = int(round(stratified(self.seed, "question_words", i,
                                    self.p["question_words"], self.strata)))
        words = base.split()
        r = rng(self.seed, "reword", i)
        if len(words) < want:
            fill, _ = vocabulary()
            extra = [fill[int(k)] for k in
                     r.integers(len(fill), size=want - len(words))]
            words = ["Concernant", *extra, "—", *words]
        elif len(words) > want:
            words = words[len(words) - want:]
        return {"index": i, "question": " ".join(words), "base": base}

    # ------------------------------------------------------------- open
    def arrivals(self, seconds: float) -> list[float]:
        """Offsets (s) of an open loop's sends in a window: Poisson at
        `rate` a second, plus `burst` requests at once every
        `burst_every` seconds."""
        rate = float(self.p["rate"])
        r = rng(self.seed, "arrivals")
        out, t = [], 0.0
        while True:
            t += float(r.exponential(1.0 / rate))
            if t >= seconds:
                break
            out.append(t)
        every = float(self.p.get("burst_every", 0) or 0)
        if every > 0:
            k = every
            while k < seconds:
                out.extend([k] * int(self.p.get("burst", 0)))
                k += every
        return sorted(out)
