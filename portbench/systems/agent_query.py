"""The shipped default deployment's query path: the agent of
`build_stack(config).active()` over BGE-M3 and its cross-encoder, on an
index of the deployed corpus's size.

Set-up makes, from the seed: the corpus (chunk texts of French words,
their heading and document, `index.chunk_words` words each), each
document's summary sheet (the six fields of the deployment's sheet over
`index.summary_words` words drawn from the document's own chunks), the
dense rows (random unit vectors, stored bf16), both models' f32 weights.
The port builds its BM25 statistics and ELL rows from the texts (its
indexer's path: the C++ runtime where it builds) and its summary index
from the sheets (the file `build_stack` reads), loads the weights through
its providers' load paths, and the stack is the default configuration's
(the agent, the summary prefilter to 40 documents, 3 expansions, 40
candidates, rerank to 10 at 512 tokens, no batching), with the port's
in-process extractive stand-in for the Ollama generator the default
names, so that the window holds only the port's work. A request is one
`agent.query(question)`.

`correct`: the agent's reply carries its sources without their scores,
so the harness keeps, at the retriever's and the reranker's boundaries,
each call's query variants, its prefilter's query and filter, its
candidates and ranked chunks (references, no copies). After the window
every retrieval's prefilter is judged by the reference's summary BM25
(`prefilter_gap`); then a sample of the reranks, drawn from the seed, the
longest question among them, is judged by the plain references from the
variants on: the query encode and the dense arm (`dense_gap`), BM25
(`sparse_gap`), the fused pool of 40 over the prefilter's documents
(`pool_gap`), the cross-encoder's scores (`rerank_gap`) and order
(`order_gap`). The variants come from the stand-in generator's text and
are taken as given; so is the prefilter's document set, once judged, for
the arms after it (an equal score may keep either document).
"""

from __future__ import annotations

import gc
import json
import tempfile
import threading
import time

import numpy as np
import torch

from .. import weights
from ..loop import clock, note
from ..reference import bm25 as ref_bm25
from ..reference import tokenizer as tok
from ..reference import xlmr as ref_xlmr
from ..reference.precision import fp8_rows
from ..traffic import rng, stratified_block, vocabulary

# the retriever's weighted RRF (k 60; original ×2, expansions ×1, BM25
# original ×1.5, BM25 expansions ×0.75), as the deployment's recipe sets it
RRF_K = 60
RRF_WEIGHTS = (2.0, 1.0, 1.5, 0.75)


def corpus_words(c: dict, seed: int):
    """(the vocabulary, each chunk's word count, every word of the corpus
    as an index into the vocabulary, chunk after chunk)."""
    ix = c["index"]
    fill, _ = vocabulary()
    lengths = np.rint(stratified_block(seed, "chunk_words", 0,
                                       ix["chunk_words"],
                                       int(ix["chunks"]))).astype(int)
    words = rng(seed, "corpus").integers(len(fill), size=int(lengths.sum()))
    return fill, lengths, words


def corpus(c: dict, seed: int) -> list[dict]:
    """The index's chunks: `chunks` of them over `documents` documents,
    their word counts the same stratified set for every seed."""
    docs = int(c["index"]["documents"])
    fill, lengths, words = corpus_words(c, seed)
    # one string of every word, each chunk a slice of it
    text = " ".join(np.asarray(fill, dtype=object)[words].tolist()) + " "
    ends = np.cumsum(np.asarray([len(w) + 1 for w in fill])[words])
    stop = ends[np.cumsum(lengths) - 1]
    start = np.concatenate([[0], stop[:-1]])
    out = []
    for i, (a, b) in enumerate(zip(start.tolist(), stop.tolist())):
        doc = i % docs
        out.append({"chunk_id": f"c{i}", "text": text[a:b - 1],
                    "heading": f"Partie {i // docs + 1}",
                    "title": f"Document {doc + 1}",
                    "doc_key": f"cnil.fr/doc/{doc}",
                    "source_url": f"https://cnil.fr/fr/doc/{doc}",
                    "source": "CNIL", "nature": "GUIDE"})
    return out


def summaries(c: dict, seed: int) -> dict:
    """Each document's summary sheet, {doc_key: {title, summary, url}},
    as the file the deployment's summary step writes: the sheet's fields
    (NATURE, TYPE, SUJETS, USAGE DPO, CONTIENT, NE CONTIENT PAS) over
    `index.summary_words` words, each drawn from a chunk of the document
    (`corpus`'s chunk i belongs to document i mod `documents`), the same
    stratified set of lengths for every seed."""
    ix = c["index"]
    n, docs = int(ix["chunks"]), int(ix["documents"])
    fill, lengths, words = corpus_words(c, seed)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    sizes = np.rint(stratified_block(seed, "summary_words", 0,
                                     ix["summary_words"], docs)).astype(int)
    doc = np.repeat(np.arange(docs), sizes)
    r = rng(seed, "summaries")
    per_doc = (n - 1 - doc) // docs + 1          # chunks of each word's doc
    chunk = doc + docs * (r.random(doc.shape[0]) * per_doc).astype(int)
    pos = (r.random(doc.shape[0]) * lengths[chunk]).astype(int)
    drawn = np.asarray(fill, dtype=object)[words[offsets[chunk] + pos]]
    out = {}
    ends = np.cumsum(sizes)
    for d in range(docs):
        w = drawn[ends[d] - sizes[d]:ends[d]].tolist()
        a, b = 5, 5 + (len(w) - 5) * 3 // 10
        e = b + (len(w) - b) * 7 // 10
        out[f"cnil.fr/doc/{d}"] = {
            "title": f"Document {d + 1}",
            "summary": (f"NATURE: GUIDE\nTYPE: {w[0]}\n"
                        f"SUJETS: {', '.join(w[1:a])}\n"
                        f"USAGE DPO: {' '.join(w[a:b])}\n"
                        f"CONTIENT: {' '.join(w[b:e])}\n"
                        f"NE CONTIENT PAS: {' '.join(w[e:])}"),
            "url": f"https://cnil.fr/fr/doc/{d}"}
    return out


def summary_text(fiche: dict) -> str:
    """A sheet's text as the summary index reads it."""
    return " ".join(str(fiche.get(f, "") or "")
                    for f in ("title", "summary", "url"))


def dense_rows(c: dict, seed: int, device) -> torch.Tensor:
    """[chunks, dim] unit rows in bf16, as the index stores them."""
    x = weights.normal((int(c["index"]["chunks"]), int(c["index"]["dim"])),
                       seed, "index.dense", device)
    return (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)


class System:
    def __init__(self, config: dict, traffic, seed: int, device,
                 trace: bool = False):
        from rag_dpo_tpu_torch import native
        from rag_dpo_tpu_torch.bootstrap import build_stack
        from rag_dpo_tpu_torch.evals.synthetic import ExtractiveFakeLLM
        from rag_dpo_tpu_torch.index import DeviceIndex, IndexConfig
        from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
        from rag_dpo_tpu_torch.providers import Embedder, EmbedderConfig
        from rag_dpo_tpu_torch.rag.topics import TopicMatcher
        from rag_dpo_tpu_torch.retrieval.bm25 import (
            build_bm25_stats, build_ell_corpus_tf, impacts_from_tf)
        from rag_dpo_tpu_torch.retrieval.reranker import (
            CrossEncoderReranker, RerankerConfig)
        from rag_dpo_tpu_torch.tokenize.french import tokenize_french_text
        from rag_dpo_tpu_torch.utils.config import load_config
        from rag_dpo_tpu_torch.utils.paths import default_paths

        self.c = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        s = config["settings"]
        ix = config["index"]
        t = clock()
        self.chunks = corpus(config, self.seed)
        texts = [ch["text"] for ch in self.chunks]
        t = note("corpus", t)
        width = int(ix["ell_width"])
        # the indexer's path, and so its rule among terms of equal count
        self.ties = "corpus" if native.is_available() else "chunk"
        if self.ties == "corpus":
            stats, terms, impacts, tf, dl = native.build_ell_corpus_native(
                texts, ell_width=width, return_tf=True)
        else:
            toks = [tokenize_french_text(t) for t in texts]
            stats = build_bm25_stats(toks)
            terms, tf, dl = build_ell_corpus_tf(toks, stats, width)
            impacts = impacts_from_tf(tf, dl, stats)
        t = note(f"bm25 ({self.ties} ties)", t)
        index = DeviceIndex(IndexConfig(dim=int(ix["dim"]), ell_width=width),
                            device=self.device)
        index.bm25_stats = stats
        index.add([ch["chunk_id"] for ch in self.chunks],
                  dense_rows(config, self.seed, self.device).float().cpu()
                  .numpy(),
                  [{k: v for k, v in ch.items() if k != "chunk_id"}
                   for ch in self.chunks], terms, impacts, tf=tf, dl=dl)
        t = note("index", t)
        enc_cfg = EncoderConfig.bge_m3(
            vocab_size=config["vocab_size"],
            hidden_size=config["hidden_size"],
            num_layers=config["num_hidden_layers"],
            num_heads=config["num_attention_heads"],
            intermediate_size=config["intermediate_size"],
            max_position_embeddings=config["max_position_embeddings"],
            type_vocab_size=config["type_vocab_size"],
            layer_norm_eps=config["layer_norm_eps"],
            pad_token_id=config["pad_token_id"])
        embedder = Embedder(
            EmbedderConfig(model=BgeM3Config(
                encoder=enc_cfg, colbert_dim=config["colbert_dim"]),
                query_max_len=s["query_max_len"]),
            params=weights.xlmr_tree(config, "m3", self.seed, "embedder",
                                     self.device),
            device=self.device)
        embedder.load()
        t = note("embedder", t)
        reranker = CrossEncoderReranker(
            config=RerankerConfig(max_len=s["rerank_max_len"]),
            model_config=enc_cfg,
            params=weights.xlmr_tree(config, "rerank", self.seed,
                                     "reranker", self.device),
            topic_matcher=TopicMatcher(embedder), device=self.device)
        reranker.load()
        t = note("reranker", t)
        self.sheets = summaries(config, self.seed)
        self._tmp = tempfile.TemporaryDirectory(prefix="portbench_")
        paths = default_paths(self._tmp.name)
        paths.document_summaries.parent.mkdir(parents=True, exist_ok=True)
        paths.document_summaries.write_text(json.dumps(self.sheets))
        t = note("summary sheets", t)
        app = load_config(env={})
        if app.retrieval.prefilter_top_docs != s["prefilter_top_docs"]:
            raise ValueError("the configuration's prefilter is not the "
                             "deployment's default")
        stack = build_stack(app, paths,
                            llm=ExtractiveFakeLLM(), index=index,
                            embedder=embedder, reranker=reranker,
                            device=self.device)
        if stack.summary_index is None or stack.summary_index.ell_width \
                != int(ix["summary_ell_width"]):
            raise ValueError("the stack's summary index is not the one the "
                             "configuration states")
        self.agent = stack.active()
        self.index, self.embedder, self.reranker = index, embedder, reranker
        self._watch(trace)
        index.warm(batch_sizes=(1, 8))
        t = note("stack and index warm-up", t)
        self.warm()
        note("warm queries", t)

    # ------------------------------------------------------------ records
    def _watch(self, trace: bool) -> None:
        """Keep each retrieval's variants, prefilter (its query, the filter
        it was given and the one it gave) and candidates, each rerank's
        question, candidates and output; with `trace`, each attention
        call's shape and launch time (K1's work in the traced window)."""
        retriever = self.agent.graph.c.retriever
        reranker = self.reranker
        lock = threading.Lock()
        local = threading.local()
        self.retrievals: dict[int, tuple] = {}
        self.reranks: list[tuple] = []
        self.attention_calls: list[tuple] = []
        queries, candidates = retriever._queries, retriever.retrieve_candidates
        doc_filter = retriever._doc_filter
        rerank = reranker.rerank

        def watched_queries(question):
            local.variants = queries(question)
            return local.variants

        def watched_doc_filter(question, where):
            local.prefilter = (question, where, doc_filter(question, where))
            return local.prefilter[2]

        def watched_candidates(question, *a, **kw):
            local.prefilter = None
            out = candidates(question, *a, **kw)
            with lock:
                self.retrievals[id(out)] = (local.variants, local.prefilter,
                                            out)
            return out

        def watched_rerank(question, chunks, *a, **kw):
            out = rerank(question, chunks, *a, **kw)
            with lock:
                self.reranks.append((time.perf_counter(), question, chunks,
                                     out))
            return out

        retriever._queries = watched_queries
        retriever._doc_filter = watched_doc_filter
        retriever.retrieve_candidates = watched_candidates
        reranker.rerank = watched_rerank
        if trace:
            from rag_dpo_tpu_torch.models import encoder

            fused = encoder.flash_attention_fused

            def watched_attention(q, k, v, lengths=None, *a, **kw):
                with lock:
                    self.attention_calls.append(
                        (time.time_ns(), tuple(q.shape), q.element_size(),
                         lengths))
                return fused(q, k, v, lengths, *a, **kw)

            encoder.flash_attention_fused = watched_attention
            self._unwatch = lambda: setattr(encoder, "flash_attention_fused",
                                            fused)

    def warm(self) -> None:
        """The agent once for the shortest, a middle and the longest of
        the traffic's first block of questions (the encoders' sequence
        buckets), then the records cleared."""
        first = [self.traffic.request(i) for i in range(self.traffic.strata)]
        first.sort(key=lambda r: len(r["question"].split()))
        for r in (first[0], first[len(first) // 2], first[-1]):
            self.agent.query(r["question"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.retrievals.clear()
        self.reranks.clear()
        self.attention_calls.clear()

    def request(self, spec: dict, rec) -> None:
        resp = self.agent.query(spec["question"])
        rec.output = resp
        if resp.error:
            raise RuntimeError(f"agent error: {resp.error}")
        rec.done = True

    def counters(self) -> dict:
        return {}

    def observe(self, records, t0, t1, before, after) -> dict:
        done = [r for r in records if r.done and r.error is None
                and t0 <= r.end <= t1]
        out = {"retrieve_s": [r.output.retrieval_time for r in done]}
        calls = []
        for t_ns, shape, itemsize, lengths in self.attention_calls:
            b, h, s_, dh = shape
            lens = ([s_] * b if lengths is None
                    else [int(x) for x in lengths.tolist()])
            calls.append((t_ns, h, dh, lens, itemsize))
        out["attention_calls"] = calls
        out["hidden"] = self.c["hidden_size"]
        out["intermediate"] = self.c["intermediate_size"]
        return out

    def release(self) -> None:
        if hasattr(self, "_unwatch"):
            self._unwatch()
        self.agent = self.index = self.embedder = self.reranker = None
        self.attention_calls = []
        self._tmp.cleanup()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def sample(self, records) -> list:
        """Reranks of the window's finished queries: the longest question,
        then others drawn from the seed, `check.requests` in all."""
        ends = [r.end for r in records if r.done and r.error is None]
        if not ends:
            return []
        last = max(ends)
        pool = [x for x in self.reranks if x[0] <= last]
        if not pool:
            return []
        want = int(self.traffic.p["check"]["requests"])
        longest = max(pool, key=lambda x: len(x[1]))
        rest = [x for x in pool if x is not longest]
        pick = rng(self.seed, "check").permutation(len(rest))[:want - 1]
        return [longest] + [rest[int(i)] for i in sorted(pick)]

    def check(self, records) -> list:
        got = self.judge(self.sample(records))
        lim = self.c["limits"]
        return [(k, got[k], float(lim[k])) for k in lim]

    def control(self, records, precision: str) -> dict:
        return self.judge(self.sample(records), precision)

    def judge(self, sample, precision: str = "f32") -> dict:
        """The compared numbers over `sample` (inf where nothing to
        compare). The reference keeps the precisions the configuration
        states: f32 encoders without TF32, the query vector rounded to
        bf16 for the product with the bf16 rows, BM25 in f64.
        `precision="below"` is the control, one step down for each: the
        encoders in TF32, the query in fp8 (e4m3), BM25 scores in bf16
        (the chunks' and the summaries': the control's own prefilter is
        the top documents by bf16 scores)."""
        low = precision == "below"
        worst = dict.fromkeys(("prefilter_gap", "dense_gap", "sparse_gap",
                               "pool_gap", "rerank_gap", "order_gap"), 0.0)
        if not sample:
            return dict.fromkeys(worst, float("inf"))
        c, dev = self.c, self.device
        s = c["settings"]
        t = clock()
        rows = dense_rows(c, self.seed, dev).double()
        texts = [ch["text"] for ch in self.chunks]
        bm = ref_bm25.Corpus(texts, int(c["index"]["ell_width"]), self.ties)
        keys = list(self.sheets)
        docs = ref_bm25.Corpus([summary_text(self.sheets[k]) for k in keys],
                               int(c["index"]["summary_ell_width"]), "chunk")
        doc_of = {key: d for d, key in enumerate(keys)}
        row_doc = np.asarray([doc_of[ch["doc_key"]] for ch in self.chunks])
        row_of = {ch["chunk_id"]: i for i, ch in enumerate(self.chunks)}
        emb = self._leaves("m3", "embedder")
        rer = self._leaves("rerank", "reranker")
        k = int(s["n_candidates"])
        top = int(s["prefilter_top_docs"])
        t = note("reference corpus and weights", t)
        for _, prefilter, _ in self.retrievals.values():
            kept = filtered_docs(prefilter, doc_of)
            ref = docs.scores(prefilter[0]) if prefilter else None
            if ref is None or kept is False:
                return dict.fromkeys(worst, float("inf"))
            if low:
                kept = top_docs(torch.from_numpy(ref).to(torch.bfloat16)
                                .double().numpy(), top)
            worst["prefilter_gap"] = max(worst["prefilter_gap"],
                                         prefilter_gap(ref, kept, top))
        t = note(f"reference prefilter over {len(self.retrievals)} "
                 "retrievals", t)
        for _, question, cands, ranked in sample:
            variants, prefilter, _ = self.retrievals.get(
                id(cands), (None, None, None))
            if variants is None:
                return dict.fromkeys(worst, float("inf"))
            kept = filtered_docs(prefilter, doc_of)
            qv = torch.stack([ref_xlmr.dense_vector(
                c, emb, tok.encode(v, c["vocab_size"], s["query_max_len"]),
                "tf32" if low else "f32") for v in variants])
            qv = fp8_rows(qv) if low else qv.to(torch.bfloat16).float()
            dense = (qv.double() @ rows.T).cpu().numpy()     # [V, N]
            sparse = np.stack([bm.scores(v) for v in variants])
            if low:
                sparse = torch.from_numpy(sparse).to(torch.bfloat16) \
                    .double().numpy()
            if kept is not None:
                # the arms search the kept documents' chunks alone
                out = ~np.isin(row_doc, sorted(kept))
                dense[:, out] = -np.inf
                sparse[:, out] = -np.inf
            for ch in cands:
                row = row_of[ch.chunk_id]
                if ch.dense_score:
                    worst["dense_gap"] = max(worst["dense_gap"], float(
                        np.min(np.abs(dense[:, row] - ch.dense_score))))
                if ch.sparse_score:
                    rel = np.abs(sparse[:, row] - ch.sparse_score) \
                        / np.maximum(1.0, np.abs(sparse[:, row]))
                    worst["sparse_gap"] = max(worst["sparse_gap"],
                                              float(np.min(rel)))
            fused = fuse(dense, sparse, k)
            ours = {row_of[ch.chunk_id] for ch in cands}
            floor = min(fused.get(r, 0.0) for r in ours)
            left = [v for r, v in fused.items() if r not in ours]
            if len(ours) < min(k, len(fused)):
                left.append(float("inf"))
            worst["pool_gap"] = max(worst["pool_gap"],
                                    max(left, default=floor) - floor)
            scores = {}
            for ch in cands:
                mine = self.chunks[row_of[ch.chunk_id]]
                passage = f"{mine['heading']}\n{mine['text']}"
                ids = tok.encode_pair(question, passage, c["vocab_size"],
                                      s["rerank_max_len"])
                scores[ch.chunk_id] = ref_xlmr.pair_score(
                    c, rer, ids, "tf32" if low else "f32")
            if not ranked or any(ch.rerank_score is None for ch in ranked):
                return dict.fromkeys(worst, float("inf"))
            for ch in ranked:
                worst["rerank_gap"] = max(worst["rerank_gap"], abs(
                    ch.rerank_score - scores[ch.chunk_id]))
            worst["order_gap"] = max(worst["order_gap"],
                                     order_gap(ranked, cands, scores))
        note(f"reference over {len(sample)} queries", t)
        return worst

    def _leaves(self, head: str, model: str):
        cache: dict = {}

        def leaf(name):
            if name not in cache:
                cache[name] = weights.xlmr_leaf(self.c, head, self.seed,
                                                model, name, self.device)
            return cache[name]

        return leaf


def filtered_docs(prefilter, doc_of: dict):
    """The documents a retrieval's prefilter kept, as indices: None where
    it filtered nothing, False where the record is not one a prefilter
    leaves (no record, or a filter the retrieval was given)."""
    if prefilter is None:
        return False
    _, given, where = prefilter
    if given is not None:
        return False
    if where is None:
        return None
    try:
        return {doc_of[key] for key in where["doc_key"]["$in"]}
    except (KeyError, TypeError):
        return False


def top_docs(scores: np.ndarray, top: int):
    """The prefilter's rule: the `top` best documents (ties to the lower
    index) among those scoring above 0; None where none does."""
    order = np.lexsort((np.arange(scores.shape[0]), -scores))[:top]
    kept = {int(d) for d in order if scores[d] > 0}
    return kept or None


def prefilter_gap(ref: np.ndarray, kept, top: int) -> float:
    """How far a prefilter's documents `kept` fall below the best one it
    left out, by the reference's scores `ref`, relative (at least 1):
    0 where they are the top `top` of those scoring above 0 (or none
    scores and nothing was kept), inf where there are too few or too many
    of them or one scores 0."""
    want = min(top, int((ref > 0).sum()))
    if kept is None:
        return 0.0 if want == 0 else float("inf")
    kept = sorted(kept)
    if len(kept) != want or (ref[kept] <= 0).any():
        return float("inf")
    floor = float(ref[kept].min())
    rest = np.delete(ref, kept)
    best = float(rest.max()) if rest.size else 0.0
    return max(0.0, best - floor) / max(1.0, floor)


def fuse(dense: np.ndarray, sparse: np.ndarray, k: int) -> dict:
    """Weighted RRF of each variant's dense and sparse top-k (rank from 1,
    ties to the lower row; rows at -inf are filtered out): {row: fused
    score}."""
    out: dict[int, float] = {}
    w_orig, w_exp, w_bm_orig, w_bm_exp = RRF_WEIGHTS
    arms = [(dense[i], w_orig if i == 0 else w_exp)
            for i in range(dense.shape[0])]
    arms += [(sparse[i], w_bm_orig if i == 0 else w_bm_exp)
             for i in range(sparse.shape[0])]
    for scores, w in arms:
        order = np.lexsort((np.arange(scores.shape[0]), -scores))[:k]
        for rank, row in enumerate(order, start=1):
            if scores[row] == -np.inf:
                break
            out[int(row)] = out.get(int(row), 0.0) + w / (RRF_K + rank)
    return out


def order_gap(ranked, cands, scores: dict) -> float:
    """How far the reranked list contradicts the reference's scores: a
    later source scored above an earlier one, or a left-out candidate
    above a kept one."""
    ref = [scores[ch.chunk_id] for ch in ranked]
    gap = max((ref[j] - ref[i] for i in range(len(ref))
               for j in range(i + 1, len(ref))), default=0.0)
    kept = {ch.chunk_id for ch in ranked}
    out = [scores[ch.chunk_id] for ch in cands if ch.chunk_id not in kept]
    if out and ref:
        gap = max(gap, max(out) - min(ref))
    return max(gap, 0.0)

