"""Whole runs of each cell at tiny sizes on the CPU (the harness's look
for a card skipped): sound runs come out correct, and each fault a cell
can have, planted under the timed path, makes `correct` false."""

import numpy as np
import pytest

from . import tiny


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_run_is_correct(cell):
    result = tiny.execute(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "setup_s" in result["metrics"]
    assert list(result)[-1] == "checks"


def altered_token(system):
    """A token changed where the pool emits it."""
    eng = system.engine
    advance = eng._plain_advance

    def bad():
        toks, lp = advance()
        toks = toks.copy()
        toks[:, 0] = (toks[:, 0] + 7) % system.m["vocab_size"]
        return toks, lp

    eng._plain_advance = bad


def unchanged_state(system, monkeypatch):
    """The cache rows a step writes are never written."""
    from rag_dpo_tpu_torch.models import decoder

    monkeypatch.setattr(decoder, "_write_rows", lambda *a, **k: None)


def half_batch(system):
    """The later half of the live slots left out of the step: their
    tokens are the earlier half's."""
    eng = system.engine
    advance = eng._plain_advance

    def bad():
        toks, lp = advance()
        toks = toks.copy()
        live = sorted(eng._active)
        half = len(live) // 2
        for i, slot in enumerate(live[half:]):
            toks[slot] = toks[live[i]]
        return toks, lp

    eng._plain_advance = bad


@pytest.mark.parametrize("fault", ["token", "state", "half"])
def test_decoder_faults_are_caught(fault, monkeypatch):
    def hook(system):
        if fault == "token":
            altered_token(system)
        elif fault == "state":
            unchanged_state(system, monkeypatch)
        else:
            half_batch(system)

    result = tiny.execute("prefill.context-8c", seed=12, seconds=3.0, hook=hook)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["score", "state", "half", "prefilter"])
def test_agent_faults_are_caught(fault):
    def hook(system):
        rr = system.reranker
        score = rr.score_pairs
        if fault == "prefilter":
            # the best document swapped for one the prefilter left out
            summary = system.agent.graph.c.retriever.summary_index
            search = summary.search

            def wrong(query, top_k=40):
                got = search(query, top_k + 1)
                return got[1:top_k + 1] if len(got) > top_k else got[1:]
            summary.search = wrong
        elif fault == "score":
            rr.score_pairs = lambda pairs: score(pairs) + np.where(
                np.arange(len(pairs)) == 0, 0.01, 0.0)
        elif fault == "half":
            def half(pairs):
                got = score(pairs[: (len(pairs) + 1) // 2])
                return np.concatenate([got, got])[:len(pairs)]
            rr.score_pairs = half
        else:
            emb = system.embedder
            encode = emb.embed_queries
            first = {}

            def stale(texts):
                out = encode(texts)
                first.setdefault("v", out[:1])
                return np.repeat(first["v"], len(texts), axis=0)
            emb.embed_queries = stale

    result = tiny.execute("query.agent-16c", seed=13, hook=hook)
    assert not result["correct"], result["checks"]


def test_int4_control_reads_wider_than_the_program():
    result = tiny.execute("prefill.context-8c", seed=21, seconds=3.0,
                          controls=("int4", "fp8"))
    got = result["readings"]
    for control in ("int4", "fp8"):
        assert got[control]["served_gap"] > got["program"]["served_gap"]
