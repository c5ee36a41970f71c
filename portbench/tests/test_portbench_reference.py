"""The plain references against the port at tiny sizes, on the CPU: the
same seeded inputs, the same answers (the port's own tests hold it to the
JAX package; these hold the yardstick to the port)."""

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.reference import bm25 as ref_bm25
from portbench.reference import decoder as ref_decoder
from portbench.reference import tokenizer as tok
from portbench.reference import xlmr as ref_xlmr
from portbench.systems import agent_query
from portbench.systems.agent_query import corpus
from portbench.systems.decoder_pool import decoder_config
from portbench.traffic import questions

from . import tiny


def test_tokenizer_copy_matches_the_port():
    from rag_dpo_tpu_torch.tokenize import HashedTokenizer

    port = HashedTokenizer(vocab_size=131072)
    for q in questions()[:12]:
        assert tok.tokenize(q, 131072) == port.tokenize(q)
        enc = port.encode_batch([q], 16)
        assert tok.encode(q, 131072, 16) == \
            enc.input_ids[0, :enc.lengths[0]].tolist()
        pair = port.encode_pairs([(q, q * 9)], 64)
        assert tok.encode_pair(q, q * 9, 131072, 64) == \
            pair.input_ids[0, :pair.lengths[0]].tolist()


def test_decoder_reference_matches_the_port_in_f32():
    import dataclasses

    from rag_dpo_tpu_torch.models.decoder import (build_decoder,
                                                  load_decoder_params)

    m = tiny.decoder_config()
    cfg = dataclasses.replace(decoder_config(m), dtype=torch.float32)
    model = load_decoder_params(build_decoder(cfg, "cpu"),
                                weights.decoder_tree(m, 3, "cpu"))
    ids = list(np.random.default_rng(0).integers(4, 512, size=40))
    with torch.no_grad():
        want = model(torch.tensor([ids]))[0]
    got = ref_decoder.forward_logits(
        m, lambda i: weights.decoder_layer(m, 3, i, "cpu"),
        weights.decoder_table(m, 3, "cpu"),
        weights.decoder_final_norm(m, 3, "cpu"), ids, range(40))
    assert (got - want).abs().max() < 1e-4 * want.abs().max()


def test_layer_by_layer_reference_equals_one_sequence_at_a_time():
    m = tiny.decoder_config()
    gen = np.random.default_rng(2)
    seqs = [(list(gen.integers(4, 512, size=n)), range(n - 3, n))
            for n in (17, 40, 9)]
    args = (m, lambda i: weights.decoder_layer(m, 6, i, "cpu"),
            weights.decoder_table(m, 6, "cpu"),
            weights.decoder_final_norm(m, 6, "cpu"))
    many = ref_decoder.forward_many(*args, seqs)
    for (ids, pos), got in zip(seqs, many):
        assert torch.equal(got, ref_decoder.forward_logits(*args, ids, pos))


def test_fp8_control_departs_from_the_reference():
    m = tiny.decoder_config()
    ids = list(np.random.default_rng(1).integers(4, 512, size=64))
    args = (m, lambda i: weights.decoder_layer(m, 4, i, "cpu"),
            weights.decoder_table(m, 4, "cpu"),
            weights.decoder_final_norm(m, 4, "cpu"), ids, range(64))
    f32 = ref_decoder.forward_logits(*args)
    fp8 = ref_decoder.forward_logits(*args, precision="fp8")
    err = (fp8 - f32).abs().max()
    assert 1e-3 < err < 0.5 * f32.abs().max()


def test_int4_control_departs_from_the_reference():
    m = tiny.decoder_config()
    ids = list(np.random.default_rng(1).integers(4, 512, size=64))
    args = (m, lambda i: weights.decoder_layer(m, 4, i, "cpu"),
            weights.decoder_table(m, 4, "cpu"),
            weights.decoder_final_norm(m, 4, "cpu"), ids, range(64))
    f32 = ref_decoder.forward_logits(*args)
    int4 = ref_decoder.forward_logits(*args, precision="int4")
    err = (int4 - f32).abs().max()
    assert 1e-3 < err < 0.5 * f32.abs().max()


@pytest.mark.parametrize("head", ["m3", "rerank"])
def test_encoder_reference_matches_the_port(head):
    from rag_dpo_tpu_torch.models import (BgeM3Config, CrossEncoderModel,
                                          EncoderConfig)
    from rag_dpo_tpu_torch.models.bge_m3 import build_bge_m3
    from rag_dpo_tpu_torch.models.convert import load_flax_params

    c = tiny.agent_config()
    enc = EncoderConfig.tiny()
    model = "embedder" if head == "m3" else "reranker"
    tree = weights.xlmr_tree(c, head, 5, model, "cpu")

    def leaf(name):
        return weights.xlmr_leaf(c, head, 5, model, name, "cpu")

    q = questions()[3]
    with torch.no_grad():
        if head == "m3":
            port = build_bge_m3(BgeM3Config(encoder=enc, colbert_dim=32),
                                params=tree, device="cpu")
            ids = tok.encode(q, 1024, 64)
            want = port(torch.tensor([ids]), torch.tensor([len(ids)]))
            got = ref_xlmr.dense_vector(c, leaf, ids)
            assert (got - want.dense[0]).abs().max() < 1e-5
        else:
            port = load_flax_params(CrossEncoderModel(enc), tree)
            ids = tok.encode_pair(q, questions()[4] * 5, 1024, 128)
            want = torch.sigmoid(port(torch.tensor([ids]),
                                      torch.tensor([len(ids)])))[0]
            got = ref_xlmr.pair_score(c, leaf, ids)
            assert abs(got - float(want)) < 1e-5


@pytest.mark.parametrize("path", ["python", "native"])
def test_bm25_reference_matches_the_port(path):
    from rag_dpo_tpu_torch import native
    from rag_dpo_tpu_torch.retrieval.bm25 import (build_bm25_stats,
                                                  build_ell_corpus_tf,
                                                  impacts_from_tf)
    from rag_dpo_tpu_torch.tokenize.french import tokenize_french_text

    c = tiny.agent_config()
    texts = [ch["text"] for ch in corpus(c, 8)]
    if path == "native":
        if not native.is_available():
            pytest.skip("the C++ runtime does not build here")
        stats, terms, imp, _, _ = native.build_ell_corpus_native(
            texts, ell_width=32, return_tf=True)
        ties = "corpus"
    else:
        toks = [tokenize_french_text(t) for t in texts]
        stats = build_bm25_stats(toks)
        terms, tf, dl = build_ell_corpus_tf(toks, stats, 32)
        imp = impacts_from_tf(tf, dl, stats)
        ties = "chunk"
    ref = ref_bm25.Corpus(texts, 32, ties)
    for q in questions()[:6]:
        t, w = stats.query_terms(q, 32)
        want = np.zeros(len(texts))
        for tid, wt in zip(t, w):
            if tid >= 0:
                want += (wt * np.where(terms == tid, imp, 0.0)).sum(axis=1)
        assert np.abs(ref.scores(q) - want).max() < 1e-5


def test_summary_reference_matches_the_ports_prefilter():
    from rag_dpo_tpu_torch.retrieval.bm25 import SummaryBm25Index

    c = tiny.agent_config()
    sheets = agent_query.summaries(c, 9)
    assert len(sheets) == c["index"]["documents"]
    index = SummaryBm25Index()
    index.build([{"doc_key": k, **f} for k, f in sheets.items()])
    keys = list(sheets)
    ref = ref_bm25.Corpus([agent_query.summary_text(sheets[k])
                           for k in keys], c["index"]["summary_ell_width"],
                          "chunk")
    for q in questions()[:8]:
        want = ref.scores(q)
        got = index.search(q, 10)
        for key, score in got:
            assert abs(score - want[keys.index(key)]) < 1e-5
        kept = {keys.index(k) for k in index.relevant_doc_keys(q, 10)}
        assert agent_query.prefilter_gap(want, kept, 10) < 1e-6
        assert agent_query.prefilter_gap(want, kept - {min(kept)}, 10) \
            == float("inf")
