"""The port's C++ ingestion runtime (`rag_dpo_tpu_torch.native`).

The one port test file that asks for the library on purpose. Whether g++
can build it is decided in a fixture, never at collection, so every
pytest-xdist worker collects the same tests. The library is the port's own
build of `native/ragdpo_native.cpp` under `rag_dpo_tpu_torch/build/`; the
JAX package's bindings are pointed at that same library
(`rag_dpo_tpu.native._load` patched), so no test here writes
`native/ragdpo_native.so` (ROADMAP C-18) and both packages' native paths
run the same machine code: their outputs must agree bit for bit.

`tests/test_native.py`'s tokenizer and ELL cases run on the port's module
against the JAX package's Python path, as they run there on JAX's.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu import native as jnative
from rag_dpo_tpu.evals.synthetic import build_synthetic_corpus
from rag_dpo_tpu.ingest.indexer import CorpusIndexer as JCorpusIndexer
from rag_dpo_tpu.models import BgeM3Config as JBgeM3Config
from rag_dpo_tpu.models import EncoderConfig as JEncoderConfig
from rag_dpo_tpu.ops.postings import PostingsIndex as JPostingsIndex
from rag_dpo_tpu.ops.sparse import ell_scores
from rag_dpo_tpu.providers import Embedder as JEmbedder
from rag_dpo_tpu.providers import EmbedderConfig as JEmbedderConfig
from rag_dpo_tpu.retrieval.bm25 import build_bm25_stats, build_ell_corpus
from rag_dpo_tpu.tokenize.french import tokenize_french_text
from rag_dpo_tpu_torch import native
from rag_dpo_tpu_torch.ingest import CorpusIndexer
from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
from rag_dpo_tpu_torch.ops.postings import PostingsIndex
from rag_dpo_tpu_torch.providers import Embedder, EmbedderConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
DATASET = REPO / "rag_dpo_tpu" / "evals" / "data" / "qa_dataset.json"
# tests/test_native.py's samples (importing that module would build the JAX
# package's library at collection)
SAMPLES = [
    "L'article 32-1 du RGPD impose la sécurité des données au "
    "sous-traitant.",
    "Notification d'une violation à la CNIL dans les 72 heures — "
    "article 33 !",
    "Durées de conservation proportionnées (référentiel CNIL, cœur du "
    "sujet).",
    "L'ŒUVRE complète : Æthique, naïveté, août, Noël, à-côtés…",
    "",
    "le la les et ou",  # all stopwords
]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lib():
    """The port's library, with the JAX bindings pointed at it; skips
    where no C++ toolchain builds it."""
    if not native.is_available():
        pytest.skip(f"native toolchain unavailable: {native.build_error()}")
    loaded = native._load()
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "_load", lambda: loaded)
    yield loaded
    mp.undo()


def test_library_lives_in_the_ports_build_dir(lib):
    path = native.library_path()
    assert path.parent == REPO / "rag_dpo_tpu_torch" / "build"
    assert path.is_file() and path.name.startswith("libragdpo_native_")
    assert jnative.is_available() and jnative._load() is lib


@pytest.mark.parametrize("text", SAMPLES)
def test_tokenizer_parity(lib, text):
    assert native.tokenize_french_native(text) == tokenize_french_text(text)


def test_tokenizer_parity_random_french(lib):
    rng = np.random.default_rng(0)
    words = ("données protection sécurité traité l'été où ça étés "
             "déjà-vu 32-1 café crème RGPD CNIL œuf moyen-âge").split()
    for _ in range(50):
        text = " ".join(rng.choice(words, size=rng.integers(1, 30)))
        assert native.tokenize_french_native(text) \
            == tokenize_french_text(text)


@pytest.mark.parametrize("text", ["1--b article 83--bis", "aipd--2 x--7--y"])
def test_tokenize_single_digit_head_in_double_hyphen_run(lib, text):
    assert native.tokenize_french_native(text) == tokenize_french_text(text)


def test_fuzz_tokenizer_parity_random_unicode(lib):
    rng = np.random.default_rng(0)
    pieces = ["données", "RGPD", "l'article", "72h", "sous-traitant",
              "œuvre", "cœur", "ÉTÉ", "naïve", "straße", "Æsir",
              "a-b-c", "--x--", "42", "º°§", "…", "«cité»", " ",
              "\t", "🙂", "Ω", "ça", "déjà-vu", "n°17", "CNIL."]
    for _ in range(60):
        text = " ".join(rng.choice(pieces, size=int(rng.integers(1, 12))))
        if rng.integers(0, 4) == 0:
            text += "\xc3"  # dangling UTF-8 lead byte
        assert native.tokenize_french_native(text) \
            == tokenize_french_text(text), repr(text)


def test_ell_build_parity(lib):
    texts = SAMPLES[:4] * 3 + ["sécurité des données personnelles santé"]
    stats_n, terms_n, impacts_n = native.build_ell_corpus_native(
        texts, ell_width=12)
    tokens = [tokenize_french_text(t) for t in texts]
    stats_p = build_bm25_stats(tokens)
    terms_p, impacts_p = build_ell_corpus(tokens, stats_p, ell_width=12)
    assert stats_n.n_docs == stats_p.n_docs
    assert set(stats_n.vocab) == set(stats_p.vocab)
    assert stats_n.avgdl == pytest.approx(stats_p.avgdl)
    for term, pid in stats_p.vocab.items():
        assert stats_n.idf[stats_n.vocab[term]] == pytest.approx(
            stats_p.idf[pid], abs=1e-5)
    names_n = {i: t for t, i in stats_n.vocab.items()}
    names_p = {i: t for t, i in stats_p.vocab.items()}
    for d in range(len(texts)):
        nat = {names_n[t]: v for t, v in zip(terms_n[d], impacts_n[d])
               if t >= 0}
        py = {names_p[t]: v for t, v in zip(terms_p[d], impacts_p[d])
              if t >= 0}
        assert set(nat) == set(py)
        for term in py:
            assert nat[term] == pytest.approx(py[term], abs=1e-5)


def test_ell_query_scoring_parity(lib):
    texts = ["violation de données notification CNIL 72 heures",
             "registre des traitements finalités durées",
             "sécurité chiffrement pseudonymisation des données"] * 2
    stats_n, terms_n, impacts_n = native.build_ell_corpus_native(
        texts, ell_width=8)
    tokens = [tokenize_french_text(t) for t in texts]
    stats_p = build_bm25_stats(tokens)
    terms_p, impacts_p = build_ell_corpus(tokens, stats_p, ell_width=8)
    scores = []
    for stats, terms, impacts in ((stats_n, terms_n, impacts_n),
                                  (stats_p, terms_p, impacts_p)):
        qt, qw = stats.query_terms("notification violation CNIL",
                                   max_terms=8)
        scores.append(np.asarray(ell_scores(
            jnp.asarray(terms), jnp.asarray(impacts),
            jnp.asarray(qt[None]), jnp.asarray(qw[None])))[0])
    np.testing.assert_allclose(scores[0], scores[1], atol=1e-5)


def test_ell_build_bit_equal_to_jax_native(lib):
    texts = [c["text"] for c in build_synthetic_corpus(
        json.loads(DATASET.read_text()))]
    for width in (12, 48):
        j = jnative.build_ell_corpus_native(texts, ell_width=width,
                                            return_tf=True)
        t = native.build_ell_corpus_native(texts, ell_width=width,
                                           return_tf=True)
        assert t[0].vocab == j[0].vocab and t[0].avgdl == j[0].avgdl
        np.testing.assert_array_equal(t[0].idf, j[0].idf)
        np.testing.assert_array_equal(t[0].df, j[0].df)
        for a, b in zip(t[1:], j[1:]):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def indexes(lib):
    """The synthetic corpus through both indexers, each on its native
    path, the tiny encoder's Flax weights carried across; then five of
    its chunks changed through an update (the incremental Python path on
    both sides)."""
    chunks = build_synthetic_corpus(json.loads(DATASET.read_text()))
    jemb = JEmbedder(JEmbedderConfig(model=JBgeM3Config(
        encoder=JEncoderConfig.tiny(use_flash_attention=False),
        colbert_dim=32)))
    emb = Embedder(EmbedderConfig(model=BgeM3Config(
        encoder=EncoderConfig.tiny(use_flash_attention=False),
        colbert_dim=32)), params=jax.tree.map(np.asarray, jemb.load()),
        device="cpu")
    calls = native.CALLS["build_ell_corpus_native"]
    jindex, _, _ = JCorpusIndexer(jemb, ell_width=48).build(chunks)
    index, _, _ = CorpusIndexer(emb, ell_width=48).build(chunks)
    # the port's indexer took its native path (JAX's module counts nothing)
    assert native.CALLS["build_ell_corpus_native"] == calls + 1
    changed = [{**c, "text": c["text"] + " Mise à jour : registre."}
               for c in chunks[:5]]
    out = {"fresh": (jindex, index)}
    jup, _, _ = JCorpusIndexer(jemb).build(changed, mode="update",
                                           index=jindex)
    up, _, _ = CorpusIndexer(emb).build(changed, mode="update", index=index)
    out["updated"] = (jup, up)
    return out


@pytest.mark.parametrize("stage", ["fresh", "updated"])
def test_indexer_native_build_bit_equal_to_jax(indexes, stage):
    j, t = indexes[stage]
    assert t.ids == j.ids
    assert t.bm25_stats.vocab == j.bm25_stats.vocab
    assert t.bm25_stats.avgdl == j.bm25_stats.avgdl
    np.testing.assert_array_equal(t.bm25_stats.idf, j.bm25_stats.idf)
    for name in ("_terms", "_impacts", "_tf", "_dl"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    np.testing.assert_allclose(t._dense.astype(np.float32),
                               j._dense.astype(np.float32), atol=1e-3)


@pytest.mark.parametrize("cap", [4, 64])
def test_invert_postings_native_equals_numpy(lib, monkeypatch, cap):
    rng = np.random.default_rng(cap)
    terms = rng.integers(-1, 300, (2000, 16)).astype(np.int32)
    # impacts of few distinct values: ties ordered by doc, as lexsort does
    impacts = rng.integers(0, 6, (2000, 16)).astype(np.float32) / 4
    calls = native.CALLS["invert_postings_native"]
    nat = PostingsIndex.build(terms, impacts, 300, cap=cap)
    jnat = JPostingsIndex.build(terms, impacts, 300, cap=cap)
    assert native.CALLS["invert_postings_native"] == calls + 1
    monkeypatch.setattr(native, "is_available", lambda: False)
    plain = PostingsIndex.build(terms, impacts, 300, cap=cap)
    for got in (nat, jnat):
        np.testing.assert_array_equal(got.post_docs, plain.post_docs)
        np.testing.assert_array_equal(got.post_impacts, plain.post_impacts)
        assert (got.cap, got.n_docs) == (plain.cap, plain.n_docs)


BUILD_RACE = textwrap.dedent("""
    import ctypes, pathlib, sys
    from rag_dpo_tpu_torch import native

    native.SRC = pathlib.Path(sys.argv[1])
    path = native.build(pathlib.Path(sys.argv[2]))
    lib = native.bind(ctypes.CDLL(str(path)))
    native._lib = lib
    assert native.tokenize_french_native("Données RGPD") == [
        "donnees", "rgpd"], "a library that does not work"
    print(path.name)
""")


def test_two_processes_build_at_once(lib, tmp_path):
    """Two processes that find no library build at once into one directory:
    each loads a whole library (a temporary file renamed into place), and
    nothing is written beside the source."""
    src_dir = tmp_path / "native"
    src_dir.mkdir()
    src = src_dir / "ragdpo_native.cpp"
    src.write_bytes(native.SRC.read_bytes())
    script = tmp_path / "race.py"
    script.write_text(BUILD_RACE)
    build_dir = tmp_path / "build"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(src), str(build_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
        for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    names = {o.strip() for o, _ in outs}
    assert len(names) == 1
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(names)
    assert sorted(p.name for p in src_dir.iterdir()) == ["ragdpo_native.cpp"]
