"""The port's rebuild and update CLIs (`ingest/rebuild.py`,
`ingest/update_cli.py`): `tests/test_rebuild_cli.py`'s cases on the port,
with `--device cpu` (the CLIs run on the card unless asked), and a
`--corpus` rebuild whose index equals the JAX CLI's. Both packages build
BM25 on the Python path there (`native.is_available` pinned off on both
sides, ROADMAP C-8), and both embedders carry the same tiny encoder's Flax
weights (the default random init is Flax's threefry, C-3)."""

import json
import logging
import pathlib

import jax
import numpy as np
import pytest
import torch

from rag_dpo_tpu import native as jnative
from rag_dpo_tpu import providers as jproviders
from rag_dpo_tpu.evals.synthetic import build_synthetic_corpus
from rag_dpo_tpu.index import DeviceIndex as JDeviceIndex
from rag_dpo_tpu.ingest.rebuild import main as j_rebuild_main
from rag_dpo_tpu_torch import native
from rag_dpo_tpu_torch import providers
from rag_dpo_tpu_torch.index import DeviceIndex
from rag_dpo_tpu_torch.ingest import update_cli
from rag_dpo_tpu_torch.ingest.indexer import write_chunks_jsonl
from rag_dpo_tpu_torch.ingest.rebuild import main as rebuild_main
from rag_dpo_tpu_torch.utils.paths import default_paths

DATASET = (pathlib.Path(__file__).resolve().parent.parent / "rag_dpo_tpu"
           / "evals" / "data" / "qa_dataset.json")
FAKE = ["--llm-mode", "fake", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def root_logging_restored():
    """The CLIs set up structured logging on the root logger (its handlers
    replaced): give the next test the root logger it had."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    for h in handlers:
        if h not in root.handlers:
            root.addHandler(h)
    root.setLevel(level)


def test_rebuild_check_plan(tmp_path, capsys):
    rc = rebuild_main(["--check", "--root", str(tmp_path), *FAKE])
    assert rc == 0
    plan = json.loads(capsys.readouterr().out)
    assert plan["would_run"][0] == "filter"
    assert plan["would_run"][-1] == "tag"


def test_rebuild_check_from_and_only(tmp_path, capsys):
    rc = rebuild_main(["--check", "--from", "index", "--root",
                       str(tmp_path), *FAKE])
    assert rc == 0
    plan = json.loads(capsys.readouterr().out)
    assert plan["would_run"] == ["index", "summaries", "cleanup", "tag"]

    rc = rebuild_main(["--check", "--only", "dedup", "--root",
                       str(tmp_path), *FAKE])
    plan = json.loads(capsys.readouterr().out)
    assert plan["would_run"] == ["dedup"]


def test_rebuild_empty_corpus_runs(tmp_path, capsys):
    """All steps over an empty raw dir complete without error."""
    rc = rebuild_main(["--root", str(tmp_path), *FAKE,
                       "--steps", "filter,organize,dedup"])
    assert rc == 0
    reports = json.loads(capsys.readouterr().out)
    assert reports["filter"]["n_kept"] == 0
    assert reports["dedup"]["n_kept"] == 0


def test_rebuild_without_a_card_asks_for_the_cpu(tmp_path, monkeypatch):
    """The CLI's default device is the card: without one it raises and
    names `device="cpu"` rather than run on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        rebuild_main(["--check", "--root", str(tmp_path), "--llm-mode",
                      "fake"])


def test_update_cli_status(tmp_path, monkeypatch):
    """`update_cli --status` runs without network or index and reports
    the empty-state counters."""
    monkeypatch.setenv("RAGDPO_LLM_MODE", "fake")
    out = []
    monkeypatch.setattr("builtins.print", lambda *a, **k:
                        out.append(" ".join(str(x) for x in a)))
    rc = update_cli.main(["--status", "--root", str(tmp_path), *FAKE])
    assert rc == 0
    status = json.loads(out[-1])
    assert status["n_known_urls"] == 0
    assert status["index_exists"] is False


def test_rebuild_from_corpus_gives_jaxs_index(tmp_path, capsys,
                                              monkeypatch):
    chunks = build_synthetic_corpus(json.loads(DATASET.read_text()))[:60]
    corpus = tmp_path / "processed_chunks.jsonl"
    write_chunks_jsonl(chunks, corpus)
    monkeypatch.setattr(jnative, "is_available", lambda: False)
    monkeypatch.setattr(native, "is_available", lambda: False)
    tree = jax.tree.map(np.asarray, jproviders.Embedder().load())
    base = providers.Embedder

    class CarriedEmbedder(base):
        """The port's default embedder with JAX's default weights."""

        def __init__(self, config=None, params=None, **kw):
            super().__init__(config, params=params or tree, **kw)

    monkeypatch.setattr(providers, "Embedder", CarriedEmbedder)
    reports = {}
    for side, main, extra in (("jax", j_rebuild_main, ["--llm-mode", "fake"]),
                              ("torch", rebuild_main, FAKE)):
        assert main(["--root", str(tmp_path / side), "--corpus", str(corpus),
                     *extra]) == 0
        reports[side] = json.loads(capsys.readouterr().out)
    assert list(reports["torch"]) == ["index", "summaries", "cleanup", "tag"]
    for r in reports.values():
        for step in r.values():
            step.pop("seconds")
        r["index"].pop("build_seconds")
    assert reports["torch"] == reports["jax"]
    assert reports["torch"]["index"]["n_indexed"] == len(chunks)

    j = JDeviceIndex.load(default_paths(tmp_path / "jax").index_dir)
    t = DeviceIndex.load(default_paths(tmp_path / "torch").index_dir,
                         device="cpu")
    assert t.ids == j.ids
    assert t.bm25_stats.vocab == j.bm25_stats.vocab
    np.testing.assert_array_equal(t._terms, j._terms)
    np.testing.assert_array_equal(t._impacts, j._impacts)
    np.testing.assert_allclose(t._dense.astype(np.float32),
                               j._dense.astype(np.float32), atol=1e-3)
    assert [t.meta.row(i) for i in range(t.n_rows)] \
        == [j.meta.row(i) for i in range(j.n_rows)]
