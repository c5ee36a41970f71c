"""Slice 14: the corpus build of the port against the JAX package's.

Both packages scrape `tests/test_ingest_e2e.py`'s four pages through the
same fetch, run the nine steps (`STEP_ORDER`) with `FakeLLMProvider` and a
tiny encoder whose Flax weights are carried across, then resume from
`summaries` in a fresh pipeline and apply two incremental updates: one where
every page answers 304, and one where a page changed and lost a section
(merge the artifacts, purge its stale chunk). Everything the pipeline
writes must be byte-equal (paths under each run's own root aside), the
indexes' ids, vocabularies, ELL terms and impacts bit-equal, and their
dense rows within 1e-3 (f16 host rows of unit vectors: one f16 rounding
step). Both packages build BM25 on the Python path (`native.is_available`
pinned off on both sides): the JAX package's C++ runtime rounds impacts
from double (ROADMAP C-8), and the port's own is held to it by
`tests/test_torch_native.py`.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

from rag_dpo_tpu import native as jnative
from rag_dpo_tpu.ingest.pipeline import IngestPipeline as JIngestPipeline
from rag_dpo_tpu.ingest.pipeline import PipelineContext as JPipelineContext
from rag_dpo_tpu.ingest.scraper import FetchResult as JFetchResult
from rag_dpo_tpu.ingest.scraper import Scraper as JScraper
from rag_dpo_tpu.ingest.scraper import ScraperConfig as JScraperConfig
from rag_dpo_tpu.ingest.update import IncrementalUpdater as JUpdater
from rag_dpo_tpu.models import BgeM3Config as JBgeM3Config
from rag_dpo_tpu.models import EncoderConfig as JEncoderConfig
from rag_dpo_tpu.providers import Embedder as JEmbedder
from rag_dpo_tpu.providers import EmbedderConfig as JEmbedderConfig
from rag_dpo_tpu.providers import FakeLLMProvider as JFakeLLMProvider
from rag_dpo_tpu.utils.paths import default_paths as j_default_paths
from rag_dpo_tpu_torch import native
from rag_dpo_tpu_torch.ingest import STEP_ORDER
from rag_dpo_tpu_torch.ingest.pipeline import IngestPipeline, PipelineContext
from rag_dpo_tpu_torch.ingest.scraper import FetchResult, Scraper, ScraperConfig
from rag_dpo_tpu_torch.ingest.update import IncrementalUpdater
from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
from rag_dpo_tpu_torch.providers import Embedder, EmbedderConfig
from rag_dpo_tpu_torch.providers import FakeLLMProvider
from rag_dpo_tpu_torch.utils.paths import default_paths
from test_ingest_e2e import PAGES

SCOPE = "https://site.test/fr"
CHANGED = "https://site.test/fr/violation"
# the changed page of the second update: new text, and its second section
# gone, so the update must purge that section's chunk
CHANGED_HTML = PAGES[CHANGED].split("<h2>Communication")[0].replace(
    "72 heures", "soixante-douze heures") + "</div></body></html>"
ARTIFACTS = ("processed_chunks", "document_metadata", "document_summaries",
             "keep_manifest")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: each pytest-xdist worker would otherwise start
    one per core, and oversubscribed, torch's CPU ops run ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def python_bm25():
    """Both packages on the Python BM25 path (module docstring)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "is_available", lambda: False)
    mp.setattr(native, "is_available", lambda: False)
    yield
    mp.undo()


def make_fetch(result_type, pages: dict):
    """The e2e test's fetch over `pages`: 304 for an If-Modified-Since of
    "fresh", else the page."""
    def fetch(url, if_modified_since="", **kw):
        html = pages.get(url)
        if html is None:
            return result_type(url=url, status=404)
        if if_modified_since == "fresh":
            return result_type(url=url, status=304)
        return result_type(url=url, status=200, content=html.encode(),
                           content_type="text/html",
                           last_modified="Mon, 01 Jan 2026 00:00:00 GMT")
    return fetch


SIDES = {
    "jax": dict(paths=j_default_paths, scraper=JScraper,
                config=JScraperConfig, result=JFetchResult,
                context=JPipelineContext, pipeline=JIngestPipeline,
                updater=JUpdater, llm=JFakeLLMProvider),
    "torch": dict(paths=default_paths, scraper=Scraper,
                  config=ScraperConfig, result=FetchResult,
                  context=PipelineContext, pipeline=IngestPipeline,
                  updater=IncrementalUpdater, llm=FakeLLMProvider),
}


def scraper_for(side, paths, pages=PAGES):
    api = SIDES[side]
    return api["scraper"](paths.raw, api["config"](scope_prefix=SCOPE,
                                                   delay_s=0.0),
                          fetch=make_fetch(api["result"], pages))


@pytest.fixture(scope="module")
def embedders():
    jemb = JEmbedder(JEmbedderConfig(
        model=JBgeM3Config(encoder=JEncoderConfig.tiny(
            use_flash_attention=False), colbert_dim=32),
        batch_size=8))
    emb = Embedder(EmbedderConfig(
        model=BgeM3Config(encoder=EncoderConfig.tiny(
            use_flash_attention=False), colbert_dim=32),
        batch_size=8), params=jax.tree.map(np.asarray, jemb.load()),
        device="cpu")
    return {"jax": jemb, "torch": emb}


@pytest.fixture(scope="module")
def built(tmp_path_factory, embedders):
    """Per side: the root, the scraper, the context and the reports of a
    whole run of the nine steps."""
    out = {}
    for side, api in SIDES.items():
        root = tmp_path_factory.mktemp(f"corpus_{side}")
        paths = api["paths"](root).ensure()
        scraper = scraper_for(side, paths)
        crawl = scraper.crawl([f"{SCOPE}/"])
        ctx = api["context"](paths=paths, llm=api["llm"](),
                             embedder=embedders[side])
        reports = api["pipeline"](ctx).run()
        out[side] = dict(root=root, paths=paths, scraper=scraper,
                         crawl=crawl, ctx=ctx, reports=reports)
    return out


def without_seconds(report):
    if isinstance(report, dict):
        return {k: without_seconds(v) for k, v in report.items()
                if k not in ("seconds", "build_seconds")}
    return report


def artifact_text(run, name) -> str:
    """An artifact's text with the run's own root written as ROOT."""
    return getattr(run["paths"], name).read_text(encoding="utf-8").replace(
        str(run["root"]), "ROOT")


def assert_indexes_equal(j, t):
    assert t.ids == j.ids
    assert t.bm25_stats.vocab == j.bm25_stats.vocab
    np.testing.assert_array_equal(t._alive, j._alive)
    np.testing.assert_array_equal(t._terms, j._terms)
    np.testing.assert_array_equal(t._impacts, j._impacts)
    np.testing.assert_allclose(t._dense.astype(np.float32),
                               j._dense.astype(np.float32), atol=1e-3)
    assert [t.meta.row(i) for i in range(t.n_rows)] \
        == [j.meta.row(i) for i in range(j.n_rows)]


def test_crawls_agree(built):
    assert built["torch"]["crawl"] == built["jax"]["crawl"]
    assert built["torch"]["crawl"]["n_fetched"] == 4


def test_reports_equal_but_for_seconds(built):
    j, t = built["jax"]["reports"], built["torch"]["reports"]
    assert list(t) == list(j) == STEP_ORDER
    assert without_seconds(t) == without_seconds(j)
    assert t["index"]["n_indexed"] == t["chunk"]["n_chunks"] >= 4
    assert t["index"]["verification"]["self_retrieval_ok"]


@pytest.mark.parametrize("name", ARTIFACTS)
def test_artifacts_byte_equal(built, name):
    assert artifact_text(built["torch"], name) \
        == artifact_text(built["jax"], name)


def test_indexes_equal(built):
    j, t = built["jax"]["ctx"].index, built["torch"]["ctx"].index
    assert str(t.device) == "cpu"
    assert_indexes_equal(j, t)


def test_resume_from_summaries_on_cpu(built, embedders, tmp_path):
    """A fresh pipeline resumed at `summaries` reloads the chunks, the
    manifest and the saved index (on the embedder's device) as JAX's does."""
    reports = {}
    for side, api in SIDES.items():
        root = tmp_path / side
        shutil.copytree(built[side]["root"], root)
        ctx = api["context"](paths=api["paths"](root), llm=api["llm"](),
                             embedder=embedders[side])
        reports[side] = api["pipeline"](ctx).run(from_step="summaries")
        assert ctx.index is not None and len(ctx.chunks) \
            == built[side]["reports"]["chunk"]["n_chunks"]
        if side == "torch":
            assert str(ctx.index.device) == "cpu"
    assert list(reports["torch"]) == ["summaries", "cleanup", "tag"]
    assert without_seconds(reports["torch"]) \
        == without_seconds(reports["jax"])


@pytest.fixture(scope="module")
def updated(built):
    """The e2e test's two updates on both sides: every page fresh (304),
    then the violation page changed (and shrunk) and the rest fresh."""
    out = {}
    for side, api in SIDES.items():
        run = built[side]
        scraper = run["scraper"]
        for meta in scraper.state["visited"].values():
            if meta.get("status") == 200:
                meta["last_modified"] = "fresh"
        fresh = api["updater"](scraper, run["ctx"]).update()
        n_before = len(run["ctx"].index)
        scraper.fetch = make_fetch(api["result"],
                                   {**PAGES, CHANGED: CHANGED_HTML})
        for url, meta in scraper.state["visited"].items():
            if meta.get("status") == 200:
                meta["last_modified"] = "stale" if url == CHANGED \
                    else "fresh"
        changed = api["updater"](scraper, run["ctx"]).update()
        out[side] = dict(fresh=fresh, changed=changed, n_before=n_before)
    return out


def test_update_with_every_page_fresh(updated):
    j, t = updated["jax"]["fresh"], updated["torch"]["fresh"]
    assert t == j
    assert t["n_changed"] == 0 and t["n_unchanged"] == 4


def test_update_merges_and_purges_as_jax(built, updated):
    j, t = updated["jax"]["changed"], updated["torch"]["changed"]
    assert t == j
    assert t["n_changed"] == 1 and t["n_stale_purged"] == 1
    tindex = built["torch"]["ctx"].index
    assert len(tindex) == updated["torch"]["n_before"] - 1
    assert_indexes_equal(built["jax"]["ctx"].index, tindex)
    for name in ARTIFACTS:
        assert artifact_text(built["torch"], name) \
            == artifact_text(built["jax"], name), name
    assert "soixante-douze" in artifact_text(built["torch"],
                                             "processed_chunks")


def test_cuda_tests_pages_are_the_e2e_pages():
    """`tests/test_torch_cuda.py` runs on a machine without jax, so it
    keeps its own copy of the four pages."""
    from test_torch_cuda import E2E_PAGES

    assert E2E_PAGES == PAGES


def test_fake_site_answers_the_scrapers_conditional_gets(tmp_path):
    """The smoke's loopback site through the scraper's own `default_fetch`:
    the crawl from the site map fetches every page, a re-crawl of the
    stored dates answers 304 but for the page given a later date."""
    from rag_dpo_tpu_torch.evals.fake_site import (
        FakeSite,
        page_path,
        render_page,
        render_pages,
    )

    chunks = [{"chunk_id": f"c{i}", "heading": "Registre", "title": "RGPD",
               "text": f"Le registre des traitements, fiche {i}."}
              for i in range(7)]
    pages = render_pages(chunks, 3)
    with FakeSite(pages) as site:
        scraper = Scraper(tmp_path, ScraperConfig(scope_prefix=site.scope,
                                                  delay_s=0.0))
        assert scraper.crawl([site.root])["n_fetched"] == 4
        site.set_page(page_path(1), render_page("RGPD", [("A", "neuf")]),
                      "Tue, 02 Jun 2026 08:00:00 GMT")
        result = scraper.update_existing()
    assert result == {"changed": [site.url + page_path(1)],
                      "n_unchanged": 3, "n_failed": 0}
    assert site.counts == {200: 5, 304: 3}
    assert b"neuf" in (tmp_path / "html" / "fr_doc_1.html").read_bytes()
