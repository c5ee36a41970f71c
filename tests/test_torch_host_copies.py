"""The port's import-path-only copies stay equal to their JAX originals.

Host modules with no jax of their own that cannot be imported from
`rag_dpo_tpu` without loading jax (its package `__init__` files import
device code) are carried in `rag_dpo_tpu_torch` as copies. Each copy must
equal its original once the package prefix is swapped back, so a fix to
either side shows up here until both agree. Only the module docstring may
differ, so a copy can word its description for the port.
"""

import ast
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
COPIES = [
    "agent/__init__.py",
    "agent/graph.py",
    "agent/nodes.py",
    "agent/state.py",
    "agent/tools.py",
    "index/__init__.py",
    "ingest/__init__.py",
    "ingest/chunker.py",
    "ingest/classify.py",
    "ingest/dedup.py",
    "ingest/enterprise.py",
    "ingest/filter.py",
    "ingest/images.py",
    "ingest/office.py",
    "ingest/pdf.py",
    "ingest/summaries.py",
    "ingest/tagging.py",
    "index/metadata.py",
    "retrieval/types.py",
    "rag/__init__.py",
    "rag/acronyms.py",
    "rag/context.py",
    "rag/expander.py",
    "rag/generator.py",
    "rag/intent.py",
    "rag/pipeline.py",
    "rag/topics.py",
    "rag/validators.py",
    "providers/__init__.py",
    "providers/base.py",
    "providers/fake.py",
    "providers/http_llm.py",
    "serving/batcher.py",
    "evals/__init__.py",
    "evals/retrieval_eval.py",
    "evals/synthetic.py",
    "retrieval/calibrate.py",
    "tokenize/base.py",
    "tokenize/french.py",
    "tokenize/hashed.py",
    "utils/alerter.py",
    "utils/config.py",
    "utils/logging.py",
    "utils/paths.py",
    "utils/query_logger.py",
]

# copies that differ from their originals in these lines only (JAX's, the
# port's): where HTML's tree comes from (bs4 and lxml are not installed
# beside the CUDA stack), and the device a saved index loads on
_SOUP = ("from bs4 import BeautifulSoup", "from .htmltree import BeautifulSoup")
_LOAD_ON_EMBEDDER = 'device=getattr(self.ctx.embedder, "device", None))'
NEAR_COPIES = {
    "ingest/parsing.py": [_SOUP],
    "ingest/scraper.py": [_SOUP],
    "ingest/pipeline.py": [(
        "self.ctx.index = DeviceIndex.load(self.ctx.paths.index_dir)",
        "self.ctx.index = DeviceIndex.load(\n"
        "                self.ctx.paths.index_dir,\n"
        f"                {_LOAD_ON_EMBEDDER}")],
    "ingest/update.py": [(
        "index = DeviceIndex.load(paths.index_dir)",
        "index = DeviceIndex.load(\n"
        "                paths.index_dir,\n"
        f"                {_LOAD_ON_EMBEDDER}")],
}


def _code(path: pathlib.Path) -> str:
    """The module's source after its docstring, with the port's package
    name swapped back to the JAX package's."""
    text = path.read_text(encoding="utf-8")
    body = ast.parse(text).body
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)):
        text = "".join(text.splitlines(keepends=True)[body[0].end_lineno:])
    return text.replace("rag_dpo_tpu_torch", "rag_dpo_tpu")


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_original(rel):
    assert (_code(REPO / "rag_dpo_tpu_torch" / rel)
            == _code(REPO / "rag_dpo_tpu" / rel))


@pytest.mark.parametrize("rel", sorted(NEAR_COPIES))
def test_near_copy_differs_only_in_its_listed_lines(rel):
    original = _code(REPO / "rag_dpo_tpu" / rel)
    port = _code(REPO / "rag_dpo_tpu_torch" / rel)
    assert port != original
    for jax_line, port_line in NEAR_COPIES[rel]:
        assert original.count(jax_line) >= 1
        original = original.replace(jax_line, port_line)
    assert port == original


def test_every_copy_is_listed():
    """A module of the port that is byte-equal to its JAX counterpart (up
    to the package name) is a copy, and must be in the list above, and so
    kept in sync."""
    port = REPO / "rag_dpo_tpu_torch"
    equal = sorted(
        str(p.relative_to(port)) for p in port.rglob("*.py")
        if (REPO / "rag_dpo_tpu" / p.relative_to(port)).is_file()
        and p.read_text(encoding="utf-8").replace(
            "rag_dpo_tpu_torch", "rag_dpo_tpu")
        == (REPO / "rag_dpo_tpu" / p.relative_to(port)).read_text(
            encoding="utf-8"))
    assert set(equal) <= set(COPIES), sorted(set(equal) - set(COPIES))


def test_harness_differs_only_in_its_dataset_path():
    """`evals/harness.py` is a copy but for `DEFAULT_DATASET`, which
    points at the dataset the JAX package ships (the port keeps none)."""
    from rag_dpo_tpu_torch.evals.harness import (
        DEFAULT_DATASET,
        load_qa_dataset,
    )

    def without_default(text):
        return re.sub(r"(#[^\n]*\n)*DEFAULT_DATASET = .*?\)\n", "", text,
                      count=1, flags=re.S)

    rel = "evals/harness.py"
    port = _code(REPO / "rag_dpo_tpu_torch" / rel)
    assert port != _code(REPO / "rag_dpo_tpu" / rel)
    assert without_default(port) == without_default(
        _code(REPO / "rag_dpo_tpu" / rel))
    assert DEFAULT_DATASET == (REPO / "rag_dpo_tpu" / "evals" / "data"
                               / "qa_dataset.json")
    assert len(load_qa_dataset()) == 48
