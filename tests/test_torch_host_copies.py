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
    "utils/paths.py",
    "utils/query_logger.py",
]


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
