"""The Quick start's two commands through the port, on the CPU.

`python -m rag_dpo_tpu_torch.check_install` is the root `check_install.py`
for the PyTorch and CUDA installation: the checks that do not name JAX or
its packages keep their labels, order and French messages, and the
summary line is the root script's. Without a card and without `--device
cpu` the card's checks fail (no fall back to the CPU). `python -m
rag_dpo_tpu_torch.app.rag_cli` is the root `test_rag_cli.py`: the same
canned questions, per-question printout and summary line, on the demo
stack, with one question, and over a saved index with the agent.
"""

import importlib.util
import pathlib
import re
import sys

import pytest
import torch

from rag_dpo_tpu_torch import check_install
from rag_dpo_tpu_torch.app import rag_cli
from rag_dpo_tpu_torch.app.demo import build_demo_stack

REPO = pathlib.Path(__file__).resolve().parent.parent
# the root script's checks that name JAX or its packages, and the port's
# that name the CUDA installation
JAX_ONLY = {"JAX devices", "package flax", "package optax",
            "package transformers"}
PORT_ONLY = {"CUDA devices", "package torch", "package triton", "nvcc"}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def isolated(tmp_path, monkeypatch):
    """The data tree under a temporary root; the LLM endpoint a closed
    loopback port."""
    monkeypatch.setenv("RAGDPO_TPU_ROOT", str(tmp_path))
    monkeypatch.setenv("RAGDPO_LLM_BASE_URL", "http://127.0.0.1:9")
    return tmp_path


def _root_script(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _checks(printed: str) -> list:
    """→ [(mark, label, detail)] of each check line, then the summary."""
    lines = [ln for ln in printed.splitlines() if ln.strip()]
    out = []
    for ln in lines[:-1]:
        m = re.match(r"^(✅|⚠️ |❌) (.+?)(?: — (.*))?$", ln)
        assert m, ln
        out.append(m.groups())
    return out, lines[-1]


def test_check_install_keeps_the_root_scripts_checks(isolated, capsys):
    assert _root_script("check_install").main() == 0
    want, want_summary = _checks(capsys.readouterr().out)
    assert check_install.main(["--device", "cpu"]) == 0
    got, summary = _checks(capsys.readouterr().out)
    assert summary == want_summary == "Prêt."
    assert [g[1] for g in got if g[1] not in PORT_ONLY] \
        == [w[1] for w in want if w[1] not in JAX_ONLY]
    shared = {g[1]: g for g in got}
    for mark, label, detail in want:
        if label in JAX_ONLY or label == "programme device":
            continue
        assert shared[label] == (mark, label, detail), label
    assert shared["programme device"] == ("✅", "programme device",
                                          "approx_topk ok (CPU)")
    assert (isolated / "data" / "index").is_dir()


def test_check_install_fails_without_a_card(isolated, capsys):
    assert not torch.cuda.is_available()
    assert check_install.main([]) == 1
    got, summary = _checks(capsys.readouterr().out)
    failed = [label for mark, label, _ in got if mark == "❌"]
    assert failed == ["CUDA devices", "nvcc", "programme device"]
    assert summary == "3 problème(s)."


def _answers(printed: str) -> tuple:
    """→ (the questions asked, each one's closing line, the summary)."""
    lines = printed.splitlines()
    asked = [ln[4:] for ln in lines if ln.startswith("=== ")]
    tails = [ln for ln in lines if ln.startswith("--- intent=")]
    return asked, tails, lines[-1]


def test_rag_cli_canned_as_the_root_script(isolated, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["test_rag_cli.py", "--canned"])
    assert _root_script("test_rag_cli").main() == 0
    want = _answers(capsys.readouterr().out)
    assert rag_cli.main(["--canned", "--device", "cpu"]) == 0
    got = _answers(capsys.readouterr().out)
    assert got[0] == want[0] == rag_cli.CANNED_QUESTIONS
    pattern = (r"--- intent=\w+ sources=\d+ temps=\d+\.\d\ds "
               r"\(retrieval \d+\.\d\ds\)$")
    assert all(re.match(pattern, t) for t in got[1] + want[1])
    for summary in (got[2], want[2]):
        assert re.match(r"==== 5/5 ok, latence moyenne \d+\.\d\ds, "
                        r"citations moyennes \d+\.\d$", summary), summary


def test_rag_cli_one_question_and_an_index_with_the_agent(
        isolated, capsys):
    question = rag_cli.CANNED_QUESTIONS[1]
    assert rag_cli.main([question, "--device", "cpu"]) == 0
    asked, _, summary = _answers(capsys.readouterr().out)
    assert asked == [question] and summary.startswith("==== 1/1 ok")
    _, ctx = build_demo_stack(device="cpu")
    ctx["index"].save(isolated / "index")
    assert rag_cli.main([question, "--agent", "--index",
                         str(isolated / "index"), "--device", "cpu"]) == 0
    asked, tails, summary = _answers(capsys.readouterr().out)
    assert asked == [question] and summary.startswith("==== 1/1 ok")
