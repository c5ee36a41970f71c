"""The learned-quality loop through the port (`scripts/train_eval_encoder.py`).

`python -m rag_dpo_tpu_torch.evals.train_encoder` trains the tiny encoder
with the committed trained record's recipe, replays the 48 questions with
it and gates the record. Here: `main` at a few steps on the CPU writes its
npz and record under `--out`, never into the JAX package, and
`load_trained_params` reads the npz back; and on stubbed replay records
the port's verdict is the JAX script's (a pass, a random-init record not
beaten, a regression against the committed trained records), its lines
among the script's printout.
"""

import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import rag_dpo_tpu.evals.hermetic as jhermetic
import rag_dpo_tpu.evals.train_encoder as jtrain_encoder
from rag_dpo_tpu.evals.harness import EvalHarness as JEvalHarness
from rag_dpo_tpu_torch.evals import train_encoder
from rag_dpo_tpu_torch.evals.hermetic import RESULTS_DIR, gated_values

REPO = pathlib.Path(__file__).resolve().parent.parent
TRAINED = RESULTS_DIR / "results_hermetic_20260820_133505.json"


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_eval_encoder", REPO / "scripts" / "train_eval_encoder.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_main_writes_under_out_and_reads_back(tmp_path, capsys):
    jax_data = REPO / "rag_dpo_tpu" / "evals" / "data"
    before = sorted((p.name, p.stat().st_mtime_ns) for p in jax_data.iterdir())
    out = tmp_path / "runs" / "encoder.npz"
    code = train_encoder.main(["--device", "cpu", "--out", str(out),
                               "--steps", "4"])
    printed = capsys.readouterr().out.splitlines()
    assert sorted((p.name, p.stat().st_mtime_ns)
                  for p in jax_data.iterdir()) == before
    assert out.is_file()
    (saved,) = out.parent.glob("results_hermetic_*.json")
    record = json.loads(saved.read_text())
    assert record["encoder"] == "trained" and record["n_questions"] == 48
    assert record["train_recipe"] == "plain-inbatch-4"
    train = json.loads(printed[0].removeprefix("train: "))
    assert train["steps"] == 4 and train["n_hard_negatives"] == 0
    assert train["train_seconds"] > 0 and train["loss_first"] > 0
    assert json.loads(printed[1].removeprefix("trained: ")) \
        == gated_values(record)
    assert code == train_encoder.gate(record)[0]
    assert printed[-1] in ("gate: OK",
                           "TRAINED DID NOT BEAT RANDOM-INIT true_doc@5") \
        or printed[-1].startswith("  ")
    params = train_encoder.load_trained_params(out)["params"]
    emb = params["encoder"]["word_embeddings"]["embedding"]
    assert emb.dtype == np.float32 and np.isfinite(emb).all()


_BASE = json.loads(TRAINED.read_text())
SCENARIOS = {
    "pass": dict(_BASE),
    "random_init_not_beaten": dict(_BASE, true_doc_hit_rate_at_5=0.8125),
    "regression": dict(_BASE, source_score=0.75),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_gate_is_the_jax_scripts(monkeypatch, capsys, name):
    record = SCENARIOS[name]
    monkeypatch.setattr(jtrain_encoder, "train_eval_encoder",
                        lambda out_npz: {"steps": 0})
    monkeypatch.setattr(jtrain_encoder, "load_trained_params",
                        lambda path: None)
    monkeypatch.setattr(jhermetic, "run_hermetic_replay",
                        lambda n_runs, encoder_params: dict(record))
    monkeypatch.setattr(JEvalHarness, "save_report",
                        lambda self, report, out_dir, tag: "not saved")
    want = _jax_script().main()
    jax_print = capsys.readouterr().out.splitlines()
    code, lines = train_encoder.gate(record)
    assert code == want == (0 if name == "pass" else 1)
    for line in lines:
        assert line in jax_print
    assert jax_print[-1] == lines[-1]


def test_port_main_saves_nothing_into_the_jax_package():
    assert train_encoder.RUNS_DIR.parent.name == "evals"
    assert "rag_dpo_tpu_torch" in train_encoder.RUNS_DIR.parts
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "rag_dpo_tpu_torch/evals/runs/" in ignored
    assert sys.modules["rag_dpo_tpu_torch.evals.train_encoder"].TRAINED_NPZ \
        .parent == REPO / "rag_dpo_tpu" / "evals" / "data"
