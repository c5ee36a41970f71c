"""The LLM-judge axis through the port (`scripts/run_judge_axis.py`'s).

    python -m rag_dpo_tpu_torch.evals.judge_axis [--device cpu] \
        [--questions 48] [--out DIR]

Builds the hermetic v2 stack (the committed trained encoder when its npz
exists, else random-init; the extractive fake LLM), wires a
Mistral-Nemo-12B int8 `TPULLMProvider` (random init, bf16 parameters,
4,096 positions) as the judge in "choose" mode (a score bucket and an
"erreur factuelle" veto by constrained choice, so every verdict parses
even from random weights), replays the questions with `use_llm_judge`,
traces the first 8 judgements (buckets and vetoes), saves the record
under `--out` (default: the loop's `RUNS_DIR`) and exits 1 if any judge
score is None.

`evals/harness.py::llm_judge_score_choose` returns None on any exception,
as the reference's does; `run_judge_axis` wraps the judge so that the
first exception it raised is kept and printed, and a None score fails
the command instead of passing silently. Random 12B weights make the
verdicts noise: what the run shows is the axis itself (scoring on the
card, the 0.60·judge + 0.40·semantic combine, the veto), and its time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback

TRACE_SAMPLE = 8   # the judgements re-traced for buckets and vetoes


class RecordingJudge:
    """A judge provider whose `choose` keeps the first exception it raised
    (with its traceback) and the seconds spent in it, then raises as
    before; the harness is left as it is."""

    def __init__(self, llm):
        self.llm = llm
        self.first_error: str | None = None
        self.seconds = 0.0
        self.calls = 0

    def choose(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.llm.choose(*args, **kwargs)
        except Exception:
            if self.first_error is None:
                self.first_error = traceback.format_exc()
            raise
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1


def device_info(dev) -> dict:
    """The card's name and `nvidia-smi`'s power limit, or the CPU."""
    import subprocess

    import torch

    dev = torch.device(dev)
    if dev.type != "cuda":
        return {"name": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, check=True).stdout.strip()
    return {"name": torch.cuda.get_device_name(dev), "nvidia_smi": smi}


def build_judge(device=None):
    """The script's judge: Mistral-Nemo-12B, int8 projections, the tied
    embedding, bf16 parameters, 4,096 positions, 8 new tokens; random
    init on `device`. → (provider, load seconds)."""
    import torch

    from ..models.decoder import DecoderConfig
    from ..providers.tpu_llm import TPULLMProvider

    cfg = dataclasses.replace(
        DecoderConfig.mistral_nemo_12b(), quantize_weights=True,
        tie_embeddings=True, max_seq_len=4096, param_dtype=torch.bfloat16)
    judge = TPULLMProvider(cfg, max_new_tokens=8, device=device)
    t0 = time.perf_counter()
    judge.generator.load()
    if judge.generator.device.type == "cuda":
        torch.cuda.synchronize(judge.generator.device)
    return judge, time.perf_counter() - t0


def run_judge_axis(judge, n_questions: int = 48, device=None) -> dict:
    """Replay the first `n_questions` hermetic questions through the
    stack with `judge` (a provider with `choose`) in choose mode. → the
    script's record, with `judge_seconds` (inside the judge's calls),
    `first_judge_error` and the device."""
    from ..ingest.indexer import CorpusIndexer
    from ..models import BgeM3Config, EncoderConfig
    from ..ops import default_device
    from ..providers import Embedder, EmbedderConfig
    from ..rag import create_pipeline
    from . import EvalHarness, load_qa_dataset
    from .harness import (
        JUDGE_SCORE_BUCKETS,
        EvalConfig,
        llm_judge_score_choose,
    )
    from .synthetic import (
        CORPUS_VERSION,
        ExtractiveFakeLLM,
        build_synthetic_corpus,
    )
    from .train_encoder import TRAINED_NPZ, load_trained_params

    device = default_device(device)
    dataset = load_qa_dataset()
    chunks = build_synthetic_corpus(dataset)
    encoder_params, encoder_label = None, "random-init"
    if pathlib.Path(TRAINED_NPZ).exists():
        encoder_params = load_trained_params(TRAINED_NPZ)
        encoder_label = "trained"
    embedder = Embedder(
        EmbedderConfig(
            model=BgeM3Config(
                encoder=EncoderConfig.tiny(use_flash_attention=False),
                colbert_dim=32),
            batch_size=64),
        params=encoder_params, device=device)
    index, stats, report = CorpusIndexer(
        embedder, ell_width=48).build(chunks, mode="reset")
    if not report.verification["self_retrieval_ok"]:
        raise RuntimeError(f"index self-check failed: {report.verification}")
    pipe = create_pipeline(index, embedder, ExtractiveFakeLLM(),
                           bm25_stats=stats, use_expansion=False)

    recording = RecordingJudge(judge)
    harness = EvalHarness(
        pipe, embedder=embedder, judge_llm=recording,
        config=EvalConfig(use_llm_judge=True, judge_mode="choose",
                          n_runs=1))
    questions = dataset[:n_questions]
    t0 = time.perf_counter()
    rep = harness.run(questions)
    wall = time.perf_counter() - t0
    judge_seconds, judge_calls = recording.seconds, recording.calls

    # buckets and vetoes: the judge again on the first answers, traced
    # (evaluate_single records only the final score)
    traces = []
    for item in questions[:TRACE_SAMPLE]:
        resp = pipe.query(item["question"])
        tr: dict = {}
        tr["score"] = llm_judge_score_choose(recording, item, resp.answer,
                                             trace=tr)
        tr["id"] = item["id"]
        traces.append(tr)

    judged = [r["judge_score"] for r in rep["results"]
              if r["judge_score"] is not None]
    return {
        "kind": "judge_axis",
        "eval_version": 2,
        "corpus_version": CORPUS_VERSION,
        "encoder": encoder_label,
        "judge": "tpu-12b-int8-choose",
        "judge_model_weights": "random-init (no download)",
        "judge_mode": "choose",
        "score_buckets": list(JUDGE_SCORE_BUCKETS),
        "n_questions": rep["n_questions"],
        "n_judged_non_null": len(judged),
        "judge_mean": round(sum(judged) / max(len(judged), 1), 4),
        "judge_vetoes_sample": sum(1 for t in traces if t.get("veto")),
        "bucket_sample": [t.get("bucket") for t in traces],
        "veto_sample": [("oui" if t["veto"] else "non") if "veto" in t
                        else None for t in traces],
        "global_score_with_judge": rep["global_score"],
        "per_category": rep["per_category"],
        "faithfulness": rep["faithfulness"],
        "source_score": rep["source_score"],
        "judge_wall_seconds": round(wall, 1),
        "judge_seconds": judge_seconds,
        "judge_calls": judge_calls,
        "judge_seconds_per_question": judge_seconds / max(len(questions), 1),
        "first_judge_error": recording.first_error,
        "device": device_info(device),
        "notes": "judge axis executed through the port via constrained "
                 "choose (score bucket + erreur_factuelle veto); "
                 "random-init 12B weights: the verdict values are noise, "
                 "the axis mechanics (device scoring, combine, veto) are "
                 "real. Not gated against non-judge hermetic series.",
    }


def verdict(record: dict) -> tuple[int, str]:
    """The script's exit code and closing line: 1 if any judge score is
    None."""
    if not record["n_judged_non_null"] \
            or record["n_judged_non_null"] != record["n_questions"]:
        return 1, "JUDGE AXIS INCOMPLETE: null judge scores present"
    return 0, "judge axis: OK (all questions judged non-null)"


def main(argv=None) -> int:
    from .train_encoder import RUNS_DIR

    ap = argparse.ArgumentParser(
        description="Judge the hermetic replay's answers with the "
                    "Mistral-Nemo-12B int8 decoder in choose mode.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--questions", type=int, default=48)
    ap.add_argument("--out", type=pathlib.Path, default=RUNS_DIR,
                    help="where the record is saved")
    args = ap.parse_args(argv)
    from . import EvalHarness

    judge, load_s = build_judge(args.device)
    print(f"judge 12B int8 loaded in {load_s:.1f}s", flush=True)
    record = run_judge_axis(judge, args.questions, args.device)
    record["judge_load_seconds"] = load_s
    path = EvalHarness.save_report(None, record, args.out, tag="judge_axis")
    print(json.dumps({k: v for k, v in record.items()
                      if k not in ("per_category", "first_judge_error")},
                     indent=1))
    print(f"saved {path}")
    if record["first_judge_error"]:
        print("first judge error:\n" + record["first_judge_error"])
    code, line = verdict(record)
    print(line)
    return code


if __name__ == "__main__":
    sys.exit(main())
