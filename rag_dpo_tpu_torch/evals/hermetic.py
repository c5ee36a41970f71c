"""Hermetic eval replay through the port — the committed-record gate.

Port of `rag_dpo_tpu/evals/hermetic.py`. The replay builds the synthetic
corpus from the vendored qa_dataset, indexes it with the port's tiny
encoder (reference attention, ColBERT dim 32, ELL width 48), calibrates
the fusion weights on content-derived queries, and replays the 48
questions through `create_pipeline` with the extractive fake LLM. Its
record is gated like-for-like against the JAX package's committed
`results_hermetic_*.json` (same `eval_version`, encoder kind and
reranker), which it reads and never writes:

    python -m rag_dpo_tpu_torch.evals.hermetic [--device cpu]

replays once (the replay is deterministic) with the committed trained
encoder, prints the gated values and the gate's verdict, and exits 1 on
a regression. It saves no file.

Weights: `encoder_params` is a Flax tree as numpy (`load_trained_params()`
for the committed trained checkpoint), or None for the seeded random init.
The port draws Flax's init from the same seed (`models/flax_init.py`), so
its own random-init replay is gated against the committed random-init
record, on the CPU and on the card, and the `"cross"` arm's random
cross-encoder is JAX's, its replay equal to the JAX arm's. No `"cross"`
record is committed; `"maxsim"` has no committed series either.

`EVAL_VERSION`, `GATED_METRICS` and the gate functions are the JAX
module's, unchanged.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

EVAL_VERSION = 2

# metrics gated against the committed records, with the max allowed
# regression per metric (scores are deterministic on CPU; the tolerance
# absorbs legitimate small re-tuning — anything larger must consciously
# regenerate the records)
GATED_METRICS = {
    "global_score_mean": 0.02,
    "faithfulness": 0.02,
    "source_score": 0.02,
    "cited_source_hit_rate_at_5": 0.02,
    "true_doc_hit_rate_at_5": 0.02,
}

# the JAX package's committed records (data files, read, not imported)
RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[2] / "rag_dpo_tpu"
               / "evals" / "results")

# half the calibration set wraps the content terms in generic French
# question scaffolding (the JAX recipe: calibration has to see
# question-shaped input to price the dense arm honestly)
_TEMPLATES = (
    "Quelles sont les conditions concernant {x} ?",
    "Que faut-il savoir sur {x} dans une entreprise ?",
    "Comment s'applique {x} et quels mécanismes sont prévus ?",
)


def run_hermetic_replay(n_runs: int = 3, encoder_params=None,
                        encoder_label: str | None = None,
                        reranker: str = "none", device=None) -> dict:
    """Build the synthetic stack on `device` (default: the first CUDA
    card), replay the 48-question dataset, and return the regression
    record, in the JAX record's format.

    `reranker`: "none" | "cross" (CrossEncoderReranker) | "maxsim"
    (MaxSimReranker over the stored ColBERT vectors)."""
    from ..ingest.indexer import CorpusIndexer
    from ..models import BgeM3Config, EncoderConfig
    from ..providers import Embedder, EmbedderConfig
    from ..rag import create_pipeline
    from ..retrieval import (
        HybridRetriever,
        RetrieverConfig,
        calibrate_fusion_weights,
    )
    from . import EvalHarness, load_qa_dataset
    from .harness import EvalConfig
    from .retrieval_eval import cited_source_hit_rate, true_doc_hit_rate
    from .synthetic import (
        CORPUS_VERSION,
        ExtractiveFakeLLM,
        build_synthetic_corpus,
    )
    from .train_encoder import build_training_pairs

    if reranker not in ("none", "cross", "maxsim"):
        raise ValueError(f"reranker must be none, cross or maxsim, got "
                         f"{reranker!r}")
    dataset = load_qa_dataset()
    chunks = build_synthetic_corpus(dataset)
    embedder = Embedder(
        EmbedderConfig(
            model=BgeM3Config(
                encoder=EncoderConfig.tiny(use_flash_attention=False),
                colbert_dim=32,
            ),
            batch_size=64,
        ),
        params=encoder_params,
        device=device,
    )
    # the maxsim arm reranks against stored ColBERT multi-vectors
    # (colbert_len 96 covers the synthetic chunks' token counts)
    maxsim = reranker == "maxsim"
    index, stats, report = CorpusIndexer(
        embedder, ell_width=48, with_colbert=maxsim,
        colbert_len=96 if maxsim else 0,
    ).build(chunks, mode="reset")
    if not report.verification["self_retrieval_ok"]:
        raise RuntimeError(f"index self-check failed: {report.verification}")

    # fusion weights calibrated on content-derived queries, never on the
    # 48 eval questions (retrieval/calibrate.py)
    cal_pairs, cal_ids = build_training_pairs(chunks,
                                              return_chunk_ids=True)
    labeled = []
    for i, ((q, _), cid) in enumerate(zip(cal_pairs, cal_ids)):
        if not cid.startswith("qa_"):  # live docs: the prior
            continue  # intentionally demotes archive/nav targets
        labeled.append((q, cid))
        labeled.append((_TEMPLATES[i % len(_TEMPLATES)].format(x=q), cid))
    retr_cfg, cal_report = calibrate_fusion_weights(
        index, embedder, stats, labeled,
        base_config=RetrieverConfig(use_prefilter=False))
    rr = None
    if reranker == "cross":
        from ..retrieval.reranker import default_reranker

        rr = default_reranker(embedder)
    elif maxsim:
        from ..retrieval.reranker import MaxSimReranker

        rr = MaxSimReranker(index, embedder)

    pipe_cfg = dataclasses.replace(
        RetrieverConfig(),
        weight_original=retr_cfg.weight_original,
        weight_expansion=retr_cfg.weight_expansion,
        weight_bm25_original=retr_cfg.weight_bm25_original,
        weight_bm25_expansion=retr_cfg.weight_bm25_expansion,
    )
    pipe = create_pipeline(
        index, embedder, ExtractiveFakeLLM(), bm25_stats=stats,
        use_reranker=rr is not None, reranker=rr,
        use_expansion=False,
        retriever_config=pipe_cfg,
    )
    harness = EvalHarness(pipe, embedder=embedder,
                          config=EvalConfig(n_runs=n_runs))
    multi = harness.run_multi(dataset)

    retriever = HybridRetriever(
        index, embedder, bm25_stats=stats, config=retr_cfg,
    )
    hits = cited_source_hit_rate(dataset, retriever, k=5)
    true_hits = true_doc_hit_rate(dataset, retriever, k=5)
    return {
        "kind": "hermetic_replay",
        "eval_version": EVAL_VERSION,
        "corpus_version": CORPUS_VERSION,
        "n_chunks": len(chunks),
        "encoder": encoder_label or (
            "trained" if encoder_params is not None else "random-init"),
        "reranker": reranker,
        "notes": "synthetic near-miss corpus from the vendored "
                 "qa_dataset; tiny encoder; extractive fake LLM — "
                 "tracks the retrieval/orchestration path, not LLM "
                 "quality",
        "n_questions": len(dataset),
        "global_score": multi["global_score"],
        "high_spread_questions": multi["high_spread_questions"],
        "per_category": multi["runs"][0]["per_category"],
        "conciseness": multi["runs"][0]["conciseness"],
        "faithfulness": multi["runs"][0]["faithfulness"],
        "source_score": multi["runs"][0]["source_score"],
        "cited_source_hit_rate_at_5": hits["mean_hit_rate"],
        "true_doc_hit_rate_at_5": true_hits["hit_rate"],
        "fusion_calibration": {"chosen": cal_report["chosen"],
                               "n_queries": cal_report["n_queries"]},
        "total_time_seconds": multi["total_time_seconds"],
    }


def gated_values(record: dict) -> dict:
    vals = {
        "global_score_mean": record["global_score"]["mean"],
        "faithfulness": record["faithfulness"],
        "source_score": record["source_score"],
        "cited_source_hit_rate_at_5":
            record["cited_source_hit_rate_at_5"],
    }
    if record.get("eval_version", 1) >= 2:
        vals["true_doc_hit_rate_at_5"] = record["true_doc_hit_rate_at_5"]
    return vals


def load_committed_records(results_dir=RESULTS_DIR) -> list[dict]:
    records = []
    for path in sorted(pathlib.Path(results_dir).glob(
            "results_hermetic_*.json")):
        records.append(json.loads(path.read_text()))
    return records


def comparable_records(records, record) -> list[dict]:
    """The committed records a new record may be gated against:
    same eval_version, same encoder kind, same reranker config
    (random-init floors never judge a trained run and vice versa;
    reranker A/B records form their own series)."""
    version = record.get("eval_version", 1)
    encoder = record.get("encoder", "random-init")
    rr = record.get("reranker", "none")
    return [r for r in records
            if r.get("eval_version", 1) == version
            and r.get("encoder", "random-init") == encoder
            and r.get("reranker", "none") == rr]


def baseline_from_records(records) -> dict:
    """Per-metric best across committed records — regressions are judged
    against the best the framework has ever recorded, so a slow ratchet
    downward across rounds cannot hide."""
    base: dict = {}
    for rec in records:
        for k, v in gated_values(rec).items():
            base[k] = max(base.get(k, float("-inf")), v)
    return base


def check_against_baseline(record: dict, records=None) -> list[str]:
    """Return the list of regression messages (empty = gate passes)."""
    records = records if records is not None else load_committed_records()
    records = comparable_records(records, record)
    if not records:
        return [
            f"no committed hermetic records for eval_version="
            f"{record.get('eval_version', 1)} encoder="
            f"{record.get('encoder', 'random-init')} — commit one via "
            "scripts/run_hermetic_replay.py"
        ]
    base = baseline_from_records(records)
    got = gated_values(record)
    failures = []
    for metric, tol in GATED_METRICS.items():
        if metric not in base or metric not in got:
            continue
        if got[metric] < base[metric] - tol:
            failures.append(
                f"{metric} regressed: {got[metric]:.4f} < committed "
                f"{base[metric]:.4f} - {tol}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Replay the 48 hermetic questions through the port with "
                    "the committed trained encoder and gate the record "
                    "against the committed ones.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    from .train_encoder import load_trained_params

    record = run_hermetic_replay(n_runs=1,
                                 encoder_params=load_trained_params(),
                                 device=args.device)
    print(json.dumps(gated_values(record)))
    failures = check_against_baseline(record)
    if failures:
        print("REGRESSION vs committed records:")
        for f in failures:
            print(f"  {f}")
        return 1
    print("gate: OK (no metric below the best committed record)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
