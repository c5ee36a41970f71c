"""Corpus rebuild CLI — the `rebuild_pipeline.py` analog.

    python -m rag_dpo_tpu_torch.ingest.rebuild [--from STEP] [--only STEP]
        [--steps a,b,c] [--check] [--test N] [--fresh]
        [--root DIR] [--llm-mode local|hybrid|fake] [--device DEV]
        [--weights NPZ | --corpus JSONL]

Steps: filter organize dedup classify chunk index summaries cleanup tag
(the reference's phases 3→6d under stable names). The embedder, and so
the index, run on `--device` (default: the first CUDA card; `cpu` asks for
the CPU).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys

from ..utils.logging import setup_structured_logging
from ..utils.paths import default_paths
from .pipeline import IngestPipeline, PipelineContext, STEP_ORDER


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--from", dest="from_step", choices=STEP_ORDER)
    ap.add_argument("--only", choices=STEP_ORDER)
    ap.add_argument("--steps", help="comma-separated step subset")
    ap.add_argument("--check", action="store_true",
                    help="print the plan, run nothing")
    ap.add_argument("--test", type=int, metavar="N",
                    help="limit to the first N documents")
    ap.add_argument("--fresh", action="store_true",
                    help="wipe derived artifacts first")
    ap.add_argument("--root", default=None)
    ap.add_argument("--llm-mode", default="local",
                    choices=["local", "hybrid", "hosted", "fake"])
    ap.add_argument("--weights", default=None, metavar="NPZ",
                    help="converted BGE-M3 params "
                         "(scripts/convert_weights.py output); default "
                         "is deterministic random init")
    ap.add_argument("--corpus", default=None, metavar="JSONL",
                    help="pre-chunked corpus (processed_chunks.jsonl "
                         "format): skip the scrape/chunk phases and "
                         "index this directly")
    ap.add_argument("--device", default=None,
                    help="torch device of the encoder and the index "
                         "(default: the first CUDA card)")
    args = ap.parse_args(argv)

    paths = default_paths(args.root).ensure()
    setup_structured_logging(paths.logs / "ingest.jsonl")

    if args.fresh:
        for artifact in (paths.processed_chunks, paths.document_summaries,
                         paths.document_metadata, paths.keep_manifest):
            artifact.unlink(missing_ok=True)
        shutil.rmtree(paths.index_dir, ignore_errors=True)

    from ..providers import Embedder
    from ..providers.factory import create_llm

    embedder = Embedder(device=args.device)
    if args.weights:
        from ..models.bge_m3 import BgeM3Config
        from ..models.convert import load_params_npz
        from ..providers.embedding import EmbedderConfig

        # real converted weights imply the production architecture
        # (XLM-RoBERTa-large backbone), not the default test-tiny config
        embedder = Embedder(
            EmbedderConfig(model=BgeM3Config()),
            params=load_params_npz(args.weights),
            device=args.device,
        )

    ctx = PipelineContext(
        paths=paths,
        llm=create_llm(args.llm_mode),
        embedder=embedder,
    )
    if args.corpus:
        from .indexer import load_chunks_jsonl

        ctx.chunks = load_chunks_jsonl(args.corpus)
    pipeline = IngestPipeline(ctx, test_limit=args.test)
    steps = args.steps.split(",") if args.steps else None
    if steps:
        unknown = [s for s in steps if s not in STEP_ORDER]
        if unknown:
            ap.error(f"unknown step(s) {unknown}; valid: {STEP_ORDER}")
    if args.corpus and not (args.from_step or args.only or steps):
        args.from_step = "index"  # chunks supplied: start at indexing
    reports = pipeline.run(
        from_step=args.from_step,
        only=args.only,
        steps=steps,
        check=args.check,
    )
    print(json.dumps(reports, ensure_ascii=False, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
