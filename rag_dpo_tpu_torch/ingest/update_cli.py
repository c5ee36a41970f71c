"""Incremental corpus refresh CLI — the `update_cnil.py` analog.

    python -m rag_dpo_tpu_torch.ingest.update_cli [--dry-run] [--status]
        [--force-reindex] [--root DIR] [--seeds URL …] [--device DEV]

Conditional scrape (If-Modified-Since/304) → re-process only the changed
documents → index upsert → summaries for changed docs. The embedder and
the index run on `--device` (default: the first CUDA card).
"""

from __future__ import annotations

import argparse
import json
import sys

from ..utils.logging import setup_structured_logging
from ..utils.paths import default_paths
from .pipeline import PipelineContext
from .scraper import Scraper, ScraperConfig
from .update import IncrementalUpdater


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--status", action="store_true")
    ap.add_argument("--force-reindex", action="store_true")
    ap.add_argument("--root", default=None)
    ap.add_argument("--llm-mode", default="local")
    ap.add_argument("--seeds", nargs="*",
                    default=["https://www.cnil.fr/fr/"])
    ap.add_argument("--device", default=None,
                    help="torch device of the encoder and the index "
                         "(default: the first CUDA card)")
    args = ap.parse_args(argv)

    paths = default_paths(args.root).ensure()
    setup_structured_logging(paths.logs / "update.jsonl")

    from ..providers import Embedder
    from ..providers.factory import create_llm

    scraper = Scraper(paths.raw, ScraperConfig())
    ctx = PipelineContext(paths=paths, llm=create_llm(args.llm_mode),
                          embedder=Embedder(device=args.device))
    updater = IncrementalUpdater(scraper, ctx)

    if args.status:
        print(json.dumps(updater.status(), indent=1))
        return 0
    result = updater.update(dry_run=args.dry_run,
                            force_reindex=args.force_reindex)
    print(json.dumps(result, ensure_ascii=False, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
