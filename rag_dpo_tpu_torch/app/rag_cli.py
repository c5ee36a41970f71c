"""CLI smoke test of the port — the root `test_rag_cli.py`'s counterpart
(the reference `test_rag.py` analog):

    python -m rag_dpo_tpu_torch.app.rag_cli [QUESTION] [--canned] \
        [--interactive] [--agent] [--index DIR] [--llm URL] [--model NAME] \
        [--device cpu]

Modes (reference :181-266): single question, 5 canned DPO questions, or an
interactive REPL; prints success/latency/citation summary. Runs against
the offline demo stack by default; `--index DIR` loads a real index
checkpoint and `--llm URL` a live Ollama-compatible endpoint; `--agent`
switches to the agent pipeline. Everything runs on the first CUDA card
unless `--device cpu` asks for the CPU (the root script's `--tpu`).
"""

from __future__ import annotations

import argparse
import sys
import time

CANNED_QUESTIONS = [
    "Quel est le délai pour notifier une violation de données à la CNIL ?",
    "Quand une AIPD est-elle obligatoire ?",
    "Que doit contenir le registre des traitements ?",
    "Quelles clauses doit contenir un contrat de sous-traitance ?",
    "Dans quel délai répondre à une demande de droit d'accès ?",
]


def build_pipeline(args):
    from ..providers import FakeLLMProvider, HTTPLLMProvider

    llm = None
    if args.llm:
        provider = HTTPLLMProvider(base_url=args.llm, model=args.model)
        if provider.is_available():
            llm = provider
        else:
            print(f"[warn] LLM endpoint {args.llm} unreachable — "
                  "using deterministic fake")
    llm = llm or FakeLLMProvider()

    if args.index:
        from ..agent import create_agent_pipeline
        from ..index import DeviceIndex
        from ..models import BgeM3Config, EncoderConfig
        from ..providers import Embedder, EmbedderConfig
        from ..rag import create_pipeline

        index = DeviceIndex.load(args.index, device=args.device)
        embedder = Embedder(EmbedderConfig(
            model=BgeM3Config(
                encoder=EncoderConfig.tiny(use_flash_attention=False),
                colbert_dim=32,
            )
        ), device=args.device)
        factory = create_agent_pipeline if args.agent else create_pipeline
        return factory(index, embedder, llm)

    from .demo import build_demo_stack

    pipe, _ = build_demo_stack(llm=llm, agent=args.agent,
                               device=args.device)
    return pipe


def run_question(pipe, question: str) -> dict:
    t0 = time.time()
    resp = pipe.query(question)
    ok = bool(resp.answer) and not resp.error
    print(f"\n=== {question}")
    print(resp.answer[:1500])
    print(f"--- intent={resp.intent} sources={len(resp.sources)} "
          f"temps={resp.total_time:.2f}s "
          f"(retrieval {resp.retrieval_time:.2f}s)")
    return {"ok": ok, "time": time.time() - t0,
            "cited": len(resp.sources)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("question", nargs="?", help="single question mode")
    ap.add_argument("--canned", action="store_true",
                    help="run the 5 canned DPO questions")
    ap.add_argument("--interactive", action="store_true")
    ap.add_argument("--agent", action="store_true",
                    help="use the agent pipeline")
    ap.add_argument("--index", help="load a real index checkpoint dir")
    ap.add_argument("--llm", help="Ollama-compatible endpoint URL")
    ap.add_argument("--model", default="mistral-nemo:12b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)

    pipe = build_pipeline(args)

    if args.interactive:
        print("REPL — question vide pour quitter.")
        while True:
            try:
                q = input("\n> ").strip()
            except (EOFError, KeyboardInterrupt):
                break
            if not q:
                break
            run_question(pipe, q)
        return 0

    questions = CANNED_QUESTIONS if args.canned or not args.question \
        else [args.question]
    results = [run_question(pipe, q) for q in questions]
    n_ok = sum(r["ok"] for r in results)
    print(f"\n==== {n_ok}/{len(results)} ok, "
          f"latence moyenne {sum(r['time'] for r in results) / len(results):.2f}s, "
          f"citations moyennes {sum(r['cited'] for r in results) / len(results):.1f}")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
