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
    "agent/tools.py",
    "app/__init__.py",
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
    "models/__init__.py",
    "parallel/__init__.py",
    "retrieval/types.py",
    "rag/__init__.py",
    "rag/acronyms.py",
    "rag/context.py",
    "rag/expander.py",
    "rag/generator.py",
    "rag/intent.py",
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
    "tokenize/hf.py",
    "utils/alerter.py",
    "utils/config.py",
    "utils/logging.py",
    "utils/paths.py",
    "utils/query_logger.py",
]

# copies that differ from their originals in these lines only (JAX's, the
# port's): where HTML's tree comes from (bs4 and lxml are not installed
# beside the CUDA stack), the device a saved index loads on, and the app
# surfaces' device (`--device` / `device=` / RAGDPO_DEVICE in place of the
# JAX package's CPU pin, torch's device inventory in place of jax's), and
# the agent's and the pipeline's spans (`utils/profiling.py`) in place of
# JAX's `time.time()` timers. A pair applies to every occurrence, in
# order; a compiled pattern is a regular expression
_SOUP = ("from bs4 import BeautifulSoup", "from .htmltree import BeautifulSoup")
_LOAD_ON_EMBEDDER = 'device=getattr(self.ctx.embedder, "device", None))'
_SPANS = "from ..utils.profiling import "
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
    "app/demo.py": [
        ("def build_demo_stack(llm=None, agent: bool = False, "
         "use_reranker=True):\n",
         "def build_demo_stack(llm=None, agent: bool = False, "
         "use_reranker=True,\n                     device=None):\n"),
        ("        batch_size=8,\n    ))\n",
         "        batch_size=8,\n    ), device=device)\n"),
        ("row_block=8))\n", "row_block=8), device=embedder.device)\n"),
        ("    summary = SummaryBm25Index()\n",
         "    summary = SummaryBm25Index(device=embedder.device)\n"),
    ],
    "app/server.py": [
        ("                import jax\n", "                import torch\n"),
        ('                    "devices": [str(d) for d in jax.devices()],\n',
         '                    "devices": [torch.cuda.get_device_name(i) '
         'for i in\n                                '
         'range(torch.cuda.device_count())]\n                    '
         'or ["cpu"],\n'),
        ("def build_system(agent_too: bool = True, llm=None) -> dict:",
         "def build_system(agent_too: bool = True, llm=None, device=None) "
         "-> dict:"),
        ("    selection rule as the CLI (`app/cli.py::_stack`).\"\"\"\n",
         "    selection rule as the CLI (`app/cli.py::_stack`). Built on "
         "`device`\n    (default: the first CUDA card; `\"cpu\"` must be "
         "asked for).\"\"\"\n"),
        ("try_build_stack(paths, llm=llm)",
         "try_build_stack(paths, llm=llm, device=device)"),
        ("build_demo_stack(llm=llm, agent=False)",
         "build_demo_stack(llm=llm, agent=False, device=device)"),
        ('build_demo_stack(llm=ctx["llm"], agent=True)',
         'build_demo_stack(llm=ctx["llm"], agent=True,\n'
         '                                         device=device)'),
        ('    ap.add_argument("--tpu", action="store_true")\n',
         '    ap.add_argument("--device", default=None,\n'
         '                    help="torch device of the encoders and the '
         'index "\n                         "(default: the first CUDA '
         'card)")\n'),
        ('    if not args.tpu:\n        import os\n\n        os.environ['
         '"JAX_PLATFORMS"] = "cpu"\n        import jax\n\n        '
         'jax.config.update("jax_platforms", "cpu")\n    system = '
         'build_system()\n',
         "    system = build_system(device=args.device)\n"),
    ],
    "app/cli.py": [
        ('config_path=getattr(args, "config", None))\n',
         'config_path=getattr(args, "config", None),\n'
         '                            device=getattr(args, "device", None))'
         '\n'),
        ('build_demo_stack(llm=llm, agent=getattr(args, "agent", False))\n',
         'build_demo_stack(llm=llm, agent=getattr(args, "agent", False),\n'
         '                            device=getattr(args, "device", None))'
         '\n'),
        ('    ap.add_argument("--tpu", action="store_true",\n'
         '                    help="backend TPU (défaut: CPU pour la démo)")'
         '\n',
         '    ap.add_argument("--device", default=None,\n'
         '                    help="device torch (défaut: la première carte '
         'CUDA)")\n'),
        ('    if not args.tpu:\n        import os\n\n        os.environ['
         '"JAX_PLATFORMS"] = "cpu"\n        import jax\n\n        '
         'jax.config.update("jax_platforms", "cpu")\n', ""),
    ],
    "app/streamlit_app.py": [
        ("def build_system():\n", "def build_system(device=None):\n"),
        ("    demo stack otherwise.\"\"\"\n",
         "    demo stack otherwise. Built on `device` (default: the first "
         "CUDA\n    card; `\"cpu\"` must be asked for).\"\"\"\n"),
        ("try_build_stack(paths)", "try_build_stack(paths, device=device)"),
        ("build_demo_stack(agent=False)",
         "build_demo_stack(agent=False, device=device)"),
        ('build_demo_stack(llm=ctx["llm"], agent=True)',
         'build_demo_stack(llm=ctx["llm"], agent=True,\n'
         '                                    device=device)'),
        ("    devices = jax.devices()\n",
         "    devices = [torch.cuda.get_device_name(i)\n"
         "               for i in range(torch.cuda.device_count())]\n"),
        ('", ".join(str(d) for d in devices))',
         '(", ".join(devices) or "cpu"))'),
        ('BGE-M3 en JAX/Flax (dense + lexical + ColBERT en "\n'
         '        "une passe, flash-attention Pallas) |',
         'BGE-M3 en PyTorch (dense + lexical + ColBERT en "\n'
         '        "une passe, flash-attention CUDA écrite pour Hopper) |'),
        ("cross-encoder JAX ou", "cross-encoder PyTorch ou"),
        ('        "ou décodeur 12B servi sur puce (int8, micro-batché) |\\n"'
         '\n        "| Parallélisme | jax.sharding Mesh — index shardé, TP, '
         '"\n        "ring-attention, multi-hôte DCN |\\n"\n',
         '        "(le décodeur servi sur la carte reste à porter) |\\n"\n'
         '        "| Parallélisme | une carte (le multi-GPU reste à porter) '
         '|\\n"\n'),
        ('    cols[2].metric("Backend", jax.default_backend())\n',
         '    cols[2].metric("Backend",\n                   "cuda" if '
         'torch.cuda.is_available() else "cpu")\n'),
        ('    if not os.environ.get("RAGDPO_TPU"):  # default: CPU demo '
         'backend\n        os.environ["JAX_PLATFORMS"] = "cpu"\n        '
         'import jax\n\n        jax.config.update("jax_platforms", "cpu")'
         '\n',
         "    # default: the first CUDA card; RAGDPO_DEVICE=cpu asks for the "
         "CPU\n    device = os.environ.get(\"RAGDPO_DEVICE\") or None\n"),
        ("        return build_system()\n",
         "        return build_system(device=device)\n"),
        ("    import jax\n", "    import torch\n"),
        # the pool's queue wait and device seconds (`ContinuousEngine.stats`)
        ("        eng = driver.engine\n        st.caption(\n",
         "        eng = driver.engine\n"
         '        wait_ms = eng.stats["queue_wait_ns"] / 1e6 \\\n'
         '            / max(eng.stats["admitted"], 1)\n'
         "        st.caption(\n"),
        ('            f" · {eng.stats[\'tokens\']} tokens"\n',
         '            f" · {eng.stats[\'tokens\']} tokens"\n'
         '            f" · attente moyenne {wait_ms:.0f} ms · device : '
         'préremplissage "\n'
         '            f"{eng.stats[\'prefill_device_ns\'] / 1e9:.1f} s, '
         'décodage "\n'
         '            f"{eng.stats[\'decode_device_ns\'] / 1e9:.1f} s"\n'),
    ],
    "agent/state.py": [
        ("import dataclasses\nimport time\n", "import dataclasses\n"),
        ("    t_start: float = dataclasses.field(default_factory="
         "time.time)\n", ""),
        ("    def record(self, node: str, t0: float):\n",
         "    def record(self, node: str, sp):\n        \"\"\"The node "
         "ran, in the span `sp`: its time adds to the node\'s.\"\"\"\n"),
        ("time.time() - t0", "sp.seconds"),
    ],
    "agent/graph.py": [
        ("import time\n", ""),
        ("from ..rag.pipeline import RAGResponse\n",
         "from ..rag.pipeline import RAGResponse\n" + _SPANS
         + "collect_spans, span, span_rows, span_seconds\n"),
        ("        t0 = time.time()\n        state = AgentState(",
         "        state = AgentState("),
        ("        state = self.graph.run(state)\n",
         '        with collect_spans() as spans, span("agent.query") as '
         "whole:\n            state = self.graph.run(state)\n"),
        ("rerank_time=0.0,", 'rerank_time=span_seconds(spans, "rerank"),'),
        ("total_time=time.time() - t0,", "total_time=whole.seconds,"),
        ('                "rewritten_question": state.question,\n'
         "            },\n",
         '                "rewritten_question": state.question,\n'
         "            },\n            spans=span_rows(spans),\n"),
    ],
    "rag/pipeline.py": [
        ("RelevanceValidator\n", "RelevanceValidator\n" + _SPANS
         + "collect_spans, span, span_rows\n"),
        ("    extras: dict[str, Any] = dataclasses.field(default_factory"
         "=dict)\n",
         "    extras: dict[str, Any] = dataclasses.field(default_factory"
         "=dict)\n"
         "    # the query\'s spans: (name, start epoch ns, duration ns, "
         "parent\'s\n    # index or -1, thread), in the order they "
         "started\n"
         "    spans: list[tuple] = dataclasses.field(default_factory="
         "list)\n"),
        # query(): a root span over the body, now `_query`
        ("    ) -> RAGResponse:\n        t_start = time.time()\n",
         "    ) -> RAGResponse:\n"
         '        with collect_spans() as spans, span("pipeline.query") '
         "as whole:\n"
         "            response = self._query(question, where_filter, "
         "enterprise_tags,\n"
         "                                   conversation_history, "
         "n_documents,\n"
         "                                   n_chunks_per_doc, "
         "temperature)\n"
         "        response.total_time = whole.seconds\n"
         "        response.spans = span_rows(spans)\n"
         "        return response\n\n"
         "    def _query(self, question, where_filter, enterprise_tags,\n"
         "               conversation_history, n_documents, "
         "n_chunks_per_doc,\n"
         "               temperature) -> RAGResponse:\n"),
        ("                total_time=time.time() - t_start,\n"
         "                n_candidates=0,\n            )\n",
         "                n_candidates=0,\n            )\n"),
        ("len(candidates), t_start,\n        )\n",
         "len(candidates),\n        )\n"),
        ("            validation_time=validation_time,\n"
         "            total_time=time.time() - t_start,\n",
         "            validation_time=sp.seconds,\n"),
        # both retrievals, the query\'s and the stream\'s
        ("        t0 = time.time()\n"
         "        documents, candidates, rerank_time, intent = "
         "self._retrieve(\n"
         "            question, where, intent_join, n_documents, "
         "n_chunks_per_doc\n        )\n"
         "        retrieval_time = time.time() - t0 - rerank_time\n",
         '        with span("pipeline.retrieve") as sp:\n'
         "            documents, candidates, rerank_time, intent = "
         "self._retrieve(\n"
         "                question, where, intent_join, n_documents, "
         "n_chunks_per_doc\n            )\n"
         "        retrieval_time = sp.seconds - rerank_time\n"),
        # the stream: its whole and its generation span the consumer\'s
        # yields, on the monotonic clock
        ("        t_start = time.time()\n",
         "        # the whole and the generation span the consumer\'s "
         "yields, which a\n        # span (a context variable) may "
         "not: the monotonic clock times them\n"
         "        t_start = time.perf_counter()\n"),
        ("total_time=time.time() - t_start,",
         "total_time=time.perf_counter() - t_start,"),
        ("        t0 = time.time()\n        pieces",
         "        t0 = time.perf_counter()\n        pieces"),
        ("generation_time=time.time() - t0,",
         "generation_time=time.perf_counter() - t0,"),
        ('        yield ("response", self._final_response(\n',
         "        response = self._final_response(\n"),
        ("len(candidates), t_start,\n        ))\n",
         "len(candidates),\n        )\n"
         "        response.total_time = time.perf_counter() - t_start\n"
         '        yield ("response", response)\n'),
        # the formatting and the rerank
        ("                        n_candidates, t_start) -> RAGResponse:"
         "\n        t0 = time.time()\n"
         "        answer = fix_markdown_formatting(answer)\n"
         "        answer, used_sources = self.context_builder.\\\n"
         "            format_response_with_sources(answer, built.sources)"
         "\n        validation_time = time.time() - t0\n",
         "                        n_candidates) -> RAGResponse:\n"
         '        with span("pipeline.format") as sp:\n'
         "            answer = fix_markdown_formatting(answer)\n"
         "            answer, used_sources = self.context_builder.\\\n"
         "                format_response_with_sources(answer, "
         "built.sources)\n"),
        ("            t0 = time.time()\n"
         "            ranked = self.reranker.rerank(\n"
         "                question, candidates, top_k=self.rerank_top_k,\n"
         "                question_topics=intent.topics,\n            )\n"
         "            rerank_time = time.time() - t0\n",
         '            with span("pipeline.rerank") as sp:\n'
         "                ranked = self.reranker.rerank(\n"
         "                    question, candidates, top_k=self."
         "rerank_top_k,\n"
         "                    question_topics=intent.topics,\n"
         "                )\n"
         "            rerank_time = sp.seconds\n"),
    ],
    "agent/nodes.py": [
        ("import dataclasses\n", "import contextvars\nimport dataclasses"
         "\nimport functools\n"),
        ("import threading\nimport time\n", "import threading\n"),
        ("from . import tools\n", _SPANS + "span\nfrom . import "
         "tools\n"),
        ("    enable_completeness: bool = True\n\n\n",
         "    enable_completeness: bool = True\n\n\n"
         "def _node(fn):\n"
         '    """Run a node inside its span `agent.<node>`; the node\'s '
         "time is the\n    span\'s (`AgentState.record`).\"\"\"\n"
         "    @functools.wraps(fn)\n"
         "    def run(c: NodeComponents, s: AgentState) -> AgentState:\n"
         '        with span(f"agent.{fn.__name__}") as sp:\n'
         "            s = fn(c, s)\n"
         "        s.record(fn.__name__, sp)\n"
         "        return s\n\n"
         "    return run\n\n\n"
         "def _in_span(s: AgentState, node: str, fn) -> None:\n"
         '    """Run `fn` in the span `agent.<node>`; its time is the '
         'node\'s."""\n'
         '    with span(f"agent.{node}") as sp:\n'
         "        fn()\n"
         "    s.timings[node] = sp.seconds\n\n\n"),
        # every node but overlap_prepare: its span is its timer
        (re.compile(r"\ndef (\w+)\(c: NodeComponents, s: AgentState\) "
                    r"-> AgentState:\n    t0 = time\.time\(\)\n"),
         r"\n@_node\ndef \1(c: NodeComponents, s: AgentState) -> AgentState:"
         r"\n"),
        (re.compile(r'    s\.record\("\w+", t0\)\n'), ""),
        # overlap_prepare: one span, each thread's in a copy of its context
        ("    t0 = time.time()\n    errors", "    errors"),
        ("        tc = time.time()\n", ""),
        (re.compile(r'        s\.timings\["\w+"\] = time\.time\(\) - tc\n'),
         ""),
        ("    threads = [threading.Thread(target=f)\n"
         "               for f in (_classify, _decompose, _prefetch)]\n"
         "    [t.start() for t in threads]\n"
         "    [t.join() for t in threads]\n",
         '    with span("agent.overlap_prepare") as whole:\n'
         "        # each thread runs in a copy of this context: its spans "
         "join the\n        # request\'s, under this one\n"
         "        threads = [threading.Thread(target=contextvars."
         "copy_context().run,\n"
         "                                    args=(_in_span, s, name, "
         "f))\n"
         '                   for name, f in (("classify", _classify),\n'
         '                                   ("decompose", _decompose),'
         "\n"
         '                                   ("prefetch", _prefetch))]\n'
         "        [t.start() for t in threads]\n"
         "        [t.join() for t in threads]\n"),
        ('s.timings["overlap_prepare"] = time.time() - t0',
         's.timings["overlap_prepare"] = whole.seconds'),
    ],
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
    for jax_text, port_text in NEAR_COPIES[rel]:
        if isinstance(jax_text, str):       # a literal: every occurrence
            jax_text = re.escape(jax_text)
            port_text = (lambda m, text=port_text: text)
        original, n = re.subn(jax_text, port_text, original)
        assert n >= 1, (rel, jax_text)
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
