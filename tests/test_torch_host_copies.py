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
# JAX package's CPU pin, torch's device inventory in place of jax's)
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
