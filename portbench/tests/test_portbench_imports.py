"""What a run may load, and where it may run: a fresh interpreter drives
a tiny run of every cell and must load no module whose top-level name is
`jax`, `jaxlib`, `flax`, `optax`, `orbax` or `rag_dpo_tpu` (compared
whole: the port, `rag_dpo_tpu_torch`, begins with the last); and the
harness refuses to run beside nothing but the benchmark's files."""

import json
import pathlib
import shutil
import subprocess
import sys

from portbench import spec

REPO = spec.REPO

PROBE = """
import json, sys
from portbench import run
from portbench.tests import tiny
for cell in sorted(tiny.CELLS):
    tiny.execute(cell, seconds=1.0)
print(json.dumps(run.forbidden_modules()))
"""


def test_no_forbidden_module_is_loaded():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole():
    from portbench import run

    assert run.forbidden_modules(["rag_dpo_tpu_torch.models", "jaxtyping",
                                  "flaxen", "torch"]) == []
    assert run.forbidden_modules(["rag_dpo_tpu.ops", "jax._src",
                                  "flax"]) == ["flax", "jax", "rag_dpo_tpu"]


def test_refuses_to_run_without_the_program(tmp_path: pathlib.Path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "prefill.context-8c", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
