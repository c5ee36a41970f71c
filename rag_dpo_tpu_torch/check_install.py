"""Environment validation of the port — the root `check_install.py`'s
counterpart (the reference `check_install.py` analog), for the PyTorch and
CUDA installation:

    python -m rag_dpo_tpu_torch.check_install [--device cpu]

Checks: Python version, torch's CUDA device (name, count, `nvidia-smi`'s
name and power limit), the packages (torch, numpy, triton, `nvcc` on
PATH), the host parsing libraries (per-format degradation), a device
program (`ops.approx_topk`, the fused top-k kernel on the card, built at
first use: its launch must be counted and no plain twin may run), the LLM
endpoint (a warning) and the directory layout. Everything runs on the
first CUDA card unless `--device cpu` asks for the CPU; without a card the
device checks fail, they do not fall back. Exit code 0 = ready.
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys

OK, WARN, FAIL = "✅", "⚠️ ", "❌"


def check(label: str, fn):
    try:
        detail = fn()
        print(f"{OK} {label}" + (f" — {detail}" if detail else ""))
        return True
    except Warning as w:
        print(f"{WARN} {label} — {w}")
        return True
    except Exception as e:
        print(f"{FAIL} {label} — {e}")
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="device torch (défaut: la première carte CUDA)")
    args = ap.parse_args(argv)
    on_cpu = args.device is not None and \
        args.device.split(":")[0] == "cpu"
    results = []

    def py_version():
        if sys.version_info < (3, 10):
            raise RuntimeError(f"Python ≥3.10 requis, trouvé "
                               f"{sys.version.split()[0]}")
        return sys.version.split()[0]
    results.append(check("Python", py_version))

    def cuda_devices():
        import torch

        if on_cpu:
            raise Warning("--device cpu: aucune carte utilisée")
        if not torch.cuda.is_available():
            raise RuntimeError("aucune carte CUDA "
                               "(torch.cuda.is_available() est faux)")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout
        return (f"{torch.cuda.device_count()} × "
                f"{torch.cuda.get_device_name(0)} (nvidia-smi: "
                f"{smi.strip().splitlines()[0]})")
    results.append(check("CUDA devices", cuda_devices))

    for pkg in ("torch", "numpy"):
        results.append(check(
            f"package {pkg}",
            lambda p=pkg: importlib.import_module(p).__version__,
        ))

    def triton():
        try:
            return importlib.import_module("triton").__version__
        except ImportError:
            raise Warning("absent (aucun noyau du port ne l'exige)")
    results.append(check("package triton", triton))

    def nvcc():
        from .ops import _kernels

        try:
            return _kernels._nvcc()
        except RuntimeError:
            if on_cpu:
                raise Warning("absent: les noyaux CUDA ne se construisent "
                              "que sur la carte")
            raise RuntimeError("introuvable: les noyaux CUDA du port se "
                               "construisent avec nvcc à leur premier "
                               "appel")
    results.append(check("nvcc", nvcc))

    def parsers():
        from .ingest.parsing import supported_formats

        formats = supported_formats()
        missing = {"pdf", "docx", "xlsx"} - set(formats)
        if missing:
            raise Warning(
                f"formats actifs {formats}; manquants {sorted(missing)} "
                "(PyMuPDF/python-docx/openpyxl non installés)"
            )
        return ", ".join(formats)
    results.append(check("parseurs de documents", parsers))

    def device_program():
        import numpy as np
        import torch

        from .ops import _kernels, approx_topk, default_device

        dev = default_device(args.device)
        before = (_kernels.LAUNCHES["fused_topk"],
                  _kernels.PLAIN_ON_CUDA["fused_topk"])
        e = torch.as_tensor(np.eye(8, 128, dtype=np.float32), device=dev)
        _, i = approx_topk(e[:2], e, 3)
        ids = i.cpu().numpy()
        if ids[0, 0] != 0 or ids[1, 0] != 1:
            raise RuntimeError(f"ids {ids.tolist()}")
        if dev.type != "cuda":
            return "approx_topk ok (CPU)"
        launched = _kernels.LAUNCHES["fused_topk"] - before[0]
        if launched < 1 or _kernels.PLAIN_ON_CUDA["fused_topk"] > before[1]:
            raise RuntimeError("le noyau fused_topk n'a pas tourné "
                               f"({launched} lancement(s))")
        return f"approx_topk ok (noyau fused_topk: {launched} lancement(s))"
    results.append(check("programme device", device_program))

    def llm_endpoint():
        from .providers import HTTPLLMProvider

        url = os.environ.get("RAGDPO_LLM_BASE_URL",
                             "http://localhost:11434")
        if HTTPLLMProvider(base_url=url).is_available():
            return url
        raise Warning(f"{url} injoignable — le FakeLLM reste disponible")
    results.append(check("endpoint LLM", llm_endpoint))

    def dirs():
        from .utils.paths import default_paths

        default_paths().ensure()
        return "ok"
    results.append(check("arborescence data/", dirs))

    n_fail = results.count(False)
    print(f"\n{'Prêt.' if n_fail == 0 else f'{n_fail} problème(s).'}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
