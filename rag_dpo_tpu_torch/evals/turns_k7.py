"""K7 (`maxsim`) of this checkout against a parent checkout's, in turns on
one NVIDIA card.

    git archive <parent> | tar -x -C logs/parent
    python rag_dpo_tpu_torch/evals/turns_k7.py --parent logs/parent

Builds the parent's `csrc/maxsim.cu` (with its own headers) into
`rag_dpo_tpu_torch/build/turns_k7/`; the parent's C entry point is that of
commit 179c2be: `maxsim(dtype, qv, q_mask, dv, d_mask, Q, LQ, C, LD, D,
partial, out, stream)` with a [Q, C, ceil(LQ / 8)] f32 scratch, which its
calls allocate as its wrapper did. This checkout's kernel runs through its
wrapper. At `chip_smoke.py::check_maxsim`'s shapes and inputs (unit
vectors, each candidate's rows valid up to a random length, seed 0): the
rerank ([1, 32] x [40, 256], D 1024, f16 rows) and the hermetic replay's
([1, 27] x [40, 96], D 32, f16). Each is timed by CUDA events over 200
calls after 3 warm-up calls, in the order parent, new, new, parent, and
once more each by the profiler's device time a call; the wrapper's host
time a call (200 calls enqueued back to back, by the host clock) beside
it. The parent's own wrapper (its `ops/maxsim.py` and `ops/_kernels.py`,
loaded as the package `parent_ops`, which builds its library into the
parent's `build/`) is timed the same way beside this checkout's, so that
the host times compare wrapper with wrapper. Prints the card's name and
power limit, one line a shape and one JSON line; exits 1 if the two
disagree beyond `chip_smoke.py`'s tolerance.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))  # run as a script
from rag_dpo_tpu_torch.evals import turns  # noqa: E402

SHAPES = {"rerank": (1, 32, 40, 256, 1024), "hermetic": (1, 27, 40, 96, 32)}
TOL = dict(rtol=1e-5, atol=1e-4)  # chip_smoke.py's MAXSIM_TOL


def parent_wrapper(parent: pathlib.Path):
    """The parent's `ops/maxsim.py`, imported as `parent_ops.maxsim` with
    its own `_kernels` beside it (its package `__init__` is not run)."""
    import importlib
    import types

    pkg = types.ModuleType("parent_ops")
    pkg.__path__ = [str(parent / "rag_dpo_tpu_torch" / "ops")]
    sys.modules["parent_ops"] = pkg
    return importlib.import_module("parent_ops.maxsim")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=pathlib.Path,
                    help="root of the parent checkout")
    args = ap.parse_args()
    import torch

    from rag_dpo_tpu_torch.ops import _kernels
    from rag_dpo_tpu_torch.ops.maxsim import maxsim

    if not torch.cuda.is_available():
        print("turns_k7: no CUDA device", file=sys.stderr)
        return 1
    card = turns.card()
    print(card, flush=True)
    parent = turns.build_parent(_kernels, args.parent.resolve(), ("maxsim",),
                                "turns_k7")["maxsim"]
    p, i = ctypes.c_void_p, ctypes.c_int
    parent.maxsim.argtypes = [i, p, p, p, p, *[i] * 5, p, p, p]
    _kernels.load("maxsim")
    parent_ops = parent_wrapper(args.parent.resolve())
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    result, ok = {"card": card}, True
    for label, (q, lq, c, ld, d) in SHAPES.items():
        qv = torch.randn((q, lq, d), generator=gen, device=dev)
        qv /= qv.norm(dim=-1, keepdim=True)
        dv = torch.randn((c, ld, d), generator=gen, device=dev)
        dv = (dv / dv.norm(dim=-1, keepdim=True)).half()
        dlen = torch.randint(1, ld + 1, (c, 1), generator=gen, device=dev)
        d_mask = torch.arange(ld, device=dev)[None, :] < dlen
        q_mask = torch.ones((q, lq), dtype=torch.bool, device=dev)

        def old(qv=qv, q_mask=q_mask, dv=dv, d_mask=d_mask, q=q, lq=lq, c=c,
                ld=ld, d=d):
            partial = torch.empty((q, c, -(-lq // 8)), device=dev)
            out = torch.empty((q, c), device=dev)
            err = parent.maxsim(1, qv.data_ptr(), q_mask.data_ptr(),
                                dv.data_ptr(), d_mask.data_ptr(), q, lq, c,
                                ld, d, partial.data_ptr(), out.data_ptr(),
                                stream)
            if err:
                raise RuntimeError(f"parent maxsim: CUDA error {err}")
            return out

        def new(qv=qv, q_mask=q_mask, dv=dv, d_mask=d_mask):
            return maxsim(qv, q_mask, dv, d_mask)

        want, got = old(), new()
        torch.cuda.synchronize()
        r = turns.turns(old, new, 200)
        r["parent_host_us"] = turns.host_us(old)
        r["new_host_us"] = turns.host_us(new)

        def old_wrapper(qv=qv, q_mask=q_mask, dv=dv, d_mask=d_mask):
            return parent_ops.maxsim(qv, q_mask, dv, d_mask)

        r["wrappers"] = turns.turns(old_wrapper, new, 200, device=False)
        r["wrappers"]["parent_host_us"] = turns.host_us(old_wrapper)
        r["wrappers"]["new_host_us"] = turns.host_us(new)
        r["max_abs_diff"] = float((got - want).abs().max())
        r["within_tol"] = bool(torch.allclose(got, want, **TOL))
        ok &= r["within_tol"]
        result[label] = r
        print(f"K7 {label} [{q},{lq}]x[{c},{ld}] D {d} f16: " + ", ".join(
            f"{key} {val}" for key, val in r.items()), flush=True)
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
