"""Which of the mesh's collectives gloo carries on CUDA tensors, with two
ranks on one card (one process each, both on `cuda:0`).

    python -m rag_dpo_tpu_torch.evals.probe_gloo_cuda

Each of the three collectives the port's mesh code calls runs in two fresh
ranks, on CUDA tensors with no copy to the host: `all_gather` (the top-k
merge, the data-parallel encode), `all_reduce` (the TP row products, the
sharded refine) and `batch_isend_irecv` (the ring). Prints one JSON line:
each collective's result ("ok" with the right values, or how a rank
ended: an exception, or a signal such as SIGABRT). NCCL cannot put two
ranks on one card, so this is the only two-rank run one card allows.
"""

from __future__ import annotations

import datetime
import json
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException


COLLECTIVES = ("all_gather", "all_reduce", "batch_isend_irecv")


def _rank(rank: int, world: int, init: str, which: str) -> None:
    # a collective gloo cannot finish fails after a minute, not 30
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    x = torch.full((4, 8), float(rank + 1), device=dev)
    if which == "all_gather":
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        ok = all(bool((p == i + 1).all()) for i, p in enumerate(parts))
    elif which == "all_reduce":
        dist.all_reduce(x)
        ok = bool((x == world * (world + 1) / 2).all())
    else:
        got = torch.empty_like(x)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, (rank + 1) % world),
                dist.P2POp(dist.irecv, got, (rank - 1) % world)]):
            req.wait()
        ok = bool((got == (rank - 1) % world + 1).all())
    torch.cuda.synchronize()
    dist.destroy_process_group()
    if not ok:
        raise RuntimeError(f"{which} gave wrong values")


def _one(which: str) -> str:
    """One collective in two fresh ranks: "ok", or how a rank ended (an
    exception's first line, or the signal that killed it)."""
    from rag_dpo_tpu_torch.parallel.mesh import free_port

    try:
        mp.start_processes(_rank, args=(
            2, f"tcp://127.0.0.1:{free_port()}", which), nprocs=2,
            join=True, start_method="spawn")
        return "ok"
    except ProcessException as e:   # the finding, not a failure
        return f"{type(e).__name__}: {str(e).strip().splitlines()[-1][:200]}"


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_gloo_cuda: no CUDA device", file=sys.stderr)
        return 1
    result = {which: _one(which) for which in COLLECTIVES}
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "gloo_on_cuda": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
