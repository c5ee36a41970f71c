"""Run one function on N ranks of CPU processes joined by gloo: the CPU
stand-in for the port's multi-device mesh (one process a device, as on the
card). Used by the `tests/test_torch_*` mesh tests; no jax here, so a rank
imports only torch, the port and the test module that names the function.

`run_ranks(fn, world, *args)` spawns `world` processes, each joins a
process group on a free loopback port (`initialize_multihost(...,
device_type="cpu")`), runs `fn(rank, world, *args)` with one intra-op
thread, and returns every rank's (picklable) result in rank order. A rank
that raises fails the call with its traceback; a run past `timeout`
seconds is killed and fails it.
"""

import os
import pickle
import tempfile
import time

import torch
import torch.multiprocessing as mp


def _entry(rank, fn, world, port, out_dir, args):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from rag_dpo_tpu_torch.parallel import initialize_multihost

    initialize_multihost(f"127.0.0.1:{port}", world, rank,
                         device_type="cpu")
    try:
        result = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, args, timeout, out_dir):
    from rag_dpo_tpu_torch.parallel.mesh import free_port

    ctx = mp.start_processes(
        _entry, args=(fn, world, free_port(), out_dir, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks ran past {timeout} s")


def run_ranks(fn, world: int, *args, timeout: float = 240.0):
    """Every rank's result of `fn(rank, world, *args)`, in rank order. A
    port another process took between `free_port` and the store's bind
    (test files run in parallel) is retried on a new port."""
    with tempfile.TemporaryDirectory() as out_dir:
        for attempt in range(3):
            try:
                _spawn(fn, world, args, timeout, out_dir)
                break
            except mp.ProcessRaisedException as e:
                if "address already in use" not in str(e).lower() \
                        or attempt == 2:
                    raise
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
