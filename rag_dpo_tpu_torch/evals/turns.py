"""What the in-turns timing scripts (`turns_*.py`) share: a parent
checkout's kernel libraries built beside this checkout's, the card's name
and power limit, and a kernel timed by CUDA events, by the profiler's
device time and by its host time a call, in the order parent, new, new,
parent on one card.

The parent is a `git archive` of an earlier commit unpacked into a
gitignored directory; its sources build with this checkout's nvcc flags
into `rag_dpo_tpu_torch/build/<subdir>/`, one nvcc per source, all started
together. Each script binds the parent's C entry points with the
signatures of the commit it names.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import time


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def build_parent(kernels, parent: pathlib.Path, sources, subdir: str
                 ) -> dict:
    """The parent checkout's `csrc/<source>.cu` libraries (with its own
    headers), built together; `kernels` is this checkout's `ops._kernels`
    (for nvcc and its flags)."""
    out = kernels.BUILD_DIR / subdir
    out.mkdir(parents=True, exist_ok=True)
    csrc = parent / "rag_dpo_tpu_torch" / "csrc"
    procs = {name: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
         str(out / f"lib{name}.so"), str(csrc / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in sources}
    libs = {}
    for name, proc in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n"
                               f"{text}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return libs


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """ms a call by CUDA events over `iters` calls after `warmup`."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """The device events' ms a call under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters / 1e3


def host_us(fn, calls: int = 200) -> float:
    """µs of host time a call: `calls` calls enqueued back to back (the
    card runs each in less than its host time), by the host clock."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return out


def turns(old, new, iters: int = 20, device: bool = True) -> dict:
    """`old` and `new` by events in the order old, new, new, old, and
    (where `device`) once more each by device time."""
    t = [event_ms(old, iters), event_ms(new, iters), event_ms(new, iters),
         event_ms(old, iters)]
    out = {"parent_ms": [t[0], t[3]], "new_ms": [t[1], t[2]]}
    if device:
        out.update(parent_device_ms=device_ms(old),
                   new_device_ms=device_ms(new))
    return out
