"""Build and bind the hand-written CUDA kernels in `rag_dpo_tpu_torch/csrc/`.

Each `csrc/<source>.cu` exposes a plain C interface: one entry point per
kernel, named after the kernel (`KERNELS` maps each kernel to its source).
At first use a source is compiled with `nvcc` for Hopper (`sm_90a`) into a
shared library under `rag_dpo_tpu_torch/build/`, named after a hash of its
source, the shared headers (`csrc/*.cuh`) and the flags (so an edited source
rebuilds), and loaded with `ctypes`.
Pointers and the current stream travel as `c_void_p`; every C entry point
returns the `cudaGetLastError()` of its launch, which `check` turns into
an exception.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without `nvcc` or a card.

Launch counters: a wrapper adds one to `LAUNCHES[name]` each time it
launches its kernel, and a plain twin adds one to `PLAIN_ON_CUDA[name]`
each time it runs on a CUDA tensor, so a run can show which path it took.
Both add under a lock (`count_launch`, `count_plain`): serving launches
kernels from several threads at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
# kernel (its C entry point) -> the csrc/<source>.cu that defines it
KERNELS = {"flash_fwd": "flash_fwd", "ell_topk": "ell_topk",
           "flash_bwd_dq": "flash_bwd", "flash_bwd_dkv": "flash_bwd",
           "maxsim": "maxsim", "fused_topk": "fused_topk",
           "pooled_max": "pooled", "fused_candidates": "seg_candidates",
           "int8_block_max_bf16": "int8_block_max",
           "int8_block_max_i8": "int8_block_max"}
SOURCES = tuple(dict.fromkeys(KERNELS.values()))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}
PLAIN_ON_CUDA: dict[str, int] = {name: 0 for name in KERNELS}
# ptxas register / shared-memory report and nvcc seconds of each source's
# build, for the smoke log
BUILD_LOGS: dict[str, str] = {}
BUILD_SECONDS: dict[str, float] = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each library's entry point (all return a cudaError_t)
SIGNATURES = {
    # dtype, q, k, v, lengths, out, lse, B, H, S, Dh, scale, stream
    "flash_fwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # terms, impacts, q_terms, q_weights, N, L, Q, T, k, scratch, out_s,
    # out_i, stream
    "ell_topk": [_P, _P, _P, _P, *[_I] * 5, _P, _P, _P, _P],
    # dtype, q, k, v, dout, lengths, lse, dd, dq, B, H, S, Dh, scale, stream
    "flash_bwd_dq": [_I, *[_P] * 8, _I, _I, _I, _I, _F, _P],
    # dtype, q, k, v, dout, lengths, lse, dd, dk, dv, B, H, S, Dh, scale,
    # stream
    "flash_bwd_dkv": [_I, *[_P] * 9, _I, _I, _I, _I, _F, _P],
    # dtype, qv, q_mask, dv, d_mask, Q, LQ, C, LD, D, row_tile, query_tile,
    # stages, slots, tickets, out, stream
    "maxsim": [_I, _P, _P, _P, _P, *[_I] * 8, _P, _P, _P, _P],
    # dtype, q, e, penalty, P, Q, N, D, k, rows_per_block, tile_q, stages,
    # lists_in_smem, merge_in_smem, cand_s, cand_i, out_s, out_i, stream
    "fused_topk": [_I, _P, _P, _P, *[_I] * 10, _P, _P, _P, _P, _P],
    # q (columns permuted), e_i8, scale, penalty, P, Q, N, D, block_n, group,
    # nq, stages, out_v, out_i, stream
    "pooled_max": [_P, _P, _P, _P, *[_I] * 8, _P, _P, _P],
    # dtype, q, e, penalty, P, Q, N, D, block_n, seg, per_seg, tile_q,
    # stages, n_blocks, scr_s, scr_i, out_s, out_i, stream
    "fused_candidates": [_I, _P, _P, _P, *[_I] * 10, _P, _P, _P, _P, _P],
    # q_i8, e_i8, Q, N, D, block, nq, stages, out, stream
    "int8_block_max_bf16": [_P, _P, *[_I] * 6, _P, _P],
    # q_i8, e_i8, Q, N, D, block, nq, stages, resident, out, stream
    "int8_block_max_i8": [_P, _P, *[_I] * 7, _P, _P],
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}  # by source
_bound: set[str] = set()  # kernels whose entry point has its signature


_count_lock = threading.Lock()


def reset_counts() -> None:
    with _count_lock:
        for name in KERNELS:
            LAUNCHES[name] = 0
            PLAIN_ON_CUDA[name] = 0


def count_launch(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def count_plain(name: str) -> None:
    with _count_lock:
        PLAIN_ON_CUDA[name] += 1


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of rag_dpo_tpu_torch build "
            "only where the CUDA toolkit is installed")
    return found


def library_path(source: str) -> pathlib.Path:
    text = (CSRC_DIR / f"{source}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source}_{digest}.so"


def build(source: str) -> pathlib.Path:
    """Compile `csrc/<source>.cu` unless a library of the same hash exists."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{source}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[source] = time.perf_counter() - t0
    BUILD_LOGS[source] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {source}.cu:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all() -> float:
    """Build (or find) every kernel library, one nvcc per source, all
    started together; returns the seconds taken."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(build, SOURCES))
    for name in KERNELS:
        load(name)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The library that holds kernel `name`, with its entry point bound."""
    source = KERNELS[name]
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            lib.kernel_error_string.restype = ctypes.c_char_p
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            _libs[source] = lib
        if name not in _bound:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = SIGNATURES[name]
            _bound.add(name)
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
