"""ColBERT late interaction (MaxSim) for the rerank of the dense top-k.

    score[q, c] = Σ_{valid l} max_{valid m} ⟨qv[q, l], dv[c, m]⟩

`maxsim` is the port of the JAX package's Pallas `maxsim`: on CUDA tensors
it launches the hand-written kernel in `csrc/maxsim.cu`, on CPU tensors it
runs `maxsim_plain`. The reference's semantics are kept: masked doc tokens
score −1e30 (never −inf) and each max is clamped at −1e30, so a candidate
with no valid token scores −1e30 per valid query token; masked query
tokens add 0. The Pallas kernel's `owner` matrix, which made the MXU do the
per-query sum, and its `block_c` / `interpret` arguments have no
counterpart: the CUDA kernel sums the valid query tokens directly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

from . import _kernels

NEG_INF = -1e30
# dv's dtype → the kernel's dtype code; all are widened to f32 exactly
_DV_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# csrc/maxsim.cu's launch plan: doc rows a block, query tokens a tile, a
# doc row's bytes in one slice of D (a TMA box's row), the ring's depth;
# a stage holds the doc box and the query boxes of 32 f32 columns (one for
# f32 rows, two for f16 / bf16); 1,024 bytes align the swizzled boxes
ROW_TILE, QUERY_TILE, ROW_BYTES = 64, 32, 128
MIN_STAGES, MAX_STAGES = 2, 6
SMEM_ALIGN = 1024
MAX_GRID = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class MaxsimPlan:
    row_tile: int      # doc rows a block
    query_tile: int    # query tokens a tile
    slice: int         # columns of D a ring stage holds
    stages: int        # the ring's depth
    smem: int          # dynamic shared bytes a block
    row_tiles: int     # blocks a candidate
    query_tiles: int   # tiles of the Q·LQ query tokens, walked in a block


@functools.lru_cache(maxsize=256)
def maxsim_plan(dtype, q: int, lq: int, c: int, ld: int, d: int
                ) -> MaxsimPlan:
    """K7's launch plan for Q queries of LQ tokens against C candidates of
    LD rows, D columns, dv of `dtype`: one block per (candidate, 64 doc
    rows), the Q·LQ query tokens walked in tiles of 32 inside it, D in
    slices of 128 bytes of a doc row with the query's same columns, through
    a ring as deep as the block has slices to load (2 to 6). Any shape
    whose grid, C·ceil(LD / 64) blocks, fits the card's 2³¹ − 1."""
    if dtype not in _DV_DTYPES:
        raise ValueError(f"maxsim kernel takes f32/f16/bf16 dv, got {dtype}")
    if min(q, lq, c, ld, d) < 1:
        raise ValueError(f"maxsim takes no empty axis, got Q={q} LQ={lq} "
                         f"C={c} LD={ld} D={d}")
    row_tiles = -(-ld // ROW_TILE)
    if c * row_tiles > MAX_GRID:
        raise ValueError(f"maxsim's grid of C·ceil(LD / {ROW_TILE}) = "
                         f"{c * row_tiles} blocks exceeds {MAX_GRID}")
    cols = ROW_BYTES // (torch.finfo(dtype).bits // 8)
    query_tiles = -(-(q * lq) // QUERY_TILE)
    stages = max(MIN_STAGES, min(MAX_STAGES, query_tiles * -(-d // cols)))
    query = QUERY_TILE * cols * 4
    smem = SMEM_ALIGN + stages * (ROW_TILE * ROW_BYTES + query)
    return MaxsimPlan(ROW_TILE, QUERY_TILE, cols, stages, smem, row_tiles,
                      query_tiles)


def maxsim_reference(qv, q_mask, dv, d_mask):
    """Oracle. qv: [Q, LQ, D], q_mask: [Q, LQ], dv: [C, LD, D],
    d_mask: [C, LD] → [Q, C] f32."""
    sim = torch.einsum("qld,cmd->qlcm", qv.float(), dv.float())
    sim = torch.where(d_mask.bool()[None, None], sim, NEG_INF)
    mx = sim.amax(dim=-1).clamp_min(NEG_INF)  # fully masked docs stay −1e30
    mx = torch.where(q_mask.bool()[:, :, None], mx, 0.0)
    return mx.sum(dim=1)


def maxsim_plain(qv, q_mask, dv, d_mask):
    """Plain twin of the MaxSim kernel: the oracle itself, since the kernel
    computes the same dots, maxima and sum (in another summation order)."""
    if dv.is_cuda:
        _kernels.count_plain("maxsim")
    return maxsim_reference(qv, q_mask, dv, d_mask)


# (device index, stream) → the kernel's zeroed workspace: [C, Q·LQ] slots
# of order-preserving maxima, then [C] tickets. Each call leaves it zero,
# so it is kept between calls and a call launches nothing but K7 (a fresh
# zeroed workspace would cost a fill kernel a call).
_WORKSPACES: dict[tuple[int, int], torch.Tensor] = {}


def _workspace(dev, stream: int, n: int) -> torch.Tensor:
    ws = _WORKSPACES.get((dev.index, stream))
    if ws is None or ws.numel() < n:
        ws = torch.zeros(n, dtype=torch.int32, device=dev)
        _WORKSPACES[(dev.index, stream)] = ws
    return ws


def _maxsim_kernel(qv, q_mask, dv, d_mask):
    if qv.dim() != 3 or dv.dim() != 3:
        raise ValueError("maxsim takes qv [Q, LQ, D] and dv [C, LD, D]")
    q, lq, d = qv.shape
    c, ld, dd = dv.shape
    if dd != d:
        raise ValueError(f"qv has D={d}, dv D={dd}")
    if q_mask.shape != (q, lq) or d_mask.shape != (c, ld):
        raise ValueError(f"masks must be [{q}, {lq}] and [{c}, {ld}], got "
                         f"{tuple(q_mask.shape)} and {tuple(d_mask.shape)}")
    if qv.dtype != torch.float32 or dv.dtype not in _DV_DTYPES:
        raise ValueError(f"maxsim kernel takes f32 qv and f32/f16/bf16 dv, "
                         f"got {qv.dtype} and {dv.dtype}")
    if q_mask.dtype != torch.bool or d_mask.dtype != torch.bool:
        raise ValueError("maxsim masks must be bool")
    plan = maxsim_plan(dv.dtype, q, lq, c, ld, d)
    dev = qv.device
    # checked, never converted: the rerank's inputs already fit, and a
    # call's host time is most of its time at these sizes
    for name, x in (("qv", qv), ("q_mask", q_mask), ("dv", dv),
                    ("d_mask", d_mask)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, qv on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    stream = _kernels.stream_of(qv)
    slots = c * q * lq
    ws = _workspace(dev, stream, slots + c)
    out = torch.empty((q, c), dtype=torch.float32, device=dev)
    lib = _kernels.load("maxsim")
    # the device is switched only where it is not the current one
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        err = lib.maxsim(
            _DV_DTYPES[dv.dtype], qv.data_ptr(), q_mask.data_ptr(),
            dv.data_ptr(), d_mask.data_ptr(), q, lq, c, ld, d,
            plan.row_tile, plan.query_tile, plan.stages, ws.data_ptr(),
            ws.data_ptr() + 4 * slots, out.data_ptr(), stream)
    _kernels.check(lib, err, "maxsim")
    _kernels.count_launch("maxsim")
    return out


def maxsim(qv, q_mask, dv, d_mask):
    """Late-interaction scores [Q, C] f32. Shapes as `maxsim_reference`;
    on CUDA, qv f32, dv f32/f16/bf16, bool masks, all contiguous.

    Candidates whose mask is entirely zero score −1e30 per valid query
    token (they sort last)."""
    if not dv.is_cuda:
        return maxsim_plain(qv, q_mask, dv, d_mask)
    return _maxsim_kernel(qv, q_mask, dv, d_mask)
