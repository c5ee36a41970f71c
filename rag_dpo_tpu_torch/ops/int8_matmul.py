"""The int8 sweep floor: int8 queries against int8 rows, reduced per block of
rows to the max of its 128-wide strided column groups (K10, K11).

Port of the kernel half of `benchmarks/bench_pallas_int8_matmul.py`, where
the JAX package measured the least an int8 sweep could cost: read an int8
row block, take its product with resident queries, write a small strip.

    out[q, j·128 + c] = max over i < block/128 of q · e[j·block + i·128 + c]

for j < N // block. The grid covers whole blocks only, as the TPU kernel's
(`grid = (N // BLOCK,)`): rows past the last whole block are not read, and
not padded in. At the recipe (N 1,000,000, D 1024, Q 64, block 2048) that is
the last 576 rows, and the strip is [64, 62,464].

`upcast="bf16"` is K10 (`kernel_bf16`: both operands widened to bf16, the
products summed in f32), `upcast="int8"` is K11 (`kernel_int8`: int8 × int8
summed in int32, the max cast to f32). Every int8 product is exact in bf16,
and every partial sum stays below 2^24 while D ≤ 1024 (1024 · 128² = 2^24),
so at D ≤ 1024 the two give the same bits. The plain twin computes the exact
integer function (in f64, exact for any D that int32 holds) for both.

On CUDA tensors `int8_block_max` launches the hand-written kernels of
`csrc/int8_block_max.cu`, both on the TMA ring of `csrc/widen_product.cuh`:
K10 on the int8-widening product it shares with K6 (each int8 element
widened to bf16 once a block, bf16 wgmma; `ops/widen_product.py`'s plan for
int8 queries), K11 on s8 wgmma with both operands in shared memory
(`i8_plan`: 8 to 128 queries a block, their tile resident or streamed); on
CPU tensors it runs `int8_block_max_plain`. Nothing in either package's
search path calls them: they measure the floor of an int8 sweep, which the
store's int8 × int8 arm and K6 are held against.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _kernels
from .topk import pad_columns
from .widen_product import (
    BARRIERS,
    CHUNK,
    COL_MULTIPLE,
    MAX_SMEM,
    MAX_STAGES,
    ROW_STAGE,
    SMEM_ALIGN,
    widen_plan,
)

LANES = 128        # the strip's columns a block: the TPU kernel's lane width
UPCASTS = {"bf16": "int8_block_max_bf16", "int8": "int8_block_max_i8"}
I8_WIDTHS = (8, 16, 32, 64, 128)   # K11's queries a block (wgmma's N)
I8_MIN_RESIDENT_STAGES = 4         # a shallower ring streams the queries


@dataclass(frozen=True)
class I8Plan:
    nq: int          # queries a block
    stages: int
    resident: bool   # the query tile staged once a block, all of D
    chunks: int      # 128-byte chunks of D

    @property
    def smem(self) -> int:
        return i8_smem(self.nq, self.stages, self.resident, self.chunks)


def i8_smem(nq: int, stages: int, resident: bool, chunks: int) -> int:
    """K11's dynamic shared bytes (`i8_smem` in the source): the ring's
    slots (rows, + the streamed query box), the resident tile, the
    barriers, the alignment slack."""
    q_tile = nq * CHUNK
    return (SMEM_ALIGN + stages * (ROW_STAGE + (0 if resident else q_tile))
            + (chunks * q_tile if resident else 0) + BARRIERS)


def i8_plan(q: int, d: int) -> I8Plan:
    """K11's plan for Q queries of D columns (padded to 16): the smallest
    wgmma width of `I8_WIDTHS` that holds Q, else 128 (ceil(Q / 128) query
    tiles); the query tile resident where it fits beside a ring of
    `I8_MIN_RESIDENT_STAGES`, else streamed beside the rows (any D); the
    deepest ring (up to 8 stages) that fits."""
    if q < 1 or d < 1:
        raise ValueError(f"i8_plan takes Q ≥ 1 and D ≥ 1, got {q}, {d}")
    chunks = -(-(-(-d // COL_MULTIPLE) * COL_MULTIPLE) // CHUNK)
    nq = next((n for n in I8_WIDTHS if n >= q), I8_WIDTHS[-1])

    def stages(resident: bool) -> int:  # streamed: 7 at NQ 128, any D
        stage = ROW_STAGE + (0 if resident else nq * CHUNK)
        return min(MAX_STAGES,
                   (MAX_SMEM - i8_smem(nq, 0, resident, chunks)) // stage)

    resident = stages(True) >= I8_MIN_RESIDENT_STAGES
    return I8Plan(nq, stages(resident), resident, chunks)


def _kernel_name(block: int, upcast: str) -> str:
    if upcast not in UPCASTS:
        raise ValueError(f"upcast must be one of {sorted(UPCASTS)}, got "
                         f"{upcast!r}")
    if block < LANES or block % LANES:
        raise ValueError(f"block ({block}) must be a positive multiple of "
                         f"{LANES}")
    return UPCASTS[upcast]


def _check_inputs(q_i8, e_i8) -> None:
    if q_i8.dim() != 2 or e_i8.dim() != 2:
        raise ValueError("int8_block_max takes q_i8 [Q, D] and e_i8 [N, D]")
    if q_i8.dtype != torch.int8 or e_i8.dtype != torch.int8:
        raise ValueError(f"int8_block_max takes int8 operands, got "
                         f"{q_i8.dtype} and {e_i8.dtype}")
    if q_i8.shape[1] != e_i8.shape[1]:
        raise ValueError(f"q_i8 has D={q_i8.shape[1]}, e_i8 "
                         f"D={e_i8.shape[1]}")
    if q_i8.shape[0] < 1 or q_i8.shape[1] < 1:
        raise ValueError(f"int8_block_max takes Q ≥ 1 and D ≥ 1, got "
                         f"{tuple(q_i8.shape)}")
    if q_i8.device != e_i8.device:
        raise ValueError(f"q_i8 is on {q_i8.device}, e_i8 on {e_i8.device}")


def int8_block_max_plain(q_i8, e_i8, *, block: int = 2048, upcast: str):
    """Plain twin of K10 and K11: the exact integer products of the whole
    blocks (f64 holds them exactly), the max over each block's strided
    groups, cast to f32."""
    name = _kernel_name(block, upcast)
    _check_inputs(q_i8, e_i8)
    if e_i8.is_cuda:
        _kernels.count_plain(name)
    q, nb = q_i8.shape[0], e_i8.shape[0] // block
    s = q_i8.double() @ e_i8[: nb * block].double().T          # [Q, nb·block]
    s = s.reshape(q, nb, block // LANES, LANES).amax(dim=2)
    return s.reshape(q, nb * LANES).float()


def _int8_block_max_kernel(q_i8, e_i8, block: int, name: str):
    _check_inputs(q_i8, e_i8)
    q, n = q_i8.shape[0], e_i8.shape[0]
    nb = n // block
    out = torch.empty((q, nb * LANES), dtype=torch.float32,
                      device=e_i8.device)
    if nb == 0:  # no whole block: nothing to read, nothing to launch
        return out
    # zero columns add 0 to every product: a copy on the card
    q_i8, e_i8 = (pad_columns(x, COL_MULTIPLE) for x in (q_i8, e_i8))
    q_i8, e_i8 = (
        x if x.is_contiguous() and x.data_ptr() % 16 == 0
        else x.clone(memory_format=torch.contiguous_format)
        for x in (q_i8, e_i8))
    d = q_i8.shape[1]
    if name == UPCASTS["bf16"]:  # the widening product's plan
        p = widen_plan(q, d, int8_queries=True)
        plan = (p.nq, p.stages)
    else:
        p = i8_plan(q, d)
        plan = (p.nq, p.stages, int(p.resident))
    lib = _kernels.load(name)
    with torch.cuda.device(e_i8.device):
        err = getattr(lib, name)(
            _kernels.ptr(q_i8), _kernels.ptr(e_i8), q, n, d, block, *plan,
            _kernels.ptr(out), _kernels.stream_of(e_i8))
    _kernels.check(lib, err, name)
    _kernels.count_launch(name)
    return out


def int8_block_max(q_i8, e_i8, *, block: int = 2048, upcast: str):
    """q_i8 [Q, D] int8 × e_i8 [N, D] int8 → [Q, (N // block)·128] f32, the
    max of each block's strided groups (see the module docstring).

    Any Q ≥ 1 and any D (on CUDA, K10's D ≤ 6144: its query tile stays in
    shared memory; past it ValueError; K11 streams its queries past what
    fits); on CUDA a D that is not a multiple of 16 is padded with zero
    columns (a copy that changes no product).
    `block` must be a multiple of 128; rows past the last whole block are
    not read."""
    name = _kernel_name(block, upcast)
    if e_i8.is_cuda:
        return _int8_block_max_kernel(q_i8, e_i8, block, name)
    return int8_block_max_plain(q_i8, e_i8, block=block, upcast=upcast)
