"""Launch plan and query layout of the int8-widening tensor-core product
that K6 (`ops/pooled.py`) and K10 (`ops/int8_matmul.py`, `upcast="bf16"`)
share, `csrc/widen_product.cuh`.

A block runs two warpgroups over tiles of 128 int8 rows (wgmma's M) against
`nq` queries (16 or 64, its N), the rows widened to bf16 in the registers
of the lane that multiplies them; D goes in 128-byte chunks through a TMA
ring of `stages` slots. K6's bf16 queries ride in each stage beside the
rows, their columns permuted to the lanes' k order (`permute_columns`);
K10's int8 query tile is `resident`: widened once a block, into that order,
all of D. The kernels check the plan they are given and ask for `smem`
bytes of dynamic shared memory; a `cuda` test holds this module's count to
the libraries' `widen_sweep_smem`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

CHUNK = 128           # D a stage (int8 bytes of a row)
COL_MULTIPLE = 16     # the D the kernels load whole: 16 bytes of int8
SLICE = 64            # the queries' columns a swizzle row of bf16
TILE_ROWS = 128       # rows of a tile
MAX_STAGES = 8
SMEM_ALIGN = 1024
MAX_SMEM = 232_448    # an H100 block's dynamic shared memory
ROW_STAGE = TILE_ROWS * CHUNK          # int8 rows, one slot
BARRIERS = 128                         # the ring's full and empty mbarriers


@dataclass(frozen=True)
class WidenPlan:
    nq: int          # queries a block: 16 or 64
    stages: int
    resident: bool   # K10's int8 query tile, widened once a block
    chunks: int      # 128-byte chunks of D

    @property
    def smem(self) -> int:
        return smem_bytes(self.nq, self.stages, self.resident, self.chunks)


def q_chunk(nq: int) -> int:
    """The query tile's bf16 bytes a chunk."""
    return nq * CHUNK * 2


def smem_bytes(nq: int, stages: int, resident: bool, chunks: int) -> int:
    """Dynamic shared bytes of a plan (`widen_smem` in the header)."""
    stage = ROW_STAGE + (0 if resident else q_chunk(nq))
    return (SMEM_ALIGN + stages * stage
            + (chunks * q_chunk(nq) if resident else 0) + BARRIERS)


def widen_plan(q: int, d: int, *, int8_queries: bool = False) -> WidenPlan:
    """The plan for Q queries of D (padded to 16) columns: 16 queries a
    block up to Q 16, else 64 (past 64, ceil(Q / 64) query tiles); the
    deepest ring (up to 8 stages) that fits. K10 (`int8_queries`) keeps its
    query tile resident; where 64 queries of D do not fit beside two stages,
    16 do (D ≤ 6144), and past that the plan refuses."""
    if q < 1 or d < 1:
        raise ValueError(f"widen_plan takes Q ≥ 1 and D ≥ 1, got {q}, {d}")
    chunks = -(-(-(-d // COL_MULTIPLE) * COL_MULTIPLE) // CHUNK)
    for nq in (16, 64) if q <= 16 else (64, 16):
        stages = min(MAX_STAGES, (MAX_SMEM - smem_bytes(nq, 0, int8_queries,
                                                        chunks))
                     // (ROW_STAGE + (0 if int8_queries else q_chunk(nq))))
        if stages >= 2:
            return WidenPlan(nq, stages, int8_queries, chunks)
    raise ValueError(f"the query tile of D={d} does not fit in shared "
                     f"memory beside the ring (K10 takes D ≤ 6144)")


def query_col(d: int) -> int:
    """Where the products read query column d: d = 64b + 16t + 4s + j goes
    to 64b + 16s + 2t + (j & 1) + 8·(j >> 1), k step s, slot 2t + ... (the
    header's `query_col`)."""
    t, s, j = (d >> 4) & 3, (d >> 2) & 3, d & 3
    return (d & ~63) + 16 * s + 2 * t + (j & 1) + 8 * (j >> 1)


def permute_columns(x):
    """x [Q, D] → [Q, ceil(D / 64)·64]: zero columns past D, then column d
    moved to `query_col(d)` (a copy; K6's queries as the products read
    them)."""
    rows, d = x.shape
    dp = -(-d // SLICE) * SLICE
    if dp != d:
        x = torch.nn.functional.pad(x, (0, dp - d))
    # [Q, b, t, s, jh, jl] → [Q, b, s, jh, t, jl]
    return (x.reshape(rows, dp // SLICE, 4, 4, 2, 2)
            .permute(0, 1, 3, 4, 2, 5).reshape(rows, dp).contiguous())
