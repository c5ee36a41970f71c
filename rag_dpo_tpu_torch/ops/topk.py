"""Dense similarity top-k, and the streaming selector's order.

* `fused_topk` — the port of the JAX package's Pallas `fused_topk` (K4):
  exact top-k of `q·eᵀ (+ penalty)` without writing the [Q, N] scores. On
  CUDA tensors it launches the hand-written kernel in `csrc/fused_topk.cu`
  (bf16 inputs: a TMA-fed wgmma product; f32 inputs: a SIMT FMA chain),
  on CPU tensors it runs `fused_topk_plain` (a matmul, the penalty and a
  stable sort). Equal scores keep the lowest row first (ROADMAP C-13).
* `fused_candidates_topk` — the port of the JAX package's Pallas
  `fused_candidates_topk` (K5): the best `per_seg` rows of every
  `seg`-row segment into a candidate strip (`seg_candidates`, the kernel in
  `csrc/seg_candidates.cu` on CUDA tensors, `seg_candidates_plain` on CPU
  tensors), then an exact top-k over the strip in plain torch. It keeps
  JAX's order among equal scores; no store path calls it, in either
  package.
* `cosine_topk_reference` — one matmul + exact top-k.
* `blocked_topk` — the JAX scan over row blocks with a running merge,
  written out as a loop (penalty folding and padding kept exactly).
* `approx_topk` — exact top-k followed by the `k·oversample` cut. On the
  CPU `approx_max_k` is exact with lowest-index ties (ROADMAP C-2), so this
  reproduces the JAX records.

`approx_topk` and `blocked_topk` compute one function, exact top-k with
the lowest row first among ties: on CUDA tensors both go through K4 and
return what their CPU code returns, fill slots included.

`topk_plan` and `candidates_plan` are the kernels' launch plans as pure
functions of the shapes (query tile, ring depth, shared-memory bytes, where
the running lists live, the grid), so the CPU tests can hold every shape a
caller may send to the card's limits. Their byte counts mirror the kernels'
layout; the `cuda` tests hold them to the libraries' own
(`fused_topk_smem`, `fused_topk_merge_smem`, `fused_candidates_smem`).

Every plain selection is a stable descending sort: `lax.top_k` puts the
lower index first among equal scores, and `torch.topk` promises no order.

`streaming_topk_reference` is the plain twin of the order in which the
reference's streaming selector (`topk.py::streaming_topk_update`, shared
by the ELL kernel) emits equal scores: by (1024-row block, extraction
round, 128-row segment), where a row's round is its rank inside its
segment by (score desc, row asc) — ROADMAP C-1.
"""

from __future__ import annotations

import math

import torch

from . import _kernels

NEG_INF = -1e30
_FUSED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FUSED_TILE_N = 128         # rows per tile; a block's rows are a multiple
COL_MULTIPLE = 8            # the D K4 and K5 load whole: 16 bytes of bf16
_SEG_MAX_SPAN = 512         # csrc/seg_candidates.cu: kMaxSpan
SMEM_MAX = 232_448          # shared memory a block may use on an H100
H100_SMS = 132
TC_TILES = (8, 16, 32, 64, 128)   # the wgmma N the bf16 kernels are built for
_RING_MIN, _RING_MAX = 3, 8       # depth of the bf16 kernels' TMA ring
_E_SLOT = 128 * 64 * 2            # a ring slot's rows: 128 × 64 bf16
_WARPS = 8                        # the warps that select (pending buffers)


def _ring_bytes(tile_q: int, stages: int) -> int:
    """csrc/tma_product.cuh::ring_bytes: the 1024-byte alignment slack and
    `stages` slots of (128 rows, tile_q queries) × 64 bf16 with two
    mbarriers each."""
    return 1024 + stages * (_E_SLOT + tile_q * 64 * 2 + 16)


def _lists_bytes(tq: int, k: int, in_smem: bool) -> int:
    """csrc/fused_topk.cu::lists_bytes: pending buffers, per-query count,
    k-th key and flag, and the [tq, k] running lists when shared."""
    return 8 * _WARPS * _FUSED_TILE_N + 16 * tq + (8 * tq * k if in_smem
                                                    else 0)


def _simt_product_bytes(tq: int) -> int:
    """csrc/tile_product.cuh::product_smem_floats, in bytes."""
    return 4 * (32 * (tq + 4) + 32 * (_FUSED_TILE_N + 4))


def _pow2_tile(q: int) -> int:
    return min(TC_TILES[-1], max(TC_TILES[0], 1 << (q - 1).bit_length()))


def _stages(fixed: int, tile_q: int) -> int:
    slot = _E_SLOT + tile_q * 64 * 2 + 16
    return min(_RING_MAX, (SMEM_MAX - 1024 - fixed) // slot)


def topk_plan(q: int, n: int, k: int, dtype, sms: int = H100_SMS) -> dict:
    """K4's launch for Q queries, N rows and k ≤ N.

    bf16 (wgmma): the query tile is Q rounded up to a power of two in
    8 … 128, halved while the running lists of its queries do not fit
    beside a ring of three slots; at 8 the lists go to the candidate
    scratch instead. The ring takes what shared memory is left (3 … 8
    slots). One block per SM: the query tiles of a row chunk are
    neighbours in the grid (they read its rows from L2 together) and the
    chunks fill one wave. f32 (SIMT): 16 or 64 queries, about four blocks
    per SM. Pass 2 keeps its eight lists in shared memory when they fit."""
    if dtype == torch.bfloat16:
        route, tile_q = "wgmma", _pow2_tile(q)
        while True:
            fixed = 4 * tile_q * (_FUSED_TILE_N + 4)
            lists_in_smem = (_ring_bytes(tile_q, _RING_MIN) + fixed
                             + _lists_bytes(tile_q, k, True)) <= SMEM_MAX
            if lists_in_smem or tile_q == TC_TILES[0]:
                break
            tile_q //= 2
        fixed += _lists_bytes(tile_q, k, lists_in_smem)
        stages = _stages(fixed, tile_q)
        smem = _ring_bytes(tile_q, stages) + fixed
        q_tiles = -(-q // tile_q)
        chunks = max(1, sms // q_tiles)
    else:
        route, tile_q, stages = "simt", 16 if q <= 16 else 64, 0
        fixed = _simt_product_bytes(tile_q) + 4 * tile_q * (_FUSED_TILE_N
                                                            + 1)
        lists_in_smem = fixed + _lists_bytes(tile_q, k, True) <= SMEM_MAX
        smem = fixed + _lists_bytes(tile_q, k, lists_in_smem)
        q_tiles = -(-q // tile_q)
        chunks = max(1, -(-4 * sms // q_tiles))
    rows = max(_FUSED_TILE_N, -(-n // chunks))
    rows = -(-rows // _FUSED_TILE_N) * _FUSED_TILE_N
    merge_in_smem = 8 * _WARPS * (_FUSED_TILE_N + k) <= SMEM_MAX
    return {"route": route, "tile_q": tile_q, "stages": stages,
            "smem_bytes": smem, "lists_in_smem": lists_in_smem,
            "rows_per_block": rows, "n_chunks": -(-n // rows),
            "q_tiles": q_tiles, "merge_in_smem": merge_in_smem,
            "merge_smem_bytes": 8 * _WARPS * (_FUSED_TILE_N
                                              + (k if merge_in_smem else 0))}


def seg_spans(seg: int) -> tuple[int, int]:
    """csrc/seg_candidates.cu::span_plan: the rows of K5's span and the
    pieces a segment is cut into. A span holds whole segments, lcm(seg,
    128) rows where that is ≤ 512, else as many as 512 rows hold; a segment
    longer than 512 rows is cut into pieces of 512 (the last shorter), one
    span each, whose picks a second pass merges."""
    if seg > _SEG_MAX_SPAN:
        return _SEG_MAX_SPAN, -(-seg // _SEG_MAX_SPAN)
    span = math.lcm(seg, _FUSED_TILE_N)
    return (span if span <= _SEG_MAX_SPAN
            else seg * (_SEG_MAX_SPAN // seg)), 1


def candidates_plan(q: int, n: int, dtype, *, block_n: int, seg: int,
                    tile_q: int = 64, sms: int = H100_SMS) -> dict:
    """K5's launch. bf16 (wgmma): the query tile is Q rounded up to a
    power of two in 8 … 128 (halved while a [tile, span] score tile and a
    three-slot ring do not fit), the ring takes the rest; one block per SM,
    walking spans. f32 (SIMT): `tile_q` rounded to 16 or 64 queries.
    `pieces` > 1 (seg > 512) adds the merge pass and its scratch of
    `scratch` (score, row) entries."""
    span, pieces = seg_spans(seg)
    n_segs = -(-n // block_n) * (block_n // seg)
    n_spans = (n_segs * pieces if pieces > 1
               else -(-(n_segs * seg) // span))
    if dtype == torch.bfloat16:
        route, tq = "wgmma", _pow2_tile(q)
        while (tq > TC_TILES[0] and _ring_bytes(tq, _RING_MIN)
               + 4 * tq * (span + 4) > SMEM_MAX):
            tq //= 2
        fixed = 4 * tq * (span + 4)
        stages = _stages(fixed, tq)
        smem = _ring_bytes(tq, stages) + fixed
        n_blocks = min(n_spans, max(1, sms // -(-q // tq)))
    else:
        route, stages = "simt", 0
        tq = 16 if min(q, tile_q) <= 16 else 64
        smem = _simt_product_bytes(tq) + 4 * tq * (span + 1)
        n_blocks = min(n_spans, 65_535)
    return {"route": route, "tile_q": tq, "stages": stages,
            "smem_bytes": smem, "span": span, "n_spans": n_spans,
            "n_blocks": n_blocks, "q_tiles": -(-q // tq), "pieces": pieces,
            "scratch": 0 if pieces == 1 else q * n_segs * pieces}


def _sort_desc(x):
    """Stable descending sort along dim 1 (lower index first among ties).
    Adding 0.0 folds −0.0 into +0.0 so no sort can split equal zeros."""
    return torch.sort(x + 0.0, dim=1, descending=True, stable=True)


def _scores(queries, embs):
    return queries.float() @ embs.float().T


def cosine_topk_reference(queries, embs, k: int):
    """[Q, D], [N, D] → ([Q, k] scores, [Q, k] int32 ids). Full materialize."""
    top, ids = _sort_desc(_scores(queries, embs))
    return top[:, :k], ids[:, :k].to(torch.int32)


def _full_penalty(penalty, n: int, dev):
    """`penalty` as [n] f32: rows past its end get −5e29, as in
    `blocked_topk`."""
    pen = torch.full((n,), NEG_INF / 2, dtype=torch.float32, device=dev)
    m = min(n, penalty.shape[0])
    pen[:m] = penalty[:m].float()
    return pen


def fused_topk_plain(queries, embs, k: int, *, penalty=None):
    """Plain twin of K4: a matmul, the penalty and a stable descending
    sort. Returns ([Q, k] f32, [Q, k] int32), (−1e30, −1) past N."""
    if embs.is_cuda:
        _kernels.count_plain("fused_topk")
    n = embs.shape[0]
    s = _scores(queries, embs)
    if penalty is not None:
        s = s + _full_penalty(penalty, n, embs.device)[None, :]
    kk = min(k, n)
    vals, idxs = _sort_desc(s)
    vals, idxs = vals[:, :kk], idxs[:, :kk].to(torch.int32)
    if kk < k:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=NEG_INF)
        idxs = torch.nn.functional.pad(idxs, (0, k - kk), value=-1)
    return vals, idxs


def _dense_inputs(what: str, queries, embs, penalty):
    """What the dense kernels (K4, K5) refuse, as JAX does: other than 2-D,
    mismatched D, an empty axis, dtypes other than one of f32 / bf16 for
    both, or tensors on two devices (ValueError). Returns the inputs as the
    kernels take them: D padded with zero columns to `COL_MULTIPLE` (a
    copy; a zero column adds +0 to every sum), each contiguous and 16-byte
    aligned (a copy where it is not), the penalty as contiguous f32."""
    if queries.dim() != 2 or embs.dim() != 2:
        raise ValueError(f"{what} takes queries [Q, D] and embs [N, D]")
    (q, d), (n, dd) = queries.shape, embs.shape
    if dd != d:
        raise ValueError(f"queries have D={d}, embs D={dd}")
    if q < 1 or n < 1 or d < 1:
        raise ValueError(f"{what} takes no empty axis, got Q={q} N={n} D={d}")
    if embs.dtype not in _FUSED_DTYPES or queries.dtype != embs.dtype:
        raise ValueError(f"the CUDA {what} kernel takes f32 or bf16 queries "
                         f"and embs of one dtype, got {queries.dtype} and "
                         f"{embs.dtype}")
    dev = embs.device
    for name, x in (("queries", queries), ("penalty", penalty)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, embs on {dev}")
    if penalty is not None and penalty.dim() != 1:
        raise ValueError("penalty must be [N]")
    queries, embs = (pad_columns(x, COL_MULTIPLE) for x in (queries, embs))
    queries, embs = (x if x.is_contiguous() and x.data_ptr() % 16 == 0
                     else x.clone(memory_format=torch.contiguous_format)
                     for x in (queries, embs))
    return (queries, embs,
            None if penalty is None else penalty.float().contiguous())


def pad_columns(x, multiple: int):
    """`x` [R, D] with zero columns up to a multiple of `multiple` (a copy),
    or `x` itself when D is one already."""
    extra = -x.shape[1] % multiple
    return torch.nn.functional.pad(x, (0, extra)) if extra else x


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _fused_topk_kernel(queries, embs, k: int, penalty):
    if k < 1:
        raise ValueError(f"fused_topk takes k ≥ 1, got {k}")
    queries, embs, penalty = _dense_inputs("fused_topk", queries, embs,
                                           penalty)
    (q, d), n, dev = queries.shape, embs.shape[0], embs.device
    kk = min(k, n)
    plan = topk_plan(q, n, kk, embs.dtype, _sms(dev))
    cand_s = torch.empty((q, plan["n_chunks"], kk), dtype=torch.float32,
                         device=dev)
    cand_i = torch.empty((q, plan["n_chunks"], kk), dtype=torch.int32,
                         device=dev)
    out_s = torch.empty((q, kk), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, kk), dtype=torch.int32, device=dev)
    lib = _kernels.load("fused_topk")
    with torch.cuda.device(dev):
        err = lib.fused_topk(
            _FUSED_DTYPES[embs.dtype], _kernels.ptr(queries),
            _kernels.ptr(embs), _kernels.ptr(penalty),
            0 if penalty is None else penalty.shape[0], q, n, d, kk,
            plan["rows_per_block"], plan["tile_q"], plan["stages"],
            int(plan["lists_in_smem"]), int(plan["merge_in_smem"]),
            _kernels.ptr(cand_s), _kernels.ptr(cand_i), _kernels.ptr(out_s),
            _kernels.ptr(out_i), _kernels.stream_of(embs))
    _kernels.check(lib, err, "fused_topk")
    _kernels.count_launch("fused_topk")
    if kk < k:
        out_s = torch.nn.functional.pad(out_s, (0, k - kk), value=NEG_INF)
        out_i = torch.nn.functional.pad(out_i, (0, k - kk), value=-1)
    return out_s, out_i


def fused_topk(queries, embs, k: int, *, penalty=None):
    """Exact top-k of `queries · embsᵀ (+ penalty)`: ([Q, k] f32 scores,
    [Q, k] int32 rows), the lowest row first among equal scores; rows past
    `penalty`'s end count −5e29 and slots past N are (−1e30, −1).

    On CUDA: queries and embs both f32 or both bf16, any k ≥ 1 and any D.
    A D that is not a multiple of 8 is padded with zero columns (a copy of
    both on the card, which changes no score; the store pads its image
    once instead), as is an input that is not contiguous and 16-byte
    aligned. Other inputs raise (`_dense_inputs`)."""
    if embs.is_cuda:
        return _fused_topk_kernel(queries, embs, k, penalty)
    return fused_topk_plain(queries, embs, k, penalty=penalty)


def blocked_topk(queries, embs, k: int, block_n: int = 4096, penalty=None):
    """Memory-bounded exact top-k: loop over row blocks with a running
    merge. `penalty` [N] (0 keep / large-negative exclude) folds tombstone
    and filter masks in; rows past `penalty` get −5e29, rows past N −1e30.

    On CUDA it is K4 (`block_n` plays no part there); the running merge's
    fill slots, (−1e30, 0) when k > N, are kept."""
    if embs.is_cuda:
        s, i = fused_topk(queries, embs, k, penalty=penalty)
        return s, torch.where(i < 0, 0, i)
    n, d = embs.shape
    q = queries.shape[0]
    dev = embs.device
    nb = -(-n // block_n)
    qf = queries.float()
    run_s = torch.full((q, k), NEG_INF, dtype=torch.float32, device=dev)
    run_i = torch.zeros((q, k), dtype=torch.int32, device=dev)
    for j in range(nb):
        base = j * block_n
        s = qf @ embs[base:base + block_n].float().T
        width = s.shape[1]
        if width < block_n:  # the reference zero-pads the last block
            s = torch.cat([s, torch.zeros((q, block_n - width), device=dev)],
                          dim=1)
        if penalty is None:
            pblk = torch.zeros((block_n,), dtype=torch.float32, device=dev)
        else:
            pblk = torch.full((block_n,), NEG_INF / 2, dtype=torch.float32,
                              device=dev)
            got = penalty[base:base + block_n].float()
            pblk[: got.shape[0]] = got
        s = s + pblk[None, :]
        valid = base + torch.arange(block_n, device=dev) < n
        s = torch.where(valid[None, :], s, NEG_INF)
        bs, bi = _sort_desc(s)
        kb = min(k, block_n)
        bs, bi = bs[:, :kb], (bi[:, :kb] + base).to(torch.int32)
        ms, mp = _sort_desc(torch.cat([run_s, bs], dim=1))
        run_i = torch.gather(torch.cat([run_i, bi], dim=1), 1, mp[:, :k])
        run_s = ms[:, :k]
    return run_s, run_i


def approx_topk(queries, embs, k: int, oversample: int = 4, penalty=None):
    """matmul + exact stable top-`k·oversample`, cut to k; pads with
    (−1e30, −1) when the corpus holds fewer than k rows. On CUDA it is K4,
    which computes the same function."""
    if embs.is_cuda:
        return fused_topk(queries, embs, k, penalty=penalty)
    scores = _scores(queries, embs)
    if penalty is not None:
        scores = scores + penalty.float()[None, :]
    kk = min(k * oversample, scores.shape[1])
    vals, idxs = _sort_desc(scores)
    vals, idxs = vals[:, :min(k, kk)], idxs[:, :min(k, kk)]
    if kk < k:
        pad = k - kk
        vals = torch.nn.functional.pad(vals, (0, pad), value=NEG_INF)
        idxs = torch.nn.functional.pad(idxs, (0, pad), value=-1)
    return vals, idxs.to(torch.int32)


def seg_candidates_plain(queries, embs, *, penalty=None, block_n: int = 2048,
                         seg: int = 128, per_seg: int = 2):
    """Plain twin of K5: the candidate strip, ([Q, W] f32, [Q, W] int32),
    W = ceil(N / block_n)·(block_n / seg)·per_seg.

    Each `seg`-row segment's rounds are the head of a stable descending
    sort of its scores (−0.0 folded into +0.0, as the reference's `==`
    does); a round after the first is at least −1e30, the value the
    reference masks its picks with. Picks ≤ −5e29 get id −1. Position
    `j·nseg·per_seg + r·nseg + g` holds round r of segment g of block j."""
    if embs.is_cuda:
        _kernels.count_plain("fused_candidates")
    q, n = queries.shape[0], embs.shape[0]
    nb, nseg = -(-n // block_n), block_n // seg
    s = _scores(queries, embs)
    if penalty is not None:
        s = s + _full_penalty(penalty, n, embs.device)[None, :]
    s = torch.nn.functional.pad(s, (0, nb * block_n - n), value=NEG_INF)
    vals, pos = _sort_desc(s.reshape(q * nb * nseg, seg))
    vals, pos = vals[:, :per_seg], pos[:, :per_seg]
    vals[:, 1:] = vals[:, 1:].clamp_min(NEG_INF)
    first = torch.arange(nb * nseg, device=embs.device).repeat(q) * seg
    ids = torch.where(vals > NEG_INF / 2, pos + first[:, None], -1)

    def strip(x):  # [Q·nb·nseg, per_seg] -> block, round, segment
        return x.reshape(q, nb, nseg, per_seg).transpose(2, 3).reshape(q, -1)

    return strip(vals), strip(ids.to(torch.int32))


def _seg_candidates_kernel(queries, embs, penalty, block_n, tile_q, seg,
                           per_seg):
    queries, embs, penalty = _dense_inputs("fused_candidates", queries, embs,
                                           penalty)
    if not (seg > 0 and block_n > 0 and block_n % seg == 0):
        raise ValueError(f"fused_candidates takes seg dividing block_n, got "
                         f"seg={seg} block_n={block_n}")
    if not 1 <= per_seg <= seg:
        raise ValueError(f"the CUDA fused_candidates kernel takes 1 ≤ per_seg "
                         f"≤ seg, got {per_seg}")
    if tile_q < 1:
        raise ValueError(f"tile_q must be positive, got {tile_q}")
    (q, d), n, dev = queries.shape, embs.shape[0], embs.device
    plan = candidates_plan(q, n, embs.dtype, block_n=block_n, seg=seg,
                           tile_q=tile_q, sms=_sms(dev))
    width = -(-n // block_n) * (block_n // seg) * per_seg
    out_s = torch.empty((q, width), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, width), dtype=torch.int32, device=dev)
    scr_s = scr_i = None
    if plan["pieces"] > 1:  # the pieces' picks, merged by a second pass
        scr_s = torch.empty(plan["scratch"] * per_seg, dtype=torch.float32,
                            device=dev)
        scr_i = torch.empty(plan["scratch"] * per_seg, dtype=torch.int32,
                            device=dev)
    lib = _kernels.load("fused_candidates")
    with torch.cuda.device(dev):
        err = lib.fused_candidates(
            _FUSED_DTYPES[embs.dtype], _kernels.ptr(queries),
            _kernels.ptr(embs), _kernels.ptr(penalty),
            0 if penalty is None else penalty.shape[0], q, n, d, block_n,
            seg, per_seg, plan["tile_q"], plan["stages"], plan["n_blocks"],
            _kernels.ptr(scr_s), _kernels.ptr(scr_i), _kernels.ptr(out_s),
            _kernels.ptr(out_i), _kernels.stream_of(embs))
    _kernels.check(lib, err, "fused_candidates")
    _kernels.count_launch("fused_candidates")
    return out_s, out_i


def seg_candidates(queries, embs, *, penalty=None, block_n: int = 2048,
                   tile_q: int = 64, seg: int = 128, per_seg: int = 2):
    """Phase 1 of `fused_candidates_topk`: the candidate strip of
    `seg_candidates_plain`. On CUDA it launches K5 (`csrc/seg_candidates.cu`;
    f32 takes `tile_q` rounded to 16- or 64-query tiles, bf16 the tile of
    `candidates_plan`): queries and embs both f32 or both bf16, any D (one
    that is not a multiple of 8 is padded with zero columns, a copy on the
    card, as `fused_topk` does), any seg dividing block_n, 1 ≤ per_seg ≤
    seg; anything else raises."""
    if embs.is_cuda:
        return _seg_candidates_kernel(queries, embs, penalty, block_n, tile_q,
                                      seg, per_seg)
    return seg_candidates_plain(queries, embs, penalty=penalty,
                                block_n=block_n, seg=seg, per_seg=per_seg)


def _select_candidates(cand_s, cand_i, k: int, n: int):
    """Phase 2: exact top-min(k, N) over the strip, the lowest strip
    position first among equal scores (the reference's `lax.top_k`, and
    above a width of 4,096 the CPU `approx_max_k` before it, which is exact
    and stable there: C-2); (−1e30, −1) past it."""
    kk = min(k, n, cand_s.shape[1])
    top, pos = _sort_desc(cand_s)
    top, pos = top[:, :kk], pos[:, :kk]
    ids = torch.where(top > NEG_INF / 2, torch.gather(cand_i, 1, pos), -1)
    if kk < k:
        top = torch.nn.functional.pad(top, (0, k - kk), value=NEG_INF)
        ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
    return top, ids


def fused_candidates_topk_plain(queries, embs, k: int, *, penalty=None,
                                block_n: int = 2048, seg: int = 128,
                                per_seg: int = 2):
    """Plain twin of `fused_candidates_topk`."""
    cand = seg_candidates_plain(queries, embs, penalty=penalty,
                                block_n=block_n, seg=seg, per_seg=per_seg)
    return _select_candidates(*cand, k, embs.shape[0])


def fused_candidates_topk(queries, embs, k: int, *, penalty=None,
                          block_n: int = 2048, tile_q: int = 64,
                          seg: int = 128, per_seg: int = 2):
    """Approximate dense top-k without the [Q, N] scores: the best
    `per_seg` rows of every `seg`-row segment (`seg_candidates`, K5 on
    CUDA), then an exact top-k over that strip. Returns ([Q, k] f32 scores,
    [Q, k] int32 rows): the JAX `fused_candidates_topk` (minus `interpret`),
    its order among equal scores included; rows past `penalty`'s end count
    −5e29, slots past the strip or N are (−1e30, −1).

    A row of the true top-k is lost only when more than `per_seg` of them
    share its segment."""
    cand = seg_candidates(queries, embs, penalty=penalty, block_n=block_n,
                          tile_q=tile_q, seg=seg, per_seg=per_seg)
    return _select_candidates(*cand, k, embs.shape[0])


def streaming_topk_reference(scores, k: int, *, block_n: int = 1024,
                             seg: int = 128, n_valid: int | None = None):
    """Exact top-k of [Q, N] scores in the reference streaming order.

    Columns at or past `n_valid` (default N) are empty: score −1e30, id −1.
    Returns ([Q, k] f32 scores, [Q, k] int32 ids); needs k ≤ N rounded up
    to `block_n`."""
    q, n = scores.shape
    dev = scores.device
    n_valid = n if n_valid is None else n_valid
    seg = min(seg, block_n)
    assert block_n % seg == 0, (block_n, seg)
    n_pad = -(-n // block_n) * block_n
    col = torch.arange(n_pad, device=dev)
    s = torch.full((q, n_pad), NEG_INF, dtype=torch.float32, device=dev)
    s[:, :n] = scores.float()
    s = torch.where(col[None, :] < n_valid, s, NEG_INF)
    # round = rank inside the segment by (score desc, row asc)
    order = _sort_desc(s.reshape(q * (n_pad // seg), seg)).indices
    rnd = torch.empty_like(order)
    rnd.scatter_(1, order, torch.arange(seg, device=dev).expand_as(order))
    rnd = rnd.reshape(q, n_pad)
    nseg = block_n // seg
    tie_key = ((col // block_n) * block_n + rnd * nseg
               + (col % block_n) // seg)  # unique per row
    perm = torch.argsort(tie_key, dim=1)
    top, pos = _sort_desc(torch.gather(s, 1, perm))
    top, pos = top[:, :k], pos[:, :k]
    ids = torch.gather(perm, 1, pos)
    ids = torch.where(top > NEG_INF / 2, ids, -1)
    return top, ids.to(torch.int32)
