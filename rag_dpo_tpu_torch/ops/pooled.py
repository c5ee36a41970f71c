"""Pooled-max dense sweep over int8 rows, a candidate generator.

`pooled_group_max` is the port of the JAX package's Pallas
`pooled_group_max` (K6): bf16 queries against int8 rows widened in the
kernel, × the per-row scale, + the penalty; per `block_n`-row block the
rows form `block_n / group` strided groups (group g holds rows
`a·ng + g`), and each group gives its max (bf16) and the row of its first
argmax (the lowest row wins a tie; −1 where the max is not above −5e29).
On CUDA tensors it launches the hand-written kernel in `csrc/pooled.cu`
(the int8 rows widened to bf16 once a block, the products on the tensor
cores; `ops/widen_product.py`'s plan and query column order), on CPU
tensors it runs `pooled_group_max_plain`. The reference's
`(block_n // group) % 128` check was a Mosaic lane constraint and is gone;
`block_n % group == 0` stays.

`pooled_topk_int8` is the reference's composition around the kernel: a
cut of the pooled strip (a stable descending sort here, where the
reference runs `approx_max_k`) and an exact re-score of the survivors. As
in the reference, no store path calls it: the store's int8 arm ranks by
int8 × int8 scores (`ops.quantize`).
"""

from __future__ import annotations

import torch

from . import _kernels
from .topk import NEG_INF, _sort_desc, pad_columns
from .widen_product import COL_MULTIPLE, permute_columns, widen_plan


def _check_blocks(block_n: int, group: int) -> None:
    if group < 1 or block_n < 1 or block_n % group:
        raise ValueError(f"block_n ({block_n}) must be a positive multiple "
                         f"of group ({group})")


def pooled_group_max_plain(queries_bf16, e_i8, e_scale, penalty=None, *,
                           block_n: int = 8192, group: int = 64):
    """Plain twin of K6: widen to f32, a matmul, the scale and the penalty,
    then max and first argmax over each strided group."""
    _check_blocks(block_n, group)
    if e_i8.is_cuda:
        _kernels.count_plain("pooled_max")
    q = queries_bf16.shape[0]
    n = e_i8.shape[0]
    dev = e_i8.device
    nb = -(-n // block_n)
    n_pad = nb * block_n
    ng = block_n // group
    s = queries_bf16.float() @ e_i8.float().T                  # [Q, N]
    scale = torch.zeros((n_pad,), dtype=torch.float32, device=dev)
    scale[:n] = e_scale.float()
    pen = torch.zeros((n_pad,), dtype=torch.float32, device=dev)
    if penalty is not None:
        pen.fill_(NEG_INF / 2)
        m = min(n_pad, penalty.shape[0])
        pen[:m] = penalty[:m].float()
    s = torch.nn.functional.pad(s, (0, n_pad - n))
    s = s * scale[None, :] + pen[None, :]
    s = torch.where(torch.arange(n_pad, device=dev)[None, :] < n, s, NEG_INF)
    s4 = s.reshape(q, nb, group, ng)        # (t, j, a, g) = s[t, j·bn + a·ng + g]
    vals = s4.amax(dim=2)                                       # [Q, nb, ng]
    a_iota = torch.arange(group, device=dev)[None, None, :, None]
    pos = torch.where(s4 == vals[:, :, None, :], a_iota, group).amin(dim=2)
    ids = (torch.arange(nb, device=dev)[None, :, None] * block_n
           + pos * ng + torch.arange(ng, device=dev)[None, None, :])
    ids = torch.where(vals > NEG_INF / 2, ids, -1).to(torch.int32)
    return (vals.reshape(q, nb * ng).to(torch.bfloat16),
            ids.reshape(q, nb * ng))


def _pooled_inputs(queries_bf16, e_i8, e_scale, penalty, block_n: int,
                   group: int):
    """What K6 refuses (ValueError), or its inputs as it takes them:
    D padded with zero columns to `COL_MULTIPLE`, contiguous and 16-byte
    aligned, the scales and penalty as contiguous f32."""
    _check_blocks(block_n, group)
    if queries_bf16.dim() != 2 or e_i8.dim() != 2:
        raise ValueError("pooled_group_max takes queries [Q, D] and e_i8 "
                         "[N, D]")
    (q, d), (n, dd) = queries_bf16.shape, e_i8.shape
    if dd != d:
        raise ValueError(f"queries have D={d}, e_i8 D={dd}")
    if q < 1 or n < 1 or d < 1:
        raise ValueError(f"pooled_group_max takes no empty axis, got Q={q} "
                         f"N={n} D={d}")
    if queries_bf16.dtype != torch.bfloat16 or e_i8.dtype != torch.int8:
        raise ValueError(f"the CUDA pooled kernel takes bf16 queries and "
                         f"int8 rows, got {queries_bf16.dtype} and "
                         f"{e_i8.dtype}")
    if e_scale.shape != (n,):
        raise ValueError(f"e_scale must be [{n}], got {tuple(e_scale.shape)}")
    dev = e_i8.device
    for name, x in (("queries", queries_bf16), ("e_scale", e_scale),
                    ("penalty", penalty)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, e_i8 on {dev}")
    # zero columns add +0 to every sum; a copy on the card, as fused_topk
    # pads
    queries_bf16, e_i8 = (pad_columns(x, COL_MULTIPLE)
                          for x in (queries_bf16, e_i8))
    queries_bf16, e_i8 = (
        x if x.is_contiguous() and x.data_ptr() % 16 == 0
        else x.clone(memory_format=torch.contiguous_format)
        for x in (queries_bf16, e_i8))
    scale = e_scale.float().contiguous()
    if penalty is not None:
        if penalty.dim() != 1:
            raise ValueError("penalty must be [N]")
        penalty = penalty.float().contiguous()
    return queries_bf16, e_i8, scale, penalty


def _pooled_max_kernel(queries_bf16, e_i8, e_scale, penalty, block_n: int,
                       group: int):
    queries_bf16, e_i8, scale, penalty = _pooled_inputs(
        queries_bf16, e_i8, e_scale, penalty, block_n, group)
    (q, d), n, dev = queries_bf16.shape, e_i8.shape[0], e_i8.device
    n_pool = -(-n // block_n) * (block_n // group)
    out_v = torch.empty((q, n_pool), dtype=torch.bfloat16, device=dev)
    out_i = torch.empty((q, n_pool), dtype=torch.int32, device=dev)
    n_pen = 0 if penalty is None else penalty.shape[0]
    if penalty is not None and n_pen == 0:  # a null pointer is no penalty
        penalty = torch.zeros(1, dtype=torch.float32, device=dev)
    plan = widen_plan(q, d)
    # the queries' columns in the lanes' k order, a copy on the card
    queries_bf16 = permute_columns(queries_bf16)
    lib = _kernels.load("pooled_max")
    with torch.cuda.device(dev):
        err = lib.pooled_max(
            _kernels.ptr(queries_bf16), _kernels.ptr(e_i8),
            _kernels.ptr(scale), _kernels.ptr(penalty), n_pen, q, n, d,
            block_n, group, plan.nq, plan.stages,
            _kernels.ptr(out_v), _kernels.ptr(out_i),
            _kernels.stream_of(e_i8))
    _kernels.check(lib, err, "pooled_max")
    _kernels.count_launch("pooled_max")
    return out_v, out_i


def pooled_group_max(queries_bf16, e_i8, e_scale, penalty=None, *,
                     block_n: int = 8192, group: int = 64):
    """[Q, D] bf16 × int8 [N, D] → pooled ([Q, N/group] bf16 maxima,
    [Q, N/group] int32 first-argmax rows), N rounded up to `block_n`.

    On CUDA: bf16 queries and int8 rows, any D (one that is not a multiple
    of 16 is padded with zero columns, a copy on the card that changes no
    score; the store pads its image once instead); other dtypes raise."""
    if e_i8.is_cuda:
        return _pooled_max_kernel(queries_bf16, e_i8, e_scale, penalty,
                                  block_n, group)
    return pooled_group_max_plain(queries_bf16, e_i8, e_scale, penalty,
                                  block_n=block_n, group=group)


def pooled_topk_int8(q_f32, e_i8, e_scale, e_ref, k: int,
                     oversample: int = 4, penalty=None, *,
                     block_n: int = 8192, group: int = 64):
    """Pooled sweep → the best `k·oversample` groups (stable descending
    sort of the strip) → exact f32 re-score against `e_ref` rows → exact
    top-k: ([Q, k] f32, [Q, k] int32), (−1e30, −1) padded. Slots whose
    pooled value carries the −1e4 penalty (≤ −1e3) stay excluded."""
    pooled_v, pooled_i = pooled_group_max(
        q_f32.to(torch.bfloat16), e_i8, e_scale, penalty, block_n=block_n,
        group=group)
    npool = pooled_v.shape[1]
    kk = min(k * oversample, npool)
    cvals, cpos = _sort_desc(pooled_v.float())
    cvals, cpos = cvals[:, :kk], cpos[:, :kk]
    cids = torch.gather(pooled_i, 1, cpos)
    safe = torch.where(cids >= 0, cids, 0)
    rows = e_ref[safe].float()                                 # [Q, C, D]
    exact = torch.einsum("qd,qcd->qc", q_f32.float(), rows)
    exact = torch.where((cids >= 0) & (cvals > -1e3), exact, NEG_INF)
    kk_out = min(k, exact.shape[1])
    top, pos = _sort_desc(exact)
    top, pos = top[:, :kk_out], pos[:, :kk_out]
    ids = torch.gather(cids, 1, pos)
    ids = torch.where(top > NEG_INF / 2, ids, -1).to(torch.int32)
    if kk_out < k:
        top = torch.nn.functional.pad(top, (0, k - kk_out), value=NEG_INF)
        ids = torch.nn.functional.pad(ids, (0, k - kk_out), value=-1)
    return top, ids
