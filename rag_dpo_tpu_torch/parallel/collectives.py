"""Cross-shard top-k: each rank scores its block of the corpus rows, keeps
its best k, and the global top-k is re-selected from everyone's k.

Port of `rag_dpo_tpu/parallel/collectives.py`. Each JAX function is split
in two pure halves joined by exactly one `dist.all_gather` on the mesh's
shard group:

* the local half (`local_topk`): the rank's own `local_fn`, its list padded
  to k with (−inf, position 0) or cut to k, and its positions mapped to
  global ids through the rank's `shard_ids`;
* the merge (`merge_topk`): a stacked [Q, S, k] of every shard's list,
  flattened shard-major and re-selected, the lowest flat index first among
  equal scores, as `lax.top_k` orders them.

So S logical shards can run in one process by stacking their local halves
and calling the merge (`topk_merge_pairs` is that merge over two lists).
The gather carries scores and ids in one f32 tensor (the int32 ids as
their bits), so a merge costs one collective.

The training step's collectives are differentiable, each over one axis of
the mesh (`mesh.AxisGroup`; None or an axis of size 1 is the identity):

* `all_gather`: JAX's `all_gather(tiled=True)`, whose transpose sums the
  full gradient over the axis and keeps this rank's block (an all-reduce,
  then a slice);
* `pmean`: the mean over the axis, whose transpose divides the (equal)
  cotangent by the axis size;
* Megatron's pair over the `model` axis: `copy_to_model` (*f*: identity
  forward, all-reduce of the gradient) before a `_COL` product, and
  `reduce_from_model` (*g*: all-reduce forward, identity backward) after a
  `_ROW` product.

Each is an `all_gather` or an `all_reduce`, the two collectives gloo
carries on CUDA tensors as well as NCCL does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.quantize import _stable_topk
from .mesh import AXIS_SHARD, axis_size


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, ax):
        ctx.dim, ctx.ax = dim, ax
        parts = [torch.empty_like(x) for _ in range(ax.size)]
        dist.all_gather(parts, x.contiguous(), group=ax.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.ax.group)
        return grad.chunk(ctx.ax.size, dim=ctx.dim)[ctx.ax.rank], None, None


class _AllReduce(torch.autograd.Function):
    """The sum over the axis, times `scale`; backward: the cotangent times
    `scale`, no collective (every rank holds the same cotangent)."""

    @staticmethod
    def forward(ctx, x, ax, scale: float):
        ctx.scale = scale
        out = x.reshape(-1).clone()          # a scalar as one element
        dist.all_reduce(out, group=ax.group)
        out = out.view(x.shape)
        return out * scale if scale != 1.0 else out

    @staticmethod
    def backward(ctx, grad):
        return (grad * ctx.scale if ctx.scale != 1.0 else grad), None, None


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.ax.group)
        return grad, None


def _active(ax) -> bool:
    return ax is not None and ax.size > 1


def all_gather(x, ax, dim: int = 0):
    """The blocks of every rank of the axis, concatenated along `dim` in
    coordinate order; differentiable (see the module docstring)."""
    return _AllGather.apply(x, dim, ax) if _active(ax) else x


def gather_rows(x, ax, dim: int = 0):
    """`all_gather` without a gradient, for any dtype (bools travel as
    int32, which every backend carries)."""
    if not _active(ax):
        return x
    with torch.no_grad():
        y = x.to(torch.int32) if x.dtype == torch.bool else x
        parts = [torch.empty_like(y) for _ in range(ax.size)]
        dist.all_gather(parts, y.contiguous(), group=ax.group)
        out = torch.cat(parts, dim=dim)
    return out.bool() if x.dtype == torch.bool else out


def pmean(x, ax):
    """The mean over the axis; differentiable."""
    return _AllReduce.apply(x, ax, 1.0 / ax.size) if _active(ax) else x


def copy_to_model(x, tp):
    """Megatron's *f*: identity forward, the gradient all-reduced over the
    model axis (each rank's `_COL` slice gives only its share of it)."""
    return _ReduceGrad.apply(x, tp) if _active(tp) else x


def reduce_from_model(x, tp):
    """Megatron's *g*: the `_ROW` slices' partial products summed over the
    model axis; the gradient passes through unchanged."""
    return _AllReduce.apply(x, tp, 1.0) if _active(tp) else x


def sum_grads(params, ax, bucket_numel: int = 1 << 26) -> None:
    """Every parameter's `.grad` summed over the axis in place, in flat
    buckets of at most `bucket_numel` elements (one all-reduce a bucket);
    parameters without a gradient are skipped on every rank alike."""
    if not _active(ax):
        return
    grads = [p.grad for p in params if p.grad is not None]
    start = 0
    while start < len(grads):
        end, n = start, 0
        while end < len(grads) and (end == start
                                    or n + grads[end].numel()
                                    <= bucket_numel):
            n += grads[end].numel()
            end += 1
        bucket = grads[start:end]
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=ax.group)
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))
        start = end


def _pad_or_cut(scores, pos, k: int):
    """JAX's `:115-125`: a list of kk < k padded with (−inf, 0); one of
    kk > k cut to its best k (stable)."""
    kk = scores.shape[1]
    if kk < k:
        scores = torch.nn.functional.pad(scores.float(), (0, k - kk),
                                         value=-torch.inf)
        pos = torch.nn.functional.pad(pos, (0, k - kk), value=0)
    elif kk > k:
        scores, keep = _stable_topk(scores, k)
        pos = torch.gather(pos, 1, keep)
    return scores.float(), pos


def local_topk(loc_scores, loc_pos, k: int, shard_ids):
    """The local half: ([Q, kk] scores desc, [Q, kk] local row positions)
    of one shard → ([Q, k] f32, [Q, k] int32 global ids)."""
    scores, pos = _pad_or_cut(loc_scores, loc_pos, k)
    pos = pos.long().clamp(0, shard_ids.shape[0] - 1)
    return scores, shard_ids.to(pos.device)[pos].to(torch.int32)


def merge_topk(all_scores, all_ids, k: int):
    """The merge: [Q, S, k'] scores and ids of S shards → ([Q, k] f32,
    [Q, k] int32), selected from the shard-major flattening with the
    lowest flat index first among equal scores."""
    q = all_scores.shape[0]
    flat_s = all_scores.reshape(q, -1)
    top, pos = _stable_topk(flat_s, k)
    return top, torch.gather(all_ids.reshape(q, -1), 1, pos).to(torch.int32)


def gather_shards(scores, ids, mesh, axis: str = AXIS_SHARD):
    """One all-gather over the mesh's `axis` group: ([Q, k], [Q, k]) of
    this rank → ([Q, S, k], [Q, S, k]) in shard order."""
    packed = torch.stack([scores.float(),
                          ids.to(torch.int32).view(torch.float32)])
    parts = [torch.empty_like(packed) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, packed.contiguous(), group=mesh.get_group(axis))
    both = torch.stack(parts, dim=2)                      # [2, Q, S, k]
    return both[0], both[1].contiguous().view(torch.int32)


def merge_sharded_topk(local_scores, local_ids, k: int, mesh,
                       axis: str = AXIS_SHARD):
    """Every shard's ([Q, k] scores desc, [Q, k] global ids) → the global
    top-k, the same on every rank of the `axis` group."""
    all_s, all_i = gather_shards(local_scores, local_ids, mesh, axis)
    return merge_topk(all_s, all_i, k)


def sharded_topk(mesh, scores_fn, k: int, *, shard_axis: str = AXIS_SHARD):
    """→ search(queries, shard_embs, shard_ids) → (scores [Q, k], global
    ids [Q, k]): `scores_fn(queries, shard_embs)` scores this rank's rows
    [Q, n_local], their stable top-min(k, n_local) is the local list."""

    def search(queries, shard_embs, shard_ids):
        s = scores_fn(queries, shard_embs)
        loc_s, loc_p = _stable_topk(s, min(k, s.shape[1]))
        return merge_sharded_topk(*local_topk(loc_s, loc_p, k, shard_ids),
                                  k, mesh, shard_axis)

    return search


def sharded_topk_multi(mesh, local_fn, k: int, n_sharded: int, *,
                       n_replicated: int = 0,
                       shard_axis: str = AXIS_SHARD):
    """General sharded top-k over any row-sharded operands (dense rows,
    ELL terms and impacts, posting tables, penalties): `local_fn(queries,
    *operands)` → ([Q, kk] local scores desc, [Q, kk] LOCAL positions),
    the operands this rank's `n_sharded` blocks then `n_replicated` whole
    arrays. → search(queries, shard_ids, *operands) → (scores [Q, k],
    global ids [Q, k]) on every rank."""

    def search(queries, shard_ids, *arrays):
        if len(arrays) != n_sharded + n_replicated:
            raise ValueError(f"search takes {n_sharded} sharded and "
                             f"{n_replicated} replicated operands, got "
                             f"{len(arrays)}")
        loc = local_topk(*local_fn(queries, *arrays), k, shard_ids)
        return merge_sharded_topk(*loc, k, mesh, shard_axis)

    return search


def topk_merge_pairs(scores_a, ids_a, scores_b, ids_b, k: int):
    """Merge two (score, id) top-k lists (e.g. two indexes): the first's
    entries first among equal scores."""
    return merge_topk(torch.cat([scores_a, scores_b], dim=-1)[:, None],
                      torch.cat([ids_a, ids_b], dim=-1)[:, None], k)
