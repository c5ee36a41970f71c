"""Ring attention: context-parallel, non-causal attention over the mesh.

Port of `rag_dpo_tpu/ops/ring_attention.py`. The sequence is split over
the mesh's `shard` axis: each rank attends its block of S_loc query rows
while the K/V blocks travel once around the ring (`batch_isend_irecv` to
the next rank of the shard group, JAX's `ppermute`), so no rank ever holds
the whole [S, S] score matrix. After t steps rank i holds the block that
started on rank src = (i − t) mod n, whose valid keys are the prefix
clamp(length − src·S_loc, 0, S_loc): the key-length mask is exact.

A step is one call of `ring_block`:

* on a CUDA tensor it is K1, `ops.flash_attention(q, k_blk, v_blk,
  block_len, scale, return_lse=True)`, and the steps combine by their lse
  in f32 (`merge_blocks`). K1 writes lse −1e20 and output 0 for a row of a
  block whose keys are all masked, which the merge weights by
  exp(−1e20 − max) = 0;
* on a CPU tensor it is JAX's own online softmax (`block_update`, its
  `:47-69`), in f32.

A query row whose GLOBAL length is 0 gets JAX's value on both paths: the
mean of all S value rows (JAX's exp(s − m) is 1 for every key when all of
them are −1e30). K1 alone would give 0, so the ring carries the sum of the
value rows beside the steps for such rows.

`ring_attention_local` is the per-rank program on this rank's blocks;
`ring_attention_inline` (the encoder's `attention_impl="ring"`) and
`make_ring_attention` take the whole [B, H, S, Dh] on every rank, as JAX's
global arrays are, cut this rank's block, and all-gather the output
blocks back along S. `ring_attention_blocks` runs n logical shards of one
device in turn (the same steps, no collectives).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.mesh import AXIS_SHARD, axis_index, axis_size
from .flash_attention import flash_attention

NEG_INF = -1e30


def block_lengths(lengths, src: int, s_loc: int):
    """[B] valid keys of the block that started on shard `src`."""
    return (lengths - src * s_loc).clamp(0, s_loc).to(torch.int32)


class RingState:
    """The running combination of one query block's steps. `lse_merge`:
    combine K1's (out, lse) pairs (default on a CUDA tensor); forced on a
    CPU tensor, the same merge runs over K1's plain twin."""

    def __init__(self, q, lengths, lse_merge: bool | None = None):
        b, h, s_loc, dh = q.shape
        self.q, self.lengths = q, lengths
        self.kernel = q.is_cuda if lse_merge is None else lse_merge
        dev = q.device
        self.acc = torch.zeros((b, h, s_loc, dh), dtype=torch.float32,
                               device=dev)
        # kernel path: m, l are the running max and sum of exp(lse − m);
        # plain path: JAX's running max and denominator
        self.m = torch.full((b, h, s_loc, 1), NEG_INF, dtype=torch.float32,
                            device=dev)
        self.l = torch.zeros((b, h, s_loc, 1), dtype=torch.float32,
                             device=dev)
        self.v_sum = torch.zeros((b, h, 1, dh), dtype=torch.float32,
                                 device=dev)
        self.n_keys = 0


def ring_block(state: RingState, k_blk, v_blk, src: int, scale: float):
    """Fold one K/V block (the one that started on shard `src`) into
    `state`: K1 and the lse merge on the card, JAX's `block_update` on the
    CPU."""
    q, lengths = state.q, state.lengths
    s_loc = k_blk.shape[2]
    blen = block_lengths(lengths, src, s_loc)
    state.v_sum += v_blk.float().sum(dim=2, keepdim=True)
    state.n_keys += s_loc
    if state.kernel:
        out, lse = flash_attention(q, k_blk, v_blk, blen, scale,
                                   return_lse=True)
        merge_blocks(state, out, lse)
        return
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k_blk.float()) * scale
    valid = torch.arange(s_loc, device=q.device)[None, :] < blen[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m_new = torch.maximum(state.m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(state.m - m_new)
    state.l = state.l * alpha + p.sum(dim=-1, keepdim=True)
    state.acc = state.acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p,
                                                 v_blk.float())
    state.m = m_new


def merge_blocks(state: RingState, out, lse):
    """Fold one block's normalised output and lse into the running sum,
    in f32: acc = Σ exp(lse_j − m)·out_j, l = Σ exp(lse_j − m)."""
    m_new = torch.maximum(state.m, lse)
    alpha = torch.exp(state.m - m_new)
    w = torch.exp(lse - m_new)
    state.l = state.l * alpha + w
    state.acc = state.acc * alpha + w * out.float()
    state.m = m_new


def finish(state: RingState):
    """The output in q's dtype; rows of a length-0 batch element take the
    mean of every value row, as JAX's ring gives them."""
    out = state.acc / state.l.clamp_min(1e-30)
    if state.kernel:
        empty = (state.lengths <= 0)[:, None, None, None]
        out = torch.where(empty, state.v_sum / state.n_keys, out)
    return out.to(state.q.dtype)


def _defaults(q, lengths, scale):
    b = q.shape[0]
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if lengths is None:  # full length: every key of every block is valid
        lengths = torch.full((b,), 1 << 30, dtype=torch.int32,
                             device=q.device)
    return lengths.to(device=q.device, dtype=torch.int32), scale


def _ring_pass(x, group, n: int, me: int):
    """Send `x` to the next rank of the ring, receive the previous one's."""
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    got = torch.empty_like(x)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x.contiguous(), nxt, group),
            dist.P2POp(dist.irecv, got, prv, group)]):
        req.wait()
    return got


def ring_attention_local(mesh, q, k, v, lengths=None, *,
                         axis_name: str = AXIS_SHARD,
                         scale: float | None = None):
    """The per-rank program: q/k/v [B, H, S_loc, Dh] are this rank's
    sequence block, `lengths` [B] the GLOBAL valid lengths (None: full
    length). → this rank's output block [B, H, S_loc, Dh]."""
    lengths, scale = _defaults(q, lengths, scale)
    n, me = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    group = mesh.get_group(axis_name)
    state = RingState(q, lengths)
    kv = torch.stack([k, v])
    for step in range(n):
        ring_block(state, kv[0], kv[1], (me - step) % n, scale)
        if step + 1 < n:
            kv = _ring_pass(kv, group, n, me)
    return finish(state)


def ring_attention_inline(mesh, q, k, v, lengths=None, *,
                          axis_name: str = AXIS_SHARD,
                          scale: float | None = None):
    """Ring attention for a caller that holds the whole [B, H, S, Dh] on
    every rank (the encoder's `attention_impl="ring"`): this rank's block
    of S/n rows runs the ring, and the output blocks are all-gathered
    back along S. S must split over the axis."""
    n, me = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    s = q.shape[2]
    if s % n:
        raise ValueError(f"sequence {s} does not split over {n} shards")
    lo, hi = me * s // n, (me + 1) * s // n
    out = ring_attention_local(mesh, q[:, :, lo:hi], k[:, :, lo:hi],
                               v[:, :, lo:hi], lengths,
                               axis_name=axis_name, scale=scale)
    if n == 1:
        return out
    parts = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(parts, out.contiguous(),
                    group=mesh.get_group(axis_name))
    return torch.cat(parts, dim=2)


def make_ring_attention(mesh, *, axis_name: str = AXIS_SHARD,
                        scale: float | None = None):
    """→ ring_attention(q, k, v, lengths=None) for [B, H, S, Dh] inputs
    whole on every rank, S split over `axis_name`. Non-causal."""

    def fn(q, k, v, lengths=None):
        return ring_attention_inline(mesh, q, k, v, lengths,
                                     axis_name=axis_name, scale=scale)

    return fn


def ring_attention_blocks(q, k, v, lengths=None, n_shards: int = 1, *,
                          scale: float | None = None,
                          lse_merge: bool | None = None):
    """n logical shards of one device: each query block runs the ring's
    steps against every K/V block in the ring's order, and the blocks are
    concatenated. The same arithmetic as the ring, no collectives."""
    lengths, scale = _defaults(q, lengths, scale)
    s = q.shape[2]
    if s % n_shards:
        raise ValueError(f"sequence {s} does not split over {n_shards}")
    s_loc = s // n_shards
    outs = []
    for me in range(n_shards):
        state = RingState(q[:, :, me * s_loc:(me + 1) * s_loc], lengths,
                          lse_merge)
        for step in range(n_shards):
            src = (me - step) % n_shards
            blk = slice(src * s_loc, (src + 1) * s_loc)
            ring_block(state, k[:, :, blk], v[:, :, blk], src, scale)
        outs.append(finish(state))
    return torch.cat(outs, dim=2)
