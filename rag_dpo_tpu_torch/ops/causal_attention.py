"""Causal grouped-query attention of the decoder over its K/V cache.

`causal_attention` is what `models.decoder.GQAttention` calls. On CUDA
tensors whose query rows fill at least one of the kernel's tiles
(`kernel_fits`) and with no key mask, it launches the hand-written kernel in
`csrc/flash_prefill.cu`: one fused, causal, GQA-grouped flash forward over
the cache's bf16 (or f32) rows, with the causal edge and the rows past a
prompt's length bounding the work. Elsewhere (the CPU, a decode step's
1 + k rows, a key mask, a head wider than 128, another dtype) it runs
`causal_attention_plain`, the decoder's blocked f32 einsums as they were.

It replaces no TPU kernel: the JAX decoder computes this attention with
XLA einsums (`rag_dpo_tpu/models/decoder.py`, `DecoderAttention`).

Both compute in f32 what the JAX module computes: logits / sqrt(Dh), keys
past a query's position masked to `NEG_INF`, softmax, the weighted sum; the
output is rounded once to the input's dtype. The kernel's products are
exact (bf16 Q·Kᵀ on the tensor cores, P carried at 24 bits as three bf16
pieces against V), so the two differ only in the order of the f32 sums.

Rows after a batch row's last `write_mask` row are padding: they write no
K/V, no valid row sees them, and the kernel writes zeros for every query
tile wholly among them. Callers read only valid rows.
"""

from __future__ import annotations

import torch

from . import _kernels

NEG_INF = -1e30
# f32 attention logits of one block of query rows of the plain twin, in
# bytes: a long prompt never materialises [B, KV, S, group, kv_len] at once
ATTN_BLOCK_BYTES = 1 << 29
# (position, head) rows of one block of the kernel: 4 warps of 16
TILE_ROWS = 64
KERNEL_MAX_DH = 128
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_fits(q, k) -> bool:
    """Whether the kernel takes q [B, S, nh, Dh] against k [B, L, nkv, Dh]
    by shape and dtype alone: the S · nh / nkv query rows fill one of its
    tiles, Dh ≤ 128, and q and k are both f32 or both bf16."""
    b, s, nh, dh = q.shape
    return (q.dtype in _KERNEL_DTYPES and k.dtype == q.dtype
            and dh <= KERNEL_MAX_DH and s * (nh // k.shape[2]) >= TILE_ROWS)


def causal_attention_plain(q, k, v, positions, attn_mask=None):
    """Plain twin: q [B, S, nh, Dh], k / v [B, kv_len, nkv, Dh], positions
    [B, S]; query row i sees key j iff j ≤ positions[b, i] (and
    attn_mask[b, j] where given). → [B, S, nh, Dh] in q's dtype."""
    if q.is_cuda:
        _kernels.count_plain("flash_prefill")
    b, s, nh, dh = q.shape
    kv_len, nkv = k.shape[1], k.shape[2]
    group = nh // nkv
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    qg = q.to(torch.float32).reshape(b, s, nkv, group, dh)
    key_pos = torch.arange(kv_len, device=q.device)
    ctx = torch.empty((b, s, nkv, group, dh), dtype=torch.float32,
                      device=q.device)
    step = max(1, ATTN_BLOCK_BYTES // (4 * b * nh * kv_len))
    for i in range(0, s, step):
        logits = torch.einsum("bskgd,bmkd->bksgm", qg[:, i:i + step],
                              kf) / (dh ** 0.5)
        # causal/cache mask: query at pos p sees keys at pos ≤ p
        mask = key_pos[None, None, None, None, :] \
            <= positions[:, None, i:i + step, None, None]
        if attn_mask is not None:   # [B, kv_len] key validity
            mask = mask & attn_mask[:, None, None, None, :kv_len]
        probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
        ctx[:, i:i + step] = torch.einsum("bksgm,bmkd->bskgd", probs, vf)
    return ctx.reshape(b, s, nh, dh).to(q.dtype)


def _kv_strides(k, v):
    """(batch stride, row stride) in elements that k and v share, their
    last two dimensions contiguous; copies where they are not."""
    dh = k.shape[3]

    def fits(x):
        return x.stride(3) == 1 and x.stride(2) == dh

    if not (fits(k) and fits(v) and k.stride()[:2] == v.stride()[:2]):
        k, v = k.contiguous(), v.contiguous()
    # a batch of one reads no batch stride
    return k, v, k.stride(0) if k.shape[0] > 1 else 0, k.stride(1)


def kernel_rows(positions, write_mask=None) -> tuple:
    """What the kernel reads of a forward's rows, the same in each of its
    layers: positions [B, S] as int32, and one past each batch row's last
    write_mask row as int32 [B] (None: every row valid), on the device."""
    pos = positions.to(torch.int32).contiguous()
    if write_mask is None:
        return pos, None
    idx = torch.arange(1, pos.shape[1] + 1, dtype=torch.int32,
                       device=pos.device)
    counts = (write_mask.to(torch.int32) * idx).amax(dim=1)
    return pos, counts.to(torch.int32).contiguous()


def flash_prefill(q, k, v, pos, counts=None):
    """The kernel: q [B, S, nh, Dh] against k / v, the cache's first
    kv_len rows [B, kv_len, nkv, Dh] (a view of the cache is read in
    place), with `kernel_rows`' pos and counts. → [B, S, nh, Dh] in q's
    dtype; each batch row's rows from its count on are padding. Takes what
    `kernel_fits` admits, k and v in q's dtype; the library refuses other
    head widths and groups."""
    b, s, nh, dh = q.shape
    kv_len, nkv = k.shape[1], k.shape[2]
    q = q.contiguous()
    k, v, kv_bs, kv_rs = _kv_strides(k, v)
    out = torch.empty_like(q)
    lib = _kernels.load("flash_prefill")
    with torch.cuda.device(q.device):
        err = lib.flash_prefill(
            _KERNEL_DTYPES[q.dtype], _kernels.ptr(q), _kernels.ptr(k),
            _kernels.ptr(v), _kernels.ptr(pos), _kernels.ptr(counts),
            _kernels.ptr(out), b, s, nh, nkv, dh, kv_len, kv_bs, kv_rs,
            float(dh) ** -0.5, _kernels.stream_of(q))
    _kernels.check(lib, err, "flash_prefill")
    _kernels.count_launch("flash_prefill")
    return out


def causal_attention(q, k, v, positions, write_mask=None, attn_mask=None,
                     rows=None):
    """q [B, S, nh, Dh] against the first kv_len cache rows k / v [B,
    kv_len, nkv, Dh] → [B, S, nh, Dh] in q's dtype: the kernel where it
    fits on the card, the plain twin elsewhere (module docstring). `rows`:
    `kernel_rows(positions, write_mask)` where the caller made it once for
    all its layers."""
    if q.is_cuda and attn_mask is None and kernel_fits(q, k):
        return flash_prefill(q, k, v,
                             *(rows or kernel_rows(positions, write_mask)))
    return causal_attention_plain(q, k, v, positions, attn_mask)
