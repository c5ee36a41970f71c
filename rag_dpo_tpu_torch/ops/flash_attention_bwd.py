"""Flash attention with a fused backward, for training the encoder.

Port of `rag_dpo_tpu/ops/flash_attention_bwd.py::flash_attention_fused`.
`flash_attention_fused` is a `torch.autograd.Function`: its forward is the
flash kernel of `ops.flash_attention` with the per-row logsumexp, and its
backward computes dq and dk/dv blockwise from (q, k, v, lse), the
FlashAttention-2 backward, so nothing [S, S] is kept between the two.

On CUDA tensors the backward launches the hand-written kernels of
`csrc/flash_bwd.cu` (`flash_bwd_dq`, `flash_bwd_dkv`), built for the widths
`KERNEL_WIDTHS`: q, k, v and dO of another Dh go in as copies padded with
zero columns (`pad_head`) and the gradients come back sliced, with `scale`
from the true Dh, which changes no bit; on CPU tensors it
runs their plain twins, which compute what the reference's `_fused_bwd`
computes, written out rather than taken from autograd through
`flash_attention_plain`: the reference zeroes dq on padded query rows and
drops those rows from dk/dv, whatever the incoming gradient holds there.

With no gradient to compute (under `torch.no_grad`/`inference_mode`, or no
input that requires one) `flash_attention_fused` is the plain forward
call: the kernel runs without lse and nothing is saved.
"""

from __future__ import annotations

import torch

from . import _kernels
from .flash_attention import (
    _KERNEL_DTYPES,
    NEG_INF,
    _defaults,
    flash_attention,
    kernel_width,
    pad_head,
)


def _row_delta(out, g):
    """D = rowsum(dO * O) in f32, [B, H, S, 1] (plain torch on every device,
    as the reference leaves it to XLA)."""
    return (g.float() * out.float()).sum(dim=-1, keepdim=True)


def _probs_and_dscores(q, k, v, lengths, lse, g, dd, scale):
    """P and dS of the reference in one key block, f32; both 0 where
    key ≥ length."""
    s = q.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    key_ok = (torch.arange(s, device=q.device)[None, :]
              < lengths.to(q.device)[:, None])[:, None, None, :]
    p = torch.where(key_ok, scores - lse, NEG_INF).exp()
    dp = torch.einsum("bhqd,bhkd->bhqk", g.float(), v.float())
    return p, p * (dp - dd)


def _query_rows_ok(q, lengths):
    s = q.shape[2]
    return (torch.arange(s, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])[:, None, :, None]


def flash_bwd_dq_plain(q, k, v, lengths, lse, dd, g, scale):
    """Plain twin of `flash_bwd_dq`: dQ = scale·dS·K, 0 on rows ≥ length."""
    if q.is_cuda:
        _kernels.count_plain("flash_bwd_dq")
    _, ds = _probs_and_dscores(q, k, v, lengths, lse, g, dd, scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    return torch.where(_query_rows_ok(q, lengths), dq, 0.0).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, lengths, lse, dd, g, scale):
    """Plain twin of `flash_bwd_dkv`: dK = scale·dSᵀ·Q and dV = Pᵀ·dO over
    query rows < length."""
    if q.is_cuda:
        _kernels.count_plain("flash_bwd_dkv")
    p, ds = _probs_and_dscores(q, k, v, lengths, lse, g, dd, scale)
    rows = _query_rows_ok(q, lengths)
    p, ds = torch.where(rows, p, 0.0), torch.where(rows, ds, 0.0)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, lengths, out, lse, g,
                              scale: float | None = None):
    """The reference's `_fused_bwd` in plain torch → (dq, dk, dv)."""
    lengths, scale = _defaults(q, lengths, scale)
    dd = _row_delta(out, g)
    dq = flash_bwd_dq_plain(q, k, v, lengths, lse, dd, g, scale)
    dk, dv = flash_bwd_dkv_plain(q, k, v, lengths, lse, dd, g, scale)
    return dq, dk, dv


def _kernel_args(q, k, v, lengths, lse, dd, g):
    """Checked, contiguous kernel inputs, q, k, v and g padded to the
    kernels' width; raises on what the kernels do not take."""
    b, h, s, dh = q.shape
    if q.dtype not in _KERNEL_DTYPES or dh < 1:
        raise ValueError(f"flash backward kernels take f32 or bf16 with "
                         f"Dh ≥ 1, got {q.dtype} Dh={dh}")
    width = kernel_width(dh)
    for x in (k, v, g):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError("k, v and the gradient must match q in shape, "
                             "dtype and device")
    for x in (lse, dd):
        if x.shape != (b, h, s, 1):
            raise ValueError(f"row statistics must be [{b},{h},{s},1], got "
                             f"{tuple(x.shape)}")
    lengths = lengths.to(device=q.device, dtype=torch.int32)
    lse, dd = (x.to(device=q.device, dtype=torch.float32) for x in (lse, dd))
    q, k, v, g = (pad_head(x, width) for x in (q, k, v, g))
    return [x.contiguous() for x in (q, k, v, g, lengths, lse, dd)]


def _unpad(x, dh: int):
    return x if x.shape[-1] == dh else x[..., :dh].contiguous()


def flash_bwd_dq(q, k, v, lengths, lse, dd, g, scale: float):
    """dQ through the `flash_bwd_dq` kernel (CUDA) or its twin (CPU)."""
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, lengths, lse, dd, g, scale)
    args = _kernel_args(q, k, v, lengths, lse, dd, g)
    dq = torch.empty_like(args[0])
    lib = _kernels.load("flash_bwd_dq")
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_dq(
            _KERNEL_DTYPES[q.dtype], *map(_kernels.ptr, args),
            _kernels.ptr(dq), *args[0].shape, scale, _kernels.stream_of(q))
    _kernels.check(lib, err, "flash_bwd_dq")
    _kernels.count_launch("flash_bwd_dq")
    return _unpad(dq, q.shape[-1])


def flash_bwd_dkv(q, k, v, lengths, lse, dd, g, scale: float):
    """(dK, dV) through the `flash_bwd_dkv` kernel (CUDA) or its twin."""
    if not q.is_cuda:
        return flash_bwd_dkv_plain(q, k, v, lengths, lse, dd, g, scale)
    args = _kernel_args(q, k, v, lengths, lse, dd, g)
    dk, dv = torch.empty_like(args[1]), torch.empty_like(args[2])
    lib = _kernels.load("flash_bwd_dkv")
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_dkv(
            _KERNEL_DTYPES[q.dtype], *map(_kernels.ptr, args),
            _kernels.ptr(dk), _kernels.ptr(dv), *args[0].shape, scale,
            _kernels.stream_of(q))
    _kernels.check(lib, err, "flash_bwd_dkv")
    _kernels.count_launch("flash_bwd_dkv")
    return _unpad(dk, q.shape[-1]), _unpad(dv, q.shape[-1])


def flash_attention_bwd(q, k, v, lengths, out, lse, g,
                        scale: float | None = None):
    """(dq, dk, dv) of `flash_attention` given the upstream gradient `g`:
    the kernels on CUDA tensors, the twins on CPU tensors."""
    lengths, scale = _defaults(q, lengths, scale)
    dd = _row_delta(out, g)
    dq = flash_bwd_dq(q, k, v, lengths, lse, dd, g, scale)
    dk, dv = flash_bwd_dkv(q, k, v, lengths, lse, dd, g, scale)
    return dq, dk, dv


class _FlashAttentionFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lengths, scale):
        out, lse = flash_attention(q, k, v, lengths, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, lengths, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, lengths, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, lengths, out, lse, g,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_fused(q, k, v, lengths=None, scale: float | None = None):
    """Differentiable flash attention. q/k/v: [B, H, S, Dh]; lengths: [B].

    Gradients flow to q, k and v (none to lengths) through the fused
    backward; without a gradient to compute this is `flash_attention`."""
    lengths, scale = _defaults(q, lengths, scale)
    if not (torch.is_grad_enabled()
            and any(x.requires_grad for x in (q, k, v))):
        return flash_attention(q, k, v, lengths, scale)
    return _FlashAttentionFused.apply(q, k, v, lengths, scale)
