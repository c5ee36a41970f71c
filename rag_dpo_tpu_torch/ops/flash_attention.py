"""Non-causal, length-masked attention for the encoder forward passes.

`flash_attention` is the port of both Pallas forwards of the JAX package
(`ops/flash_attention.py::flash_attention` and
`ops/flash_attention_bwd.py::_fwd_with_stats`): on a CUDA tensor it launches
the hand-written kernel in `csrc/flash_fwd.cu` (both products on the tensor
cores; f32 inputs as 3xTF32, three TF32 products of a split into big and
small parts, which keeps f32 accuracy), on a CPU tensor it runs
`flash_attention_plain`, the same math in one key block. Both keep the
reference's clamps (running max ≥ −1e20, denominator ≥ 1e-30), so a row
whose keys are all masked outputs 0, not NaN, and its lse is −1e20.

The kernels are built for the head widths `KERNEL_WIDTHS`. The forward
takes any Dh up to the last and fills the columns past it with zeros as
it loads; the backward kernels get copies padded by `pad_head`. A zero
column adds an exact zero to every sum, so neither changes a bit.

`attention_reference` is the plain softmax oracle, with the JAX
reference's semantics: a fully masked row averages over all keys. The
encoder uses it when `use_flash_attention` is off.
"""

from __future__ import annotations

import torch

from . import _kernels

NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_WIDTHS = (16, 32, 64, 128, 256, 512)


def kernel_width(dh: int) -> int:
    """The narrowest width the kernels are built for that holds `dh`."""
    for w in KERNEL_WIDTHS:
        if dh <= w:
            return w
    raise ValueError(f"the flash kernels take head widths up to "
                     f"{KERNEL_WIDTHS[-1]}, got Dh={dh}")


def pad_head(x, width: int):
    """`x` [..., Dh] with zero columns up to `width` (a copy), or `x`
    itself when Dh is `width` already."""
    extra = width - x.shape[-1]
    return torch.nn.functional.pad(x, (0, extra)) if extra else x


def attention_reference(q, k, v, lengths=None, scale: float | None = None):
    """[B, H, S, Dh] ×3 (+ [B] lengths) → [B, H, S, Dh]. Plain oracle."""
    b, h, s, dh = q.shape
    if scale is None:
        scale = dh ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if lengths is not None:
        mask = (torch.arange(s, device=q.device)[None, :]
                < lengths.to(q.device)[:, None])
        logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def _defaults(q, lengths, scale):
    b, _, s, dh = q.shape
    if scale is None:
        scale = float(dh) ** -0.5
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    return lengths, scale


def flash_attention_plain(q, k, v, lengths=None, scale: float | None = None,
                          return_lse: bool = False):
    """Plain twin of the flash kernel: the online softmax of the reference
    collapsed to a single key block. lse is [B, H, S, 1] f32."""
    if q.is_cuda:
        _kernels.count_plain("flash_fwd")
    lengths, scale = _defaults(q, lengths, scale)
    s = q.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    col = torch.arange(s, device=q.device)
    mask = col[None, :] < lengths.to(q.device)[:, None]
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True).clamp_min(-1e20)
    p = torch.exp(logits - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = (torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l_safe).to(q.dtype)
    if return_lse:
        return out, m + torch.log(l_safe)
    return out


def flash_attention(q, k, v, lengths=None, scale: float | None = None,
                    return_lse: bool = False):
    """Fused non-causal attention. q/k/v: [B, H, S, Dh]; lengths: [B] i32.

    Returns out [B, H, S, Dh] in q's dtype, and with `return_lse` also the
    per-row logsumexp [B, H, S, 1] f32. CPU tensors take the plain twin;
    CUDA tensors (f32 or bf16, 1 ≤ Dh ≤ 512) launch the kernel or
    raise."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, lengths, scale, return_lse)
    lengths, scale = _defaults(q, lengths, scale)
    b, h, s, dh = q.shape
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes f32 or bf16, got {q.dtype}")
    if dh < 1:
        raise ValueError(f"flash kernel takes Dh ≥ 1, got {dh}")
    kernel_width(dh)  # raises past the widest instance
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype, device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [{b}], got {tuple(lengths.shape)}")
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s, 1), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = _kernels.load("flash_fwd")
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            _KERNEL_DTYPES[q.dtype], _kernels.ptr(q), _kernels.ptr(k),
            _kernels.ptr(v), _kernels.ptr(lengths), _kernels.ptr(out),
            _kernels.ptr(lse), b, h, s, dh, scale, _kernels.stream_of(q))
    _kernels.check(lib, err, "flash_fwd")
    _kernels.count_launch("flash_fwd")
    return (out, lse) if return_lse else out
