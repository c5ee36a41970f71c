"""Int8 index quantization: symmetric per-row int8 with an f32 scale.

    x_i8 = clip(round(x / s), −127, 127),  s = max(max|x|, 1e-12) / 127

Port of `rag_dpo_tpu/ops/quantize.py::quantize_rows`, plain torch, bit for
bit: the division is IEEE f32 and `torch.round` rounds half to even, as
`jnp.round` does. The JAX module's int8×int8 sweeps (`approx_topk_int8*`,
`int8_blockscan_candidates`, `dequant_refine`) are not ported: the port's
int8 sweep is the pooled-max kernel (`ops/pooled.py`, ROADMAP C-14).
"""

from __future__ import annotations

import torch


def quantize_rows(x):
    """[N, D] float (tensor or array) → ([N, D] int8, [N] f32 scales), on
    the tensor's device."""
    x = torch.as_tensor(x).float()
    amax = x.abs().amax(dim=1, keepdim=True)
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]
