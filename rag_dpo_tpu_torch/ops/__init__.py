"""Device ops: hand-written CUDA kernels for Hopper with plain-torch twins.

Every kernel wrapper takes its plain PyTorch version only for tensors that
live on the CPU; for a CUDA tensor it launches the kernel (built at first
use by `_kernels`) or raises. Work that XLA did without a hand-written
kernel in the JAX package (RRF fusion, the postings engine, int8
quantization) is plain torch here.
"""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """`device` if given, else the first CUDA card. Without a card it
    raises rather than fall back: a run on the CPU is asked for with
    `device="cpu"`, so no caller measures the CPU thinking it is a card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); pass "
            'device="cpu" to run on the CPU')
    return torch.device("cuda")


from .topk import (  # noqa: E402,F401
    approx_topk,
    blocked_topk,
    cosine_topk_reference,
    fused_candidates_topk,
    fused_topk,
    streaming_topk_reference,
)
from .fusion import rrf_fuse, rrf_fuse_reference  # noqa: E402,F401
from .flash_attention import (  # noqa: E402,F401
    attention_reference,
    flash_attention,
)
from .sparse import ell_scores, ell_scores_reference, ell_topk  # noqa: E402,F401
from .maxsim import maxsim, maxsim_reference  # noqa: E402,F401
