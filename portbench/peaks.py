"""The card's published peaks: NVIDIA H100 SXM data sheet, dense rates
without sparsity, at its 700 W limit. Every roofline and `mfu` share is
stated against these, with the card's power limit printed beside it.

An f32-input product is held to the TF32 tensor cores' rate: it is the
highest rate at which the card takes f32 inputs, so no kernel that keeps
f32 accuracy can read above 100% of it.
"""

TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def flops_peak(dtype: str) -> float:
    """The product rate for inputs of `dtype` ("f32" or "bf16")."""
    return {"f32": TF32_FLOPS, "bf16": BF16_FLOPS}[dtype]
