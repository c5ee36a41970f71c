"""K1, fused non-causal attention over [B, H, S, Dh] with each batch row's
valid length: every valid query row against its row's valid keys (q·kᵀ
and p·v), q, k and v read over the valid rows, out written there."""

from __future__ import annotations

from typing import Sequence

from .. import peaks
from . import xlmr

# K1's kernels in a device trace
KERNEL = "flash_fwd_kernel"


def k1_work(heads: int, dh: int, lengths: Sequence[int],
            itemsize: int) -> tuple[int, int]:
    """(products, bytes) of one call."""
    sq = sum(int(n) * int(n) for n in lengths)
    rows = sum(int(n) for n in lengths)
    return (4 * dh * heads * sq,
            4 * heads * dh * rows * itemsize + 4 * len(lengths))


def k1_bound_s(heads: int, dh: int, lengths: Sequence[int],
               itemsize: int) -> float:
    """The least time the card could take: the products at the rate for
    the inputs' type, or the bytes at the memory's rate."""
    flops, nbytes = k1_work(heads, dh, lengths, itemsize)
    rate = peaks.flops_peak("f32" if itemsize == 4 else "bf16")
    return max(flops / rate, nbytes / peaks.HBM_BYTES_PER_S)


def attention_work(calls, trace: dict, hidden: int,
                   intermediate: int) -> tuple[float, float, float]:
    """(K1's bound seconds, the encoder layers' products, K1's device
    seconds) of the traced window. `calls` are the attention calls the
    harness recorded [(launch ns, heads, Dh, lengths, itemsize)]; each is
    one encoder layer. Raises where K1 ran in the window and no call was
    recorded there: the harness's hook on the program's attention entry
    has come loose, and the metrics that read it would go silent."""
    t0, t1 = trace["start_ns"], trace["end_ns"]
    device_s = sum(d for name, _, d in trace["kernels"]
                   if KERNEL in name) / 1e9
    bound = flops = 0.0
    n = 0
    for t_ns, h, dh, lens, itemsize in calls:
        if t0 <= t_ns <= t1:
            bound += k1_bound_s(h, dh, lens, itemsize)
            flops += xlmr.layer_flops(lens, hidden, intermediate)
            n += 1
    if device_s > 0 and not n:
        raise RuntimeError(
            f"{KERNEL} ran {device_s:.3f} s in the traced window, but no "
            "attention call was recorded there: the hook on the port's "
            "attention entry no longer sees its calls")
    return bound, flops, device_s
