"""An XLM-RoBERTa encoder layer's work (BGE-M3 and its cross-encoder):
four H×H projections and the H×F, F×H MLP over every valid token, and
attention of each valid query over its row's valid keys."""

from __future__ import annotations

from typing import Iterable


def layer_flops(lengths: Iterable[int], hidden: int,
                intermediate: int) -> int:
    """Products of one encoder layer over rows of these valid lengths."""
    total = 0
    for n in lengths:
        n = int(n)
        total += 2 * n * (4 * hidden * hidden + 2 * hidden * intermediate)
        total += 4 * n * n * hidden
    return total
